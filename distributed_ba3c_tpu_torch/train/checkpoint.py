"""Checkpoint and resume of the learner state, with keep-best.

Port of ``distributed_ba3c_tpu/train/checkpoint.py``. The layout and the
rules are the JAX package's: each save is ``root/ckpt-<step>/``, and
``root/checkpoint.json`` holds ``all``, ``latest``, ``best`` and
``best_score``; pruning beyond ``max_to_keep`` never deletes the best step
or the one just saved; ``run_meta.json`` records the run's shape. Every
JSON write goes through a ``.tmp`` file and ``os.replace``.

The format is the port's own (orbax is JAX's): ``ckpt-<step>/state.pt``,
written by ``torch.save`` and read with ``weights_only=True``. A learner
state is saved as the payload of :func:`train_state_payload`: ``step``,
``params`` (a flax tree of CPU tensors, ``models/convert.py::to_flax``'s
names) and ``opt`` (:meth:`ClipAdam.state_dict`: optax's ``count``,
``mu``, ``nu`` and the ``learning_rate`` hyperparam).
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Optional

import torch

_STATE_FILE = "state.pt"


def _write_json(path: str, obj) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


class CheckpointManager:
    """Saves and restores payloads (nested dicts of tensors and numbers)
    under ``root/ckpt-<step>``."""

    def __init__(self, root: str, max_to_keep: int = 3):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        self.max_to_keep = max_to_keep
        self._meta_path = os.path.join(self.root, "checkpoint.json")
        self._meta = {"all": [], "latest": None, "best": None, "best_score": None}
        if os.path.isfile(self._meta_path):
            with open(self._meta_path) as f:
                self._meta = json.load(f)
        self._run_meta_path = os.path.join(self.root, "run_meta.json")

    def write_run_meta(self, **fields) -> None:
        """Persist the run's shape (steps_per_epoch, batch shape, ...) next
        to the checkpoints: a resume derives its epoch from step //
        steps_per_epoch, so another shape would stretch the anneal."""
        _write_json(self._run_meta_path, fields)

    def read_run_meta(self) -> dict:
        if os.path.isfile(self._run_meta_path):
            with open(self._run_meta_path) as f:
                return json.load(f)
        return {}

    def _dir(self, step: int) -> str:
        return os.path.join(self.root, f"ckpt-{step}")

    def save(self, payload: Any, step: int) -> str:
        """Save ``payload`` as step ``step``, then prune; returns the
        checkpoint's directory."""
        path = self._dir(step)
        os.makedirs(path, exist_ok=True)
        target = os.path.join(path, _STATE_FILE)
        torch.save(payload, target + ".tmp")
        os.replace(target + ".tmp", target)
        if step not in self._meta["all"]:
            # re-saving a step (a killed run re-driven over the same logdir)
            # must not duplicate its entry
            self._meta["all"].append(step)
        self._meta["latest"] = step
        # prune the oldest beyond max_to_keep, but never the best or the
        # step just saved (with max_to_keep=1 that would delete `latest`)
        protected = {self._meta.get("best"), step}
        keep = list(self._meta["all"])
        deletable = [s for s in keep if s not in protected]
        while len(keep) > self.max_to_keep and deletable:
            victim = deletable.pop(0)
            keep.remove(victim)
            if os.path.isdir(self._dir(victim)):
                shutil.rmtree(self._dir(victim))
        self._meta["all"] = keep
        _write_json(self._meta_path, self._meta)
        return path

    def mark_best(self, step: int, score: float) -> bool:
        """Record ``step`` as best if ``score`` improves; True if so."""
        best = self._meta.get("best_score")
        if best is None or score > best:
            self._meta["best"] = step
            self._meta["best_score"] = float(score)
            _write_json(self._meta_path, self._meta)
            return True
        return False

    @property
    def all_steps(self) -> list:
        """Every kept step, ascending, deduplicated."""
        return sorted(set(self._meta.get("all", [])))

    @property
    def latest_step(self) -> Optional[int]:
        return self._meta.get("latest")

    @property
    def best_step(self) -> Optional[int]:
        return self._meta.get("best")

    def restore(self, step: Optional[int] = None, map_location="cpu") -> Any:
        """The payload saved at ``step`` (the latest when None), its tensors
        on ``map_location``."""
        if step is None:
            step = self.latest_step
        if step is None:
            raise FileNotFoundError(f"no checkpoint to restore in {self.root}")
        return torch.load(
            os.path.join(self._dir(step), _STATE_FILE),
            map_location=map_location, weights_only=True,
        )


def train_state_payload(train) -> dict:
    """A :class:`TrainState`'s checkpoint payload: its step, the model's
    params as a flax tree of CPU tensors, the optimizer's state."""
    from distributed_ba3c_tpu_torch.models.convert import to_flax, tree_to_torch

    return {
        "step": int(train.step),
        "params": tree_to_torch(to_flax(train.model.state_dict())),
        "opt": train.optimizer.state_dict(),
    }


def load_params(model, params) -> None:
    """Copy a flax tree of params (tensors or numpy arrays) into ``model``."""
    from distributed_ba3c_tpu_torch.models.convert import from_flax, tree_to_numpy

    model.load_state_dict(from_flax(tree_to_numpy(params)))


def restore_params(model, root: str, step: Optional[int] = None) -> int:
    """Load the params of the checkpoint at ``step`` (the latest when None)
    under ``root`` into ``model`` (``--task eval|play --load``); returns
    the checkpoint's step."""
    payload = CheckpointManager(root).restore(
        step, map_location=next(model.parameters()).device
    )
    load_params(model, payload["params"])
    return int(payload["step"])


def restore_train_state(train, mgr: CheckpointManager, step: Optional[int] = None):
    """Load the checkpoint at ``step`` (the latest when None) into
    ``train``'s model and optimizer, in place; returns ``train`` at the
    checkpoint's step."""
    import dataclasses

    dev = next(train.model.parameters()).device
    payload = mgr.restore(step, map_location=dev)
    load_params(train.model, payload["params"])
    train.optimizer.load_state_dict(payload["opt"])
    return dataclasses.replace(train, step=int(payload["step"]))

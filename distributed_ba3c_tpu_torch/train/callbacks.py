"""Callbacks around the training loop, hyperparameter schedules and live
overrides.

Port of ``distributed_ba3c_tpu/train/callbacks.py:24-519`` (Tensorpack's
callbacks, SURVEY.md §2.7): ``Callback``/``Callbacks``/``PeriodicTrigger``,
``StartProcOrThread``, the hyperparameter setters (scheduled, and
``HumanHyperParamSetter`` over ``<logdir>/hyper.txt``), ``StatPrinter``
(stat.json, fps from ``train_samples_total``), ``ModelSaver``/``MaxSaver``
(``train/checkpoint.py``) and ``Evaluator``. Hook order in the loop, as
there: ``before_train`` -> per-step ``trigger_step`` -> per-epoch
``trigger_epoch`` -> ``after_train``. One process: the multi-host broadcast
of ``HumanHyperParamSetter`` and collective saves are not ported (ROADMAP
queue A item 8). ``anneal_interp`` and ``read_hyper_file`` are shared with
the fused loop.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np

from distributed_ba3c_tpu_torch.utils import logger


class Callback:
    trainer = None  # set by setup()

    def setup(self, trainer) -> None:
        self.trainer = trainer

    def before_train(self) -> None:
        pass

    def trigger_step(self, metrics: Optional[dict]) -> None:
        pass

    def trigger_epoch(self) -> None:
        pass

    def after_train(self) -> None:
        pass


class Callbacks(Callback):
    """Dispatch group; after_train runs for every member even on errors."""

    def __init__(self, cbs: Sequence[Callback]):
        self.cbs = list(cbs)

    def setup(self, trainer) -> None:
        for cb in self.cbs:
            cb.setup(trainer)

    def before_train(self) -> None:
        for cb in self.cbs:
            cb.before_train()

    def trigger_step(self, metrics) -> None:
        for cb in self.cbs:
            cb.trigger_step(metrics)

    def trigger_epoch(self) -> None:
        for cb in self.cbs:
            cb.trigger_epoch()

    def after_train(self) -> None:
        for cb in self.cbs:
            try:
                cb.after_train()
            except Exception:  # noqa: BLE001 - teardown must not cascade
                import traceback

                logger.error(
                    "error in %s.after_train:\n%s",
                    type(cb).__name__,
                    traceback.format_exc(),
                )


class PeriodicTrigger(Callback):
    """Run the wrapped callback's trigger_epoch every N epochs (or steps)."""

    def __init__(
        self,
        cb: Callback,
        every_k_epochs: Optional[int] = None,
        every_k_steps: Optional[int] = None,
    ):
        assert (every_k_epochs is None) != (every_k_steps is None)
        self.cb = cb
        self.every_k_epochs = every_k_epochs
        self.every_k_steps = every_k_steps

    def setup(self, trainer):
        super().setup(trainer)
        self.cb.setup(trainer)

    def before_train(self):
        self.cb.before_train()

    def trigger_step(self, metrics):
        if (
            self.every_k_steps
            and self.trainer.global_step % self.every_k_steps == 0
        ):
            self.cb.trigger_epoch()

    def trigger_epoch(self):
        if (
            self.every_k_epochs
            and self.trainer.epoch_num % self.every_k_epochs == 0
        ):
            self.cb.trigger_epoch()

    def after_train(self):
        self.cb.after_train()


class StartProcOrThread(Callback):
    """Start simulator processes and the master/predictor/feed threads with
    the trainer; anything with ``.start()`` works. Processes start with
    SIGINT masked and are registered for termination at exit."""

    def __init__(self, startables: Sequence) -> None:
        self.startables = list(startables)

    def _split(self):
        import multiprocessing as mp

        procs = [s for s in self.startables if isinstance(s, mp.process.BaseProcess)]
        others = [s for s in self.startables if not isinstance(s, mp.process.BaseProcess)]
        return procs, others

    def before_train(self) -> None:
        from distributed_ba3c_tpu_torch.utils.concurrency import (
            ensure_proc_terminate,
            start_proc_mask_signal,
        )

        procs, others = self._split()
        if procs:
            ensure_proc_terminate(procs)
            start_proc_mask_signal(procs)
        for s in others:
            s.start()
        logger.info(
            "StartProcOrThread: started %d processes, %d threads/servers",
            len(procs),
            len(others),
        )

    def after_train(self) -> None:
        """Full teardown: stop everything, join and close the threads (ZMQ
        contexts included), then reap every process."""
        procs, others = self._split()
        for s in others:
            stop = getattr(s, "stop", None)
            if callable(stop):
                stop()
        for p in procs:
            if p.is_alive():
                p.terminate()
        for s in others:
            join = getattr(s, "join", None)
            if callable(join):
                try:
                    join(timeout=5)
                except TypeError:
                    join()
            close = getattr(s, "close", None)
            if callable(close):
                close()
        for p in procs:
            p.join(timeout=5)
            if p.is_alive():
                p.kill()
                p.join(timeout=5)


class HyperParamSetter(Callback):
    """Base: sets ``trainer.hyperparams[name]`` at epoch boundaries."""

    def __init__(self, name: str):
        self.name = name

    def _value_to_set(self) -> Optional[float]:
        raise NotImplementedError

    def _set(self):
        v = self._value_to_set()
        if v is not None and v != self.trainer.hyperparams.get(self.name):
            logger.info("hyperparam %s <- %.6g", self.name, v)
            self.trainer.hyperparams[self.name] = v

    def before_train(self):
        self._set()

    def trigger_epoch(self):
        self._set()


def anneal_interp(v0: float, v1: float, frac: float, mode: str) -> float:
    """Interpolate a hyperparam between ``v0`` and ``v1`` at ``frac`` in
    [0, 1]. ``mode="exp"`` is geometric and needs positive endpoints."""
    frac = min(max(frac, 0.0), 1.0)
    if mode == "exp":
        if v0 <= 0 or v1 <= 0:
            raise ValueError(
                f"exp anneal needs positive endpoints, got {v0} -> {v1}"
            )
        return v0 * (v1 / v0) ** frac
    return v0 + frac * (v1 - v0)


def read_hyper_file(path: str) -> Dict[str, float]:
    """Parse a hyper.txt of ``name: value`` lines ({} if absent or
    unreadable). A malformed line is skipped with a warning; the other
    lines still apply, so one typo mid-edit does not revert every
    override to its scheduled value."""
    if not os.path.isfile(path):
        return {}
    try:
        with open(path) as f:
            lines = f.readlines()
    except OSError:
        logger.warn("could not read %s", path)
        return {}
    out: Dict[str, float] = {}
    for line in lines:
        if ":" not in line:
            continue
        k, _, v = line.partition(":")
        try:
            out[k.strip()] = float(v)
        except ValueError:
            logger.warn("ignoring malformed line in %s: %r", path, line.strip())
    return out


class ScheduledHyperParamSetter(HyperParamSetter):
    """Piecewise schedule [(epoch, value), ...]; optional linear/exp
    interpolation between the knots."""

    def __init__(
        self,
        name: str,
        schedule: Sequence[Tuple[int, float]],
        interp: Optional[str] = None,
    ):
        super().__init__(name)
        self.schedule = sorted(schedule)
        assert interp in (None, "linear", "exp")
        self.interp = interp

    def _value_to_set(self) -> Optional[float]:
        e = self.trainer.epoch_num
        laste, lastv = None, None
        for se, sv in self.schedule:
            if se == e:
                return sv
            if se > e:
                if self.interp is None or laste is None:
                    return lastv
                frac = (e - laste) / (se - laste)
                return anneal_interp(lastv, sv, frac, self.interp)
            laste, lastv = se, sv
        return lastv


class HumanHyperParamSetter(HyperParamSetter):
    """Read ``<dir>/<fname>`` lines of ``name: value`` each epoch (the
    reference's human-editable live hyperparam file). ``shared_dir`` is
    where to look (the trainer's log dir when None)."""

    def __init__(
        self,
        name: str,
        fname: str = "hyper.txt",
        shared_dir: Optional[str] = None,
    ):
        super().__init__(name)
        self.fname = fname
        self.shared_dir = shared_dir

    def _value_to_set(self) -> Optional[float]:
        log_dir = self.shared_dir or self.trainer.config.log_dir
        if log_dir is None:
            return None
        return read_hyper_file(os.path.join(log_dir, self.fname)).get(self.name)


class StatPrinter(Callback):
    """Samples step metrics, accumulates epoch stats, prints + stat.json.

    Device scalars are fetched only every ``sample_every`` steps, so the
    loop does not sync the card every step. The fps reads the learner
    registry's ``train_samples_total`` (the trainer's one account of
    progress); the epoch record also takes the telemetry scalars
    (``tele/<role>/<name>``).
    """

    def __init__(self, sample_every: int = 20):
        self.sample_every = sample_every
        self._counters: Dict[str, list] = {}
        self._epoch_t0 = None
        self._last_samples = 0.0
        self._last_gstep = 0

    def before_train(self):
        from distributed_ba3c_tpu_torch import telemetry

        self._epoch_t0 = time.monotonic()
        self._samples_counter = telemetry.registry("learner").counter(
            "train_samples_total"
        )
        self._last_samples = self._samples_counter.value()
        self._last_gstep = self.trainer.global_step

    def trigger_step(self, metrics):
        if metrics is None or self.trainer.global_step % self.sample_every:
            return
        for k, v in metrics.items():
            self._counters.setdefault(k, []).append(float(v))

    def trigger_epoch(self):
        from distributed_ba3c_tpu_torch import telemetry

        tr = self.trainer
        holder = tr.stat_holder
        dt = time.monotonic() - self._epoch_t0 if self._epoch_t0 else 0.0
        samples = self._samples_counter.value() - self._last_samples
        self._last_samples += samples
        if not telemetry.enabled():
            # telemetry off: the counters are no-ops, count the loop's steps
            samples = (tr.global_step - self._last_gstep) * tr.batch_size
        self._last_gstep = tr.global_step
        fps = samples / dt if dt > 0 else 0.0
        holder.add_stat("global_step", tr.global_step)
        holder.add_stat("epoch", tr.epoch_num)
        holder.add_stat("fps", fps)
        for k, vs in self._counters.items():
            if vs:
                holder.add_stat(k, float(np.mean(vs)))
        if tr.score_counter is not None and tr.score_counter.count:
            holder.add_stat("mean_score", tr.score_counter.average)
            holder.add_stat("max_score", tr.score_counter.max)
            tr.last_mean_score = tr.score_counter.average
            tr.score_counter.reset()
        if telemetry.enabled():
            holder.add_stats(telemetry.export_scalars())
        record = holder.finalize()
        logger.info(
            "epoch %d | step %d | fps %.0f | %s",
            tr.epoch_num,
            tr.global_step,
            fps,
            " ".join(
                f"{k}={v:.4g}"
                for k, v in record.items()
                if k not in ("epoch", "global_step", "fps")
                and not k.startswith("tele/")
            ),
        )
        self._counters = {}
        self._epoch_t0 = time.monotonic()


class ModelSaver(Callback):
    """Save the learner state every epoch (``train/checkpoint.py``)."""

    def __init__(self, ckpt_dir: Optional[str] = None, max_to_keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.max_to_keep = max_to_keep

    def before_train(self):
        from distributed_ba3c_tpu_torch.train.checkpoint import CheckpointManager

        d = self.ckpt_dir or os.path.join(
            self.trainer.config.log_dir or ".", "checkpoints"
        )
        self.trainer.ckpt_manager = CheckpointManager(
            d, max_to_keep=self.max_to_keep
        )

    def trigger_epoch(self):
        if self.trainer.ckpt_manager is not None:
            from distributed_ba3c_tpu_torch import telemetry
            from distributed_ba3c_tpu_torch.train.checkpoint import (
                train_state_payload,
            )

            path = self.trainer.ckpt_manager.save(
                train_state_payload(self.trainer.state), self.trainer.global_step
            )
            telemetry.record("checkpoint", step=self.trainer.global_step)
            logger.info("saved checkpoint %s", path)


class MaxSaver(Callback):
    """Mark the checkpoint as best when the monitored stat improves.

    Reads ``monitor`` from the epoch record StatPrinter just finalized (so
    ``eval_mean_score`` tracks the greedy Evaluator); epochs without the
    stat leave the best pointer untouched.
    """

    def __init__(self, monitor: str = "mean_score"):
        self.monitor = monitor

    def trigger_epoch(self):
        tr = self.trainer
        if tr.ckpt_manager is None:
            return
        history = tr.stat_holder.stat_history
        score = history[-1].get(self.monitor) if history else None
        if score is None and self.monitor == "mean_score":
            score = tr.last_mean_score
        if score is not None and tr.ckpt_manager.mark_best(
            tr.global_step, score
        ):
            logger.info("new best %s=%.3f", self.monitor, score)


class Evaluator(Callback):
    """Play eval episodes with the current greedy policy each epoch; the
    players step in lockstep, so every forward is one batched call."""

    def __init__(self, nr_eval: int, build_player: Callable[[int], object]):
        self.nr_eval = nr_eval
        self.build_player = build_player

    def trigger_epoch(self):
        from distributed_ba3c_tpu_torch.train.eval import eval_model

        mean, mx = eval_model(
            self.trainer.predictor_fn(),
            self.build_player,
            self.nr_eval,
        )
        self.trainer.stat_holder.add_stat("eval_mean_score", mean)
        self.trainer.stat_holder.add_stat("eval_max_score", mx)
        logger.info("eval: mean=%.3f max=%.3f over %d eps", mean, mx, self.nr_eval)

"""The port's trainer and callbacks (``train/trainer.py``,
``train/callbacks.py``) held against the JAX package's ``Trainer``.

One synthetic feed (seeded numpy batches) and one score stream go through
the JAX ``Trainer`` (its ``make_train_step`` on a one-device CPU mesh) and
the port's (its ``make_train_step``, behind ``DeviceIngest`` on the CPU),
with the same callbacks: the hyperparameter setters (a
``ScheduledHyperParamSetter`` on the learning rate, ``hyper.txt`` through
``HumanHyperParamSetter`` on the entropy beta), ``StatPrinter``,
``ModelSaver`` and ``MaxSaver``. The stat.json records (epochs, steps,
keys, scores), ``checkpoint.json`` and the hyperparameters each epoch saw
must agree; then a ``--load`` restore on each side continues the step.
"""

from __future__ import annotations

import json
import os
import queue

import jax
import numpy as np
import pytest

from distributed_ba3c_tpu.config import BA3CConfig as JaxConfig
from distributed_ba3c_tpu.models.a3c import BA3CNet as JaxNet
from distributed_ba3c_tpu.ops.gradproc import make_optimizer as jax_make_optimizer
from distributed_ba3c_tpu.parallel import train_step as jstep
from distributed_ba3c_tpu.parallel.mesh import make_mesh
from distributed_ba3c_tpu.train import callbacks as jcb
from distributed_ba3c_tpu.train import trainer as jtrainer
from distributed_ba3c_tpu_torch.config import BA3CConfig
from distributed_ba3c_tpu_torch.data.staging import DeviceIngest
from distributed_ba3c_tpu_torch.models import BA3CNet, from_flax
from distributed_ba3c_tpu_torch.parallel.train_step import (
    create_train_state,
    make_train_step,
)
from distributed_ba3c_tpu_torch.train import callbacks as pcb
from distributed_ba3c_tpu_torch.train import trainer as ptrainer

FEATS = (8, 8, 16, 16)
SIZE, BATCH, STEPS, EPOCHS = 16, 8, 3, 3
SCHEDULE = [(1, 1e-3), (3, 2.5e-4)]


class _Feed:
    """The same seeded batches for either trainer (stands in for TrainFeed)."""

    def __init__(self, seed=0):
        self.rng = np.random.default_rng(seed)

    def next_batch(self, timeout=None):
        return {
            "state": self.rng.integers(0, 256, (BATCH, SIZE, SIZE, 4), dtype=np.uint8),
            "action": self.rng.integers(0, 4, BATCH).astype(np.int32),
            "return": self.rng.normal(size=BATCH).astype(np.float32),
        }


def _recorder(base):
    class Record(base):
        """Feeds one episode score per step and records the hyperparams
        each epoch ended with."""

        def __init__(self):
            self.seen = []

        def trigger_step(self, metrics):
            g = self.trainer.global_step
            self.trainer.score_queue.put(float(g % 5) - 1.0)

        def trigger_epoch(self):
            self.seen.append(dict(self.trainer.hyperparams))

    return Record()


def _callbacks(mod, logdir):
    return [
        mod.HumanHyperParamSetter("entropy_beta", shared_dir=logdir),
        mod.StatPrinter(sample_every=2),
        mod.ModelSaver(ckpt_dir=os.path.join(logdir, "checkpoints"), max_to_keep=2),
        mod.MaxSaver(monitor="mean_score"),
        mod.ScheduledHyperParamSetter("learning_rate", SCHEDULE, interp="linear"),
    ]


@pytest.fixture(scope="module")
def jax_parts():
    cfg = JaxConfig(image_size=(SIZE, SIZE), fc_units=16, num_actions=4, batch_size=BATCH)
    model = JaxNet(num_actions=4, fc_units=16, conv_features=FEATS)
    opt = jax_make_optimizer(cfg.learning_rate, cfg.adam_epsilon, cfg.grad_clip_norm)
    step = jstep.make_train_step(model, opt, cfg, make_mesh(num_data=1, devices=jax.devices()[:1]))
    state = jax.device_get(jstep.create_train_state(jax.random.PRNGKey(0), model, cfg, opt))
    return cfg, step, state


def _run_jax(parts, logdir, epochs, load=None):
    cfg, step, state = parts
    rec = _recorder(jcb.Callback)
    tr = jtrainer.Trainer(
        jtrainer.TrainLoopConfig(steps_per_epoch=STEPS, max_epoch=epochs, log_dir=logdir),
        cfg, step, state, _Feed(), _callbacks(jcb, logdir) + [rec],
        score_queue=queue.Queue(),
    )
    if load:
        tr.restore(load)
    tr.train()
    return tr, rec


def _run_port(parts, logdir, epochs, load=None):
    _, _, jstate = parts
    cfg = BA3CConfig(image_size=(SIZE, SIZE), fc_units=16, num_actions=4, batch_size=BATCH)
    net = BA3CNet(4, fc_units=16, conv_features=FEATS, image_size=(SIZE, SIZE), device="cpu")
    net.load_state_dict(from_flax(jstate.params))
    state = create_train_state(net, cfg)
    rec = _recorder(pcb.Callback)
    tr = ptrainer.Trainer(
        ptrainer.TrainLoopConfig(steps_per_epoch=STEPS, max_epoch=epochs, log_dir=logdir),
        cfg, make_train_step(net, state.optimizer, cfg), state,
        DeviceIngest(_Feed(), "cpu"), _callbacks(pcb, logdir) + [rec],
        score_queue=queue.Queue(),
    )
    if load:
        tr.restore(load)
    tr.train()
    return tr, rec


def _read(logdir):
    with open(os.path.join(logdir, "stat.json")) as f:
        stats = json.load(f)
    with open(os.path.join(logdir, "checkpoints", "checkpoint.json")) as f:
        meta = json.load(f)
    return stats, meta


def _plain_keys(rec):
    return {k for k in rec if not k.startswith("tele/")}


@pytest.fixture(scope="module")
def runs(jax_parts, tmp_path_factory):
    out = {}
    for side, run in (("jax", _run_jax), ("port", _run_port)):
        logdir = str(tmp_path_factory.mktemp(side))
        with open(os.path.join(logdir, "hyper.txt"), "w") as f:
            f.write("entropy_beta: 0.02\nlearning_rate oops\n")
        tr, rec = run(jax_parts, logdir, EPOCHS)
        out[side] = {"trainer": tr, "seen": rec.seen, "logdir": logdir, "read": _read(logdir)}
    return out


def test_stat_json_matches_the_jax_trainer(runs):
    (js, _), (ps, _) = runs["jax"]["read"], runs["port"]["read"]
    assert [r["epoch"] for r in ps] == [r["epoch"] for r in js] == [1, 2, 3]
    assert [r["global_step"] for r in ps] == [r["global_step"] for r in js] == [3, 6, 9]
    for p, j in zip(ps, js):
        assert _plain_keys(p) == _plain_keys(j), (_plain_keys(p) ^ _plain_keys(j))
        for k in ("mean_score", "max_score"):
            assert p[k] == pytest.approx(j[k]), k
        assert all(np.isfinite(p[k]) for k in _plain_keys(p))
    assert ps[-1]["tele/learner/train_samples_total"] >= EPOCHS * STEPS * BATCH


def test_checkpoints_match_the_jax_trainer(runs):
    (_, jm), (_, pm) = runs["jax"]["read"], runs["port"]["read"]
    assert pm == jm
    assert pm["latest"] == 9 and len(pm["all"]) == 2


def test_hyperparams_follow_the_schedule_and_hyper_txt(runs):
    assert runs["port"]["seen"] == pytest.approx(runs["jax"]["seen"])
    assert runs["port"]["seen"][-1] == {"learning_rate": 2.5e-4, "entropy_beta": 0.02}
    # the value set at the end of epoch 2 is the one epoch 3's steps ran
    # with, and it reached Adam
    opt = runs["port"]["trainer"].state.optimizer
    assert opt.learning_rate == pytest.approx(runs["jax"]["seen"][1]["learning_rate"])
    assert opt.learning_rate == pytest.approx(6.25e-4)


def test_load_continues_the_step(runs, jax_parts, tmp_path):
    for side, run in (("jax", _run_jax), ("port", _run_port)):
        src = os.path.join(runs[side]["logdir"], "checkpoints")
        tr, _ = run(jax_parts, str(tmp_path / side), 1, load=src)
        assert tr.global_step == 12, side
        stats, meta = _read(str(tmp_path / side))
        assert [r["global_step"] for r in stats] == [12]
        assert meta["latest"] == 12
    port_state = runs["port"]["trainer"].state
    assert port_state.step == 9


def test_feed_starvation_raises(jax_parts, tmp_path):
    class Dead:
        def next_batch(self, timeout=None):
            raise queue.Empty

    cfg = BA3CConfig(image_size=(SIZE, SIZE), fc_units=16, num_actions=4, batch_size=BATCH)
    net = BA3CNet(4, fc_units=16, conv_features=FEATS, image_size=(SIZE, SIZE), device="cpu")
    state = create_train_state(net, cfg)
    tr = ptrainer.Trainer(
        ptrainer.TrainLoopConfig(steps_per_epoch=2, max_epoch=1, log_dir=str(tmp_path),
                                 feed_timeout=0.1),
        cfg, make_train_step(net, state.optimizer, cfg), state, Dead(), [],
    )
    with pytest.raises(RuntimeError, match="starved"):
        tr.train()

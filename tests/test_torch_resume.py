"""The port's fused trainer keeps and resumes its runs, through the CLI on
the CPU (distributed_ba3c_tpu_torch/fused/loop.py, cli.py).

The resume sequence takes tests/test_fused_resume.py's flags and runs
through both packages' CLIs: a 2-epoch run, then ``--load`` with
``--max_epoch 4`` continues at epoch 3 (epochs [1, 2, 3, 4], global steps
[2, 4, 6, 8]), then a third run is a no-op. The port's runs must log the
JAX runs' lifecycle lines, keep the same run_meta.json and checkpoint.json,
and apply the JAX run's learning rate in epoch 3. ``hyper.txt`` is parsed
as the JAX package parses it, and overrides the learning rate (0 leaves
the params exactly where they were) with a malformed line skipped;
``--task eval|play --load`` serve the checkpoint's params.
"""

from __future__ import annotations

import json
import logging
import os

import numpy as np
import pytest
import torch

from distributed_ba3c_tpu_torch import cli
from distributed_ba3c_tpu_torch.config import BA3CConfig
from distributed_ba3c_tpu_torch.models import BA3CNet, to_flax
from distributed_ba3c_tpu_torch.parallel.train_step import create_train_state
from distributed_ba3c_tpu_torch.train.callbacks import read_hyper_file
from distributed_ba3c_tpu_torch.train.checkpoint import (
    CheckpointManager,
    train_state_payload,
)
from distributed_ba3c_tpu_torch.train.eval_tools import make_checkpoint_evaluator

FLAGS = [
    "--trainer", "tpu_fused_ba3c", "--env", "jax:pong", "--batch_size", "8",
    "--rollout_len", "2", "--fc_units", "16", "--steps_per_epoch", "2",
    "--nr_eval", "1", "--eval_max_steps", "8", "--learning_rate_final", "1e-5",
    "--anneal", "exp", "--max_to_keep", "8",
]
#: the log lines of a run's lifecycle, the same in both packages
LIFECYCLE = ("resume", "resumed train state", "loaded step")


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


@pytest.fixture
def log_lines():
    h = _Lines()
    logger = logging.getLogger("ba3c")
    level = logger.level
    logger.addHandler(h)
    logger.setLevel(logging.INFO)
    yield h.lines
    logger.removeHandler(h)
    logger.setLevel(level)


def _run(logdir, max_epoch, load=False, extra=(), main=cli.main):
    args = ["--task", "train", *FLAGS, "--max_epoch", str(max_epoch), "--logdir", str(logdir),
            *extra]
    if main is cli.main:
        args += ["--device", "cpu"]
    if load:
        args += ["--load", os.path.join(logdir, "checkpoints")]
    return main(args)


def _jax_run(logdir, max_epoch, load=False):
    from distributed_ba3c_tpu.cli import main

    return _run(logdir, max_epoch, load, main=main)


def _stats(logdir):
    return json.loads((logdir / "stat.json").read_text())


def _ckpt(logdir, step):
    return CheckpointManager(str(logdir / "checkpoints")).restore(step)


def _jax_opt(logdir, step):
    """(count, learning_rate) of the JAX checkpoint at ``step``: the
    InjectHyperparamsState's, as orbax restores it without a target."""
    from distributed_ba3c_tpu.train.checkpoint import CheckpointManager as JaxManager

    inject = JaxManager(str(logdir / "checkpoints")).restore(None, step)["opt_state"][1]
    return int(inject["inner_state"][0]["count"]), np.asarray(inject["hyperparams"]["learning_rate"])


def test_resume_continues_epochs_and_the_anneal(tmp_path, log_lines):
    """The same three runs through the port's CLI and the JAX package's:
    2 epochs, a --load resume to 4, a --load with the budget spent."""
    lifecycle, run_meta = {}, {}
    for side, run in (("port", _run), ("jax", _jax_run)):
        logdir = tmp_path / side
        lifecycle[side] = []
        for max_epoch, load in ((2, False), (4, True), (4, True)):
            log_lines.clear()
            assert run(logdir, max_epoch, load) == 0
            lifecycle[side].append([m for m in log_lines if m.startswith(LIFECYCLE)])
            if not load:
                run_meta[side] = (logdir / "checkpoints" / "run_meta.json").read_text()
    port, jax_dir = tmp_path / "port", tmp_path / "jax"
    assert lifecycle["port"] == lifecycle["jax"]
    assert "resume: continuing at epoch 3/4 (restored step 4)" in lifecycle["port"][1]
    assert any("nothing to train" in m for m in lifecycle["port"][2])
    assert run_meta["port"] == run_meta["jax"]
    shape = lambda d: [(int(r["epoch"]), int(r["global_step"])) for r in _stats(d)]  # noqa: E731
    assert shape(port) == shape(jax_dir) == [(1, 2), (2, 4), (3, 6), (4, 8)]
    assert ((port / "checkpoints" / "checkpoint.json").read_text()
            == (jax_dir / "checkpoints" / "checkpoint.json").read_text())
    assert int(_ckpt(port, 8)["opt"]["count"]) == _jax_opt(jax_dir, 8)[0] == 8

    # epoch 3's learning rate is the JAX run's there, and the one an
    # uninterrupted 4-epoch run of the port applies
    lr3 = _ckpt(port, 6)["opt"]["learning_rate"].numpy()
    assert lr3.dtype == np.float32 and lr3 == _jax_opt(jax_dir, 6)[1]
    straight = tmp_path / "straight"
    assert _run(straight, 4) == 0
    assert lr3 == _ckpt(straight, 6)["opt"]["learning_rate"].numpy()


def test_a_changed_run_shape_warns_on_every_later_resume(tmp_path, log_lines):
    logdir = tmp_path / "run"
    assert _run(logdir, 1) == 0
    meta = CheckpointManager(str(logdir / "checkpoints")).read_run_meta()
    assert meta == {"steps_per_epoch": 2, "batch_size": 8, "rollout_len": 2, "max_epoch": 1}
    for _ in range(2):
        log_lines.clear()
        assert _run(logdir, 1, load=True, extra=["--steps_per_epoch", "1"]) == 0
        warned = [m for m in log_lines if "resume shape mismatch: steps_per_epoch was 2" in m]
        assert warned, log_lines
        # the saved shape stays on record
        assert CheckpointManager(str(logdir / "checkpoints")).read_run_meta() == meta


def test_hyper_file_sets_the_learning_rate_live(tmp_path, log_lines):
    logdir = tmp_path / "run"
    assert _run(logdir, 1) == 0
    (logdir / "hyper.txt").write_text("learning_rate: 0\nentropy_beta: not-a-number\n")
    assert _run(logdir, 2, load=True) == 0
    before, after = _ckpt(logdir, 2), _ckpt(logdir, 4)
    for k, v in before["params"].items():
        for leaf, t in v.items():
            assert torch.equal(after["params"][k][leaf], t), (k, leaf)
    assert float(after["opt"]["learning_rate"]) == 0.0
    assert int(after["opt"]["count"]) == 4  # Adam stepped, at learning rate 0
    assert any("ignoring malformed line" in m and "entropy_beta" in m for m in log_lines)


@pytest.mark.parametrize("text", [
    "learning_rate: 3e-4\n\nentropy_beta: 0.0x1\nno colon\n gamma : 0.9 \n",
    "learning_rate: 1e-3\nentropy_beta: 0.01\n",
    "learning_rate 1e-3\n",
    None,
])
def test_read_hyper_file_matches_jax(tmp_path, log_lines, text):
    """the same hyper.txt parsed by both packages: the same values, and one
    warning for each malformed line"""
    from distributed_ba3c_tpu.train.callbacks import read_hyper_file as jax_read_hyper_file

    path = tmp_path / "hyper.txt"
    if text is not None:
        path.write_text(text)
    warned = {}
    got = {}
    for side, read in (("port", read_hyper_file), ("jax", jax_read_hyper_file)):
        log_lines.clear()
        got[side] = read(str(path))
        warned[side] = [m for m in log_lines if "ignoring malformed line" in m]
    assert got["port"] == got["jax"]
    assert warned["port"] == warned["jax"]


def _fake_checkpoint(tmp_path, seed=5):
    """A checkpoint of the model the CLI builds for --env fake at 16x16."""
    net = BA3CNet(4, fc_units=16, image_size=(16, 16), device="cpu",
                  generator=torch.Generator().manual_seed(seed))
    train = create_train_state(net, BA3CConfig(fc_units=16, num_actions=4))
    train.step = 7
    root = tmp_path / "checkpoints"
    CheckpointManager(str(root)).save(train_state_payload(train), 7)
    return str(root), net.state_dict()


@pytest.mark.parametrize("task", ["eval", "play"])
def test_eval_and_play_serve_the_checkpoints_params(tmp_path, monkeypatch, task):
    from distributed_ba3c_tpu_torch.predict import server

    root, want = _fake_checkpoint(tmp_path)
    served = []
    real = server.BatchedPredictor

    def spy(model, params, **kw):
        served.append({k: v.clone() for k, v in params.items()})
        return real(model, params, **kw)

    monkeypatch.setattr(server, "BatchedPredictor", spy)
    args = ["--task", task, "--env", "fake", "--image_size", "16", "--fc_units", "16",
            "--nr_eval", "1", "--max_steps", "10", "--device", "cpu"]
    assert cli.main([*args, "--load", root]) == 0
    assert cli.main(args) == 0  # without --load: the seeded init
    assert all(torch.equal(served[0][k], v) for k, v in want.items())
    assert not all(torch.equal(served[1][k], v) for k, v in want.items())


def test_checkpoint_evaluator_loads_the_params_it_is_given(tmp_path):
    logdir = tmp_path / "run"
    assert _run(logdir, 1, extra=["--fc_units", "16"]) == 0
    mgr, model, evaluate, n_eval = make_checkpoint_evaluator(
        "jax:pong", str(logdir / "checkpoints"), nr_eval=0, max_steps=4,
        fc_units=16, device="cpu")
    assert n_eval == 1 and mgr.latest_step == 2
    params = mgr.restore()["params"]
    mean, mx, n = evaluate(params, 0)
    assert (mean, n) == (0.0, 0)  # no Pong episode ends in 4 steps
    loaded = to_flax(model.state_dict())
    for k, v in params.items():
        for leaf, t in v.items():
            np.testing.assert_array_equal(loaded[k][leaf], t.numpy())

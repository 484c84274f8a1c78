"""The port's command line: ``--task train`` with the fused trainer and
with the sync trainer.

The fused train command runs at a small shape on the CPU (``--device
cpu``): full conv widths, ``--fc_units 16``, 2 envs x ``--rollout_len 3``,
2 steps x 2 epochs, a 5-step greedy eval. The sync trainer runs
``tests/test_e2e_fake.py``'s command (4 FakeEnv simulators, batch 32,
16x16 frames, fc 16, 2 x 80 steps, a 4-episode greedy eval) and must reach
its learning thresholds. Without ``--device`` the command asks for the card
and, where there is none, raises: it never carries on on the CPU.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

from distributed_ba3c_tpu_torch import cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = [
    "--task", "train", "--trainer", "tpu_fused_ba3c", "--env", "jax:pong",
    "--fc_units", "16", "--batch_size", "6", "--rollout_len", "3",
    "--steps_per_epoch", "2", "--max_epoch", "2", "--eval_max_steps", "5",
]


def test_train_on_cpu_exits_0_and_writes_stat_json(tmp_path):
    r = subprocess.run(
        [sys.executable, "-m", "distributed_ba3c_tpu_torch", *SMALL,
         "--device", "cpu", "--logdir", str(tmp_path)],
        capture_output=True, text=True, timeout=240, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO),
    )
    assert r.returncode == 0, r.stderr[-3000:]
    stats = json.loads((tmp_path / "stat.json").read_text())
    assert [s["epoch"] for s in stats] == [1.0, 2.0]
    assert [s["global_step"] for s in stats] == [2.0, 4.0]
    for s in stats:
        for k in ("loss", "policy_loss", "value_loss", "entropy", "grad_norm", "fps"):
            assert k in s and s[k] == s[k], k  # present and not NaN
    assert stats[-1]["tele/learner/train_samples_total"] == 2 * 2 * 2 * 3
    assert "fused training: 2 envs x 3 rollout" in r.stderr


def test_train_without_device_raises_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main([*SMALL, "--logdir", str(tmp_path)])
    assert not (tmp_path / "stat.json").exists()


#: tests/test_e2e_fake.py's flags
E2E = ["--env", "fake", "--simulator_procs", "4", "--batch_size", "32",
       "--image_size", "16", "--fc_units", "16", "--steps_per_epoch", "80",
       "--max_epoch", "2", "--nr_eval", "4"]


def test_sync_trainer_learns_the_fake_env(tmp_path):
    """The sync path end to end on the CPU: FakeEnv simulator processes ->
    ZMQ -> master -> predictor -> TrainFeed/DeviceIngest -> the learner ->
    callbacks and eval, reaching tests/test_e2e_fake.py's thresholds."""
    logdir = tmp_path / "log"
    r = subprocess.run(
        [sys.executable, "-m", "distributed_ba3c_tpu_torch", "--task", "train",
         "--trainer", "tpu_sync_ba3c", *E2E, "--device", "cpu", "--logdir", str(logdir)],
        capture_output=True, text=True, timeout=240, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO),
    )
    assert r.returncode == 0, r.stderr[-3000:]
    stats = json.loads((logdir / "stat.json").read_text())
    assert len(stats) == 2
    final = stats[-1]
    assert final["eval_mean_score"] >= 0.75, final
    assert final["mean_score"] >= 0.4, final
    assert final["global_step"] == 160
    assert final["tele/master/datapoints_total"] >= 160 * 32
    assert final["tele/predictor/param_publishes_total"] >= 160
    ckpt = json.loads((logdir / "checkpoints" / "checkpoint.json").read_text())
    assert ckpt["latest"] == 160 and ckpt["best"] is not None
    assert "StartProcOrThread: started 4 processes" in r.stderr


def test_sync_trainer_trains_a_jax_game_through_host_players(tmp_path):
    """``--env jax:qbert`` on the sync path: 4 simulator processes each
    step one Q*bert on CPU tensors (``envs/jaxenv/host_adapter.py``) at
    the game's 84x84 frames, the learner trains at full conv width, and
    the greedy Evaluator plays 2 episodes through the same players."""
    logdir = tmp_path / "log"
    r = subprocess.run(
        [sys.executable, "-m", "distributed_ba3c_tpu_torch", "--task", "train",
         "--trainer", "tpu_sync_ba3c", "--env", "jax:qbert", "--simulator_procs", "4",
         "--batch_size", "16", "--fc_units", "16", "--steps_per_epoch", "10",
         "--max_epoch", "1", "--nr_eval", "2", "--device", "cpu", "--logdir", str(logdir)],
        capture_output=True, text=True, timeout=240, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO),
    )
    assert r.returncode == 0, r.stderr[-3000:]
    final = json.loads((logdir / "stat.json").read_text())[-1]
    assert final["global_step"] == 10
    assert final["tele/master/datapoints_total"] >= 10 * 16
    for k in ("eval_mean_score", "eval_max_score"):
        assert k in final and final[k] == final[k], k  # present and not NaN
    assert "StartProcOrThread: started 4 processes" in r.stderr


def test_sync_trainer_refuses_a_block_larger_than_the_serving_bucket(tmp_path):
    with pytest.raises(SystemExit, match="predict_batch_size"):
        cli.main(["--env", "cpp:pong", "--simulator_procs", "16", "--predict_batch_size", "8",
                  "--wire", "block", "--fc_units", "16", "--device", "cpu",
                  "--logdir", str(tmp_path)])


def test_sync_trainer_without_device_raises_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main([*E2E, "--logdir", str(tmp_path)])
    assert not (tmp_path / "stat.json").exists()


def test_fused_trainer_needs_a_jax_env(tmp_path):
    with pytest.raises(SystemExit, match="jax:<name>"):
        cli.main(["--task", "train", "--trainer", "tpu_fused_ba3c", "--env", "fake",
                  "--device", "cpu", "--logdir", str(tmp_path)])


def test_steps_per_dispatch_must_divide_steps_per_epoch(tmp_path):
    with pytest.raises(SystemExit, match="must divide"):
        cli.main([*SMALL, "--steps_per_dispatch", "3", "--device", "cpu",
                  "--logdir", str(tmp_path)])


def test_parser_keeps_the_jax_flag_defaults():
    from distributed_ba3c_tpu.cli import make_parser as jax_parser

    port = vars(cli.make_parser().parse_args([]))
    ref = vars(jax_parser().parse_args([]))
    # every trainer of the JAX CLI is one of the port's
    trainers = next(a for a in jax_parser()._actions if a.dest == "trainer").choices
    assert sorted(cli.TRAINERS) == sorted(trainers)
    for k in ("steps_per_epoch", "max_epoch", "rollout_len", "grad_chunk_samples",
              "steps_per_dispatch", "batch_size", "learning_rate",
              "learning_rate_final", "entropy_beta", "entropy_beta_final",
              "anneal", "anneal_lr", "anneal_beta", "eval_every",
              "eval_max_steps", "seed", "logdir", "trainer", "load", "max_to_keep",
              "task", "nr_eval", "simulator_procs", "local_time_max",
              "predict_batch_size", "predictor_threads", "frame_history", "wire",
              "wire_crc", "pipe_c2s", "pipe_s2c", "actor_timeout", "publish_every",
              "ingest_staging", "rollout_dtype", "num_actions", "image_size",
              "fc_units", "gamma", "reward_clip", "overlap",
              # the int8 rung and the single serving plane
              "quant_spec", "quant_calibrate", "serve_slo_ms", "canary_load",
              "canary_fraction", "shadow_load"):
        assert port[k] == ref[k], k
    # the rollout precision ladder's rungs, and the new flags' types
    actions = {p: {a.dest: a for a in parser._actions}
               for p, parser in (("port", cli.make_parser()), ("jax", jax_parser()))}
    for k in ("rollout_dtype", "quant_spec", "quant_calibrate", "serve_slo_ms",
              "canary_load", "canary_fraction", "shadow_load"):
        a, r = actions["port"][k], actions["jax"][k]
        assert (a.choices, a.type) == (r.choices, r.type), k

"""The port's CLI flags of the int8 rung and of the single serving plane
(``--rollout_dtype int8``, ``--quant_spec``, ``--quant_calibrate``,
``--serve_slo_ms``, ``--canary_load``, ``--canary_fraction``,
``--shadow_load``), held against the JAX CLI's.

- Every rule of the JAX CLI (its ``orchestrate/topology.py``) is a usage
  error of both CLIs, exit 2 with the same message and no traceback.
- ``--task eval`` and ``--task play`` serve float32 in both CLIs whatever
  ``--rollout_dtype`` says.
- The sync trainer at ``tests/test_e2e_fake.py``'s small shape with
  ``--rollout_dtype int8 --quant_calibrate 4`` ends serving int8, and with
  a frozen ``--quant_spec`` serves int8 from the first batch.
- The same trainer with a canary (fraction 0.25) and a shadow from a
  checkpoint and ``--serve_slo_ms 200``: the canary holds 0.15-0.35 of the
  served rows, the shadow mirrors batches, and no served row misses its
  deadline.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from distributed_ba3c_tpu_torch import cli, telemetry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: tests/test_e2e_fake.py's flags, one shorter epoch
SYNC = ["--task", "train", "--trainer", "tpu_sync_ba3c", "--env", "fake",
        "--simulator_procs", "4", "--batch_size", "32", "--image_size", "16",
        "--fc_units", "16", "--steps_per_epoch", "40", "--max_epoch", "1",
        "--nr_eval", "2", "--device", "cpu"]

#: (flags, the message both CLIs exit 2 with)
RULES = {
    "int8_without_source": (
        ["--rollout_dtype", "int8"],
        "rollout_dtype int8 needs exactly ONE calibration source"),
    "int8_with_both_sources": (
        ["--rollout_dtype", "int8", "--quant_spec", "s.json", "--quant_calibrate", "4"],
        "rollout_dtype int8 needs exactly ONE calibration source"),
    "quant_spec_off_int8": (
        ["--rollout_dtype", "bfloat16", "--quant_spec", "s.json"],
        "they do not apply to rollout_dtype 'bfloat16'"),
    "quant_calibrate_off_int8": (
        ["--quant_calibrate", "4"],
        "they do not apply to rollout_dtype 'float32'"),
    "negative_quant_calibrate": (
        ["--rollout_dtype", "int8", "--quant_calibrate", "-1"],
        "mode.quant_calibrate must be >= 0, got -1"),
    "int8_fused_without_overlap": (
        ["--trainer", "tpu_fused_ba3c", "--env", "jax:pong", "--rollout_dtype", "int8",
         "--quant_calibrate", "2"],
        "it requires overlap"),
    "canary_load_without_fraction": (
        ["--canary_load", "ckpt"],
        "serving.canary_load and serving.canary_fraction come together"),
    "canary_fraction_without_load": (
        ["--canary_fraction", "0.25"],
        "serving.canary_load and serving.canary_fraction come together"),
    "canary_fraction_above_one": (
        ["--canary_load", "ckpt", "--canary_fraction", "1.5"],
        "serving.canary_fraction must be a traffic fraction in [0, 1], got 1.5"),
}


def _usage_error(main, argv, capsys) -> str:
    with pytest.raises(SystemExit) as e:
        main(argv)
    assert e.value.code == 2
    return capsys.readouterr().err.strip().splitlines()[-1]


@pytest.mark.parametrize("name", sorted(RULES))
def test_flag_rules_are_the_jax_clis_usage_errors(name, capsys, tmp_path):
    from distributed_ba3c_tpu.cli import main as jax_main

    flags, message = RULES[name]
    argv = [*flags, "--logdir", str(tmp_path)]
    ours = _usage_error(cli.main, [*argv, "--device", "cpu"], capsys)
    ref = _usage_error(jax_main, argv, capsys)
    assert message in ref, ref
    assert ours.split("error: ", 1)[1] == ref.split("error: ", 1)[1]
    assert not (tmp_path / "stat.json").exists()


@pytest.mark.parametrize("entry", [["-m", "distributed_ba3c_tpu_torch"], ["train.py"]],
                         ids=["port", "jax"])
def test_a_usage_error_exits_2_without_a_traceback(entry, tmp_path):
    r = subprocess.run(
        [sys.executable, *entry, "--rollout_dtype", "int8", "--logdir", str(tmp_path)],
        capture_output=True, text=True, timeout=120, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu"),
    )
    assert r.returncode == 2, r.stderr[-2000:]
    assert "Traceback" not in r.stderr
    assert "needs exactly ONE calibration source" in r.stderr


@pytest.mark.parametrize("task", ["eval", "play"])
def test_eval_and_play_serve_float32_in_both_clis(task, monkeypatch, tmp_path):
    """The JAX CLI's eval and play build their predictor without a
    rollout dtype (float32); the port's must serve float32 too, whatever
    --rollout_dtype and the quant flags say."""
    from distributed_ba3c_tpu.cli import main as jax_main
    from distributed_ba3c_tpu.predict import server as jserver
    from distributed_ba3c_tpu_torch.predict import server

    built = {"port": [], "jax": []}

    class Port(server.BatchedPredictor):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            built["port"].append(self.rollout_dtype)

    class Jax(jserver.BatchedPredictor):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            built["jax"].append(self.rollout_dtype)

    monkeypatch.setattr(server, "BatchedPredictor", Port)
    monkeypatch.setattr(jserver, "BatchedPredictor", Jax)
    base = ["--task", task, "--env", "fake", "--image_size", "16", "--fc_units", "16",
            "--nr_eval", "1", "--logdir", str(tmp_path)]
    spec = tmp_path / "spec.json"
    from distributed_ba3c_tpu_torch.quantize import QuantSpec

    QuantSpec(act_scales={"Conv_0": 1.0}).save(str(spec))
    for extra in (["--rollout_dtype", "bfloat16"],
                  ["--rollout_dtype", "int8", "--quant_spec", str(spec)]):
        assert cli.main([*base, *extra, "--max_steps", "5", "--device", "cpu"]) == 0
        if task == "eval":
            assert jax_main([*base, *extra]) == 0
    assert built["port"] == ["float32", "float32"]
    if task == "eval":
        assert built["jax"] == ["float32", "float32"]


def _last_record(logdir):
    return json.loads((logdir / "stat.json").read_text())[-1]


@pytest.fixture
def predictors(monkeypatch):
    """The port's predictors the CLI builds, kept for their state."""
    from distributed_ba3c_tpu_torch.predict import server

    made = []

    class Kept(server.BatchedPredictor):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(server, "BatchedPredictor", Kept)
    telemetry.reset_all()
    return made


def test_sync_trainer_calibrates_live_then_serves_int8(tmp_path, predictors):
    logdir = tmp_path / "log"
    assert cli.main([*SYNC, "--rollout_dtype", "int8", "--quant_calibrate", "4",
                     "--logdir", str(logdir)]) == 0
    (pred,) = predictors
    assert pred.serving_dtype == "int8"
    assert pred.quant_spec.calibration_batches == 4
    assert pred.shadow_tap is None
    rec = _last_record(logdir)
    assert rec["tele/predictor/quant_spec_frozen"] == 1.0
    assert rec["tele/predictor/quant_calib_batches_total"] == 4
    assert 0 < rec["tele/predictor/int8_batches_total"] < rec["tele/predictor/batches_total"]
    assert rec["tele/predictor/sheds_total"] == 0
    assert rec["tele/predictor/callback_errors_total"] == 0
    for k in ("loss", "entropy", "grad_norm"):
        assert rec[k] == rec[k], k  # not NaN


def test_sync_trainer_serves_a_frozen_spec(tmp_path, predictors):
    from distributed_ba3c_tpu_torch.quantize import QuantSpec

    spec = QuantSpec(act_scales={"Conv_0": 1 / 127, "Conv_1": 0.02, "Conv_2": 0.02,
                                 "Conv_3": 0.02, "Dense_0": 0.02})
    spec.save(str(tmp_path / "spec.json"))
    logdir = tmp_path / "log"
    assert cli.main([*SYNC, "--trainer", "tpu_vtrace_ba3c", "--rollout_dtype", "int8",
                     "--quant_spec", str(tmp_path / "spec.json"),
                     "--logdir", str(logdir)]) == 0
    (pred,) = predictors
    assert pred.serving_dtype == "int8" and pred.quant_spec == spec
    rec = _last_record(logdir)
    assert rec["tele/predictor/int8_batches_total"] == rec["tele/predictor/batches_total"] > 0
    assert rec["tele/predictor/shadow_batches_total"] == 0


def test_canary_shadow_and_slo_on_the_sync_trainer(tmp_path, predictors):
    first = tmp_path / "first"
    assert cli.main([*SYNC, "--steps_per_epoch", "10", "--nr_eval", "0",
                     "--logdir", str(first)]) == 0
    ckpt = str(first / "checkpoints")
    del predictors[:]
    telemetry.reset_all()
    logdir = tmp_path / "log"
    assert cli.main([*SYNC, "--canary_load", ckpt, "--canary_fraction", "0.25",
                     "--shadow_load", ckpt, "--serve_slo_ms", "200",
                     "--logdir", str(logdir)]) == 0
    (pred,) = predictors
    assert sorted(pred._policies) == ["canary", "default", "shadow"]
    rec = _last_record(logdir)
    rows = rec["tele/predictor/rows_total"]
    canary = rec["tele/predictor/policy_canary_rows_total"]
    assert rows > 0 and 0.15 <= canary / rows <= 0.35, (canary, rows)
    assert rec["tele/predictor/shadow_batches_total"] > 0
    assert rec["tele/predictor/deadline_misses_total"] == 0
    assert rec["tele/predictor/slo_ms"] == 200.0
    # the canary and the shadow are the checkpoint's params
    import torch

    from distributed_ba3c_tpu_torch.train.checkpoint import CheckpointManager
    from distributed_ba3c_tpu_torch.models.convert import from_flax, tree_to_numpy

    saved = from_flax(tree_to_numpy(CheckpointManager(ckpt).restore()["params"]))
    for pid in ("canary", "shadow"):
        for k, v in saved.items():
            assert torch.equal(pred._policies[pid][k], v), (pid, k)

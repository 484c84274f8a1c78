"""The port's int8 rung (distributed_ba3c_tpu_torch/quantize) held against
the JAX package's (distributed_ba3c_tpu/quantize).

The fixtures are JAX's (tests/test_quantize.py): ``BA3CNet(fc_units=16)``
at full conv width, and real Pong frames of 4 envs x 8 steps rolled by
JAX's own rollout body; the port takes the same params (``from_flax``) and
the same frames. The bounds:

- the spec: ``to_json()`` and ``sha256()`` byte-equal, files cross-load,
  the same rejections with the same messages;
- the int8 table: ``quantize_params`` on ``from_flax(params)`` bit-equal
  to JAX's table through ``quant_from_flax`` (int8 kernels, ``w_scale``,
  ``bias``, ``act_scale``), and back through ``quant_to_flax``;
- the forward, both arms, against JAX's ``make_quant_apply`` (jitted, as
  JAX's predictor runs it) on the same table and frames: the ``int8``
  arm's int32 accumulators equal given the same int8 input, its per-layer
  int8 inputs within 1 on at most 1e-4 of elements (XLA folds ``x /
  255.0`` into a product and may contract ``acc * s + b`` into an FMA, so
  a 1-ulp difference can cross a rounding half of the next layer's grid),
  logits and value within 1e-3; the ``folded`` arm within 1e-3; both arms
  inside JAX's bands against the port's f32 forward on Pong and Seaquest
  (log mu within 0.1, V within 0.05);
- calibration: the port's scales within 1e-5 relative of JAX's on the
  same batches for both methods, order-invariant, and
  ``calibrate_from_env`` with JAX's draws replayed within 1e-5 of JAX's;
- the predictor (frozen spec, calibrate-then-switch, the tap's counters,
  no hidden fallback of the int8 arm) and the overlap's int8 actor at lag
  0 against f32 (JAX's ``test_int8_lag0_learning_parity_on_pong``).
"""

from __future__ import annotations

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_ba3c_tpu import quantize as jq
from distributed_ba3c_tpu.config import BA3CConfig as JaxConfig
from distributed_ba3c_tpu.envs.jaxenv import pong as jpong
from distributed_ba3c_tpu.models.a3c import BA3CNet as JaxNet
from distributed_ba3c_tpu.ops.gradproc import make_optimizer as jax_make_optimizer
from distributed_ba3c_tpu.quantize import qforward as jqf
from distributed_ba3c_tpu.quantize.spec import QuantSpecError as JaxQuantSpecError
from distributed_ba3c_tpu_torch import telemetry
from distributed_ba3c_tpu_torch.config import BA3CConfig
from distributed_ba3c_tpu_torch.envs.jaxenv import pong
from distributed_ba3c_tpu_torch.models import BA3CNet, from_flax
from distributed_ba3c_tpu_torch.models.convert import quant_from_flax, quant_to_flax
from distributed_ba3c_tpu_torch.predict.server import BatchedPredictor
from distributed_ba3c_tpu_torch.quantize import (
    ActRangeAccumulator,
    QuantSpec,
    calibrate_from_env,
    calibrate_offline,
    make_quant_apply,
    quant_layer_names,
    quantize_params,
)
from distributed_ba3c_tpu_torch.quantize import qforward
from distributed_ba3c_tpu_torch.quantize.spec import QuantSpecError
from test_quantize import BAND_LOG_MU, BAND_VALUE, _real_frames
from test_torch_pong import JaxReplay, reset_noise, to_torch

ACC_SHARE = 1e-4   # share of a layer's int8 inputs that may differ (by 1)
OUT_TOL = 1e-3     # logits and value against JAX's arm
SCALE_REL = 1e-5   # calibrated scales against JAX's


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), jax.device_get(tree))


def _parts(game=jpong):
    cfg = JaxConfig(num_actions=game.num_actions, fc_units=16)
    model = JaxNet(num_actions=cfg.num_actions, fc_units=cfg.fc_units)
    opt = jax_make_optimizer(cfg.learning_rate, cfg.adam_epsilon, cfg.grad_clip_norm)
    return cfg, model, opt


def _port_net(jparams, num_actions=6):
    net = BA3CNet(num_actions, fc_units=16, device="cpu")
    net.load_state_dict(from_flax(_np_tree(jparams)))
    return net


@pytest.fixture(scope="module")
def pong_run():
    """JAX's params and real Pong frames, a spec calibrated on them by
    JAX, JAX's table, and the port's net over the same params."""
    cfg, model, opt = _parts()
    params, frames = _real_frames(cfg, model, opt, jpong)
    spec = jq.calibrate_offline(model, params, [frames])
    table = _np_tree(jq.quantize_params(params, spec))
    net = _port_net(params)
    return {"cfg": cfg, "model": model, "params": params, "frames": frames,
            "spec": spec, "table": table, "net": net}


def _port_spec(jspec) -> QuantSpec:
    return QuantSpec.from_doc(jspec.to_doc())


# -- the spec ---------------------------------------------------------------------

SPEC_DOCS = [
    dict(act_scales={"Conv_0": 0.5, "Dense_0": 1.25}, calibration_batches=4,
         calibration_rows=64),
    dict(act_scales={"Conv_0": 1 / 127, "Conv_1": 0.1 + 0.2, "Conv_2": 3e-9,
                     "Conv_3": 123456.789, "Dense_0": 2}, method="percentile",
         percentile=99.9),
    dict(act_scales={"Dense_0": 1e300}, percentile=100, version=1),
]


@pytest.mark.parametrize("doc", SPEC_DOCS, ids=["small", "percentile", "edge"])
def test_spec_json_and_sha256_are_byte_equal_to_jax(doc, tmp_path):
    ours, ref = QuantSpec(**doc), jq.QuantSpec(**doc)
    assert ours.to_json() == ref.to_json()
    assert ours.sha256() == ref.sha256()
    assert ours.layers == ref.layers
    # a JAX spec file loads in the port, and a port spec file in JAX
    ref.save(str(tmp_path / "jax.json"))
    ours.save(str(tmp_path / "port.json"))
    assert (tmp_path / "jax.json").read_bytes() == (tmp_path / "port.json").read_bytes()
    assert QuantSpec.load(str(tmp_path / "jax.json")) == ours
    assert jq.QuantSpec.load(str(tmp_path / "port.json")) == ref


BAD_DOCS = {
    "unknown_field": {"act_scales": {"Conv_0": 1.0}, "mystery_knob": 1},
    "zero_scale": {"act_scales": {"Conv_0": 0.0}},
    "negative_scale": {"act_scales": {"Conv_0": -1.0}},
    "nan_scale": {"act_scales": {"Conv_0": float("nan")}},
    "inf_scale": {"act_scales": {"Conv_0": float("inf")}},
    "bool_scale": {"act_scales": {"Conv_0": True}},
    "string_scale": {"act_scales": {"Conv_0": "1.0"}},
    "empty": {"act_scales": {}},
    "missing_scales": {"method": "absmax"},
    "bad_method": {"act_scales": {"Conv_0": 1.0}, "method": "vibes"},
    "version_2": {"act_scales": {"Conv_0": 1.0}, "version": 2},
    "percentile_0": {"act_scales": {"Conv_0": 1.0}, "percentile": 0},
    "percentile_101": {"act_scales": {"Conv_0": 1.0}, "percentile": 101},
    "negative_counter": {"act_scales": {"Conv_0": 1.0}, "calibration_rows": -1},
    "not_a_mapping": [1, 2],
}


@pytest.mark.parametrize("name", sorted(BAD_DOCS))
def test_spec_rejects_what_jax_rejects_with_its_message(name):
    doc = BAD_DOCS[name]
    with pytest.raises(JaxQuantSpecError) as ref:
        jq.QuantSpec.from_doc(doc)
    with pytest.raises(QuantSpecError) as ours:
        QuantSpec.from_doc(doc)
    assert isinstance(ours.value, ValueError)
    assert str(ours.value) == str(ref.value)


def test_spec_rejects_bad_json_and_missing_file(tmp_path):
    for text in ("{", "[]"):
        with pytest.raises(JaxQuantSpecError) as ref:
            jq.QuantSpec.from_json(text)
        with pytest.raises(QuantSpecError) as ours:
            QuantSpec.from_json(text)
        assert str(ours.value) == str(ref.value)
    with pytest.raises(QuantSpecError, match="cannot read"):
        QuantSpec.load(str(tmp_path / "absent.json"))


def test_zero_range_freezes_to_valid_scale(pong_run):
    """All-zero traffic freezes Conv_0's scale to 1.0 (finite, > 0), as
    JAX's does, with the other layers' scales within SCALE_REL of JAX's."""
    zeros = np.zeros((4, 84, 84, 4), np.uint8)
    ref = jq.ActRangeAccumulator(pong_run["model"], pong_run["params"])
    ref.observe(zeros)
    acc = ActRangeAccumulator(pong_run["net"], pong_run["net"].state_dict())
    acc.observe(zeros)
    ours, want = acc.freeze(), ref.freeze()
    assert ours.act_scales["Conv_0"] == want.act_scales["Conv_0"] == 1.0
    for k, v in want.act_scales.items():
        assert np.isfinite(ours.act_scales[k]) and ours.act_scales[k] > 0
        assert abs(ours.act_scales[k] - v) <= SCALE_REL * v, k


def test_zero_range_weight_channel_gets_scale_one(pong_run):
    params = _np_tree(pong_run["params"])
    params["Conv_0"]["kernel"][..., 0] = 0.0
    sd = from_flax(params)
    spec = _port_spec(pong_run["spec"])
    q = quantize_params(sd, spec)
    assert float(q["Conv_0.w_scale"][0]) == 1.0
    assert torch.all(q["Conv_0.kernel_q"][:, 0] == 0)
    assert torch.isfinite(q["Conv_0.w_scale"]).all() and (q["Conv_0.w_scale"] > 0).all()
    ref = quant_from_flax(_np_tree(jq.quantize_params(params, pong_run["spec"])))
    assert torch.equal(q["Conv_0.w_scale"], ref["Conv_0.w_scale"])


# -- the table --------------------------------------------------------------------


def test_quantize_params_is_bit_equal_to_jax_table(pong_run):
    net, spec = pong_run["net"], _port_spec(pong_run["spec"])
    ours = quantize_params(net.state_dict(), spec)
    ref = quant_from_flax(pong_run["table"])
    assert sorted(ours) == sorted(ref)
    for name in quant_layer_names(net):
        kq = ours[f"{name}.kernel_q"]
        assert kq.dtype == torch.int8 and kq.shape[0] % 8 == 0 and kq.stride(0) == 1
        for leaf in ("kernel_q", "w_scale", "bias", "act_scale"):
            k = f"{name}.{leaf}"
            assert ours[k].dtype == ref[k].dtype, k
            assert torch.equal(ours[k], ref[k]), k
    # the heads and the PReLU pass through untouched
    for k in qforward.PASSTHROUGH:
        assert torch.equal(ours[k], net.state_dict()[k]), k
    # conv0's K = 5*5*4 = 100 is padded to 104 with zero rows
    assert ours["Conv_0.kernel_q"].shape == (104, 32)
    assert torch.all(ours["Conv_0.kernel_q"][100:] == 0)
    # and back: the JAX table, leaf for leaf
    back = quant_to_flax(ours)
    for name, leaves in pong_run["table"].items():
        for leaf, v in leaves.items():
            np.testing.assert_array_equal(back[name][leaf], v, err_msg=f"{name}/{leaf}")


def test_quantize_params_missing_layer_raises(pong_run):
    with pytest.raises(ValueError, match="absent"):
        quantize_params(pong_run["net"].state_dict(), QuantSpec(act_scales={"Conv_99": 1.0}))


# -- the forward ------------------------------------------------------------------


def _jax_int8_trace(model, table, frames):
    """JAX's int8 arm layer by layer (its own helpers, jitted): each
    quantized layer's int8 input and int32 accumulators."""
    from flax import linen as nn
    from jax import lax

    layout = jqf.conv_layout(model)

    def run(q, state):
        x = state.astype(jnp.float32) / 255.0
        out = []
        for i, (_f, _k, pooled) in enumerate(layout):
            p = q[f"Conv_{i}"]
            xq = jqf._quantize_tensor(x, p["act_scale"])
            acc = lax.conv_general_dilated(
                xq, p["kernel_q"], (1, 1), "SAME",
                dimension_numbers=jqf._DIMENSION_NUMBERS,
                preferred_element_type=jnp.int32)
            out.append((xq, acc))
            x = nn.relu(acc.astype(jnp.float32) * (p["act_scale"] * p["w_scale"]) + p["bias"])
            if pooled:
                x = nn.max_pool(x, window_shape=(2, 2), strides=(2, 2))
        x = x.reshape((x.shape[0], -1))
        p = q["Dense_0"]
        xq = jqf._quantize_tensor(x, p["act_scale"])
        acc = lax.dot_general(xq, p["kernel_q"], (((1,), (0,)), ((), ())),
                              preferred_element_type=jnp.int32)
        out.append((xq, acc))
        return out

    return [tuple(np.asarray(a) for a in pair) for pair in jax.jit(run)(table, frames)]


def _jax_apply(model, arm, table, frames):
    out = jax.jit(jq.make_quant_apply(model, arm=arm))(table, jnp.asarray(frames))
    return np.asarray(out.logits), np.asarray(out.value)


def test_int8_arm_matches_jax_layer_by_layer(pong_run):
    model, net, frames = pong_run["model"], pong_run["net"], pong_run["frames"]
    qtable = quantize_params(net.state_dict(), _port_spec(pong_run["spec"]))
    qnet = make_quant_apply(net, arm="int8")
    assert qnet.quant_arm == "int8"
    rec = []
    with torch.no_grad():
        out = torch.func.functional_call(qnet, qtable, (torch.from_numpy(frames),),
                                         {"record": rec})
    ref = _jax_int8_trace(model, pong_run["table"], frames)
    layers = [name for name, _, _ in rec]
    assert layers == list(quant_layer_names(net))
    for (name, xq, acc), (jxq, jacc) in zip(rec, ref):
        xq = xq.numpy()
        assert xq.dtype == np.int8 and xq.shape == jxq.shape, name
        d = np.abs(xq.astype(np.int32) - jxq.astype(np.int32))
        assert d.max() <= 1 and (d > 0).mean() <= ACC_SHARE, (name, d.max(), (d > 0).mean())
        # the int32 accumulators, given JAX's int8 input: equal
        kq = qtable[f"{name}.kernel_q"]
        if name == "Dense_0":
            got = qforward.int8_matmul(torch.from_numpy(jxq), kq)
        else:
            k = net.conv_kernels[int(name[len("Conv_"):])]
            got = qforward.int8_matmul(qforward.im2col_int8(torch.from_numpy(jxq), k, kq.shape[0]), kq)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), jacc.reshape(got.shape), err_msg=name)
        assert acc.shape == got.shape
    logits, value = _jax_apply(model, "int8", pong_run["table"], frames)
    np.testing.assert_allclose(out.logits.numpy(), logits, rtol=0, atol=OUT_TOL)
    np.testing.assert_allclose(out.value.numpy(), value, rtol=0, atol=OUT_TOL)


def test_folded_arm_matches_jax(pong_run):
    net, frames = pong_run["net"], pong_run["frames"]
    qtable = quant_from_flax(pong_run["table"])
    qnet = make_quant_apply(net, arm="folded")
    with torch.no_grad():
        out = torch.func.functional_call(qnet, qtable, (torch.from_numpy(frames),))
    logits, value = _jax_apply(pong_run["model"], "folded", pong_run["table"], frames)
    np.testing.assert_allclose(out.logits.numpy(), logits, rtol=0, atol=OUT_TOL)
    np.testing.assert_allclose(out.value.numpy(), value, rtol=0, atol=OUT_TOL)


def _band(net, frames, spec, arm):
    """max |d log mu| and max |d V| of the quantized forward against the
    port's f32 forward, on the same frames."""
    x = torch.from_numpy(frames)
    q = quantize_params(net.state_dict(), spec)
    with torch.no_grad():
        ref = net(x)
        out = torch.func.functional_call(make_quant_apply(net, arm=arm), q, (x,))
    lp = lambda o: torch.log_softmax(o.logits, dim=-1)  # noqa: E731
    return (float((lp(ref) - lp(out)).abs().max()),
            float((ref.value - out.value).abs().max()))


@pytest.mark.parametrize("arm", ["int8", "folded"])
def test_both_arms_inside_the_bands_on_pong(pong_run, arm):
    spec = calibrate_offline(pong_run["net"], pong_run["net"].state_dict(), [pong_run["frames"]])
    d_logmu, d_value = _band(pong_run["net"], pong_run["frames"], spec, arm)
    assert d_logmu < BAND_LOG_MU, d_logmu
    assert d_value < BAND_VALUE, d_value


@pytest.mark.parametrize("arm", ["int8", "folded"])
def test_both_arms_inside_the_bands_on_seaquest(arm):
    from distributed_ba3c_tpu.envs.jaxenv import seaquest

    cfg, model, opt = _parts(seaquest)
    params, frames = _real_frames(cfg, model, opt, seaquest)
    net = _port_net(params, seaquest.num_actions)
    spec = calibrate_offline(net, net.state_dict(), [frames])
    d_logmu, d_value = _band(net, frames, spec, arm)
    assert d_logmu < BAND_LOG_MU, d_logmu
    assert d_value < BAND_VALUE, d_value


def test_explicit_int8_arm_never_falls_back(pong_run, monkeypatch):
    """A device whose probe fails: ``auto`` resolves to folded, and an
    explicit ``int8`` raises with the probe's reason."""
    monkeypatch.setitem(qforward._INT8_OK, "cpu", "RuntimeError: probe refused")
    assert make_quant_apply(pong_run["net"], arm="auto").quant_arm == "folded"
    with pytest.raises(RuntimeError, match="probe refused"):
        make_quant_apply(pong_run["net"], arm="int8")
    with pytest.raises(ValueError, match="quant arm"):
        make_quant_apply(pong_run["net"], arm="fp4")


def test_int8_matmul_pads_small_products_and_the_probe_runs():
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.integers(-127, 128, (3, 16), dtype=np.int8))
    b = qforward.k_major(torch.from_numpy(rng.integers(-127, 128, (16, 8), dtype=np.int8)))
    got = qforward.int8_matmul(a, b)
    assert got.shape == (3, 8) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), a.numpy().astype(np.int64) @ b.numpy().astype(np.int64))
    assert qforward.int8_conv_supported("cpu")


# -- calibration ------------------------------------------------------------------


@pytest.mark.parametrize("method", ["absmax", "percentile"])
def test_calibration_scales_match_jax(pong_run, method):
    frames = pong_run["frames"]
    batches = [frames[i::3] for i in range(3)]
    ref = jq.calibrate_offline(pong_run["model"], pong_run["params"], batches, method=method)
    ours = calibrate_offline(pong_run["net"], pong_run["net"].state_dict(), batches,
                             method=method)
    assert (ours.method, ours.percentile, ours.calibration_batches, ours.calibration_rows) == (
        ref.method, ref.percentile, ref.calibration_batches, ref.calibration_rows)
    assert ours.layers == ref.layers
    for k, v in ref.act_scales.items():
        assert abs(ours.act_scales[k] - v) <= SCALE_REL * v, (k, ours.act_scales[k], v)
    # the same batches in another order freeze the same spec
    again = calibrate_offline(pong_run["net"], pong_run["net"].state_dict(),
                              [batches[2], batches[0], batches[1]], method=method)
    assert again.sha256() == ours.sha256() and again.to_json() == ours.to_json()


def test_percentile_matches_jnp_percentile():
    rng = np.random.default_rng(1)
    for n in (1, 2, 7, 1000, 100003):
        a = rng.random(n).astype(np.float32) * 3
        for q in (0.5, 50.0, 99.9, 100.0):
            from distributed_ba3c_tpu_torch.quantize.calibrate import percentile

            want = float(jnp.percentile(jnp.asarray(a), q))
            got = float(percentile(torch.from_numpy(a), q))
            assert abs(got - want) <= 1e-6 * max(abs(want), 1e-6), (n, q, got, want)


def test_offline_calibration_of_zero_batches_raises(pong_run):
    with pytest.raises(ValueError, match="zero batches"):
        calibrate_offline(pong_run["net"], pong_run["net"].state_dict(), [])


class _EnvReplay(JaxReplay):
    """JAX's ``calibrate_from_env`` draws: the envs reset from
    ``split(key, n_envs)``, the rollout's keys from ``fold_in(key, 1)``."""

    def __init__(self, key):
        super().__init__(jax.random.fold_in(key, 1))
        self.reset_key = key

    def reset_noise(self, n, device):
        return to_torch(reset_noise(jax.random.split(self.reset_key, n))).to(device)


def test_calibrate_from_env_replays_jax_draws(pong_run):
    cfg, model = pong_run["cfg"], pong_run["model"]
    key = jax.random.PRNGKey(3)
    ref = jq.calibrate_from_env(model, cfg, jpong, pong_run["params"], key,
                                n_envs=4, batches=2, rollout_len=4)
    net = pong_run["net"]
    ours = calibrate_from_env(net, BA3CConfig(fc_units=16), pong, net.state_dict(),
                              _EnvReplay(key), n_envs=4, batches=2, rollout_len=4)
    assert (ours.calibration_batches, ours.calibration_rows) == (2, 2 * 4 * 4)
    assert ours.layers == ref.layers
    for k, v in ref.act_scales.items():
        assert abs(ours.act_scales[k] - v) <= SCALE_REL * v, (k, ours.act_scales[k], v)


# -- the predictor ----------------------------------------------------------------


def test_predictor_serves_a_frozen_spec_in_int8(pong_run):
    net, frames = pong_run["net"], pong_run["frames"]
    spec = _port_spec(pong_run["spec"])
    states = frames[:4]
    telemetry.reset_all()
    p32 = BatchedPredictor(net, net.state_dict(), batch_size=4, greedy=True, device="cpu")
    p8 = BatchedPredictor(net, net.state_dict(), batch_size=4, greedy=True, device="cpu",
                          rollout_dtype="int8", quant_spec=spec, tele_role="predictor.int8")
    assert p8.serving_dtype == "int8" and p8.quant_spec is spec
    assert p8._policies["default"]["Conv_0.kernel_q"].dtype == torch.int8
    _, v32, _ = p32.predict_batch(states)
    _, v8, _ = p8.predict_batch(states)
    assert np.max(np.abs(v32 - v8)) < BAND_VALUE
    # an f32 publish lands re-quantized
    p8.update_params(net.state_dict())
    table = p8._policies["default"]
    assert table["Conv_0.kernel_q"].dtype == torch.int8
    assert torch.equal(table["Conv_0.kernel_q"],
                       quantize_params(net.state_dict(), spec)["Conv_0.kernel_q"])
    p8.add_policy("canary", net.state_dict())
    assert p8._policies["canary"]["Dense_0.kernel_q"].dtype == torch.int8
    a8, _, _ = p8.predict_batch(states)
    assert a8.shape == (4,)


def _drain(pred, states, n):
    done = threading.Event()
    left = [n]

    def cb(a, v, lp):
        left[0] -= 1
        if left[0] == 0:
            done.set()

    for _ in range(n):
        pred.put_block_task(states, cb)
    assert done.wait(120)


def test_predictor_calibrates_then_switches_to_int8(pong_run):
    net, frames = pong_run["net"], pong_run["frames"]
    states = frames[:4]
    telemetry.reset_all()
    pred = BatchedPredictor(net, net.state_dict(), batch_size=4, greedy=True, coalesce_ms=0.0,
                            rollout_dtype="int8", quant_calibrate=3, device="cpu",
                            tele_role="predictor.calib")
    assert pred.serving_dtype == "float32" and pred.quant_spec is None
    assert pred.shadow_tap is not None and pred._shadow == "default"
    pred.warmup((84, 84, 4))
    pred.start()
    try:
        _drain(pred, states, 4)
        deadline = time.monotonic() + 60
        while pred.quant_spec is None and time.monotonic() < deadline:
            _drain(pred, states, 1)
        assert pred.quant_spec is not None, "spec never froze"
        assert pred.serving_dtype == "int8"
        assert pred.shadow_tap is None and pred._shadow is None
        assert pred._policies["default"]["Conv_0.kernel_q"].dtype == torch.int8
        assert pred.quant_spec.calibration_batches == 3
        assert pred.quant_spec.calibration_rows == 3 * 4
        # async serving continues on the switched forward ...
        _drain(pred, states, 2)
        # ... and the sync path sees forward and table together
        a, v, _ = pred.predict_batch(states)
        assert a.shape == (4,) and np.isfinite(v).all()
    finally:
        pred.stop()
        pred.join(5)
    tele = telemetry.registry("predictor.calib").scalars()
    # the tap's counters: N batches of 4 rows, then frozen
    assert tele["quant_calib_batches_total"] == 3
    assert tele["quant_calib_rows_total"] == 12
    assert tele["quant_spec_frozen"] == 1.0
    assert 0 < tele["int8_batches_total"] < tele["batches_total"]
    # the spec froze on exactly the batches a direct calibration sees
    want = calibrate_offline(net, net.state_dict(), [states] * 3)
    assert pred.quant_spec.to_json() == want.to_json()


# -- the overlap's int8 actor -----------------------------------------------------


def test_overlap_int8_needs_a_spec(pong_run):
    from distributed_ba3c_tpu_torch.fused.loop import create_fused_state
    from distributed_ba3c_tpu_torch.fused.overlap import make_overlap_step

    net = BA3CNet(6, fc_units=16, device="cpu")
    state = create_fused_state(0, net, BA3CConfig(fc_units=16), pong, 2)
    with pytest.raises(ValueError, match="quant_spec"):
        make_overlap_step(net, state.train.optimizer, BA3CConfig(fc_units=16), pong, 3,
                          rollout_dtype="int8")


def test_int8_lag0_learning_parity_on_pong():
    """Lag 0 with the int8 actor against f32, from one seeded state and
    one draw seed: only the rollout forward's precision differs. The first
    update's loss, pred_value and entropy within 0.05, every metric finite
    over two updates (JAX's ``test_int8_lag0_learning_parity_on_pong``)."""
    from distributed_ba3c_tpu_torch.fused.loop import create_fused_state, device_draws
    from distributed_ba3c_tpu_torch.fused.overlap import make_overlap_step

    cfg = BA3CConfig(fc_units=16)
    n_envs = 2
    probe = BA3CNet(6, fc_units=16, device="cpu", generator=torch.Generator().manual_seed(0))
    spec = calibrate_from_env(probe, cfg, pong, probe.state_dict(), device_draws(pong, 5, "cpu"),
                              n_envs=n_envs, batches=2, rollout_len=4)

    def run(dtype, quant_spec=None):
        net = BA3CNet(6, fc_units=16, device="cpu", generator=torch.Generator().manual_seed(0))
        state = create_fused_state(0, net, cfg, pong, n_envs)
        step = make_overlap_step(net, state.train.optimizer, cfg, pong, 3, lag=0,
                                 rollout_dtype=dtype, quant_spec=quant_spec)
        if dtype == "int8":
            assert step.actor_net.quant_arm == "int8" and step.quant_spec is spec
        state = step.put(state)
        ms = []
        for _ in range(2):
            state, m = step(state, cfg.entropy_beta)
            ms.append({k: float(v) for k, v in m.items()})
        return ms

    f32 = run("float32")
    i8 = run("int8", quant_spec=spec)
    for ms in (f32, i8):
        for m in ms:
            for k, v in m.items():
                assert np.isfinite(v), k
    for k in ("loss", "pred_value", "entropy"):
        assert abs(f32[0][k] - i8[0][k]) < 0.05, (k, f32[0][k], i8[0][k])

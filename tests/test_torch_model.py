"""The port's BA3CNet (distributed_ba3c_tpu_torch/models/) held against the
JAX package's on the same params (converted from flax) and the same uint8
frames, made from a numpy seed.

Tolerances: float32 compute within rtol 1e-4 / atol 1e-5 (only the order of
the conv sums differs); bf16 compute within 2e-2 of the output's scale (the
two sides may round a bf16 sum differently, as in the conv-block suite).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_ba3c_tpu.models.a3c import BA3CNet as JaxNet
from distributed_ba3c_tpu.models.layers import PReLU as JaxPReLU
from distributed_ba3c_tpu_torch.models import (
    BA3CNet,
    PReLU,
    conv_layout,
    from_flax,
    to_flax,
)
from distributed_ba3c_tpu_torch.ops.conv_block import conv_block_fwd

BAND = 2e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _jax_params(num_actions, fc_units, size, seed=0):
    model = JaxNet(num_actions=num_actions, fc_units=fc_units)
    x = np.zeros((1, size, size, 4), np.uint8)
    return jax.device_get(model.init(jax.random.PRNGKey(seed), x)["params"])


@pytest.fixture(scope="module")
def full_params():
    """flax params of BA3CNet(6) at full width, seed 0 (one init per module)."""
    return _jax_params(6, 512, 84)


def _port(num_actions, fc_units, size, params, **kw):
    net = BA3CNet(
        num_actions, fc_units=fc_units, image_size=(size, size), device="cpu", **kw
    )
    net.load_state_dict(from_flax(params))
    return net


def _frames(n, size, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, size, size, 4), dtype=np.uint8)


def _within_band(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return float(np.max(np.abs(got - ref))) <= BAND * (float(np.max(np.abs(ref))) + 1e-6)


# -- the weight bridge -------------------------------------------------------


def test_from_flax_to_flax_round_trips_exactly(full_params):
    p = full_params
    back = to_flax(from_flax(p))
    flat_p = jax.tree_util.tree_leaves_with_path(p)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [k for k, _ in flat_p] == [k for k, _ in flat_b]
    for (k, a), (_, b) in zip(flat_p, flat_b):
        assert a.shape == b.shape and a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b)


def test_state_dict_round_trips_exactly():
    sd = BA3CNet(6, device="cpu", generator=torch.Generator().manual_seed(3)).state_dict()
    back = from_flax(to_flax(sd))
    assert sorted(back) == sorted(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k


def test_full_width_layout_matches_flax_tree(full_params):
    """At full width the converted tree loads into BA3CNet(6) strictly."""
    net = BA3CNet(6, device="cpu")
    sd = from_flax(full_params)
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: tuple(v.shape) for k, v in net.state_dict().items()
    }
    net.load_state_dict(sd)  # strict
    assert tuple(net.fc.weight.shape) == (512, 10 * 10 * 64)


# -- forward parity with the JAX model ---------------------------------------


@pytest.mark.parametrize("size", [16, 32])
def test_float32_matches_jax_float32(size):
    p = _jax_params(4, 16, size)
    x = _frames(3, size)
    ref = JaxNet(num_actions=4, fc_units=16, compute_dtype=jnp.float32).apply({"params": p}, x)
    net = _port(4, 16, size, p, compute_dtype=torch.float32)
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(ref.logits), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got.value.numpy(), np.asarray(ref.value), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("conv_backend", ["cuda", "torch"])
def test_bf16_matches_jax_pallas_backend(conv_backend):
    """bf16 against JAX conv_backend='pallas' (the Pallas kernel in
    interpret mode on blocks 1-3), the port under that model's rules. On
    the CPU the port's 'cuda' backend is the kernel wrapper taking its plain
    version, so both agree."""
    p = _jax_params(4, 16, 16)
    x = _frames(3, 16, seed=1)
    ref = JaxNet(num_actions=4, fc_units=16, conv_backend="pallas").apply({"params": p}, x)
    net = _port(4, 16, 16, p, conv_backend=conv_backend, block_rules="pallas")
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    assert _within_band(got.logits.numpy(), ref.logits)
    assert _within_band(got.value.numpy(), ref.value)


@pytest.mark.parametrize("conv_backend", ["cuda", "torch"])
def test_bf16_matches_jax_default_backend(conv_backend):
    """bf16 against JAX's default model (conv_backend='xla': flax's layers
    in every block), the port under its default rules, which take the plain
    blocks through flax_block on the CPU."""
    p = _jax_params(4, 16, 16)
    x = _frames(3, 16, seed=5)
    ref = JaxNet(num_actions=4, fc_units=16).apply({"params": p}, x)
    net = _port(4, 16, 16, p, conv_backend=conv_backend)
    assert net.block_rules == "xla"
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    assert _within_band(got.logits.numpy(), ref.logits)
    assert _within_band(got.value.numpy(), ref.value)


def test_full_width_bf16_matches_jax(full_params):
    """The one full-width check: 84x84x4 frames, FC 512, 6 actions, B=2."""
    p = full_params
    x = _frames(2, 84, seed=2)
    ref = JaxNet(num_actions=6).apply({"params": p}, x)
    net = _port(6, 512, 84, p)
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    assert got.logits.shape == (2, 6) and got.value.shape == (2,)
    assert _within_band(got.logits.numpy(), ref.logits)
    assert _within_band(got.value.numpy(), ref.value)


def test_uint8_and_prescaled_inputs_agree():
    net = BA3CNet(4, fc_units=16, image_size=(16, 16), device="cpu",
                  generator=torch.Generator().manual_seed(1))
    x = torch.from_numpy(_frames(2, 16, seed=3))
    with torch.no_grad():
        out_u8 = net(x)
        out_f = net(x.to(torch.bfloat16) / 255.0)
    np.testing.assert_allclose(out_u8.logits.numpy(), out_f.logits.numpy(), atol=2e-2)


def test_forward_shapes_and_dtypes():
    net = BA3CNet(6, device="cpu")
    with torch.no_grad():
        out = net(torch.zeros((3, 84, 84, 4), dtype=torch.uint8))
    assert out.logits.shape == (3, 6) and out.value.shape == (3,)
    assert out.logits.dtype == torch.float32 and out.value.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in net.parameters())
    assert conv_layout(net) == ((32, 5, True), (32, 5, True), (64, 4, True), (64, 3, False))


def test_seeded_init_is_deterministic_and_lecun_scaled(full_params):
    a = BA3CNet(6, device="cpu", generator=torch.Generator().manual_seed(7))
    b = BA3CNet(6, device="cpu", generator=torch.Generator().manual_seed(7))
    c = BA3CNet(6, device="cpu", generator=torch.Generator().manual_seed(8))
    assert all(torch.equal(a.state_dict()[k], b.state_dict()[k]) for k in a.state_dict())
    assert not torch.equal(a.fc.weight, c.fc.weight)
    # flax lecun_normal: std 1/sqrt(fan_in), like the JAX init's
    std_port = float(a.fc.weight.detach().std())
    std_jax = float(np.std(full_params["Dense_0"]["kernel"]))
    assert abs(std_port - std_jax) / std_jax < 0.05
    assert float(a.prelu.alpha.detach()) == pytest.approx(0.001)
    assert all(float(v.abs().max()) == 0 for k, v in a.state_dict().items() if k.endswith("bias"))


def test_prelu_matches_jax_in_bf16():
    x = np.random.default_rng(0).normal(0, 1, (4, 8)).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    jl = JaxPReLU()
    jp = jl.init(jax.random.PRNGKey(0), jx)
    ref = np.asarray(jl.apply(jp, jx), np.float32)
    layer = PReLU()
    with torch.no_grad():
        got = layer(torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), ref)


@pytest.mark.parametrize(
    "kwargs",
    [dict(conv_features=(8, 8, 16, 16)), dict(in_channels=3), dict(conv_kernels=(5, 5, 3, 3)),
     dict(pooled_layers=(True, True, False, False))],
    ids=["narrow", "in_channels", "kernels", "pooling"],
)
def test_cuda_backend_refuses_a_geometry_without_a_kernel(kwargs):
    """conv_backend='cuda' takes only what csrc/conv_block.cu instantiates
    (ops.conv_block.kernel_instantiated), and says so at construction, not
    at the first forward on the card; 'torch' takes any geometry."""
    with pytest.raises(ValueError, match="kernel_instantiated"):
        BA3CNet(6, device="cpu", conv_backend="cuda", **kwargs)
    net = BA3CNet(6, fc_units=16, device="cpu", conv_backend="torch", **kwargs)
    with torch.no_grad():
        out = net(torch.zeros((1, 84, 84, net.in_channels), dtype=torch.uint8))
    assert out.logits.shape == (1, 6)
    for size in (16, 84, 96):  # the BA3C blocks at any frame size
        BA3CNet(6, fc_units=16, image_size=(size, size), device="cpu", conv_backend="cuda")


def test_constructor_validation(monkeypatch):
    with pytest.raises(ValueError, match="conv_backend"):
        BA3CNet(4, device="cpu", conv_backend="xla")
    with pytest.raises(ValueError, match="block_rules"):
        BA3CNet(4, device="cpu", block_rules="cuda")
    assert BA3CNet(4, device="cpu").block_rules == "xla"  # JAX's default
    with pytest.raises(ValueError, match="bf16 kernel"):
        BA3CNet(4, device="cpu", conv_backend="cuda", compute_dtype=torch.float32)
    assert BA3CNet(4, device="cpu").conv_backend == "torch"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        BA3CNet(4)  # cuda by default, and no card: raises, never runs on CPU


# -- gradients: each JAX model's rules, the port's both backends ---------------

GRAD_REL_L2 = 2e-2
#: the conv biases' bound. Their gradient is the sum of a bf16 cotangent
#: over B*H*W positions, which XLA takes in bf16 (the transpose of the bias
#: broadcast) and the port in f32: JAX's own sum is several percent off
#: the exact one at these sizes (test_jax_sums_a_bf16_bias_gradient_in_bf16)
CONV_BIAS_REL_L2 = 0.1


def _bound(leaf: str) -> float:
    return CONV_BIAS_REL_L2 if "Conv_" in leaf and "bias" in leaf else GRAD_REL_L2


def _assert_within_bounds(errs: dict) -> None:
    assert all(e < _bound(k) for k, e in errs.items()), errs


def pong_frames(n: int, seed: int = 0) -> np.ndarray:
    """[n, 84, 84, 4] uint8 frame stacks of JAX Pong after a few random
    steps: exact zeros everywhere but the walls, paddles and ball."""
    from distributed_ba3c_tpu.envs.jaxenv import pong as jpong

    key = jax.random.PRNGKey(seed)
    state = jax.vmap(jpong.reset)(jax.random.split(key, n))
    step = jax.jit(jax.vmap(jpong.step))
    rng = np.random.default_rng(seed)
    frames = []
    for t in range(6):
        key, k = jax.random.split(key)
        a = jnp.asarray(rng.integers(0, 6, n), jnp.int32)
        state, obs, _, _ = step(state, a, jax.random.split(k, n))
        frames.append(np.asarray(obs))
    return np.stack(frames[-4:], axis=-1)


def _rel_l2_per_leaf(got: dict, ref: dict) -> dict:
    """||d||_2 / max(||ref||_2, 1e-3 * ||all ref grads||_2) per flax leaf."""
    flat_g = dict(jax.tree_util.tree_leaves_with_path(got))
    flat_r = dict(jax.tree_util.tree_leaves_with_path(ref))
    assert flat_g.keys() == flat_r.keys()
    total = float(np.sqrt(sum(float(np.sum(np.square(v, dtype=np.float64))) for v in flat_r.values())))
    out = {}
    for k, r in flat_r.items():
        g = np.asarray(flat_g[k], np.float64)
        assert g.shape == r.shape, k
        d = float(np.linalg.norm(g - np.asarray(r, np.float64)))
        out[jax.tree_util.keystr(k)] = d / max(float(np.linalg.norm(r)), 1e-3 * total)
    return out


def _sq_loss_grads_port(net, x) -> dict:
    out = net(torch.from_numpy(x))
    (out.logits.square().sum() + out.value.square().sum()).backward()
    grads = {k: p.grad for k, p in net.named_parameters()}
    assert all(g is not None and g.dtype == torch.float32 for g in grads.values())
    return to_flax(grads)


def _sq_loss_grads_jax(model, params, x) -> dict:
    def f(p):
        out = model.apply({"params": p}, x)
        return jnp.sum(jnp.square(out.logits)) + jnp.sum(jnp.square(out.value))

    return jax.device_get(jax.jit(jax.grad(f))(params))


def _full_width_grads(**jax_kw):
    """jax.grad through BA3CNet(**jax_kw) at full conv widths, fc_units=16,
    on 4 Pong frame stacks."""
    model = JaxNet(num_actions=6, fc_units=16, **jax_kw)
    x = pong_frames(4)
    params = jax.device_get(model.init(jax.random.PRNGKey(3), x[:1])["params"])
    return params, x, _sq_loss_grads_jax(model, params, x)


@pytest.fixture(scope="module")
def full_width_grads():
    """The pallas model's gradients (its Pallas blocks interpret)."""
    return _full_width_grads(conv_backend="pallas")


@pytest.fixture(scope="module")
def full_width_grads_xla():
    """JAX's default model's gradients: the model every JAX entry point
    builds (flax's layers in every block)."""
    return _full_width_grads()


@pytest.mark.parametrize("conv_backend", ["torch", "cuda"])
def test_full_width_gradients_match_jax_pallas_model(full_width_grads, conv_backend):
    """Under block_rules="pallas", blocks 1-3 differentiate as JAX's
    reference_block (the custom VJP), conv0 as flax's layers; on the CPU
    the 'cuda' backend runs the conv_block Function around the kernel
    wrapper's plain version."""
    params, x, ref = full_width_grads
    assert float(np.mean(x == 0)) > 0.9  # Pong: mostly exact zeros
    net = _port(6, 16, 84, params, conv_backend=conv_backend, block_rules="pallas")
    errs = _rel_l2_per_leaf(_sq_loss_grads_port(net, x), ref)
    _assert_within_bounds(errs)


@pytest.mark.parametrize("conv_backend", ["torch", "cuda"])
def test_full_width_gradients_match_jax_default_model(full_width_grads_xla, conv_backend):
    """The port's default model differentiates every block as flax's
    layers, as JAX's default (xla) model does; on Pong frames the ties make
    the other rules miss (the next test)."""
    params, x, ref = full_width_grads_xla
    net = _port(6, 16, 84, params, conv_backend=conv_backend)
    errs = _rel_l2_per_leaf(_sq_loss_grads_port(net, x), ref)
    _assert_within_bounds(errs)


def test_block_rules_change_the_gradients_not_the_forward(full_width_grads_xla):
    """On Pong frames the pallas rules' gradients leave the default model's
    bounds (Conv_1's bias by far), while the forward is the same function."""
    params, x, ref = full_width_grads_xla
    nets = {r: _port(6, 16, 84, params, block_rules=r) for r in ("xla", "pallas")}
    with torch.no_grad():
        outs = {r: n(torch.from_numpy(x)) for r, n in nets.items()}
    assert torch.equal(outs["xla"].logits, outs["pallas"].logits)
    errs = _rel_l2_per_leaf(_sq_loss_grads_port(nets["pallas"], x), ref)
    assert errs["['Conv_1']['bias']"] > 3 * CONV_BIAS_REL_L2, errs


def test_narrow_width_gradients_follow_flax_rules_in_every_block():
    """conv_features (8, 8, 16, 16): no block is supported, so every block
    takes flax's rules, in JAX's pallas model and in the port."""
    feats = (8, 8, 16, 16)
    model = JaxNet(num_actions=6, fc_units=16, conv_features=feats, conv_backend="pallas")
    x = pong_frames(4, seed=1)
    params = jax.device_get(model.init(jax.random.PRNGKey(4), x[:1])["params"])
    ref = _sq_loss_grads_jax(model, params, x)
    net = _port(6, 16, 84, params, conv_features=feats)
    errs = _rel_l2_per_leaf(_sq_loss_grads_port(net, x), ref)
    _assert_within_bounds(errs)


def test_jax_sums_a_bf16_bias_gradient_in_bf16():
    """Why the conv biases have their own bound: JAX's gradient of a bf16
    bias add (the VJP of the broadcast) is a bf16 sum, several percent off
    the exact sum of its bf16 cotangent; the port's is within 1e-2."""
    g = np.random.default_rng(0).normal(0, 1, (4, 84, 84, 32)).astype(np.float32)
    gb = jnp.asarray(g, jnp.bfloat16)
    exact = np.asarray(gb, np.float64).sum(axis=(0, 1, 2))
    _, vjp = jax.vjp(lambda b: jnp.zeros(g.shape, jnp.bfloat16) + b, jnp.zeros(32, jnp.bfloat16))
    jax_err = np.linalg.norm(np.asarray(vjp(gb)[0], np.float64) - exact) / np.linalg.norm(exact)
    tb = torch.zeros(32, dtype=torch.bfloat16, requires_grad=True)
    (torch.zeros(g.shape, dtype=torch.bfloat16) + tb).backward(torch.from_numpy(g).to(torch.bfloat16))
    port_err = np.linalg.norm(tb.grad.double().numpy() - exact) / np.linalg.norm(exact)
    assert jax_err > 0.02 and port_err < 0.01, (jax_err, port_err)


@pytest.mark.cuda
def test_kernel_model_matches_plain_model_on_the_card(cuda):
    """BA3CNet through the CUDA kernel against BA3CNet through the plain
    version, same seeded params and frames, on the card."""
    x = torch.from_numpy(_frames(64, 84, seed=4)).to(cuda)
    nets = [BA3CNet(6, conv_backend=b, device=cuda,
                    generator=torch.Generator().manual_seed(0)) for b in ("cuda", "torch")]
    before = conv_block_fwd.launches
    with torch.no_grad():
        got, ref = (n(x) for n in nets)
    torch.cuda.synchronize()
    assert conv_block_fwd.launches == before + 4
    assert _within_band(got.logits.cpu().numpy(), ref.logits.cpu().numpy())
    assert _within_band(got.value.cpu().numpy(), ref.value.cpu().numpy())

"""The port's conv block (distributed_ba3c_tpu_torch/ops/conv_block.py) held
against the JAX package's (distributed_ba3c_tpu/ops/pallas_conv.py).

On the CPU the port's wrapper computes its plain version, which is held
against the JAX ``reference_block`` and, for the blocks Mosaic accepts, the
Pallas kernel itself in interpret mode (as tests/test_pallas_conv.py runs
it). Tolerance: max|d| / max|ref| < 2e-2, the JAX suite's own bound (the
two sides sum the bf16 products in f32 in different orders, which can flip
a bf16 rounding). The CUDA kernel is held against the plain version on the
card by the ``cuda``-marked tests, which skip here.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_ba3c_tpu.ops import pallas_conv as jconv
from distributed_ba3c_tpu_torch.ops import _build
from distributed_ba3c_tpu_torch.ops.conv_block import (
    ConvSpec,
    ba3c_specs,
    conv_block,
    conv_block_fwd,
    flax_block,
    reference_block,
    supported,
)

REL_TOL = 2e-2
B = 2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _jax_spec(s: ConvSpec):
    return jconv.ConvSpec(
        H=s.H, W=s.W, Ci=s.Ci, Co=s.Co, kh=s.kh, kw=s.kw, pool=s.pool,
        scale_uint8=s.scale_uint8,
    )


def _inputs(s: ConvSpec, seed: int, batch: int = B):
    rng = np.random.default_rng(seed)
    if s.scale_uint8:
        x = rng.integers(0, 256, (batch, s.H, s.W * s.Ci), dtype=np.uint8)
    else:
        x = np.abs(rng.normal(0, 0.5, (batch, s.H, s.W * s.Ci))).astype(np.float32)
        # exactly representable in bf16 on both sides
        x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    w = rng.normal(0, 0.1, (s.kh, s.kw, s.Ci, s.Co)).astype(np.float32)
    b = rng.normal(0, 0.05, (s.Co,)).astype(np.float32)
    return x, w, b


def _torch_args(x, w, b):
    tx = torch.from_numpy(x)
    if tx.dtype != torch.uint8:
        tx = tx.to(torch.bfloat16)
    return tx, torch.from_numpy(w).to(torch.bfloat16), torch.from_numpy(b).to(torch.bfloat16)


def _rel_err(got: np.ndarray, ref: np.ndarray) -> float:
    return float(np.max(np.abs(got - ref)) / (np.max(np.abs(ref)) + 1e-6))


#: every BA3C block geometry: block 0 as the frames take it (uint8) and as
#: the model path gives it (bf16 /255), then blocks 1-3
CASES = [("block0_uint8", ba3c_specs()[0])] + [
    (f"block{i}", dataclasses.replace(s, scale_uint8=False))
    for i, s in enumerate(ba3c_specs())
]


def test_ba3c_specs_match_the_jax_package():
    port, ref = ba3c_specs(), jconv.ba3c_specs()
    assert len(port) == len(ref) == 4
    for p, r in zip(port, ref):
        assert (p.H, p.W, p.Ci, p.Co, p.kh, p.kw, p.pool, p.scale_uint8) == (
            r.H, r.W, r.Ci, r.Co, r.kh, r.kw, r.pool, r.scale_uint8
        )
        assert (p.ph, p.pw, p.Ho, p.Wo) == (r.ph, r.pw, r.Ho, r.Wo)
    assert [s.flops_per_sample for s in port] == [
        45158400, 90316800, 28901376, 7372800
    ]


@pytest.mark.parametrize("name,s", CASES, ids=[c[0] for c in CASES])
def test_plain_block_matches_jax_reference(name, s):
    x, w, b = _inputs(s, seed=len(name))
    jx = jnp.asarray(x) if s.scale_uint8 else jnp.asarray(x, jnp.bfloat16)
    ref = np.asarray(
        jconv.reference_block(jx, jnp.asarray(w), jnp.asarray(b), _jax_spec(s)),
        np.float32,
    )
    got = reference_block(*_torch_args(x, w, b), s).float().numpy()
    assert got.shape == ref.shape == (B, s.Ho, s.Wo * s.Co)
    assert _rel_err(got, ref) < REL_TOL, name


@pytest.mark.parametrize(
    "name,s", [c for c in CASES if jconv.supported(_jax_spec(c[1]))],
    ids=[c[0] for c in CASES if jconv.supported(_jax_spec(c[1]))],
)
def test_wrapper_matches_pallas_kernel_interpret(name, s):
    """Blocks 1-3 (Mosaic cannot take conv0's P*Ci=16 lanes): the port's
    wrapper on the CPU against the Pallas kernel run in interpret mode."""
    x, w, b = _inputs(s, seed=10 + len(name))
    js = _jax_spec(s)
    got_j = jconv.conv_block_fwd(
        jnp.asarray(x, jnp.bfloat16),
        jconv.pack_weights(jnp.asarray(w), js),
        jconv.pack_bias(jnp.asarray(b), js),
        js,
        interpret=True,
    )
    got = conv_block_fwd(*_torch_args(x, w, b), s).float().numpy()
    assert _rel_err(got, np.asarray(got_j, np.float32)) < REL_TOL, name


def test_block_stack_chains_like_the_jax_reference():
    """All four blocks chained from uint8 frames (the JAX suite's chaining):
    the port's output after block 3 stays within the band of JAX's."""
    rng = np.random.default_rng(5)
    xj = jnp.asarray(rng.integers(0, 256, (B, 84, 84 * 4), dtype=np.uint8))
    xt = torch.from_numpy(np.asarray(xj))
    for s in ba3c_specs():
        w = rng.normal(0, 0.1, (s.kh, s.kw, s.Ci, s.Co)).astype(np.float32)
        b = rng.normal(0, 0.05, (s.Co,)).astype(np.float32)
        xj = jconv.reference_block(xj, jnp.asarray(w), jnp.asarray(b), _jax_spec(s))
        xt = conv_block_fwd(
            xt, torch.from_numpy(w).to(torch.bfloat16),
            torch.from_numpy(b).to(torch.bfloat16), s,
        )
    assert xt.shape == (B, 10, 640) and xt.dtype == torch.bfloat16
    assert _rel_err(xt.float().numpy(), np.asarray(xj, np.float32)) < REL_TOL


def test_wrapper_on_cpu_is_the_plain_version_and_not_counted():
    s = CASES[2][1]
    args = _torch_args(*_inputs(s, seed=3))
    before = conv_block_fwd.launches
    assert torch.equal(conv_block_fwd(*args, s), reference_block(*args, s))
    assert conv_block_fwd.launches == before


def test_plain_block_float32_path_matches_jax_float32():
    """The model's float32 compute path runs the same ops in float32."""
    s = CASES[3][1]
    x, w, b = _inputs(s, seed=4)
    y = jax.lax.conv_general_dilated(
        jnp.asarray(x).reshape(B, s.H, s.W, s.Ci), jnp.asarray(w), (1, 1),
        [(s.ph, s.kh - 1 - s.ph), (s.pw, s.kw - 1 - s.pw)],
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
    )
    y = jnp.maximum(y + jnp.asarray(b), 0.0)
    y = y[:, : 2 * s.Ho, : 2 * s.Wo].reshape(B, s.Ho, 2, s.Wo, 2, s.Co).max(axis=(2, 4))
    got = reference_block(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), s,
        dtype=torch.float32,
    ).numpy()
    np.testing.assert_allclose(
        got, np.asarray(y).reshape(got.shape), rtol=1e-4, atol=1e-5
    )


@pytest.mark.parametrize(
    "bad",
    ["x_dtype", "w_dtype", "x_shape", "w_shape", "noncontiguous"],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    s = CASES[2][1]
    x, w, b = _torch_args(*_inputs(s, seed=6))
    if bad == "x_dtype":
        x = x.float()
    elif bad == "w_dtype":
        w = w.float()
    elif bad == "x_shape":
        x = x[:, :-1]
    elif bad == "w_shape":
        w = w[:-1]
    else:
        x = x.transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises((TypeError, ValueError)):
        conv_block_fwd(x, w, b, s)


def test_wrapper_refuses_a_device_it_has_no_path_for():
    """No fallback: a tensor that is neither CPU nor CUDA raises."""
    s = CASES[4][1]
    x, w, b = (t.to("meta") for t in _torch_args(*_inputs(s, seed=7)))
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        conv_block_fwd(x, w, b, s)


def test_cuda_request_without_a_card_raises(monkeypatch):
    from distributed_ba3c_tpu_torch.utils.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    """The kernel is built from csrc/ at first use; with no nvcc the load
    raises (it never falls back to the plain version)."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build.os.path, "isfile", lambda p: False)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()


def test_library_path_tracks_the_source(tmp_path, monkeypatch):
    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "out"))
    first = _build.library_path("k")
    assert first == _build.library_path("k")
    assert first.startswith(str(tmp_path / "out")) and first.endswith(".so")
    src.write_text("// two\n")
    assert _build.library_path("k") != first


@pytest.mark.cuda
@pytest.mark.parametrize("name,s", CASES, ids=[c[0] for c in CASES])
def test_kernel_matches_plain_version_on_the_card(cuda, name, s):
    """The CUDA kernel against reference_block (cuDNN) on the card, B=64:
    within the band, and >= 99.9% of elements within one bf16 ulp."""
    x, w, b = (t.to(cuda) for t in _torch_args(*_inputs(s, seed=20, batch=64)))
    before = conv_block_fwd.launches
    got = conv_block_fwd(x, w, b, s)
    ref = reference_block(x, w, b, s)
    torch.cuda.synchronize()
    assert conv_block_fwd.launches == before + 1
    g, r = got.float(), ref.float()
    assert float((g - r).abs().max() / (r.abs().max() + 1e-6)) < REL_TOL
    mag = torch.maximum(g.abs(), r.abs()).clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    assert float(((g - r).abs() <= ulp).float().mean()) >= 0.999


# -- the backward: the tie rules and the custom VJP ---------------------------


def _tie_inputs(s: ConvSpec, seed: int, batch: int = B):
    """Inputs with exact zeros, as Pong frames and zero biases give: the
    image is 0 outside a band of rows and a few random pixels, and every
    other bias is 0, so many pre-activations are exactly 0 (relu ties) and
    many pool windows hold four equal values (pool ties)."""
    rng = np.random.default_rng(seed)
    x, w, b = _inputs(s, seed, batch)
    keep = np.zeros((batch, s.H, s.W, 1), bool)
    keep[:, s.H // 3 : s.H // 3 + 3] = True
    keep |= rng.random(keep.shape) < 0.01
    keep = np.broadcast_to(keep, (batch, s.H, s.W, s.Ci))
    x = np.where(keep.reshape(x.shape), x, 0).astype(x.dtype)
    b[::2] = 0.0
    b[1::4] = np.abs(b[1::4])  # positive biases: four equal relu outputs
    # a sparse +-1 cotangent: every partial sum of a bias gradient is then
    # exact in bf16. XLA sums the bias gradient (the transpose of the bias
    # broadcast) in bf16, ~10% off a dense normal cotangent's exact sum at
    # these sizes; the port sums in f32 (PERF.md, "Findings")
    g = rng.choice([-1.0, 1.0], (batch, s.Ho, s.Wo * s.Co))
    g = (g * (rng.random(g.shape) < 0.1)).astype(np.float32)
    return x, w, b, g


def _count_ties(x, w, b, s: ConvSpec):
    """(relu ties, tied pool windows) of the bf16 block on these inputs."""
    tx, tw, tb = _torch_args(x, w, b)
    with torch.no_grad():
        from distributed_ba3c_tpu_torch.ops.conv_block import _conv

        pre = _conv(tx, tw, s, torch.bfloat16) + tb[:, None, None]
    relu_ties = int((pre == 0).sum())
    if not s.pool:
        return relu_ties, 0
    y = pre.clamp_min(0)[:, :, : 2 * s.Ho, : 2 * s.Wo]
    win = y.reshape(x.shape[0], s.Co, s.Ho, 2, s.Wo, 2)
    top = win.amax(dim=(3, 5), keepdim=True)
    return relu_ties, int(((win == top).sum(dim=(3, 5)) > 1).sum())


def _jax_vjp(fn, x, w, b, g, s: ConvSpec):
    jx = jnp.asarray(x) if s.scale_uint8 else jnp.asarray(x, jnp.bfloat16)
    argnums = (1, 2) if s.scale_uint8 else (0, 1, 2)
    args = [jx, jnp.asarray(w), jnp.asarray(b)]

    def f(*diff):
        full = list(args)
        for i, a in zip(argnums, diff):
            full[i] = a
        return fn(*full)

    _, vjp = jax.vjp(f, *[args[i] for i in argnums])
    grads = vjp(jnp.asarray(g, jnp.bfloat16))
    return {"xwb"[i]: np.asarray(gr, np.float32) for i, gr in zip(argnums, grads)}


def _torch_vjp(fn, x, w, b, g, s: ConvSpec, param_dtype=torch.float32):
    tx, _, _ = _torch_args(x, w, b)
    tw = torch.from_numpy(w).to(param_dtype).requires_grad_(True)
    tb = torch.from_numpy(b).to(param_dtype).requires_grad_(True)
    leaves = {"w": tw, "b": tb}
    if not s.scale_uint8:
        tx.requires_grad_(True)
        leaves["x"] = tx
    y = fn(tx, tw, tb)
    y.backward(torch.from_numpy(g).to(torch.bfloat16))
    return {k: t.grad for k, t in leaves.items()}, leaves


@pytest.mark.parametrize("name,s", CASES, ids=[c[0] for c in CASES])
def test_plain_block_vjp_matches_jax_reference_at_ties(name, s):
    """reference_block's VJP against jax.vjp of JAX's reference_block on
    inputs full of exact zeros: relu ties take 1/2 of the cotangent and a
    tied pool window splits it evenly, on both sides."""
    x, w, b, g = _tie_inputs(s, seed=30 + len(name))
    relu_ties, pool_ties = _count_ties(x, w, b, s)
    assert relu_ties > 1000 and (pool_ties > 1000 or not s.pool), (relu_ties, pool_ties)
    ref = _jax_vjp(
        lambda xx, ww, bb: jconv.reference_block(xx, ww, bb, _jax_spec(s)),
        x, w, b, g, s,
    )
    got, leaves = _torch_vjp(
        lambda xx, ww, bb: reference_block(xx, ww, bb, s), x, w, b, g, s
    )
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].shape == leaves[k].shape and got[k].dtype == leaves[k].dtype
        assert _rel_err(got[k].float().numpy(), ref[k]) < REL_TOL, (name, k)


@pytest.mark.parametrize(
    "name,s", [c for c in CASES if supported(c[1])],
    ids=[c[0] for c in CASES if supported(c[1])],
)
def test_conv_block_function_matches_jax_custom_vjp(name, s):
    """Blocks 1-3: the port's conv_block Function (on the CPU its forward
    is the plain version) against jax.vjp of JAX's conv_block custom VJP
    with the Pallas forward in interpret mode."""
    x, w, b, g = _tie_inputs(s, seed=40 + len(name))
    js = _jax_spec(s)
    out_j = jconv.conv_block(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w), jnp.asarray(b), js, True
    )
    ref = _jax_vjp(
        lambda xx, ww, bb: jconv.conv_block(xx, ww, bb, js, True), x, w, b, g, s
    )
    tx, tw, tb = (t.requires_grad_(True) for t in _torch_args(x, w, b))
    before = conv_block.launches
    y = conv_block(tx, tw, tb, s)
    assert _rel_err(y.detach().float().numpy(), np.asarray(out_j, np.float32)) < REL_TOL
    y.backward(torch.from_numpy(g).to(torch.bfloat16))
    assert conv_block.launches == before  # CPU backward: not counted
    for k, t in zip("xwb", (tx, tw, tb)):
        assert t.grad.shape == t.shape and t.grad.dtype == torch.bfloat16, k
        assert _rel_err(t.grad.float().numpy(), ref[k]) < REL_TOL, (name, k)


def test_conv_block_uint8_input_takes_no_gradient():
    s = CASES[0][1]
    x, w, b, g = _tie_inputs(s, seed=50)
    tx, tw, tb = _torch_args(x, w, b)
    tw.requires_grad_(True)
    tb.requires_grad_(True)
    conv_block(tx, tw, tb, s).backward(torch.from_numpy(g).to(torch.bfloat16))
    assert tx.grad is None and tw.grad.shape == tw.shape and tb.grad.shape == tb.shape


@pytest.mark.parametrize("name,s", CASES[1:2] + CASES[3:4], ids=["block0", "block2"])
def test_flax_block_vjp_matches_flax_layers_at_ties(name, s):
    """flax_block's VJP against nn.Conv + nn.relu + nn.max_pool's: relu
    ties take no gradient and the first maximum of a window takes it all."""
    import flax.linen as nn

    x, w, b, g = _tie_inputs(s, seed=60 + len(name))

    def flax_fn(xx, ww, bb):
        xx = xx.reshape(B, s.H, s.W, s.Ci)
        y = nn.Conv(s.Co, (s.kh, s.kw), padding="SAME", dtype=jnp.bfloat16).apply(
            {"params": {"kernel": ww, "bias": bb}}, xx
        )
        y = nn.relu(y)
        if s.pool:
            y = nn.max_pool(y, (2, 2), strides=(2, 2))
        return y.reshape(B, s.Ho, s.Wo * s.Co)

    ref = _jax_vjp(flax_fn, x, w, b, g, s)
    got, _ = _torch_vjp(lambda xx, ww, bb: flax_block(xx, ww, bb, s), x, w, b, g, s)
    for k in ref:
        assert _rel_err(got[k].float().numpy(), ref[k]) < REL_TOL, (name, k)
    # the two tie rules really differ on these inputs
    other, _ = _torch_vjp(lambda xx, ww, bb: reference_block(xx, ww, bb, s), x, w, b, g, s)
    assert _rel_err(other["b"].float().numpy(), ref["b"]) > REL_TOL


def test_supported_matches_the_jax_predicate():
    for s in [c[1] for c in CASES] + list(ba3c_specs(conv_features=(8, 8, 16, 16))):
        assert supported(s) == jconv.supported(_jax_spec(s)), s
    assert [supported(s) for s in ba3c_specs()] == [False, True, True, True]


@pytest.mark.cuda
@pytest.mark.parametrize("name,s", CASES[1:], ids=[c[0] for c in CASES[1:]])
def test_conv_block_vjp_on_the_card_matches_its_plain_block(cuda, name, s):
    """On the card the Function's forward is the kernel (one launch) and
    its backward the plain block's VJP (counted once): the output and the
    gradients within the band of the plain block's on the same inputs."""
    plain = reference_block if supported(s) else flax_block
    x, w, b, g = _tie_inputs(s, seed=70 + len(name), batch=64)
    tx, tw, tb = (t.to(cuda) for t in _torch_args(x, w, b))
    gy = torch.from_numpy(g).to(torch.bfloat16).to(cuda)
    outs = []
    before = (conv_block_fwd.launches, conv_block.launches)
    for fn in (lambda *a: conv_block(*a, s, plain), lambda *a: plain(*a, s)):
        leaves = [t.detach().requires_grad_(True) for t in (tx, tw, tb)]
        y = fn(*leaves)
        y.backward(gy)
        outs.append([y.detach()] + [t.grad for t in leaves])
    torch.cuda.synchronize()
    assert (conv_block_fwd.launches, conv_block.launches) == (before[0] + 1, before[1] + 1)
    (y, *grads), (y_ref, *grads_ref) = outs
    assert float((y.float() - y_ref.float()).abs().max()) <= REL_TOL * float(y_ref.float().abs().max())
    for a, r in zip(grads, grads_ref):
        assert a.shape == r.shape and a.dtype == r.dtype
        # the same recompute on the same inputs; cuDNN may sum in another order
        assert float((a.float() - r.float()).abs().max()) <= REL_TOL * float(r.float().abs().max())

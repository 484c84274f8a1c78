"""The conv block's backward (csrc/conv_block_bwd.cu, through
distributed_ba3c_tpu_torch/ops/conv_block.py) held on the CPU against the
JAX package's conv_block VJP (distributed_ba3c_tpu/ops/pallas_conv.py).

Two views of the three backward launches, both in numpy:

- the GEMM view: the route of the cotangent through the pool and the relu
  (by each tie rule), the dgrad as a GEMM with the flipped weights, the
  wgrad as im2col^T . dz split over positions and reduced in a fixed order;
  held against jax.vjp of JAX's conv_block (the Pallas forward in interpret
  mode; blocks 1-3) and of flax's nn.Conv + nn.relu + nn.max_pool (block 0),
  on inputs full of ties. dz and db must be bit-exact (a sparse +-1
  cotangent keeps every sum exact in bf16); dx and dw within 2e-2 of
  max|ref| (XLA and the GEMM sum in other orders) and >= 99.9% within one
  bf16 ulp of an f32-summed oracle (the port's plain versions).
- a lane-level emulation of the kernels' indexing, in the pattern of
  tests/test_torch_conv_block.py's ``_emulate_kernel``: the route epilogue's
  window registers and db partials, the dgrad's swapped pads and block 2's
  zero 21st row and column, the wgrad's pixel-pair halo, its tap split over
  warps and CTAs and its position split, at ragged B and band heights.
  Shared memory is filled with NaN, so a word the kernel must not read
  reaches the output.

The kernels themselves run on the card: chip_smoke.py, and the cuda-marked
test in tests/test_torch_conv_block.py.
"""

from __future__ import annotations

import dataclasses
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_ba3c_tpu.ops import pallas_conv as jconv
from distributed_ba3c_tpu_torch.ops import _build
from distributed_ba3c_tpu_torch.ops import conv_block as cb
from distributed_ba3c_tpu_torch.ops.conv_block import (
    DGRAD_GEOMETRIES,
    ConvSpec,
    conv_block_bwd,
    conv_block_dgrad,
    conv_block_route,
    conv_block_wgrad,
    dgrad_plain,
    flax_block,
    reference_block,
    wgrad_plain,
)
from test_torch_conv_block import (
    _G,
    _LANE,
    _T,
    CASES,
    REL_TOL,
    _bf16,
    _count_ties,
    _emulate_mainloop,
    _Geom,
    _jax_spec,
    _jax_vjp,
    _ldsm,
    _mma,
    _rel_err,
    _tie_inputs,
    _torch_args,
    _ulp_share,
)

B = 2
SPECS = dict(CASES)
INV255 = float(torch.tensor(1.0 / 255.0, dtype=torch.bfloat16))


def _dz_grid(s: ConvSpec):
    return (2 * s.Ho, 2 * s.Wo) if s.pool else (s.H, s.W)


def _x_values(x, s: ConvSpec) -> np.ndarray:
    """x as the kernels read it: [n, H, W, Ci] bf16 values (uint8 scaled
    by bf16(1/255) with one rounding)."""
    x = x.reshape(x.shape[0], s.H, s.W, s.Ci).astype(np.float64)
    return _bf16(x * INV255) if s.scale_uint8 else x


def _pad_x(xv, s: ConvSpec) -> np.ndarray:
    """SAME-padded x cut to the rows and columns dz's grid reads."""
    Hd, Wd = _dz_grid(s)
    xp = np.zeros((xv.shape[0], Hd + s.kh - 1, Wd + s.kw - 1, s.Ci))
    rows, cols = min(s.H, Hd + s.kh - 1 - s.ph), min(s.W, Wd + s.kw - 1 - s.pw)
    xp[:, s.ph: s.ph + rows, s.pw: s.pw + cols] = xv[:, :rows, :cols]
    return xp


def _patches(xp, kh, kw, Ho, Wo) -> np.ndarray:
    """im2col: [n, Ho, Wo, kh*kw*C], K ordered (ky, kx, c)."""
    return np.stack(
        [xp[:, ky: ky + Ho, kx: kx + Wo] for ky in range(kh) for kx in range(kw)], axis=3
    ).reshape(xp.shape[0], Ho, Wo, -1)


def _acc64(x, w, s: ConvSpec) -> np.ndarray:
    """The pre-bias sums on dz's grid, in float64 (exact for these sizes up
    to the last bits of a double): [n, Hd, Wd, Co]."""
    Hd, Wd = _dz_grid(s)
    p = _patches(_pad_x(_x_values(x, s), s), s.kh, s.kw, Hd, Wd)
    return p @ w.reshape(-1, s.Co).astype(np.float64)


def _route_np(z, g, s: ConvSpec, flax: bool) -> np.ndarray:
    """The GEMM view's route: dz [n, Hd, Wd, Co] from the pre-activations z
    on dz's grid and the cotangent g [n, Ho, Wo*Co]. reference_block's
    rule: relu'(0) = 1/2, and the nested max (column pair of each window
    row, then the rows) splits a tie evenly; flax's: relu'(0) = 0 and the
    whole window to its first maximum, row-major."""
    n = z.shape[0]
    g = g.reshape(n, s.Ho, s.Wo, s.Co).astype(np.float64)
    relu_d = np.where(z > 0, 1.0, np.where(z == 0, 0.0 if flax else 0.5, 0.0))
    if not s.pool:
        return g * relu_d
    r = np.maximum(z, 0.0).reshape(n, s.Ho, 2, s.Wo, 2, s.Co)  # [.., f, .., h, ..]
    if flax:
        q = r.transpose(0, 1, 3, 5, 2, 4).reshape(n, s.Ho, s.Wo, s.Co, 4)
        first = np.argmax(q == q.max(-1, keepdims=True), axis=-1)
        share = (np.arange(4) == first[..., None]).astype(np.float64)
        share = share.reshape(n, s.Ho, s.Wo, s.Co, 2, 2).transpose(0, 1, 4, 2, 5, 3)
    else:
        m = r.max(axis=4, keepdims=True)
        col = (r == m) / (r == m).sum(axis=4, keepdims=True)
        M = m.max(axis=2, keepdims=True)
        row = (m == M) / (m == M).sum(axis=2, keepdims=True)
        share = col * row
    d = share * g[:, :, None, :, None, :]
    return d.reshape(z.shape) * relu_d


def _dgrad_gemm(dz, w, s: ConvSpec) -> np.ndarray:
    """dx = conv(dz, W flipped, in and out swapped), pads k-1-(k-1)//2 on
    the top and left, dz's grid zero beyond its last row and column; the
    f32 GEMM rounded to bf16. [n, H, W*Ci]."""
    n, (Hd, Wd) = dz.shape[0], _dz_grid(s)
    top, left = s.kh - 1 - s.ph, s.kw - 1 - s.pw
    dp = np.zeros((n, s.H + s.kh - 1, s.W + s.kw - 1, s.Co), np.float32)
    dp[:, top: top + Hd, left: left + Wd] = dz
    wt = w[::-1, ::-1].transpose(0, 1, 3, 2).reshape(-1, s.Ci).astype(np.float32)
    dx = _patches(dp, s.kh, s.kw, s.H, s.W).astype(np.float32) @ wt
    return _bf16(dx).reshape(n, s.H, s.W * s.Ci)


def _wgrad_gemm(x, dz, s: ConvSpec, splits: int = 3):
    """dw = im2col(x)^T . dz over dz's positions, as f32 partials of
    ``splits`` position ranges added in order, rounded to bf16; db the f32
    sums of dz's partials the same way."""
    n, (Hd, Wd) = x.shape[0], _dz_grid(s)
    p = _patches(_pad_x(_x_values(x, s), s), s.kh, s.kw, Hd, Wd).reshape(-1, s.kh * s.kw * s.Ci)
    d = dz.reshape(-1, s.Co)
    parts = np.array_split(np.arange(p.shape[0]), splits)
    dw = np.zeros((p.shape[1], s.Co), np.float32)
    db = np.zeros((s.Co,), np.float32)
    for idx in parts:
        dw += p[idx].astype(np.float32).T @ d[idx].astype(np.float32)
        db += d[idx].astype(np.float32).sum(0)
    return _bf16(dw).reshape(s.kh, s.kw, s.Ci, s.Co), _bf16(db)


# -- the JAX side ------------------------------------------------------------


def _jax_acc(x, w, s: ConvSpec) -> np.ndarray:
    """JAX's pre-bias conv output [n, H, W, Co], bf16 (reference_block's
    conv)."""
    jx = jnp.asarray(x).reshape(x.shape[0], s.H, s.W, s.Ci)
    jx = jx.astype(jnp.bfloat16) * jnp.bfloat16(1.0 / 255.0) if s.scale_uint8 else jx.astype(jnp.bfloat16)
    return jax.lax.conv_general_dilated(
        jx, jnp.asarray(w, jnp.bfloat16), (1, 1),
        [(s.ph, s.kh - 1 - s.ph), (s.pw, s.kw - 1 - s.pw)],
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
    )


def _jax_tail(acc, b, s: ConvSpec, flax: bool):
    """The ops after the conv: reference_block's (pallas_conv.py:379-387)
    or flax's nn.relu + nn.max_pool."""
    import flax.linen as nn

    n = acc.shape[0]
    bb = jnp.asarray(b, jnp.bfloat16)
    if flax:
        y = nn.relu(acc + bb)
        return nn.max_pool(y, (2, 2), strides=(2, 2)) if s.pool else y
    y = jnp.maximum(acc + bb, jnp.bfloat16(0.0))
    if s.pool:
        y = y[:, : 2 * s.Ho, : 2 * s.Wo].reshape(n, s.Ho, 2, s.Wo, 2, s.Co)
        y = jnp.max(jnp.max(y, axis=4), axis=2)
    return y


def _jax_dz(x, w, b, g, s: ConvSpec, flax: bool):
    """(z, dz): JAX's pre-activation and jax.vjp of the tail at its own
    conv output, both on dz's grid."""
    Hd, Wd = _dz_grid(s)
    acc = _jax_acc(x, w, s)
    _, vjp = jax.vjp(lambda a: _jax_tail(a, b, s, flax), acc)
    n = x.shape[0]
    (dz,) = vjp(jnp.asarray(g, jnp.bfloat16).reshape(n, s.Ho, s.Wo, s.Co))
    z = _bf16(np.asarray(acc, np.float32) + _bf16(b))
    return z[:, :Hd, :Wd], np.asarray(dz, np.float32)[:, :Hd, :Wd]


def _flax_layers(s: ConvSpec, n: int):
    import flax.linen as nn

    def fn(xx, ww, bb):
        xx = xx.reshape(n, s.H, s.W, s.Ci)
        y = nn.Conv(s.Co, (s.kh, s.kw), padding="SAME", dtype=jnp.bfloat16).apply(
            {"params": {"kernel": ww, "bias": bb}}, xx
        )
        y = nn.relu(y)
        if s.pool:
            y = nn.max_pool(y, (2, 2), strides=(2, 2))
        return y.reshape(n, s.Ho, s.Wo * s.Co)

    return fn


#: (block, tie rule): the model's rules (flax's for block 0, reference_
#: block's for 1-3), and flax's on block 2's pool of 21 rows
GEMM_CASES = [("block0", True), ("block1", False), ("block2", False), ("block3", False),
              ("block2", True)]


@pytest.mark.parametrize("name,flax", GEMM_CASES,
                         ids=[f"{n}-{'flax' if f else 'reference'}" for n, f in GEMM_CASES])
def test_gemm_view_of_the_backward_matches_jax_at_ties(name, flax):
    """The route, the flipped-weight dgrad and the split, fixed-order wgrad
    against jax.vjp of JAX's conv_block (reference rule) or of flax's layers
    (flax rule) on inputs full of ties: dz and db bit-exact, dx and dw
    within 2e-2 of max|ref| and >= 99.9% within one bf16 ulp of the port's
    f32-summed plain versions."""
    s = SPECS[name]
    x, w, b, g = _tie_inputs(s, seed=200 + len(name) + 7 * flax)
    w, b = _bf16(w), _bf16(b)
    relu_ties, pool_ties = _count_ties(x, w, b, s)
    assert relu_ties > 1000 and (pool_ties > 1000 or not s.pool), (relu_ties, pool_ties)

    z, dz_ref = _jax_dz(x, w, b, g, s, flax)
    dz = _route_np(z, g, s, flax)
    assert np.array_equal(dz, dz_ref), name
    assert np.array_equal(_bf16(dz), dz)  # g times 0, 1/8, 1/4, 1/2 or 1

    if flax:
        ref = _jax_vjp(_flax_layers(s, B), x, w, b, g, s)
    else:
        js = _jax_spec(s)
        ref = _jax_vjp(lambda xx, ww, bb: jconv.conv_block(xx, ww, bb, js, True), x, w, b, g, s)
    dw, db = _wgrad_gemm(x, dz, s)
    assert np.array_equal(db, ref["b"]), name
    tx, tw, _ = _torch_args(x, w, b)
    tdz = torch.from_numpy(dz.astype(np.float32)).to(torch.bfloat16)
    dw_f32 = wgrad_plain(tx, tdz, torch.zeros((1, s.Co)), s)[0].float().numpy()
    assert _rel_err(dw, ref["w"]) < REL_TOL, name
    assert _ulp_share(dw, dw_f32) >= 0.999, name
    if (s.kh, s.kw, s.Ci, s.Co, s.pool) in DGRAD_GEOMETRIES:
        dx = _dgrad_gemm(dz, w, s)
        dx_f32 = dgrad_plain(tdz, tw, s).float().numpy()
        assert _rel_err(dx, ref["x"]) < REL_TOL, name
        assert _ulp_share(dx, dx_f32) >= 0.999, name


@pytest.mark.parametrize("name,flax", GEMM_CASES,
                         ids=[f"{n}-{'flax' if f else 'reference'}" for n, f in GEMM_CASES])
def test_plain_pieces_compose_to_the_plain_vjp(name, flax):
    """The CPU paths of conv_block_route, conv_block_dgrad and
    conv_block_wgrad (their plain versions, the chip's oracles) compose to
    the plain block's VJP: dz bit-exact against the GEMM view's route of
    the same z, the gradients within the band of autograd's."""
    s = SPECS[name]
    plain = flax_block if flax else reference_block
    x, w, b, g = _tie_inputs(s, seed=300 + len(name) + 7 * flax)
    tx, tw, tb = _torch_args(x, w, b)
    tg = torch.from_numpy(g).to(torch.bfloat16)
    counts = (conv_block_route.launches, conv_block_dgrad.launches, conv_block_wgrad.launches)
    dz, dbpart = conv_block_route(tx, tw, tb, tg, s, plain)
    Hd, Wd = _dz_grid(s)
    assert dz.shape == (B, Hd, Wd, s.Co) and dz.dtype == torch.bfloat16
    with torch.no_grad():
        acc = cb._conv(tx, tw, s, torch.bfloat16) + tb[:, None, None]
    z = acc.float().permute(0, 2, 3, 1).numpy()[:, :Hd, :Wd]
    assert np.array_equal(dz.float().numpy(), _route_np(z, g, s, flax))
    need = ((s.kh, s.kw, s.Ci, s.Co, s.pool) in DGRAD_GEOMETRIES, True, True)
    dx, dw, db = conv_block_bwd(tx, tw, tb, tg, s, plain, need)
    leaves = [t.clone().requires_grad_(n) for t, n in zip((tx, tw, tb), need)]
    plain(*leaves, s).backward(tg)
    for got, leaf in zip((dx, dw, db), leaves):
        if leaf.requires_grad:
            assert got.shape == leaf.shape and got.dtype == torch.bfloat16
            assert _rel_err(got.float().numpy(), leaf.grad.float().numpy()) < REL_TOL
    assert torch.equal(db, dbpart.sum(0).to(torch.bfloat16))
    assert counts == (conv_block_route.launches, conv_block_dgrad.launches,
                      conv_block_wgrad.launches)  # CPU calls are not counted


# -- the kernels' indexing, emulated lane by lane ------------------------------

_WARPS = 4  # conv_block.cuh's kWarps


def _pool_route_lanes(z, gv, flax):
    """conv_block.cuh's pool_route over arrays: z [4, ...] (q = 2 * row +
    column), gv [...] -> d [4, ...]."""
    r = np.maximum(z, 0.0)
    rg = lambda zz, fl: np.where(zz > 0, 1.0, np.where((zz == 0) & (not fl), 0.5, 0.0))
    if flax:
        m = np.maximum(np.maximum(r[0], r[1]), np.maximum(r[2], r[3]))
        first = np.where(r[0] == m, 0, np.where(r[1] == m, 1, np.where(r[2] == m, 2, 3)))
        return np.stack([np.where(first == q, gv * rg(z[q], True), 0.0) for q in range(4)])
    m = [np.maximum(r[0], r[1]), np.maximum(r[2], r[3])]
    M = np.maximum(m[0], m[1])
    rs = np.where((m[0] == M) & (m[1] == M), 0.5, 1.0)
    d = []
    for f in range(2):
        gr = np.where(m[f] == M, gv * rs, 0.0)
        cs = np.where((r[2 * f] == m[f]) & (r[2 * f + 1] == m[f]), 0.5, 1.0)
        for h in range(2):
            q = 2 * f + h
            d.append(np.where(r[q] == m[f], gr * cs * rg(z[q], False), 0.0))
    return np.stack(d)


def _emulate_route(x, w, b, g, s: ConvSpec, R: int, grid: int, flax: bool):
    """conv_block_kernel<.., kRoute> with band height R on ``grid`` CTAs:
    dz [n, Hd, Wd, Co] and the db partials [grid, Co], every sum in the
    kernel's f32 order (per lane over its chunks, the xor butterfly over the
    8 lanes of a channel pair, then the warps)."""
    G = _Geom(s)
    n = x.shape[0]
    HO, WO = s.H // G.U, s.W // G.U
    Hd, Wd = _dz_grid(s)
    gq = g.reshape(n, HO * WO, s.Co)
    dz = np.full((n, Hd * Wd, s.Co), np.nan)
    dbs = np.zeros((grid, _WARPS, 32, G.NJ, 2), np.float32)
    NB = -(-HO // R)
    for bi, r0, units, u0, acc in _emulate_mainloop(x, w, s, R):
        cta = (bi * NB + r0 // R) % grid
        for c in range(len(u0)):
            warp = c % _WARPS
            for j in range(G.NJ):
                co = 8 * j + 2 * _T
                for e in range(2):
                    bias = b[co + e]
                    pre = lambda a: _bf16(_bf16(a) + bias)
                    if G.POOL:
                        u = u0[c] + _G
                        ok = u < units
                        uc = np.where(ok, u, 0)
                        z = np.stack([pre(acc[q >> 1, j, c, :, 2 * (q & 1) + e]) for q in range(4)])
                        d = _pool_route_lanes(z, gq[bi, r0 * WO + uc, co + e], flax)
                        uy, ux = uc // WO, uc % WO
                        for q in range(4):
                            at = (2 * (r0 + uy) + (q >> 1)) * Wd + 2 * ux + (q & 1)
                            dz[bi, at[ok], (co + e)[ok]] = d[q][ok]
                            dbs[cta, warp, :, j, e] += np.where(ok, d[q], 0).astype(np.float32)
                    else:
                        for f in range(2):
                            for h in range(2):
                                u = u0[c] + f * 16 + h * 8 + _G
                                ok = u < units
                                uc = np.where(ok, u, 0)
                                z = pre(acc[f, j, c, :, 2 * h + e])
                                rg = np.where(z > 0, 1.0, np.where((z == 0) & (not flax), 0.5, 0.0))
                                d = gq[bi, r0 * WO + uc, co + e] * rg
                                dz[bi, (r0 * WO + uc)[ok], (co + e)[ok]] = d[ok]
                                dbs[cta, warp, :, j, e] += np.where(ok, d, 0).astype(np.float32)
    for o in (4, 8, 16):  # __shfl_xor_sync
        dbs = dbs + dbs[:, :, _LANE ^ o]
    red = np.zeros((grid, _WARPS, s.Co), np.float32)
    for j in range(G.NJ):
        for e in range(2):
            red[:, :, 8 * j + 2 * _T[:4] + e] = dbs[:, :, :4, j, e]
    dbpart = np.zeros((grid, s.Co), np.float32)
    for wi in range(_WARPS):
        dbpart += red[:, wi]
    return dz.reshape(n, Hd, Wd, s.Co), dbpart


#: small frames per case, band heights that leave a ragged last band or a
#: band of one row, and grids that give some CTAs several items
_ROUTE = [("block0_uint8", 10, 2, 3, True), ("block0", 8, 3, 2, True),
          ("block1", 10, 2, 4, False), ("block2", 9, 3, 2, False),
          ("block2", 9, 1, 5, True), ("block3", 7, 3, 2, False)]


@pytest.mark.parametrize(
    "name,size,R,grid,flax", _ROUTE,
    ids=[f"{n}-{hw}-R{r}-grid{gr}-{'flax' if f else 'reference'}" for n, hw, r, gr, f in _ROUTE],
)
def test_route_epilogue_emulated_matches_the_gemm_view(name, size, R, grid, flax):
    """The route epilogue, lane by lane on the kernel's accumulators at
    B=3 on tie inputs: dz bit-exact against the GEMM view's route of the
    float64 sums (every dz element written, block 2's 9th row and column
    never formed), and the CTAs' db partials adding up to db."""
    s = dataclasses.replace(SPECS[name], H=size, W=size)
    x, w, b, g = _tie_inputs(s, seed=400 + size + R, batch=3)
    w, b = _bf16(w), _bf16(b)
    dz, dbpart = _emulate_route(x, w, b, g, s, R, grid, flax)
    z = _bf16(_bf16(_acc64(x, w, s)) + b)
    ref = _route_np(z, g, s, flax)
    assert not np.isnan(dz).any()
    assert np.array_equal(dz, ref), name
    assert (z == 0).sum() > 50 and np.abs(ref).sum() > 0
    np.testing.assert_allclose(dbpart.sum(0), ref.sum(axis=(0, 1, 2)), rtol=1e-5, atol=1e-5)


def _dgrad_spec(s: ConvSpec) -> ConvSpec:
    """The dgrad as a conv of the kernel's: Co in, Ci out, unpooled."""
    return ConvSpec(H=s.H, W=s.W, Ci=s.Co, Co=s.Ci, kh=s.kh, kw=s.kw, pool=False,
                    scale_uint8=False)


def _emulate_dgrad(dz, w, s: ConvSpec, R: int) -> np.ndarray:
    """conv_block_kernel<Geom<kh, kw, Co, Ci, false, kh-1-ph, kw-1-pw>,
    bf16, kStore> with band height R: dz's grid (Hd x Wd) is the input, the
    forward's input grid (H x W) the output; the sums rounded to bf16."""
    sd = _dgrad_spec(s)
    G = _Geom(sd, ph=s.kh - 1 - s.ph, pw=s.kw - 1 - s.pw)
    wt = w[::-1, ::-1].transpose(0, 1, 3, 2)  # the wrapper's flip
    n = dz.shape[0]
    dx = np.full((n, s.H * s.W, s.Ci), np.nan)
    for bi, r0, units, u0, acc in _emulate_mainloop(dz.reshape(n, -1), wt, sd, R, G=G,
                                                    hin=_dz_grid(s)):
        for j in range(G.NJ):
            co = 8 * j + 2 * _T
            for f in range(2):
                for h in range(2):
                    u = u0[:, None] + f * 16 + h * 8 + _G
                    ok = u < units
                    cols = co[None].repeat(len(u0), 0)[ok]
                    for e in range(2):
                        dx[bi, r0 * s.W + u[ok], cols + e] = _bf16(acc[f, j, :, :, 2 * h + e])[ok]
    return dx.reshape(n, s.H, s.W * s.Ci)


_DGRAD = [("block1", 10, 3), ("block1", 6, 6), ("block2", 9, 2), ("block2", 11, 4),
          ("block3", 7, 2)]


@pytest.mark.parametrize("name,size,R", _DGRAD, ids=[f"{n}-{hw}-R{r}" for n, hw, r in _DGRAD])
def test_dgrad_emulated_matches_the_plain_input_gradient(name, size, R):
    """The dgrad's indexing (the forward's mainloop with the pads swapped
    to k-1-(k-1)//2, dz's grid as the input: block 2's pooled 9 -> 8 reads
    the 9th row and column as 0) at B=3: every dx written, rel < 2e-2 and
    >= 99.9% within one bf16 ulp of the port's plain dgrad (f32 sums) and
    of the GEMM view."""
    s = dataclasses.replace(SPECS[name], H=size, W=size)
    x, w, b, g = _tie_inputs(s, seed=500 + size + R, batch=3)
    w, b = _bf16(w), _bf16(b)
    dz = _route_np(_bf16(_bf16(_acc64(x, w, s)) + b), g, s, False)
    got = _emulate_dgrad(dz, w, s, R)
    tdz = torch.from_numpy(dz.astype(np.float32)).to(torch.bfloat16)
    for ref in (dgrad_plain(tdz, torch.from_numpy(w).to(torch.bfloat16), s).float().numpy(),
                _dgrad_gemm(dz, w, s)):
        assert not np.isnan(got).any()
        assert _rel_err(got, ref) < REL_TOL, name
        assert _ulp_share(got, ref) >= 0.999, name


class _WGeom:
    """conv_block_bwd.cu's ``WGeom<G>``, G the forward's geometry unpooled."""

    def __init__(self, s: ConvSpec):
        self.G = G = _Geom(dataclasses.replace(s, pool=False))
        self.SS = 8 if G.ROW else G.CS
        self.MH = 16 if G.ROW else 8
        self.MF = 4 if G.CO == 32 else 2
        self.NF = G.KP // 16
        need = -(-self.NF // self.MF)
        self.KG = -(-need // 8)
        self.WARPS = -(-need // self.KG)
        self.DS = G.WS

    @staticmethod
    def tile_rows(Wd, R):
        return -(-R * Wd // 16) * 16


def _emulate_wgrad(x, dz, dbpart, s: ConvSpec, R: int, P: int):
    """wgrad_kernel with band height R and P position splits on KG * P
    CTAs, then wgrad_reduce_kernel: (dw, db, part)."""
    WG = _WGeom(s)
    G = WG.G
    n, (Hd, Wd) = x.shape[0], _dz_grid(s)
    xv = _x_values(x, s)
    hwc, pitch = G.halo_cols(Wd), G.halo_pitch(Wd)
    NB = -(-Hd // R)
    dzf = dz.reshape(n, Hd * Wd, s.Co)
    part = np.full((P, G.KP, s.Co), np.nan)
    bw = (((_LANE & 7) + ((_LANE >> 3) & 1) * 8) * WG.DS + (_LANE >> 4) * 8) * 2
    for cta in range(WG.KG * P):
        kg, ps = cta % WG.KG, cta // WG.KG
        acc = np.zeros((WG.WARPS, WG.MF, G.NJ, 32, 4))
        for item in range(ps, n * NB, P):
            bi, r0 = item // NB, (item % NB) * R
            rows = min(R, Hd - r0)
            units = rows * Wd
            nrows = rows + G.KH - 1
            hs = np.full(nrows * pitch * WG.SS, np.nan)
            for hr in range(nrows):
                iy = r0 - G.PH + hr
                for hc in range(hwc):
                    for half in range(2 if G.ROW else 1):  # row mode: pixel pairs
                        ix = hc - G.PW + half
                        val = xv[bi, iy, ix] if 0 <= iy < s.H and 0 <= ix < s.W else 0.0
                        at = (hr * pitch + hc) * WG.SS + half * 4
                        hs[at: at + G.CI] = val
            dzs = np.full(WG.tile_rows(Wd, R) * WG.DS, np.nan)
            for u in range(WG.tile_rows(Wd, rows)):
                dzs[u * WG.DS: u * WG.DS + s.Co] = dzf[bi, r0 * Wd + u] if u < units else 0.0
            u0 = np.arange(0, units, 16)
            fb = [_ldsm(dzs, bw[None] + (u0[:, None] * WG.DS + jj * 16) * 2, trans=True)
                  for jj in range(G.NJ // 2)]
            u = np.minimum(u0[:, None] + (_LANE >> 4) * 8 + (_LANE & 7), units - 1)
            at = (((u // Wd) * pitch + u % Wd) * WG.SS + ((_LANE >> 3) & 1) * WG.MH) * 2
            for warp in range(WG.WARPS):
                mf0 = (kg * WG.WARPS + warp) * WG.MF
                for i in range(WG.MF):
                    mf = mf0 + i
                    if mf >= WG.NF:
                        continue
                    if G.ROW:
                        toff = ((mf >> 1) * pitch + (mf & 1) * 4) * WG.SS * 2
                    else:
                        tap, c = divmod(mf * 16, G.CI)
                        ky, kx = divmod(tap, G.KW)
                        toff = ((ky * pitch + kx) * WG.SS + c) * 2
                    fa = _ldsm(hs, at + toff, trans=True)
                    for jj in range(G.NJ // 2):
                        for jn, (b0, b1) in enumerate([(0, 1), (2, 3)]):
                            step = np.zeros((len(u0), 32, 4))
                            _mma(step, fa, fb[jj][:, :, b0], fb[jj][:, :, b1])
                            acc[warp, i, 2 * jj + jn] += step.sum(0)
        for warp in range(WG.WARPS):
            mf0 = (kg * WG.WARPS + warp) * WG.MF
            for i in range(WG.MF):
                if mf0 + i >= WG.NF:
                    continue
                for j in range(G.NJ):
                    for h in range(2):
                        kp = (mf0 + i) * 16 + _G + 8 * h
                        for e in range(2):
                            part[ps, kp, 8 * j + 2 * _T + e] = acc[warp, i, j, :, 2 * h + e]
    # wgrad_reduce_kernel: every element's partials in order, in f32
    k = np.arange(s.kh * s.kw * s.Ci)
    kp = (k // (s.kw * s.Ci)) * G.KROW + k % (s.kw * s.Ci) if G.ROW else k
    dw = np.zeros((k.size, s.Co), np.float32)
    for p in range(P):
        dw += part[p, kp].astype(np.float32)
    db = np.zeros((s.Co,), np.float32)
    for p in range(dbpart.shape[0]):
        db += dbpart[p]
    return _bf16(dw).reshape(s.kh, s.kw, s.Ci, s.Co), _bf16(db), part


_WGRAD = [("block0_uint8", 10, 3, 2), ("block0", 9, 4, 3), ("block1", 10, 3, 2),
          ("block2", 9, 8, 1), ("block2", 9, 3, 4), ("block3", 7, 2, 3)]


@pytest.mark.parametrize("name,size,R,P", _WGRAD,
                         ids=[f"{n}-{hw}-R{r}-P{p}" for n, hw, r, p in _WGRAD])
def test_wgrad_emulated_matches_the_plain_weight_gradient(name, size, R, P):
    """The wgrad's indexing at B=3 (the pixel-pair halo of Ci = 4, K split
    over warps and CTAs, positions over bands and P splits, the ragged last
    k16 step, the fixed-order reduction): every partial written, dw rel <
    2e-2 and >= 99.9% within one bf16 ulp of the port's plain wgrad (f32
    sums) and of the GEMM view; db the partials' sum."""
    s = dataclasses.replace(SPECS[name], H=size, W=size)
    x, w, b, g = _tie_inputs(s, seed=600 + size + R, batch=3)
    w, b = _bf16(w), _bf16(b)
    dz = _route_np(_bf16(_bf16(_acc64(x, w, s)) + b), g, s, name.startswith("block0"))
    flat = dz.reshape(-1, s.Co).astype(np.float32)
    dbpart = np.stack([flat[:7].sum(0), flat[7:].sum(0)])  # the route's, any split
    dw, db, part = _emulate_wgrad(x, dz, dbpart, s, R, P)
    assert not np.isnan(part).any()
    tx = _torch_args(x, w, b)[0]
    tdz = torch.from_numpy(dz.astype(np.float32)).to(torch.bfloat16)
    dw_plain, db_plain = wgrad_plain(tx, tdz, torch.from_numpy(dbpart), s)
    for ref in (dw_plain.float().numpy(), _wgrad_gemm(x, dz, s)[0]):
        assert _rel_err(dw, ref) < REL_TOL, name
        assert _ulp_share(dw, ref) >= 0.999, name
    assert np.array_equal(db, db_plain.float().numpy())


def test_wgrad_split_covers_every_k_fragment_once():
    """At full width: the K fragments, split MF per warp, WARPS per CTA and
    KG CTAs along K, cover every fragment once, and the accumulators a
    thread holds stay at 64 (the register budget)."""
    for name in ("block0", "block1", "block2", "block3"):
        WG = _WGeom(SPECS[name])
        owned = [(kg * WG.WARPS + w) * WG.MF + i for kg in range(WG.KG)
                 for w in range(WG.WARPS) for i in range(WG.MF)]
        owned = [m for m in owned if m < WG.NF]
        assert sorted(owned) == list(range(WG.NF)), name
        assert WG.WARPS <= 8 and WG.MF * WG.G.NJ * 4 == 64, name
        assert WG.G.KP == cb._kp(SPECS[name]), name
    assert [(_WGeom(SPECS[n]).KG, _WGeom(SPECS[n]).WARPS)
            for n in ("block0", "block1", "block2", "block3")] == [(1, 3), (2, 7), (2, 8), (3, 6)]


# -- the wrappers and the entry points ----------------------------------------


def test_backward_geometries_are_those_the_entry_points_instantiate():
    """conv_block_bwd.cu's route and wgrad dispatch the forward's four
    geometries (uint8 for block 0's), its dgrad exactly DGRAD_GEOMETRIES."""
    with open(os.path.join(_build.CSRC, "conv_block_bwd.cu")) as fh:
        src = fh.read()

    def dispatched(fn):
        body = src[src.index(f'extern "C" int {fn}('):]
        body = body[: body.index("\n}\n")]
        return {(int(k), int(k), int(ci), int(co), p == "true")
                for k, ci, co, p in re.findall(r"is\((\d+), (\d+), (\d+), (true|false)\)\)", body)}

    forward = set(cb.KERNEL_GEOMETRIES)
    assert dispatched("ba3c_conv_block_route") == forward
    assert dispatched("ba3c_conv_block_wgrad") == forward
    assert dispatched("ba3c_conv_block_dgrad") == DGRAD_GEOMETRIES
    assert DGRAD_GEOMETRIES == {k for k in forward if k[2] != 4}
    for fn in ("ba3c_conv_block_route", "ba3c_conv_block_dgrad", "ba3c_conv_block_wgrad"):
        assert fn in _build._SIGNATURES["conv_block_bwd"]


def test_a_plain_without_a_kernel_rule_raises():
    """The backward's kernels know two tie rules; another plain block (one
    that differentiates otherwise) has no kernel and raises, on the CPU's
    path through the route wrapper as on the card's."""
    s = SPECS["block1"]
    tx, tw, tb = _torch_args(*_tie_inputs(s, seed=7)[:3])
    tg = torch.zeros((B, s.Ho, s.Wo * s.Co), dtype=torch.bfloat16)
    other = lambda *a, **k: reference_block(*a, **k)
    with pytest.raises(ValueError, match="tie rules"):
        conv_block_route(tx, tw, tb, tg, s, other)
    with pytest.raises(ValueError, match="tie rules"):
        cb._tie_rule(other)
    assert cb._tie_rule(reference_block) == 0 and cb._tie_rule(flax_block) == 1


def test_backward_wrappers_refuse_a_device_without_a_path():
    s = SPECS["block1"]
    x, w, b = (t.to("meta") for t in _torch_args(*_tie_inputs(s, seed=8)[:3]))
    g = torch.zeros((B, s.Ho, s.Wo * s.Co), dtype=torch.bfloat16, device="meta")
    dz = torch.zeros((B, *_dz_grid(s), s.Co), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        conv_block_route(x, w, b, g, s)
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        conv_block_dgrad(dz, w, s)
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        conv_block_wgrad(x, dz, torch.zeros((1, s.Co), device="meta"), s)


def test_library_path_tracks_the_headers(tmp_path, monkeypatch):
    """An edited header (conv_block.cuh holds the shared mainloop) gives a
    new library name, so it is rebuilt."""
    (tmp_path / "k.cu").write_text('#include "k.cuh"\n')
    (tmp_path / "k.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "out"))
    first = _build.library_path("k")
    (tmp_path / "k.cuh").write_text("// two\n")
    assert _build.library_path("k") != first

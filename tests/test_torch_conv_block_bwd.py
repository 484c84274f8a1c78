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
  tests/test_torch_conv_block.py's ``_emulate_kernel``: the route's halo
  planes, tile pairs (a pool window in one thread's registers), weights
  read through their descriptor, dz staging box and db partials; the
  dgrad's weight panels laid out from
  the forward's HWIO w (the flip in the load), its swapped pads and block
  2's zero 21st row and column; the wgrad's swizzled dz tile, pixel-pair
  halo, K split over a CTA's warpgroups, contiguous runs of items and
  cluster sums; wgmma's descriptor reads and accumulator layout as modelled
  by ``_desc_read`` and ``_epilogue_lanes``; at ragged B and band heights.
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
    _Geom,
    _jax_spec,
    _jax_vjp,
    _ldsm,
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


#: (block, tie rule): the pallas model's rules (flax's for block 0,
#: reference_block's for 1-3), and flax's for blocks 1-3 (the default xla
#: model's), block 2's pool of 21 rows among them
GEMM_CASES = [("block0", True), ("block1", False), ("block2", False), ("block3", False),
              ("block2", True), ("block1", True), ("block3", True)]


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


def _pool_route_lanes(z, gv, flax):
    """conv_block_bwd.cu's pool_route over arrays: z [4, ...] (q = 2 * row +
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


class _RGeom:
    """conv_block_bwd.cu's ``RGeom<G, WGS>``, G the forward's geometry."""

    STAGES = 3

    def __init__(self, s: ConvSpec, wgs=None):
        self.G = G = _Geom(s)
        self.U = G.U
        self.NP = 4 if s.pool else 1
        self.SB = 16 if G.ROW else s.Ci * 2
        self.N = s.Co
        self.KSTEPS = G.KP // 16
        self.DROW = s.Co * 2
        self.SWZ = 1 if s.Co == 64 else 2
        self.KGROUP = 8 * self.DROW
        self.MT = 32 if s.pool else 64
        self.NT = 2 if s.pool else 1
        # the entry point's choice: three, but two for block 2
        self.WGS = wgs or (2 if (s.Ci, s.Co) == (32, 64) else 3)
        self.CW = 4 * self.WGS
        self.W_BYTES = -(-G.KP * self.DROW // 1024) * 1024

    def halo_rows(self, R):
        return self.U * R + self.G.KH - 1

    def plane_rows(self, R):
        return (self.halo_rows(R) + 1) // 2 if self.G.POOL else self.halo_rows(R)

    def plane_cols(self, W):
        c = self.G.halo_cols(W)
        return (c + 1) // 2 if self.G.POOL else c

    def pitch(self, W):
        """Slots a plane row: plane_cols padded to W / U mod 8."""
        c = self.plane_cols(W)
        return c + ((W // self.U - c) & 7)

    def plane_bytes(self, W, R):
        return -(-self.plane_rows(R) * self.pitch(W) * self.SB // 1024) * 1024

    def staging_bytes(self, W, R):
        return -(-self.U * R * (W // self.U * self.U) * self.DROW // 1024) * 1024

    def row_offset(self, u, v):
        """Row u's 16-byte chunk v in a box of DROW-byte rows, swizzled as
        TMA lays it out (the g box, the dz staging box, the weights)."""
        phase = (u & 7) if self.N == 64 else ((u >> 1) & 3)
        return u * self.DROW + ((v ^ phase) << 4)


def _route_weights(w, RG: _RGeom) -> np.ndarray:
    """The route's weights as the kernel loads them from HWIO w: B[kp][co]
    at row_offset(kp, co // 8), Ci = 4's kernel rows padded to KROW with
    zeros; the rest of the buffer NaN."""
    G = RG.G
    ws = np.full(RG.W_BYTES // 2, np.nan)
    wf = np.asarray(w, np.float64).reshape(-1, RG.N)
    for kp in range(G.KP):
        src, valid = kp, True
        if G.ROW:
            ky, j = divmod(kp, G.KROW)
            valid = j < G.KW * G.CI
            src = ky * G.KW * G.CI + j if valid else 0
        for v in range(RG.N // 8):
            o = RG.row_offset(kp, v) // 2
            ws[o: o + 8] = wf[src, v * 8: v * 8 + 8] if valid else 0.0
    return ws


def _route_b(ws, RG: _RGeom, ks: int) -> np.ndarray:
    """B of k step ks [16, Co]: wgmma's read of the weights through the
    MN-major descriptor."""
    return _desc_read(ws, ks * 16 * RG.DROW, RG.KGROUP, RG.KGROUP, RG.SWZ, RG.N, True)


def _strided(a, r0, c0, rows, cols, step):
    """a [H, W, C] at rows r0, r0 + step, .. and columns c0, c0 + step, ..
    (rows x cols of them), zero outside: a TMA box with a traversal
    stride."""
    out = np.zeros((rows, cols, a.shape[2]))
    for i in range(rows):
        iy = r0 + step * i
        if 0 <= iy < a.shape[0]:
            for j in range(cols):
                ix = c0 + step * j
                if 0 <= ix < a.shape[1]:
                    out[i, j] = a[iy, ix]
    return out


def _route_halo(xb, RG: _RGeom, R: int, y0: int) -> np.ndarray:
    """A stage's halo as the kernel lays it out from one sample xb [H, W,
    Ci] (bf16 values), halo row 0 at input row y0: pooled, the four (row
    parity, column parity) planes, each a TMA box with traversal stride 2
    (Ci = 4: the producers' pixel pairs, slot column hc holding pixels
    hc - PW and hc - PW + 1); else one TMA box. The rest NaN."""
    G = RG.G
    H, W = xb.shape[:2]
    pitch, prows, pb = RG.pitch(W), RG.plane_rows(R), RG.plane_bytes(W, R)
    mem = np.full(RG.NP * pb // 2, np.nan)
    if G.ROW:
        for p in range(RG.NP):
            for pr in range(prows):
                iy = y0 + 2 * pr + (p >> 1)
                for pc in range(RG.plane_cols(W)):
                    at = (p * pb + (pr * pitch + pc) * 16) // 2
                    for h in range(2):
                        ix = 2 * pc + (p & 1) - G.PW + h
                        inside = 0 <= iy < H and 0 <= ix < W
                        mem[at + 4 * h: at + 4 * h + 4] = xb[iy, ix] if inside else 0.0
        return mem
    step = 2 if G.POOL else 1
    for p in range(RG.NP):
        box = _strided(xb, y0 + (p >> 1), -G.PW + (p & 1), prows, pitch, step)
        mem[p * pb // 2: (p + 1) * pb // 2] = _tma_box(box, prows, pitch, RG.SB)
    return mem


def _route_a_addr(RG: _RGeom, q: int, units: int, W: int, pb: int, f: int, ks: int):
    """route_kernel's a_addr: the byte address (from the stage's halo) that
    lane l of warp wl gives ldmatrix for tile f of the band's tile q at k
    step ks, [4 warps, 32 lanes]. Rows past the band take its last window
    (position)."""
    G = RG.G
    WO, pitch = W // RG.U, RG.pitch(W)
    wl, lane = np.arange(4)[:, None], _LANE[None, :]
    if G.POOL:
        v = np.minimum(q * 32 + 8 * wl + (lane & 7), units - 1)
        uy, ux, h = v // WO, v % WO, (lane >> 3) & 1
        if G.ROW:  # kernel row ky, pixel pairs 2 sp and 2 sp + 1 of its slot columns
            ky, sp = divmod(ks, 2)
            row = uy + ((f + ky) >> 1)
            return (h * pb + ((f + ky) & 1) * 2 * pb
                    + (row * pitch + ux + 2 * sp + (lane >> 4)) * 16)
        tap, cc = divmod(ks, G.CI // 16)
        ky, kx = divmod(tap, G.KW)
        cp, col = (h + kx) & 1, ux + ((h + (kx & 1)) >> 1) + (kx >> 1)
        slot = (uy + ((f + ky) >> 1)) * pitch + col
        return cp * pb + ((f + ky) & 1) * 2 * pb + _swizzled(slot, 2 * cc + (lane >> 4), RG.SB)
    v = np.minimum(q * 64 + 16 * wl + (lane & 15), units - 1)
    tap, cc = divmod(ks, G.CI // 16)
    ky, kx = divmod(tap, G.KW)
    return _swizzled(v // W * pitch + v % W + ky * pitch + kx, 2 * cc + (lane >> 4), RG.SB)


def _route_tiles(RG: _RGeom, n_items: int, NB: int, R: int, HO: int, WO: int, grid: int):
    """route_kernel's schedule: for each CTA (a contiguous run of items)
    and item, (bi, r0, units, [(warpgroup, tile), ..]): the band's tiles
    round-robin over the warpgroups, counted across the CTA's items."""
    out = []
    for cta in range(grid):
        done, run = 0, []
        for item in range(n_items * cta // grid, n_items * (cta + 1) // grid):
            bi, r0 = item // NB, item % NB * R
            units = min(R, HO - r0) * WO
            tiles = -(-units // RG.MT)
            run.append((bi, r0, units, [(wg, q) for wg in range(RG.WGS)
                                        for q in range((wg - done) % RG.WGS, tiles, RG.WGS)]))
            done += tiles
        out.append(run)
    return out


def _emulate_route(x, w, b, g, s: ConvSpec, R: int, grid: int, flax: bool, wgs=None):
    """route_kernel with band height R on ``grid`` CTAs: dz [n, Hd, Wd, Co]
    (what the TMA stores write out of each band's staging box) and the db
    partials [grid, Co]. Per tile: A by ldmatrix from the halo planes, B
    through the weights' descriptor, the accumulators through wgmma's
    layout; the route on the registers (a thread's window across the tile
    pair), dz into the swizzled staging box, g from the stage's box; every
    db sum in the kernel's f32 order (a thread's tiles in order, the xor
    butterfly over the 8 lanes of a channel pair, the warps of a warpgroup,
    then the warpgroups)."""
    RG = _RGeom(s, wgs)
    G = RG.G
    n, nj = x.shape[0], RG.N // 8
    HO, WO = s.H // RG.U, s.W // RG.U
    Hd, Wd = HO * RG.U, WO * RG.U
    xv = _x_values(x, s)
    gq = g.reshape(n, HO, WO, s.Co).astype(np.float64)
    ws = _route_weights(w, RG)
    bsteps = [_route_b(ws, RG, ks) for ks in range(RG.KSTEPS)]
    pb = RG.plane_bytes(s.W, R)
    NB = -(-HO // R)
    dz = np.full((n, Hd * Wd, s.Co), np.nan)
    dbs = np.zeros((grid, RG.CW, 32, nj, 2), np.float32)
    relu_d = lambda z: np.where(z > 0, 1.0, np.where((z == 0) & (not flax), 0.5, 0.0))
    for cta, run in enumerate(_route_tiles(RG, n * NB, NB, R, HO, WO, grid)):
        for bi, r0, units, tiles in run:
            hs = _route_halo(xv[bi], RG, R, RG.U * r0 - G.PH)
            gs = _tma_box(_strided(gq[bi], r0, 0, R, WO, 1), R, WO, RG.DROW)
            stg = np.full(RG.staging_bytes(s.W, R) // 2, np.nan)
            for wg, q in tiles:
                acc = np.zeros((RG.NT, 64, RG.N))
                for ks in range(RG.KSTEPS):
                    for f in range(RG.NT):
                        a = _frag16(_ldsm(hs, _route_a_addr(RG, q, units, s.W, pb, f, ks)))
                        acc[f] += a.reshape(64, 16) @ bsteps[ks]
                regs = np.zeros((RG.NT, 4, RG.N // 2, 32))  # [tile, warp, register, lane]
                for idx, (row, col) in enumerate(_epilogue_lanes(RG.N)):
                    i, wl = divmod(idx, 4)
                    regs[:, wl, i] = acc[:, row, col]
                for wl in range(4):
                    warp = 4 * wg + wl
                    for h in range(1 if G.POOL else 2):
                        # pooled: the thread's window; else its position
                        v = q * 32 + 8 * wl + _G if G.POOL else q * 64 + 16 * wl + _G + 8 * h
                        ok = v < units
                        vc = np.where(ok, v, 0)
                        for j in range(nj):
                            for e in range(2):
                                c = 8 * j + 2 * _T + e
                                pre = lambda a: _bf16(_bf16(a) + b[c])
                                gv = gs[RG.row_offset(vc, j) // 2 + 2 * _T + e]
                                if G.POOL:
                                    z = np.stack([pre(regs[qq >> 1, wl, 4 * j + 2 * (qq & 1) + e])
                                                  for qq in range(4)])
                                    d = _pool_route_lanes(z, gv, flax)
                                    uy, ux = vc // WO, vc % WO
                                    u = [(2 * uy + (qq >> 1)) * Wd + 2 * ux + (qq & 1)
                                         for qq in range(4)]
                                else:
                                    d = (gv * relu_d(pre(regs[0, wl, 4 * j + 2 * h + e])))[None]
                                    u = [vc]
                                for dq, uq in zip(d, u):
                                    stg[(RG.row_offset(uq, j) // 2 + 2 * _T + e)[ok]] = dq[ok]
                                    dq32 = np.where(ok, dq, 0).astype(np.float32)
                                    dbs[cta, warp, :, j, e] += dq32
            # the TMA store: the box's rows inside dz (the rest clipped)
            for u in range(min(RG.U * R, Hd - RG.U * r0) * Wd):
                for v in range(nj):
                    o = RG.row_offset(u, v) // 2
                    dz[bi, RG.U * r0 * Wd + u, v * 8: v * 8 + 8] = stg[o: o + 8]
    for o in (4, 8, 16):  # __shfl_xor_sync
        dbs = dbs + dbs[:, :, _LANE ^ o]
    red = np.zeros((grid, RG.CW, s.Co), np.float32)
    for j in range(nj):
        for e in range(2):
            red[:, :, 8 * j + 2 * _T[:4] + e] = dbs[:, :, :4, j, e]
    dbpart = np.zeros((grid, s.Co), np.float32)
    for k in range(RG.WGS):  # the warps of a warpgroup, then the warpgroups
        part = np.zeros((grid, s.Co), np.float32)
        for i in range(4):
            part += red[:, 4 * k + i]
        dbpart += part
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
    """route_kernel lane by lane at B=3 on tie inputs: dz bit-exact
    against the GEMM view's route of the float64 sums (every dz element
    stored, block 2's 9th row and column never formed), and the CTAs' db
    partials adding up to db."""
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


#: blocks 1-3 under flax's rule, the JAX CLI model's: small frames, ragged
#: bands, grids with several items per CTA
_FLAX_ROUTE = [("block1", 10, 3, 2), ("block2", 11, 2, 3), ("block3", 8, 3, 2)]


@pytest.mark.parametrize("name,size,R,grid", _FLAX_ROUTE,
                         ids=[f"{n}-{hw}-R{r}-grid{gr}" for n, hw, r, gr in _FLAX_ROUTE])
def test_route_epilogue_emulated_takes_flax_rule_as_jax_does(name, size, R, grid):
    """route_kernel under flax's rule (relu'(0) = 0, the window's first
    maximum), lane by lane on blocks 1-3 at B=3 on tie inputs: dz bit-exact
    against jax.vjp of flax's nn.relu + nn.max_pool at JAX's own
    pre-activations. x on a grid of 1/8 and w of 1/64 make every partial
    sum exact in f32, so JAX's pre-activations are the kernel's."""
    s = dataclasses.replace(SPECS[name], H=size, W=size)
    x, w, b, g = _tie_inputs(s, seed=500 + size + R, batch=3)
    x, w, b = np.round(x * 8) / 8, np.round(w * 64) / 64, _bf16(b)
    relu_ties, pool_ties = _count_ties(x, w, b, s)
    assert relu_ties > 50 and (pool_ties > 20 or not s.pool), (relu_ties, pool_ties)
    z_jax, dz_jax = _jax_dz(x, w, b, g, s, True)
    assert np.array_equal(_bf16(_bf16(_acc64(x, w, s)) + b), z_jax)
    dz, dbpart = _emulate_route(x, w, b, g, s, R, grid, True)
    assert not np.isnan(dz).any()
    assert np.array_equal(dz, dz_jax), name
    assert np.abs(dz_jax).sum() > 0
    np.testing.assert_allclose(dbpart.sum(0), dz_jax.sum(axis=(0, 1, 2)), rtol=1e-5, atol=1e-5)


#: wider frames, where a band holds several tiles and 8 windows of an
#: ldmatrix wrap an output row; three warpgroups on block 0, two on block 1
_ROUTE_WIDE = [("block0", 20, 3, 2, 3), ("block1", 26, 3, 3, 2), ("block2", 21, 4, 2, 3),
               ("block3", 18, 5, 3, 2)]


@pytest.mark.parametrize("name,size,R,grid,wgs", _ROUTE_WIDE,
                         ids=[f"{n}-{hw}-R{r}-grid{gr}-wgs{k}" for n, hw, r, gr, k in _ROUTE_WIDE])
def test_route_emulated_with_several_tiles_a_band(name, size, R, grid, wgs):
    """route_kernel at B=2 where bands hold several tile pairs shared
    round-robin by the warpgroups, tiles wrap output rows and the padded
    plane rows take the wrap: dz bit-exact against the GEMM view's route
    under flax's rule, db partials adding up."""
    s = dataclasses.replace(SPECS[name], H=size, W=size)
    x, w, b, g = _tie_inputs(s, seed=800 + size + R, batch=2)
    w, b = _bf16(w), _bf16(b)
    dz, dbpart = _emulate_route(x, w, b, g, s, R, grid, True, wgs)
    ref = _route_np(_bf16(_bf16(_acc64(x, w, s)) + b), g, s, True)
    assert not np.isnan(dz).any()
    assert np.array_equal(dz, ref), name
    np.testing.assert_allclose(dbpart.sum(0), ref.sum(axis=(0, 1, 2)), rtol=1e-5, atol=1e-5)


def _dgrad_spec(s: ConvSpec) -> ConvSpec:
    """The dgrad as a conv of the kernel's: Co in, Ci out, unpooled."""
    return ConvSpec(H=s.H, W=s.W, Ci=s.Co, Co=s.Ci, kh=s.kh, kw=s.kw, pool=False,
                    scale_uint8=False)


def _frag16(a) -> np.ndarray:
    """The m16 x k16 matrix of each warp from its lanes' registers [n, 32, 4,
    2], in mma.sync's A layout (which wgmma takes for an A in registers,
    warp w giving rows 16w .. 16w + 15 of the m64 tile): [n, 16, 16]."""
    A = np.zeros((a.shape[0], 16, 16))
    for i, (ro, ko) in enumerate([(0, 0), (8, 0), (0, 8), (8, 8)]):
        for e in range(2):
            A[:, _G + ro, 2 * _T + ko + e] = a[:, :, i, e]
    return A


#: a descriptor's layout -> (bytes of a swizzle row, mask of the row phase)
_SWIZZLE = {1: (128, 7), 2: (64, 3)}


def _desc_read(mem, start, lbo, sbo, layout, n, mn_major) -> np.ndarray:
    """B [16, n] (k16 x N) as wgmma reads it from shared memory ``mem`` (bf16
    values; byte address // 2) through a descriptor, by the canonical
    layouts: groups of 8 rows SBO bytes apart, a row one swizzle row long;
    K-major rows are n with k along the row, MN-major rows are k with n
    along the row (MN panels LBO apart). The swizzle XORs an address's
    16-byte chunk (bits 4-6) with its row phase (bits 7-9)."""
    row, mask = _SWIZZLE[layout]
    k, nn = np.arange(16)[:, None], np.arange(n)[None, :]
    if mn_major:
        per = row // 2
        addr = start + (k // 8) * sbo + (k % 8) * row + (nn // per) * lbo + (nn % per) * 2
    else:
        addr = start + (nn // 8) * sbo + (nn % 8) * row + k * 2
    return mem[(addr ^ (((addr >> 7) & mask) << 4)) // 2]


def _epilogue_lanes(n_cols):
    """wgmma's accumulator layout: for each register i and warp wl of the
    warpgroup, the rows and columns its 32 lanes hold in the m64 x N tile."""
    for i in range(n_cols // 2):
        for wl in range(4):
            yield (16 * wl + _G + 8 * ((i >> 1) & 1)), 8 * (i >> 2) + 2 * _T + (i & 1)


class _DGeom:
    """conv_block_bwd.cu's ``DGeom<G>``, G the dgrad's geometry (Co in, Ci
    out, the swapped pads)."""

    STAGES = 3

    def __init__(self, s: ConvSpec):
        self.G = G = _Geom(_dgrad_spec(s), ph=s.kh - 1 - s.ph, pw=s.kw - 1 - s.pw)
        self.WGS = 3 if s.Ci == 32 else 2  # the entry point's choice: 3 for blocks 1-2
        self.N = G.CO
        self.KSTEPS = G.KP // 16
        self.PANELS = -(-G.KP // 64)
        self.PANEL = self.N * 128
        self.W_BYTES = self.PANELS * self.PANEL
        self.SB = G.CI * 2  # bytes of a halo slot (a dz pixel's channels)

    def halo_rows(self, R):
        return R + self.G.KH - 1

    def stage_bytes(self, W, R):
        return -(-self.halo_rows(R) * self.G.halo_cols(W) * self.SB // 1024) * 1024

    def w_offset(self, k, n):
        """Byte offset of B[k][n] (k a multiple of 8): K-major 64-wide
        panels of N rows, the 16-byte chunks XORed with the row mod 8."""
        return (k >> 6) * self.PANEL + n * 128 + ((((k & 63) >> 3) ^ (n & 7)) << 4)


def _swizzled(slot, c, sb):
    """conv_block_bwd.cu's ``swizzled<SB>``: the byte offset of 16-byte chunk
    c of a slot of ``sb`` bytes in a TMA box laid out with that swizzle."""
    phase = (slot & 7) if sb == 128 else ((slot >> 1) & 3)
    return slot * sb + ((c ^ phase) << 4)


def _tma_box(src, rows, cols, sb) -> np.ndarray:
    """A TMA box as the kernels read it: pixel (hr, hc) of ``src`` [rows,
    cols, C] (zeros already in place outside the tensor) at slot hr * cols
    + hc, its 16-byte chunks swizzled; the rest of the stage NaN."""
    mem = np.full(-(-rows * cols * sb // 1024) * 1024 // 2, np.nan)
    for hr in range(rows):
        for hc in range(cols):
            for c in range(sb // 16):
                o = _swizzled(hr * cols + hc, c, sb) // 2
                mem[o: o + 8] = src[hr, hc, c * 8: c * 8 + 8]
    return mem


def _padded(a, r0, c0, rows, cols) -> np.ndarray:
    """a [H, W, C] cut to rows r0 .. r0 + rows - 1 and columns c0 .. c0 +
    cols - 1, zero outside: what a TMA box at (r0, c0) reads."""
    out = np.zeros((rows, cols, a.shape[2]))
    for hr in range(rows):
        iy = r0 + hr
        if 0 <= iy < a.shape[0]:
            lo, hi = max(0, c0), min(a.shape[1], c0 + cols)
            if lo < hi:
                out[hr, lo - c0: hi - c0] = a[iy, lo:hi]
    return out


def _dgrad_weights(w, D: _DGeom) -> np.ndarray:
    """The dgrad's weight panels as the kernel loads them from the forward's
    HWIO w: B[k = (tap, c)][n] = w[KH-1-ky][KW-1-kx][n][c]."""
    G = D.G
    taps, CV = G.KH * G.KW, G.CI // 8
    ws = np.full(D.W_BYTES // 2, np.nan)
    wsrc = np.asarray(w).reshape(taps, D.N, G.CI)
    for src_tap in range(taps):
        for nn in range(D.N):
            for v in range(CV):
                o = D.w_offset((taps - 1 - src_tap) * G.CI + v * 8, nn) // 2
                ws[o: o + 8] = wsrc[src_tap, nn, v * 8: v * 8 + 8]
    return ws


def _emulate_dgrad(dz, w, s: ConvSpec, R: int) -> np.ndarray:
    """dgrad_kernel with band height R: the weights laid out from the
    forward's HWIO w (the tap flip and the Ci/Co swap in the load), each
    item's dz halo (dz's grid Hd x Wd the input, the forward's input grid H
    x W the output, pads k-1-(k-1)//2), each warpgroup's 64-position tiles
    (A by ldmatrix from the halo, B through the K-major descriptor), and
    the epilogue through wgmma's accumulator layout, rounded to bf16."""
    D = _DGeom(s)
    G = D.G
    n, (Hd, Wd), H, W = dz.shape[0], _dz_grid(s), s.H, s.W
    ws = _dgrad_weights(w, D)
    bsteps = [_desc_read(ws, (ks >> 2) * D.PANEL + (ks & 3) * 32, 16, 1024, 1, D.N, False)
              for ks in range(D.KSTEPS)]
    hwc = G.halo_cols(W)
    NB = -(-H // R)
    dzv = dz.reshape(n, Hd, Wd, G.CI)
    dx = np.full((n, H * W, D.N), np.nan)
    for item in range(n * NB):
        bi, r0 = item // NB, (item % NB) * R
        rows = min(R, H - r0)
        units = rows * W
        # the TMA box: halo_rows(R) rows from r0 - PH, columns from -PW
        hs = _tma_box(_padded(dzv[bi], r0 - G.PH, -G.PW, D.halo_rows(R), hwc),
                      D.halo_rows(R), hwc, D.SB)
        tiles = -(-units // 64)
        # lane l of warp wl: position tile * 64 + 16 wl + (l & 15), chunk (l >> 4)
        u = (np.arange(tiles)[:, None, None] * 64 + 16 * np.arange(4)[None, :, None]
             + (_LANE & 15)[None, None, :]).reshape(-1, 32)
        u = np.minimum(u, units - 1)
        slot0 = (u // W) * hwc + u % W
        acc = np.zeros((tiles, 64, D.N))
        for ks in range(D.KSTEPS):
            c, tap = ks % (G.CI // 16), ks // (G.CI // 16)
            ky, kx = divmod(tap, G.KW)
            a = _frag16(_ldsm(hs, _swizzled(slot0 + ky * hwc + kx, 2 * c + (_LANE >> 4), D.SB)))
            acc += a.reshape(tiles, 64, 16) @ bsteps[ks]
        for row, col in _epilogue_lanes(D.N):
            uo = np.arange(tiles)[:, None] * 64 + row[None]
            ok = uo < units
            dx[bi, (r0 * W + uo)[ok], np.broadcast_to(col, uo.shape)[ok]] = _bf16(acc[:, row, col][ok])
    return dx.reshape(n, H, W * D.N)


_DGRAD = [("block1", 10, 3), ("block1", 6, 6), ("block2", 9, 2), ("block2", 11, 4),
          ("block3", 7, 2), ("block3", 10, 10), ("block1", 13, 5)]


@pytest.mark.parametrize("name,size,R", _DGRAD, ids=[f"{n}-{hw}-R{r}" for n, hw, r in _DGRAD])
def test_dgrad_emulated_matches_the_plain_input_gradient(name, size, R):
    """The dgrad's indexing (the flipped weights laid out from HWIO w, the
    pads swapped to k-1-(k-1)//2, dz's grid as the input: block 2's pooled
    9 -> 8 reads the 9th row and column as 0; ragged 64-position tiles) at
    B=3: every dx written, rel < 2e-2 and >= 99.9% within one bf16 ulp of
    the port's plain dgrad (f32 sums) and of the GEMM view."""
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


_DGRAD_JAX = [("block1", 6), ("block2", 4), ("block3", 10)]


@pytest.mark.parametrize("name,R", _DGRAD_JAX, ids=[f"{n}-R{r}" for n, r in _DGRAD_JAX])
def test_dgrad_emulated_from_hwio_w_matches_jax_input_gradient(name, R):
    """At full frame size on tie inputs, the dgrad's emulation reading the
    forward's HWIO w directly (no flipped copy) from JAX's own dz: equal to
    the port's plain dgrad within one bf16 ulp (>= 99.9%), and within 2e-2
    of max|ref| of JAX's input gradient (jax.vjp of conv_block, the Pallas
    forward in interpret mode)."""
    s = SPECS[name]
    x, w, b, g = _tie_inputs(s, seed=700 + R, batch=B)
    w, b = _bf16(w), _bf16(b)
    _, dz = _jax_dz(x, w, b, g, s, False)
    got = _emulate_dgrad(dz, w, s, R)
    assert not np.isnan(got).any()
    tdz = torch.from_numpy(dz).to(torch.bfloat16)
    plain = dgrad_plain(tdz, torch.from_numpy(w).to(torch.bfloat16), s).float().numpy()
    assert _ulp_share(got, plain) >= 0.999, name
    js = _jax_spec(s)
    ref = _jax_vjp(lambda xx, ww, bb: jconv.conv_block(xx, ww, bb, js, True), x, w, b, g, s)
    assert _rel_err(got, ref["x"]) < REL_TOL, name


class _WGeom:
    """conv_block_bwd.cu's ``WGeom<G>``, G the forward's geometry unpooled."""

    STAGES = 3
    CL = 2

    def __init__(self, s: ConvSpec):
        self.G = G = _Geom(dataclasses.replace(s, pool=False))
        self.SB = 16 if G.ROW else G.CI * 2  # a pixel pair, or a TMA box's pixel
        self.PAIRS = -(-s.kw // 2)  # row mode: pixel pairs a kernel row
        self.CHUNKS = s.kh * self.PAIRS  # row mode: 8-row chunks of K
        self.KP = -(-self.CHUNKS * 8 // 64) * 64 if G.ROW else G.KP
        self.NF = self.KP // 16
        self.TILES = -(-self.NF // 4)
        self.WGS = min(3, self.TILES)
        self.THREADS = 128 * self.WGS
        self.TPW = -(-self.TILES // self.WGS)
        self.AD = 3 if self.TPW <= 3 else 2
        self.NACC = G.CO // 2
        self.DROW = G.CO * 2
        self.SWZ = 1 if G.CO == 64 else 2
        self.KGROUP = 8 * self.DROW

    def tile_pos(self, Wd, R):
        """Positions a stage holds: whole rotations of the A ring (AD k16
        steps)."""
        return -(-R * Wd // (16 * self.AD)) * 16 * self.AD

    def dz_bytes(self, Wd, R):
        return self.tile_pos(Wd, R) * self.DROW

    def halo_rows(self, R):
        return R + self.G.KH - 1

    def dz_offset(self, u, v):
        """The dz tile's byte offset of position u, channels 8v .. 8v + 7."""
        phase = (u & 7) if self.G.CO == 64 else ((u >> 1) & 3)
        return u * self.DROW + ((v ^ phase) << 4)

    def tap(self, mf, half, pitch):
        """The rows of fragment mf's 8-row ``half``: (slot offset from a
        position's slot, 16-byte chunk); ``pitch`` the halo's slots a row.
        Row mode: chunk 2 mf + half, pixel pair p of kernel row ky."""
        G = self.G
        if G.ROW:
            ky, p = divmod(min(2 * mf + half, self.CHUNKS - 1), self.PAIRS)
            return ky * pitch + 2 * p, 0
        tap, c = divmod(mf * 16, G.CI)
        ky, kx = divmod(tap, G.KW)
        return ky * pitch + kx, c // 8 + half

    def kp_of(self, k):
        """The K row of weight k = (ky * KW + kx) * CI + ci."""
        G = self.G
        if not G.ROW:
            return k
        ky, kx, ci = k // (G.KW * G.CI), k // G.CI % G.KW, k % G.CI
        return (ky * self.PAIRS + kx // 2) * 8 + (kx % 2) * G.CI + ci


def _emulate_wgrad(x, dz, dbpart, s: ConvSpec, R: int, P: int):
    """wgrad_kernel with band height R on P clusters of CL CTAs, each CTA a
    contiguous run of items with all of K (a stage: the swizzled dz tile,
    then the x halo; A by ldmatrix.trans, B through the MN-major
    descriptor), each CTA's sums through wgmma's accumulator layout, the
    cluster's partial in rank order, then wgrad_reduce_kernel's fixed order:
    (dw, db, part)."""
    WG = _WGeom(s)
    G = WG.G
    n, (Hd, Wd) = x.shape[0], _dz_grid(s)
    xv = _x_values(x, s)
    hwc = G.halo_cols(Wd)
    pitch = G.halo_pitch(Wd) if G.ROW else hwc  # the pair halo, or the TMA box
    NB = -(-Hd // R)
    dzf = dz.reshape(n, Hd * Wd, s.Co)
    grid, n_items = WG.CL * P, n * NB
    # each fragment's rows, lane by lane: lanes (l >> 3) & 1 give the second 8
    half = (_LANE >> 3) & 1
    taps = [[WG.tap(min(mf, WG.NF - 1), h, pitch) for h in half] for mf in range(4 * WG.TILES)]
    toff = np.array([[tp[0] for tp in row] for row in taps])
    tch = np.array([[tp[1] for tp in row] for row in taps])
    red = np.full((grid, WG.KP, s.Co), np.nan, np.float32)
    for cta in range(grid):
        acc = np.zeros((WG.TILES, 64, s.Co))
        for item in range(n_items * cta // grid, n_items * (cta + 1) // grid):
            bi, r0 = item // NB, (item % NB) * R
            rows = min(R, Hd - r0)
            units = rows * Wd
            # the dz tile: the TMA box of R rows (zero past dz's last row), then
            # zeros up to a whole k16 pair
            tile = np.full(WG.dz_bytes(Wd, R) // 2, np.nan)
            for u in range(WG.tile_pos(Wd, R)):
                for v in range(s.Co // 8):
                    o = WG.dz_offset(u, v) // 2
                    tile[o: o + 8] = dzf[bi, r0 * Wd + u, v * 8: v * 8 + 8] if u < units else 0.0
            if G.ROW:  # the pixel pairs (hc - PW, hc - PW + 1), expanded from x's rows
                hs = np.full(WG.halo_rows(R) * pitch * 8, np.nan)
                for hr in range(rows + G.KH - 1):
                    iy = r0 - G.PH + hr
                    for hc in range(hwc):
                        for half in range(2):
                            ix = hc - G.PW + half
                            val = xv[bi, iy, ix] if 0 <= iy < s.H and 0 <= ix < s.W else 0.0
                            at = (hr * pitch + hc) * 8 + half * 4
                            hs[at: at + G.CI] = val
            else:  # the TMA box: halo_rows(R) rows from r0 - PH, columns from -PW
                hs = _tma_box(_padded(xv[bi], r0 - G.PH, -G.PW, WG.halo_rows(R), hwc),
                              WG.halo_rows(R), hwc, WG.SB)
            for ks in range(WG.tile_pos(Wd, rows) // 16):
                u = np.minimum(ks * 16 + (_LANE >> 4) * 8 + (_LANE & 7), units - 1)
                slot = ((u // Wd) * pitch + u % Wd)[None] + toff
                at = slot * 16 if G.ROW else _swizzled(slot, tch, WG.SB)
                a = _frag16(_ldsm(hs, at, trans=True))
                bm = _desc_read(tile, ks * 16 * WG.DROW, WG.KGROUP, WG.KGROUP, WG.SWZ, s.Co, True)
                acc += a.reshape(WG.TILES, 64, 16) @ bm
        for tile in range(WG.TILES):
            for row, col in _epilogue_lanes(s.Co):
                kp = tile * 64 + row
                ok = kp < WG.KP
                red[cta, kp[ok], col[ok]] = acc[tile, row[ok], col[ok]]
    part = np.zeros((P, WG.KP, s.Co), np.float32)
    for c in range(P):
        for r in range(WG.CL):  # rank order
            part[c] += red[c * WG.CL + r]
    # wgrad_reduce_kernel: 8 contiguous runs of the partials, each added in
    # order, then the runs' sums in run order, in f32; db the same way
    def in_runs(parts):
        n = len(parts)
        runs = [sum((parts[p] for p in range(n * r // 8, n * (r + 1) // 8)),
                    np.zeros_like(parts[0])) for r in range(8)]
        out = runs[0]
        for r in runs[1:]:
            out = out + r
        return out

    kp = np.array([WG.kp_of(k) for k in range(s.kh * s.kw * s.Ci)])
    dw = in_runs([part[p, kp] for p in range(P)])
    db = in_runs([dbpart[p].astype(np.float32) for p in range(dbpart.shape[0])])
    return _bf16(dw).reshape(s.kh, s.kw, s.Ci, s.Co), _bf16(db), part


_WGRAD = [("block0_uint8", 10, 3, 2), ("block0", 9, 4, 3), ("block1", 10, 3, 2),
          ("block2", 9, 8, 1), ("block2", 9, 3, 4), ("block3", 7, 2, 3),
          ("block3", 10, 10, 1), ("block1", 12, 5, 3)]


@pytest.mark.parametrize("name,size,R,P", _WGRAD,
                         ids=[f"{n}-{hw}-R{r}-P{p}" for n, hw, r, p in _WGRAD])
def test_wgrad_emulated_matches_the_plain_weight_gradient(name, size, R, P):
    """The wgrad's indexing at B=3 (the pixel-pair halo of Ci = 4, K split
    over the warpgroups' m64 tiles, positions over bands and P clusters of
    contiguous runs, the swizzled dz tile, the ragged last k16 pair, the
    cluster sums and the fixed-order reduction): every partial written, dw
    rel < 2e-2 and >= 99.9% within one bf16 ulp of the port's plain wgrad
    (f32 sums) and of the GEMM view; db the partials' sum."""
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
    """At full width: the K fragments, one a warp of an m64 tile, the tiles
    round-robin over the CTA's warpgroups (no K split across CTAs; each
    warpgroup compiled for its own count), cover every fragment once, and
    block 0's chunks (pixel pairs of a kernel row) cover every real weight
    once; the accumulators and the A fragments in flight that a thread
    holds stay within the register budget of one CTA an SM (168 a thread
    at 384 threads)."""
    for name in ("block0", "block1", "block2", "block3"):
        s = SPECS[name]
        WG = _WGeom(s)
        counts = [(WG.TILES - wg + WG.WGS - 1) // WG.WGS for wg in range(WG.WGS)]
        assert set(counts) <= {WG.TPW, WG.TPW - 1} and sum(counts) == WG.TILES, name
        owned = [(wg + WG.WGS * i) * 4 + wl for wg in range(WG.WGS) for i in range(counts[wg])
                 for wl in range(4)]
        owned = [m for m in owned if m < WG.NF]
        assert sorted(owned) == list(range(WG.NF)), name
        assert WG.TPW * (WG.NACC + 4 * WG.AD) <= 136 and 65536 // WG.THREADS >= 168, name
        assert WG.KP == cb._kp(s), name
        kps = [WG.kp_of(k) for k in range(s.kh * s.kw * s.Ci)]
        assert len(set(kps)) == len(kps) and max(kps) < WG.KP, name
    assert [(_WGeom(SPECS[n]).TILES, _WGeom(SPECS[n]).TPW)
            for n in ("block0", "block1", "block2", "block3")] == [(2, 1), (13, 5), (8, 3), (9, 3)]


_ROUNDS = [("block1", u) for u in (1, 63, 64, 126, 252, 256, 441, 504)] + [
    ("block3", u) for u in (30, 100, 300)]


@pytest.mark.parametrize("name,units", _ROUNDS, ids=[f"{n}-{u}" for n, u in _ROUNDS])
def test_dgrad_rounds_cover_every_tile_once(name, units):
    """The dgrad's tiles: warpgroup wg takes the 64-position tiles wg, wg +
    WGS, .. of a band; over the warpgroups every tile is taken once, and no
    warpgroup takes more than one more than another."""
    D = _DGeom(SPECS[name])
    ntiles = -(-units // 64)
    taken = [list(range(wg, ntiles, D.WGS)) for wg in range(D.WGS)]
    assert sorted(t for ts in taken for t in ts) == list(range(ntiles))
    assert max(map(len, taken)) - min(map(len, taken)) <= 1


@pytest.mark.parametrize("name", ["block1", "block2", "block3"])
def test_dgrad_weight_panels_read_back_the_flipped_weights(name):
    """The dgrad's weight layout and its descriptors: over all k16 steps,
    wgmma's reads of the panels written from HWIO w give B[k = (tap of the
    flipped kernel, dz channel)][ci] = w[KH-1-ky][KW-1-kx][ci][co], each
    weight read once."""
    s = SPECS[name]
    D = _DGeom(s)
    G = D.G
    w = np.arange(s.kh * s.kw * s.Ci * s.Co, dtype=np.float64).reshape(s.kh, s.kw, s.Ci, s.Co)
    ws = _dgrad_weights(w, D)
    got = np.concatenate([_desc_read(ws, (ks >> 2) * D.PANEL + (ks & 3) * 32, 16, 1024, 1,
                                     D.N, False) for ks in range(D.KSTEPS)])
    want = w[::-1, ::-1].transpose(0, 1, 3, 2).reshape(-1, s.Ci)
    assert np.array_equal(got, want)
    assert got.size == w.size == np.unique(got).size


@pytest.mark.parametrize("name", ["block0", "block1", "block2", "block3"])
def test_wgrad_dz_tile_reads_back_the_positions(name):
    """The wgrad's dz tile (cp.async's 16-byte chunks at the swizzled
    offsets) read through the MN-major descriptors of its k16 steps gives
    dz's positions in order, every written element once; the tile and the
    halo start on 1024-byte boundaries, as the swizzle's row phase needs."""
    s = SPECS[name]
    WG = _WGeom(s)
    Hd, Wd = _dz_grid(s)
    R = 3
    npos = WG.tile_pos(Wd, R)
    mem = np.full(WG.dz_bytes(Wd, R) // 2, np.nan)
    vals = np.arange(npos * s.Co, dtype=np.float64).reshape(npos, s.Co)
    for u in range(npos):
        for v in range(s.Co // 8):
            o = WG.dz_offset(u, v) // 2
            mem[o: o + 8] = vals[u, v * 8: v * 8 + 8]
    got = np.concatenate([_desc_read(mem, ks * 16 * WG.DROW, WG.KGROUP, WG.KGROUP, WG.SWZ,
                                     s.Co, True) for ks in range(npos // 16)])
    assert np.array_equal(got, vals)
    assert WG.dz_bytes(Wd, R) % 1024 == 0


_ROUTE_ROUNDS = [("block0", 84, 3, 4), ("block0", 84, 4, 3), ("block1", 42, 3, 5),
                 ("block1", 42, 4, 3), ("block2", 21, 3, 7), ("block2", 21, 4, 2),
                 ("block3", 10, 6, 3), ("block3", 10, 4, 5)]


@pytest.mark.parametrize("name,size,R,grid", _ROUTE_ROUNDS,
                         ids=[f"{n}-{hw}-R{r}-grid{gr}" for n, hw, r, gr in _ROUTE_ROUNDS])
def test_route_tiles_cover_every_window_once(name, size, R, grid):
    """route_kernel's schedule at B=3 (contiguous runs of items, tiles
    round-robin over the warpgroups across a CTA's items): every window
    (position) of every band, the ragged last band included, is stored by
    exactly one thread once, every dz position of the band once; A's rows
    stay inside their band; a CTA's warpgroups differ by at most one tile."""
    s = dataclasses.replace(SPECS[name], H=size, W=size)
    RG = _RGeom(s)
    HO, WO = s.H // RG.U, s.W // RG.U
    Wd = WO * RG.U
    NB = -(-HO // R)
    stored = np.zeros((3, HO * WO), int)
    dz_hits = np.zeros((3, HO * RG.U * Wd), int)
    for run in _route_tiles(RG, 3 * NB, NB, R, HO, WO, grid):
        per_wg = np.zeros(RG.WGS, int)
        for bi, r0, units, tiles in run:
            for wg, q in tiles:
                per_wg[wg] += 1
                rows_a = (np.arange(RG.MT)[:, None] if RG.G.POOL else np.arange(64)[:, None])
                assert (np.minimum(q * RG.MT + rows_a, units - 1) < units).all()
                for wl in range(4):
                    for h in range(1 if RG.G.POOL else 2):
                        v = (q * 32 + 8 * wl + _G) if RG.G.POOL else (q * 64 + 16 * wl + _G + 8 * h)
                        v = v[v < units]
                        stored[bi, r0 * WO + v] += 1
                        if RG.G.POOL:
                            for qq in range(4):
                                u = (2 * (v // WO) + (qq >> 1)) * Wd + 2 * (v % WO) + (qq & 1)
                                dz_hits[bi, 2 * r0 * Wd + u] += 1
                        else:
                            dz_hits[bi, r0 * WO + v] += 1
        assert per_wg.max() - per_wg.min() <= 1, per_wg
    assert (stored == 1).all() and (dz_hits == 1).all()


@pytest.mark.parametrize("name", ["block0", "block1", "block2", "block3"])
def test_route_weight_panels_read_back_the_hwio_weights(name):
    """The route's weights as loaded from the forward's HWIO w, read through
    the MN-major descriptors of its k16 steps: B[k = (ky, kx, ci)][co] =
    w[ky][kx][ci][co] unflipped, Ci = 4's kernel rows padded to KROW = 32
    with zeros (the forward's 10 k16 steps), each weight read once."""
    s = SPECS[name]
    RG = _RGeom(s)
    w = 1.0 + np.arange(s.kh * s.kw * s.Ci * s.Co, dtype=np.float64).reshape(s.kh, s.kw, s.Ci, s.Co)
    got = np.concatenate([_route_b(_route_weights(w, RG), RG, ks) for ks in range(RG.KSTEPS)])
    want = w.reshape(s.kh, s.kw * s.Ci, s.Co)
    if RG.G.ROW:
        pad = np.zeros((s.kh, RG.G.KROW - s.kw * s.Ci, s.Co))
        want = np.concatenate([want, pad], axis=1)
    assert np.array_equal(got, want.reshape(-1, s.Co))
    assert np.unique(got[got != 0]).size == w.size
    assert RG.KSTEPS == {"block0": 10, "block1": 50, "block2": 32, "block3": 36}[name]


@pytest.mark.parametrize("name", ["block0", "block1", "block2", "block3"])
def test_route_dz_staging_box_reads_back_as_the_wgrad_reads_dz(name):
    """The dz staging box as the route's epilogue writes it (4 bytes a
    thread at row_offset of each window position), written out by the TMA
    store, then read as the wgrad reads a band of dz (WGeom::dz_offset of
    its TMA box): every position's channels in place; the box a whole
    number of 1024-byte swizzle periods."""
    s = SPECS[name]
    RG, WG = _RGeom(s), _WGeom(s)
    WO, R = s.W // RG.U, 3
    Wd = WO * RG.U
    vals = 1.0 + np.arange(RG.U * R * Wd * s.Co, dtype=np.float64).reshape(-1, s.Co)
    stg = np.full(RG.staging_bytes(s.W, R) // 2, np.nan)
    for v in range(R * WO):  # each thread's window (position), all channel pairs
        for qq in range(4 if RG.G.POOL else 1):
            u = ((2 * (v // WO) + (qq >> 1)) * Wd + 2 * (v % WO) + (qq & 1)) if RG.G.POOL else v
            for j in range(s.Co // 8):
                at = RG.row_offset(u, j) // 2 + 2 * _T
                stg[at], stg[at + 1] = vals[u, 8 * j + 2 * _T], vals[u, 8 * j + 2 * _T + 1]
    # the TMA store writes the box out row-major; the wgrad's box of the same
    # rows lands at WGeom::dz_offset
    out = np.stack([np.concatenate([stg[RG.row_offset(u, v) // 2: RG.row_offset(u, v) // 2 + 8]
                                    for v in range(s.Co // 8)]) for u in range(len(vals))])
    tile = np.full(WG.dz_bytes(Wd, RG.U * R) // 2, np.nan)
    for u in range(len(vals)):
        for v in range(s.Co // 8):
            o = WG.dz_offset(u, v) // 2
            tile[o: o + 8] = out[u, v * 8: v * 8 + 8]
    back = np.stack([np.concatenate([tile[WG.dz_offset(u, v) // 2: WG.dz_offset(u, v) // 2 + 8]
                                     for v in range(s.Co // 8)]) for u in range(len(vals))])
    assert np.array_equal(out, vals) and np.array_equal(back, vals)
    n = len(vals) * RG.DROW // 2  # the same bytes: one layout
    assert np.array_equal(stg[:n], tile[:n])
    assert RG.staging_bytes(s.W, R) % 1024 == 0


@pytest.mark.parametrize("name", ["block0", "block1", "block2", "block3"])
def test_route_ldmatrix_rows_fall_on_distinct_banks(name):
    """At full frame size, over every tile of a whole sample's band and
    every k step, each ldmatrix phase of route_kernel's A (8 rows of 16
    bytes) is one wavefront: a pooled tile's 8 windows, 2 pixels apart in
    the image, are 8 consecutive slots of a parity plane, and the plane
    rows padded to WO mod 8 slots keep a row wrap on the bank sequence (so
    do block 3's rows, padded to W mod 8)."""
    from test_torch_conv_block import _wavefronts

    s = SPECS[name]
    RG = _RGeom(s)
    HO, WO = s.H // RG.U, s.W // RG.U
    units, pb = HO * WO, RG.plane_bytes(s.W, HO)
    waves = np.concatenate([
        _wavefronts(_route_a_addr(RG, q, units, s.W, pb, f, ks).reshape(-1), 16)
        for q in range(-(-units // RG.MT)) for f in range(RG.NT) for ks in range(RG.KSTEPS)])
    assert (waves == 1).all(), (name, waves.mean())


@pytest.mark.parametrize("name", ["block0", "block1", "block2"])
def test_route_tile_pair_takes_tile_0s_fragments_a_kernel_row_later(name):
    """What route_kernel's fragment reuse rests on: in a pooled tile pair,
    tile 1's A at kernel row ky (its windows' bottom pre-pool rows) is
    tile 0's A at kernel row ky + 1, lane by lane and step by step, at
    every tile of a band that wraps output rows (the kernel loads each
    once, and 2 of every 2 * KH fragments become KH + 1)."""
    s = SPECS[name]
    RG = _RGeom(s)
    HO, WO = s.H // RG.U, s.W // RG.U
    R = 3
    units, pb = R * WO, RG.plane_bytes(s.W, R)
    spr = RG.KSTEPS // s.kh  # k steps a kernel row
    for q in range(-(-units // RG.MT)):
        for ks in range(RG.KSTEPS - spr):
            assert np.array_equal(_route_a_addr(RG, q, units, s.W, pb, 1, ks),
                                  _route_a_addr(RG, q, units, s.W, pb, 0, ks + spr))
        assert not np.array_equal(_route_a_addr(RG, q, units, s.W, pb, 1, 0),
                                  _route_a_addr(RG, q, units, s.W, pb, 0, 0))


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


# -- chip_smoke.py's test of a route that differs from cuDNN's -----------------


def _route_at(acc, b, g, s, relu, pool):
    """dz of ``pool(relu(acc + b))`` at a given bf16 pre-bias sum ``acc``."""
    Hd, Wd = _dz_grid(s)
    with torch.enable_grad():
        a = acc.detach().requires_grad_(True)
        y = relu(a + b.to(torch.bfloat16)[:, None, None])
        if s.pool:
            y = pool(y[:, :, : 2 * s.Ho, : 2 * s.Wo])
        (dz,) = torch.autograd.grad(cb._flatten(y, s), a, g)
    return dz[:, :, :Hd, :Wd].permute(0, 2, 3, 1).contiguous()


def _rules(plain):
    """(relu, pool) of ``plain``'s tie rule."""
    if plain is flax_block:
        return torch.relu, lambda y: torch.nn.functional.max_pool2d(y, 2)

    def amax_pool(y):
        n, c, h, w = y.shape
        return y.reshape(n, c, h // 2, 2, w // 2, 2).amax(dim=5).amax(dim=3)

    return (lambda z: torch.maximum(z, torch.zeros((), dtype=z.dtype))), amax_pool


@pytest.mark.parametrize("case", range(7), ids=lambda i: f"case{i}")
def test_rounding_flip_check_tells_a_rounding_from_a_rule_fault(case):
    """chip_smoke.py's ``rounding_flips`` on random inputs: a route whose
    pre-bias sums come from another f32 order (the exact sum moved by less
    than the check's delta) gates a few elements otherwise than the plain
    route, and each is explained; a route whose relu takes gradient 1 at
    z == 0 (a tie-rule fault, as sparse as exact zeros are) is refused,
    at a dz share far under DZ_MISMATCH."""
    import chip_smoke

    i, s, plain, _ = chip_smoke.bwd_cases()[case]
    nb = {0: 32, 1: 16, 2: 32, 3: 128}[i]
    x, w, b, g = chip_smoke.bwd_inputs(s, nb, "random", "cpu", seed=100 * i + nb)
    dz_ref, _ = cb.route_plain(x, w, b, g, s, plain)
    relu, pool = _rules(plain)
    acc = cb._conv(x, w, s, torch.float64)
    # the check's delta is 16 units; the other order moves each sum by < 15
    unit = 2.0 ** -24 * cb._conv(x.abs(), w.abs(), s, torch.float64)
    shift = (torch.rand(acc.shape, generator=torch.Generator().manual_seed(case),
                        dtype=torch.float64) * 2 - 1) * 15 * unit
    other_order = (acc + shift).float().to(torch.bfloat16)
    n, explained = chip_smoke.rounding_flips(
        x, w, b, s, _route_at(other_order, b, g, s, relu, pool), dz_ref, plain)
    assert n > 0 and explained

    def relu_fault(z):  # gradient 1 at z == 0
        return torch.where(z >= 0, z, torch.zeros((), dtype=z.dtype))

    faulty = _route_at(cb._conv(x, w, s, torch.bfloat16), b, g, s, relu_fault, pool)
    n, explained = chip_smoke.rounding_flips(x, w, b, s, faulty, dz_ref, plain)
    assert n > 0 and not explained
    assert n / dz_ref.numel() < chip_smoke.DZ_MISMATCH


def test_rounding_flip_check_takes_uint8_frames_as_the_blocks_scale_them():
    """``rounding_flips`` on block 0's uint8 frames (chip_smoke.py's
    ``[bwd]`` holds the route's uint8 path against route_plain with it):
    the exact sums are taken over the frames as the blocks see them, uint8
    times bf16(1/255) rounded once, so a route from another f32 order of
    those sums is explained, and a relu that takes gradient 1 at 0 is not."""
    import chip_smoke

    s = cb.ba3c_specs()[0]
    gen = torch.Generator().manual_seed(11)
    x = torch.randint(0, 256, (16, s.H, s.W * s.Ci), generator=gen, dtype=torch.uint8)
    _, w, b, g = chip_smoke.bwd_inputs(s, 16, "random", "cpu", seed=11)
    dz_ref, _ = cb.route_plain(x, w, b, g, s, flax_block)
    relu, pool = _rules(flax_block)
    xv = (x.to(torch.bfloat16) * torch.tensor(INV255, dtype=torch.bfloat16)).to(torch.float64)
    sf = dataclasses.replace(s, scale_uint8=False)
    acc = cb._conv(xv, w, sf, torch.float64)
    unit = 2.0 ** -24 * cb._conv(xv.abs(), w.abs(), sf, torch.float64)
    shift = (torch.rand(acc.shape, generator=torch.Generator().manual_seed(5),
                        dtype=torch.float64) * 2 - 1) * 15 * unit
    other_order = (acc + shift).float().to(torch.bfloat16)
    n, explained = chip_smoke.rounding_flips(
        x, w, b, s, _route_at(other_order, b, g, s, relu, pool), dz_ref, flax_block)
    assert n > 0 and explained

    def relu_fault(z):  # gradient 1 at z == 0
        return torch.where(z >= 0, z, torch.zeros((), dtype=z.dtype))

    faulty = _route_at(cb._conv(x, w, s, torch.bfloat16), b, g, s, relu_fault, pool)
    n, explained = chip_smoke.rounding_flips(x, w, b, s, faulty, dz_ref, flax_block)
    assert n > 0 and not explained

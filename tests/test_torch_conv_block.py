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
    KERNEL_GEOMETRIES,
    conv_block_fwd,
    flax_block,
    kernel_instantiated,
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


def _ulp_share(got: np.ndarray, ref: np.ndarray) -> float:
    """Share of elements within one bf16 ulp of the larger magnitude."""
    mag = np.maximum(np.maximum(np.abs(got), np.abs(ref)), 2.0 ** -126)
    ulp = np.exp2(np.floor(np.log2(mag)) - 7)
    return float(np.mean(np.abs(got - ref) <= ulp))


def _bf16(a: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16).float().numpy()


def _im2col_block(x, w, b, s: ConvSpec) -> np.ndarray:
    """The GEMM view csrc/conv_block.cu computes, as an explicit im2col.

    M is the pre-pool positions the output needs (2*Ho x 2*Wo when pooled:
    block 2's 21st row and column are never formed), K = kh*kw*Ci ordered
    (ky, kx, ci) so that the flattened HWIO weight is the [K, Co] matrix,
    and the input is zero-padded SAME (top/left (k-1)//2). For Ci = 4 K runs
    by kernel rows: each row's kw*Ci values padded to 32 with zero weights,
    the extra A values being the pixels to the right. Then the sum rounded
    to bf16, the bias added in bf16, relu, and the 2x2 max."""
    n = x.shape[0]
    if s.scale_uint8:
        inv255 = float(torch.tensor(1.0 / 255.0, dtype=torch.bfloat16))
        x = _bf16(x.astype(np.float32) * inv255)
    x = x.reshape(n, s.H, s.W, s.Ci).astype(np.float32)
    mh, mw = (2 * s.Ho, 2 * s.Wo) if s.pool else (s.H, s.W)
    row_mode = s.Ci % 16 != 0
    krow = -(-s.kw * s.Ci // 16) * 16 if row_mode else s.kw * s.Ci
    extra = -(-(krow - s.kw * s.Ci) // s.Ci) if row_mode else 0
    xp = np.zeros((n, mh + s.kh - 1, mw + s.kw - 1 + extra, s.Ci), np.float32)
    rows, cols = min(s.H, mh + s.kh - 1 - s.ph), min(s.W, mw + s.kw - 1 + extra - s.pw)
    xp[:, s.ph : s.ph + rows, s.pw : s.pw + cols] = x[:, :rows, :cols]
    wk = w.reshape(s.kh, s.kw * s.Ci, s.Co)  # the HWIO weight as [K, Co], K by rows
    if row_mode:
        wk = np.concatenate(
            [wk, np.zeros((s.kh, krow - s.kw * s.Ci, s.Co), np.float32)], axis=1
        )
    cols_per_row = krow // s.Ci
    patches = np.stack(
        [
            xp[:, ky : ky + mh, kx : kx + mw]
            for ky in range(s.kh)
            for kx in range(cols_per_row)
        ],
        axis=3,
    ).reshape(n, mh, mw, s.kh * krow)
    acc = patches.reshape(-1, s.kh * krow) @ wk.reshape(s.kh * krow, s.Co)
    y = np.maximum(_bf16(_bf16(acc) + b), 0.0).reshape(n, mh, mw, s.Co)
    if s.pool:
        y = y.reshape(n, s.Ho, 2, s.Wo, 2, s.Co).max(axis=(2, 4))
    return y.reshape(n, s.Ho, s.Wo * s.Co)


@pytest.mark.parametrize("name,s", CASES, ids=[c[0] for c in CASES])
def test_gemm_view_matches_both_references(name, s):
    """The im2col product the kernel relies on (K = 100, 800, 512, 576;
    block 0 padded per kernel row to 160) against the port's and JAX's
    reference_block: rel < 2e-2 and >= 99.9% within one bf16 ulp."""
    x, w, b = _inputs(s, seed=80 + len(name))
    w, b = _bf16(w), _bf16(b)
    got = _im2col_block(x, w, b, s)
    ref_t = reference_block(*_torch_args(x, w, b), s).float().numpy()
    jx = jnp.asarray(x) if s.scale_uint8 else jnp.asarray(x, jnp.bfloat16)
    ref_j = np.asarray(
        jconv.reference_block(jx, jnp.asarray(w), jnp.asarray(b), _jax_spec(s)),
        np.float32,
    )
    for ref in (ref_t, ref_j):
        assert got.shape == ref.shape == (B, s.Ho, s.Wo * s.Co)
        assert _rel_err(got, ref) < REL_TOL, name
        assert _ulp_share(got, ref) >= 0.999, name


# -- the kernel's index math, emulated lane by lane ----------------------------
#
# A numpy mirror of csrc/conv_block.cuh: Geom, load_halo, conv_chunk (the
# ldmatrix lane addresses, the A/B fragments of mma.m16n8k16, the row-mode
# 32-bit A loads) and the epilogue, over the same shared-memory layout. It
# keeps the kernel's names, so an edit to the kernel's indexing is made here
# too; the card then checks the kernel itself (chip_smoke.py, the cuda tests).
# Shared memory is filled with NaN, so a read of a word the kernel never
# writes (a channel pad, the pad slot of a split halo row) reaches the output.

_LANE = np.arange(32)
_G, _T = _LANE >> 2, _LANE & 3


class _Geom:
    """conv_block.cuh's ``Geom<KH, KW, CI, CO, POOL, PH, PW>``."""

    def __init__(self, s: ConvSpec, ph=None, pw=None):
        self.KH, self.KW, self.CI, self.CO, self.POOL = s.kh, s.kw, s.Ci, s.Co, s.pool
        self.U = 2 if s.pool else 1
        self.PH = (s.kh - 1) // 2 if ph is None else ph
        self.PW = (s.kw - 1) // 2 if pw is None else pw
        self.ROW = s.Ci % 16 != 0
        self.KROW = (s.kw * s.Ci + 15) // 16 * 16
        self.KP = s.kh * self.KROW if self.ROW else s.kh * s.kw * s.Ci
        self.EXTRA = (self.KROW - s.kw * s.Ci + s.Ci - 1) // s.Ci if self.ROW else 0
        self.SPLIT = s.pool and not self.ROW
        self.CS = s.Ci if self.ROW else (s.Ci if (s.Ci // 8) % 2 else s.Ci + 8)
        self.WS = s.Co if (s.Co // 8) % 2 else s.Co + 8
        self.UPC = 8 if s.pool else 32
        self.NJ = s.Co // 8

    def halo_cols(self, W):
        return W + self.KW - 1 + self.EXTRA

    def halo_pitch(self, W):
        """Slots per halo row: at least halo_cols, and equal to W/U mod 8."""
        c = self.halo_cols(W)
        return c + ((W // self.U - c) & 7)

    def slot(self, hr, hc, pitch, plane):
        """The slot of halo pixel (hr, hc). Split: the even rows, then the
        odd ones from ``plane``; in a row, the even columns, then the odd
        ones from (pitch + 1) // 2."""
        if not self.SPLIT:
            return hr * pitch + hc
        return (hr & 1) * plane + (hr >> 1) * pitch + (hc & 1) * ((pitch + 1) >> 1) + (hc >> 1)


def _ldsm(mem, addr, trans=False):
    """ldmatrix.x4 (.trans): byte addresses per lane [n, 32] -> the four
    registers of each lane as bf16 pairs [n, 32, 4, 2]."""
    assert (addr % 16 == 0).all() and addr.min() >= 0
    i = np.arange(4)[None, :, None]
    e = np.arange(2)[None, None, :]
    t, q = _T[:, None, None], (_LANE >> 2)[:, None, None]
    if trans:  # lane T: rows 2t, 2t+1 of matrix i, column T // 4
        return mem[addr[:, 8 * i + 2 * t + e] // 2 + q]
    return mem[addr[:, 8 * i + q] // 2 + 2 * t + e]  # row T // 4, columns 2t, 2t+1


def _mma(acc, a, b0, b1):
    """acc [n, 32, 4] += A (16x16 from the lanes' a [n, 32, 4, 2]) times B
    (16x8 from b0, b1 [n, 32, 2]), in the m16n8k16 fragment layouts."""
    n = a.shape[0]
    A = np.zeros((n, 16, 16))
    Bm = np.zeros((n, 16, 8))
    for i, (ro, ko) in enumerate([(0, 0), (8, 0), (0, 8), (8, 8)]):
        for e in range(2):
            A[:, _G + ro, 2 * _T + ko + e] = a[:, :, i, e]
    for e in range(2):
        Bm[:, 2 * _T + e, _G] = b0[:, :, e]
        Bm[:, 2 * _T + 8 + e, _G] = b1[:, :, e]
    D = A @ Bm
    acc[:, :, 0:2] += D[:, _G[:, None], 2 * _T[:, None] + np.arange(2)]
    acc[:, :, 2:4] += D[:, _G[:, None] + 8, 2 * _T[:, None] + np.arange(2)]


def _a_pos(G, u0, units, WO, pitch, plane, f, row, par):
    """conv_chunk's ``pos``: the halo slot of A row ``row`` (0-15) of m
    fragment f at tap (0, par), for a whole row of chunks u0 at once."""
    if G.POOL:
        u = u0[:, None] + (row & 7)
    else:
        u = u0[:, None] + f * 16 + row
    u = np.where(u >= units, u0[:, None], u)
    uy, ux = u // WO, u % WO
    if G.POOL:
        return G.slot(2 * uy + f, 2 * ux + (row >> 3) + par, pitch, plane)
    return G.slot(uy, ux, pitch, plane)


def _emulate_mainloop(x, w, s: ConvSpec, R: int):
    """conv_block_kernel's loads and mainloop with band height R, item by
    item: yields (bi, r0, units, u0, acc), acc[f, j, chunk, lane, 4] the
    accumulators of every chunk u0 of the item. x as the kernel reads it
    (uint8 or bf16 values), w bf16 values."""
    G = _Geom(s)
    n, H, W = x.shape[0], s.H, s.W
    HO, WO = H // G.U, W // G.U
    NB = -(-HO // R)
    hwc, pitch = G.halo_cols(W), G.halo_pitch(W)
    scale = float(torch.tensor(1.0 / 255.0, dtype=torch.bfloat16))
    ws = np.full(G.KP * G.WS, np.nan)
    wf = w.reshape(-1, G.CO)
    for kp in range(G.KP):  # row mode pads each kernel row with zeros
        src, valid = kp, True
        if G.ROW:
            ky, j = divmod(kp, G.KROW)
            valid = j < G.KW * G.CI
            src = ky * G.KW * G.CI + j if valid else 0
        ws[kp * G.WS: kp * G.WS + G.CO] = wf[src] if valid else 0.0
    bw = (((_LANE & 7) + ((_LANE >> 3) & 1) * 8) * G.WS + (_LANE >> 4) * 8) * 2
    for item in range(n * NB):
        bi, r0 = item // NB, (item % NB) * R
        rows = min(R, HO - r0)
        units = rows * WO
        nrows = rows * G.U + G.KH - 1
        # load_halo: rows r0*U - PH .., columns -PW .., zero outside
        hs = np.full(nrows * pitch * G.CS, np.nan)
        plane = ((nrows + 1) >> 1) * pitch
        xs = x[bi].reshape(H, W, G.CI).astype(np.float64)
        if s.scale_uint8:
            xs = _bf16(xs * scale)
        for hr in range(nrows):
            iy = r0 * G.U - G.PH + hr
            for hc in range(hwc):
                ix = hc - G.PW
                inside = 0 <= iy < H and 0 <= ix < W
                p = G.slot(hr, hc, pitch, plane)
                hs[p * G.CS: p * G.CS + G.CI] = xs[iy, ix] if inside else 0.0
        # conv_chunk for every chunk of the band at once
        u0 = np.arange(0, units, G.UPC)
        acc = np.zeros((2, G.NJ, len(u0), 32, 4))
        steps = []  # (A fragments of f = 0, 1; k0)
        if not G.ROW:
            # a[f][par]: tap (0, par) of fragment f. Split, tap (ky, kx) of
            # f is a[(f + ky) & 1][kx & 1] plus (f + ky) >> 1 rows and
            # kx >> 1 slots; else a[f][0] plus ky rows and kx slots
            row, ch = _LANE & 15, (_LANE >> 4) * 8
            a = [[(_a_pos(G, u0, units, WO, pitch, plane, f, row,
                          par if G.SPLIT else 0) * G.CS + ch) * 2
                  for par in range(2)] for f in range(2)]
            for ky in range(G.KH):
                for kx in range(G.KW):
                    for c in range(G.CI // 16):
                        fa = []
                        for f in range(2):
                            q = f + ky
                            at = (a[q & 1][kx & 1] + ((q >> 1) * pitch + (kx >> 1)) * G.CS * 2
                                  if G.SPLIT else a[f][0] + (ky * pitch + kx) * G.CS * 2)
                            fa.append(_ldsm(hs, at + c * 32))
                        steps.append((fa, (ky * G.KW + kx) * G.CI + c * 16))
        else:
            p = [[_a_pos(G, u0, units, WO, pitch, plane, f, _G + 8 * h, 0) * G.CS + 2 * _T
                  for h in range(2)] for f in range(2)]
            for ky in range(G.KH):
                for kk in range(G.KROW // 16):
                    eo = ky * pitch * G.CS + kk * 16
                    fa = []
                    for f in range(2):
                        r = np.empty((len(u0), 32, 4, 2))
                        for i, (h, o) in enumerate([(0, 0), (1, 0), (0, 8), (1, 8)]):
                            idx = p[f][h] + eo + o
                            assert idx.min() >= 0
                            r[:, :, i, 0], r[:, :, i, 1] = hs[idx], hs[idx + 1]
                        fa.append(r)
                    steps.append((fa, ky * G.KROW + kk * 16))
        for fa, k0 in steps:
            for jj in range(G.NJ // 2):
                fb = _ldsm(ws, (bw + (k0 * G.WS + jj * 16) * 2)[None], trans=True)
                fb = np.broadcast_to(fb, (len(u0),) + fb.shape[1:])
                for f in range(2):
                    _mma(acc[f, 2 * jj], fa[f], fb[:, :, 0], fb[:, :, 1])
                    _mma(acc[f, 2 * jj + 1], fa[f], fb[:, :, 2], fb[:, :, 3])
        yield bi, r0, units, u0, acc


def _emulate_kernel(x, w, b, s: ConvSpec, R: int) -> np.ndarray:
    """conv_block_kernel with band height R, item by item; x as the kernel
    reads it (uint8 or bf16 values), w and b bf16 values."""
    G = _Geom(s)
    n = x.shape[0]
    HO, WO = s.H // G.U, s.W // G.U
    y = np.full((n, HO * WO, G.CO), np.nan)
    for bi, r0, units, u0, acc in _emulate_mainloop(x, w, s, R):
        # the epilogue: round, bias, relu, the 2x2 max; masked stores
        act = lambda v, bias: np.maximum(_bf16(_bf16(v) + bias), 0.0)
        yb = y[bi, r0 * WO:]
        for j in range(G.NJ):
            co = 8 * j + 2 * _T
            bias = np.stack([b[co], b[co + 1]], axis=-1)  # [32, 2]
            if G.POOL:
                m = np.zeros((len(u0), 32, 2))
                for f in range(2):
                    for h in range(2):
                        m = np.maximum(m, act(acc[f, j, :, :, 2 * h: 2 * h + 2], bias))
                u = u0[:, None] + _G
                ok = u < units
                yb[u[ok], co[None].repeat(len(u0), 0)[ok]] = m[ok][:, 0]
                yb[u[ok], co[None].repeat(len(u0), 0)[ok] + 1] = m[ok][:, 1]
            else:
                for f in range(2):
                    for h in range(2):
                        v = act(acc[f, j, :, :, 2 * h: 2 * h + 2], bias)
                        u = u0[:, None] + f * 16 + h * 8 + _G
                        ok = u < units
                        cols = co[None].repeat(len(u0), 0)[ok]
                        yb[u[ok], cols] = v[ok][:, 0]
                        yb[u[ok], cols + 1] = v[ok][:, 1]
    return y.reshape(n, HO, WO * G.CO)


#: small frames per case, each with band heights that leave a ragged last
#: band, a band of one row, and chunks that wrap an output row
_EMULATED = [
    ("block0_uint8", 12, (1, 4)),
    ("block0", 10, (2,)),
    ("block1", 10, (2, 5)),
    ("block2", 9, (3,)),  # 9 -> 4: the 9th row and column are never formed
    ("block3", 7, (3, 7)),
]


@pytest.mark.parametrize(
    "name,size,R", [(n, hw, r) for n, hw, rs in _EMULATED for r in rs],
    ids=[f"{n}-{hw}-R{r}" for n, hw, rs in _EMULATED for r in rs],
)
def test_kernel_index_math_emulated_matches_reference(name, size, R):
    """The lane-level emulation of csrc/conv_block.cu against the port's
    reference_block at B=3: rel < 2e-2 and >= 99.9% within one bf16 ulp,
    every output written, no uninitialised shared memory read."""
    s = dataclasses.replace(dict(CASES)[name], H=size, W=size)
    x, w, b = _inputs(s, seed=90 + size + R, batch=3)
    w, b = _bf16(w), _bf16(b)
    got = _emulate_kernel(x, w, b, s, R)
    ref = reference_block(*_torch_args(x, w, b), s).float().numpy()
    assert not np.isnan(got).any(), name
    assert got.shape == ref.shape
    assert _rel_err(got, ref) < REL_TOL, name
    assert _ulp_share(got, ref) >= 0.999, name


def _wavefronts(addr, width: int) -> np.ndarray:
    """Shared-memory wavefronts of each access of ``128 // width`` lanes
    reading ``width`` bytes each (an ldmatrix phase: 8 rows of 16 bytes; a
    32-bit load: 32 words): the most distinct such words on one bank."""
    rows = addr.reshape(-1, 128 // width)
    return np.array([np.bincount((np.unique(r) % 128) // width).max() for r in rows])


@pytest.mark.parametrize("name,s", CASES[1:], ids=[c[0] for c in CASES[1:]])
def test_kernel_shared_loads_fall_on_distinct_banks(name, s):
    """At full frame size, over a whole sample's chunks, every A and B
    shared-memory load of the kernel is one wavefront: no bank conflicts.
    The halo layout does it: a pooled window's 2-pixel stride would put two
    of an ldmatrix's 8 rows on one bank group, so the halo is split by row
    and column parity, and the row pitch is WO mod 8, so that a chunk that
    wraps to the next output row continues its bank sequence (the linear
    layout averaged 1.14, 2.25, 2.31 and 1.44 wavefronts on blocks 0-3)."""
    G = _Geom(s)
    HO, WO = s.H // G.U, s.W // G.U
    pitch = G.halo_pitch(s.W)
    plane = ((HO * G.U + G.KH) >> 1) * pitch  # one band of the whole sample
    u0 = np.arange(0, HO * WO, G.UPC)
    if G.ROW:
        for f in range(2):
            for h in range(2):
                p = _a_pos(G, u0, HO * WO, WO, pitch, plane, f, _G + 8 * h, 0) * G.CS + 2 * _T
                for o in (0, 8):
                    assert (_wavefronts((p + o) * 2, 4) == 1).all()
    else:
        row, ch = _LANE & 15, (_LANE >> 4) * 8
        waves = np.concatenate([
            _wavefronts((_a_pos(G, u0, HO * WO, WO, pitch, plane, f, row, par) * G.CS + ch) * 2, 16)
            for f in range(2) for par in range(2 if G.SPLIT else 1)
        ])
        assert (waves == 1).all(), (name, waves.mean())
    bw = (((_LANE & 7) + ((_LANE >> 3) & 1) * 8) * G.WS + (_LANE >> 4) * 8) * 2
    for k0 in range(0, G.KP, 16):
        assert (_wavefronts(bw + k0 * G.WS * 2, 16) == 1).all()


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


def test_kernel_geometries_are_those_the_entry_point_instantiates():
    """KERNEL_GEOMETRIES names exactly the (kh, kw, Ci, Co, pool) cases
    ba3c_conv_block_fwd dispatches (square kernels), uint8 where it takes
    it; every BA3C block is among them, at any frame size, and others not."""
    import os
    import re

    with open(os.path.join(_build.CSRC, "conv_block.cu")) as fh:
        src = fh.read()
    cases = re.findall(r"if \(is\((\d+), (\d+), (\d+), (true|false)\)\)(.*)", src)
    found = {(int(k), int(k), int(ci), int(co), p == "true"): "uint8_t" in rest
             for k, ci, co, p, rest in cases}
    # block 0's case opens a brace; its uint8 launch is on the next lines
    body = src[src.index("if (is(5, 4, 32, true))"):src.index("if (x_uint8) return")]
    found[(5, 5, 4, 32, True)] = "uint8_t" in body
    assert found == KERNEL_GEOMETRIES
    for size in (7, 16, 84, 96):
        assert all(kernel_instantiated(dataclasses.replace(s, H=size, W=size)) for _, s in CASES)
    narrow = ba3c_specs(conv_features=(8, 8, 16, 16))
    assert not any(kernel_instantiated(s) for s in narrow)
    assert not kernel_instantiated(ba3c_specs(frame_history=3)[0])
    assert not kernel_instantiated(dataclasses.replace(CASES[2][1], scale_uint8=True))


def test_supported_matches_the_jax_predicate():
    for s in [c[1] for c in CASES] + list(ba3c_specs(conv_features=(8, 8, 16, 16))):
        assert supported(s) == jconv.supported(_jax_spec(s)), s
    assert [supported(s) for s in ba3c_specs()] == [False, True, True, True]


@pytest.mark.cuda
@pytest.mark.parametrize("name,s", CASES[1:], ids=[c[0] for c in CASES[1:]])
def test_conv_block_vjp_on_the_card_matches_its_plain_block(cuda, name, s):
    """On the card the Function's forward is the kernel (one launch) and
    its backward the route, dgrad (blocks 1-3) and wgrad kernels (one
    launch each; the backward counted once): the output and the gradients
    within the band of the plain block's on the same inputs, and a second
    backward bit-equal to the first."""
    from distributed_ba3c_tpu_torch.ops.conv_block import (
        DGRAD_GEOMETRIES,
        conv_block_dgrad,
        conv_block_route,
        conv_block_wgrad,
    )

    plain = reference_block if supported(s) else flax_block
    x_grad = (s.kh, s.kw, s.Ci, s.Co, s.pool) in DGRAD_GEOMETRIES
    x, w, b, g = _tie_inputs(s, seed=70 + len(name), batch=64)
    tx, tw, tb = (t.to(cuda) for t in _torch_args(x, w, b))
    gy = torch.from_numpy(g).to(torch.bfloat16).to(cuda)
    counters = (conv_block_fwd, conv_block, conv_block_route, conv_block_dgrad, conv_block_wgrad)
    outs = []
    for fn in (lambda *a: conv_block(*a, s, plain), lambda *a: conv_block(*a, s, plain),
               lambda *a: plain(*a, s)):
        before = [f.launches for f in counters]
        leaves = [t.detach().requires_grad_(n) for t, n in zip((tx, tw, tb), (x_grad, True, True))]
        y = fn(*leaves)
        y.backward(gy)
        outs.append([y.detach()] + [t.grad for t in leaves if t.grad is not None])
        torch.cuda.synchronize()
        launched = [f.launches - n for f, n in zip(counters, before)]
        if len(outs) < 3:
            assert launched == [1, 1, 1, int(x_grad), 1]
    (y, *grads), (_, *again), (y_ref, *grads_ref) = outs
    assert all(torch.equal(a, c) for a, c in zip(grads, again))
    assert float((y.float() - y_ref.float()).abs().max()) <= REL_TOL * float(y_ref.float().abs().max())
    for a, r in zip(grads, grads_ref):
        assert a.shape == r.shape and a.dtype == r.dtype
        # the kernels' z can differ from cuDNN's by one bf16 ulp, and the
        # sums run in another order
        assert float((a.float() - r.float()).abs().max()) <= REL_TOL * float(r.float().abs().max())

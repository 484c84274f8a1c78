"""The BA3C conv block: conv + bias + relu (+ 2x2 maxpool), fused.

Port of ``distributed_ba3c_tpu/ops/pallas_conv.py``. The TPU kernel there
(``_fwd_kernel``, launched by ``conv_block_fwd``) becomes the hand-written
Hopper kernel in ``csrc/conv_block.cu``; see its header for the design and
what bounds it. The function is the same:

    y = maxpool2x2?(relu(bf16(conv_SAME(x, W)) + b))

with bf16 operands, f32 accumulation, the sum rounded to bf16 before the
bf16 bias add, then relu, then the pool -- the op order ``nn.Conv`` +
``nn.relu`` + ``nn.max_pool`` give under XLA.

Two plain versions compute that function and differ only in how they
differentiate at ties, as the JAX model's two block paths do:

- :func:`reference_block` is ``pallas_conv.py:reference_block``: relu as a
  ``maximum`` with 0 (gradient 1/2 at 0) and a reshape-max pool (a tie
  splits the gradient evenly). The JAX model takes it, through the custom
  VJP ``conv_block``, for every block where :func:`supported` holds.
- :func:`flax_block` is ``nn.Conv`` + ``nn.relu`` + ``nn.max_pool``:
  gradient 0 at 0, and the whole pool gradient to the first maximum. The
  JAX model takes it for every other block (conv0 at full width, every
  block at narrow test widths).

:func:`conv_block` is the trainable block, the port of ``conv_block``
(``pallas_conv.py:335-359``): forward :func:`conv_block_fwd`, backward the
VJP of a plain version recomputed from the saved inputs.

Public layouts are the JAX package's: ``x`` is ``[B, H, W*Ci]`` (uint8 for a
``scale_uint8`` block, else bf16), ``w`` is HWIO ``[kh, kw, Ci, Co]``, ``b``
is ``[Co]``, and the output is ``[B, Ho, Wo*Co]`` bf16.

:func:`reference_block` is the plain PyTorch version, in the op order of
``pallas_conv.py:reference_block``. :func:`conv_block_fwd` takes it only
for a tensor on the CPU; for a CUDA tensor it launches the kernel or
raises.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

#: the Pallas kernel's lane-packing factor; only :func:`supported` reads it
LANE_PACK = 4


#: bf16(1/255) as a float: the scale of a uint8 block's input
_BF16_INV_255 = float(torch.tensor(1.0 / 255.0, dtype=torch.bfloat16))


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    """Static geometry of one fused conv block."""

    H: int             # input height
    W: int             # input width
    Ci: int            # input channels
    Co: int            # output channels
    kh: int
    kw: int
    pool: bool         # 2x2/2 maxpool after relu
    scale_uint8: bool  # input is uint8; cast and multiply by 1/255

    @property
    def ph(self) -> int:  # top row pad (XLA SAME convention)
        return (self.kh - 1) // 2

    @property
    def pw(self) -> int:  # left col pad
        return (self.kw - 1) // 2

    @property
    def Ho(self) -> int:
        return self.H // 2 if self.pool else self.H

    @property
    def Wo(self) -> int:
        return self.W // 2 if self.pool else self.W

    @property
    def in_dtype(self) -> torch.dtype:
        return torch.uint8 if self.scale_uint8 else torch.bfloat16

    @property
    def flops_per_sample(self) -> int:
        """Multiply-adds of the pre-pool conv, counted as 2 operations."""
        return 2 * self.H * self.W * self.Co * self.kh * self.kw * self.Ci


def ba3c_specs(
    frame_history: int = 4,
    conv_features: Tuple[int, ...] = (32, 32, 64, 64),
    conv_kernels: Tuple[int, ...] = (5, 5, 4, 3),
) -> Tuple[ConvSpec, ...]:
    """The four BA3C conv blocks (84x84xhist uint8 in, 10x10x64 out)."""
    specs = []
    h = w = 84
    ci = frame_history
    pooled = (True, True, True, False)
    for i, (co, k, pool) in enumerate(
        zip(conv_features, conv_kernels, pooled, strict=True)
    ):
        s = ConvSpec(
            H=h, W=w, Ci=ci, Co=co, kh=k, kw=k, pool=pool,
            scale_uint8=(i == 0),
        )
        specs.append(s)
        h, w, ci = s.Ho, s.Wo, co
    return tuple(specs)


def _conv(x, w, s: ConvSpec, dtype) -> torch.Tensor:
    """[B, H, W*Ci] -> the pre-bias conv output [B, Co, H, W] in ``dtype``."""
    B = x.shape[0]
    x = x.reshape(B, s.H, s.W, s.Ci)
    if s.scale_uint8:
        # a scale tensor of the compute type, not a Python float: the
        # product must round like the reference's bf16 x bf16(1/255)
        x = x.to(dtype) * torch.tensor(1.0 / 255.0, dtype=dtype, device=x.device)
    else:
        x = x.to(dtype)
    x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW
    x = F.pad(x, (s.pw, s.kw - 1 - s.pw, s.ph, s.kh - 1 - s.ph))
    return F.conv2d(x, w.to(dtype).permute(3, 2, 0, 1))  # HWIO -> OIHW


def _flatten(y: torch.Tensor, s: ConvSpec) -> torch.Tensor:
    """[B, Co, Ho, Wo] -> [B, Ho, Wo*Co]."""
    return y.permute(0, 2, 3, 1).reshape(y.shape[0], s.Ho, s.Wo * s.Co)


def reference_block(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    s: ConvSpec,
    dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """x: [B, H, W*Ci] -> [B, Ho, Wo*Co], plain PyTorch ops, same op order.

    ``dtype`` is the compute type: bf16 is the kernel's function; the
    model's float32 path runs the same ops in float32. Differentiates as
    JAX's ``reference_block``: ``maximum(y + b, 0)`` gives 1/2 at a tie,
    and ``amax`` splits a tied pool window evenly.
    """
    B = x.shape[0]
    y = _conv(x, w, s, dtype)
    zero = torch.zeros((), dtype=dtype, device=y.device)
    y = torch.maximum(y + b.to(dtype)[:, None, None], zero)
    if s.pool:
        y = y[:, :, : 2 * s.Ho, : 2 * s.Wo].reshape(
            B, s.Co, s.Ho, 2, s.Wo, 2
        )
        y = y.amax(dim=5).amax(dim=3)
    return _flatten(y, s)


def flax_block(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    s: ConvSpec,
    dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """The same function as :func:`reference_block`, differentiated as
    flax's ``nn.Conv`` + ``nn.relu`` + ``nn.max_pool``: ``torch.relu`` has
    gradient 0 at 0, and ``F.max_pool2d`` sends a window's gradient to its
    first maximum."""
    y = torch.relu(_conv(x, w, s, dtype) + b.to(dtype)[:, None, None])
    if s.pool:
        y = F.max_pool2d(y, 2)
    return _flatten(y, s)


def supported(s: ConvSpec) -> bool:
    """``pallas_conv.py:supported``: the geometries the JAX model runs
    through its Pallas block (and so differentiates by
    :func:`reference_block`'s rules); every other block takes flax's."""
    P = LANE_PACK
    return (P * s.Ci) % 128 == 0 and s.kw <= P + 1 and P % 2 == 0


#: the (kh, kw, Ci, Co, pool) geometries csrc/conv_block.cu instantiates
#: (at any H and W), each with whether it also takes a uint8 input
KERNEL_GEOMETRIES = {
    (5, 5, 4, 32, True): True,
    (5, 5, 32, 32, True): False,
    (4, 4, 32, 64, True): False,
    (3, 3, 64, 64, False): False,
}


def kernel_instantiated(s: ConvSpec) -> bool:
    """Whether ``csrc/conv_block.cu`` has a kernel for ``s``: the four BA3C
    block geometries at any H and W, uint8 input only for block 0's."""
    uint8_ok = KERNEL_GEOMETRIES.get((s.kh, s.kw, s.Ci, s.Co, s.pool))
    return uint8_ok is not None and (uint8_ok or not s.scale_uint8)


def _check(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, s: ConvSpec):
    if x.dtype != s.in_dtype:
        raise TypeError(f"x must be {s.in_dtype} for {s}, got {x.dtype}")
    if w.dtype != torch.bfloat16 or b.dtype != torch.bfloat16:
        raise TypeError(
            f"w and b must be bfloat16, got {w.dtype} and {b.dtype}"
        )
    if x.dim() != 3 or x.shape[1:] != (s.H, s.W * s.Ci):
        raise ValueError(
            f"x must be [B, {s.H}, {s.W * s.Ci}], got {tuple(x.shape)}"
        )
    if w.shape != (s.kh, s.kw, s.Ci, s.Co) or b.shape != (s.Co,):
        raise ValueError(
            f"w must be [{s.kh}, {s.kw}, {s.Ci}, {s.Co}] and b [{s.Co}], "
            f"got {tuple(w.shape)} and {tuple(b.shape)}"
        )
    if not (x.device == w.device == b.device):
        raise ValueError(
            f"x, w and b on different devices: {x.device}, {w.device}, "
            f"{b.device}"
        )
    if not (x.is_contiguous() and w.is_contiguous() and b.is_contiguous()):
        raise ValueError("x, w and b must be contiguous")


def conv_block_fwd(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, s: ConvSpec
) -> torch.Tensor:
    """Fused conv+bias+relu(+pool). x: [B, H, W*Ci] (uint8 for scale_uint8).

    On a CUDA tensor, launches ``csrc/conv_block.cu`` on the current stream
    and counts the launch in ``conv_block_fwd.launches`` (a geometry where
    :func:`kernel_instantiated` is false raises); on a CPU tensor, computes
    :func:`reference_block`. Any other device raises.
    """
    _check(x, w, b, s)
    if x.device.type == "cpu":
        return reference_block(x, w, b, s)
    if x.device.type != "cuda":
        raise ValueError(f"conv_block_fwd runs on cuda or cpu, not {x.device}")
    if not kernel_instantiated(s):
        raise ValueError(
            f"csrc/conv_block.cu has no kernel for {s} (kernel_instantiated "
            f"is false; it takes (kh, kw, Ci, Co, pool) in "
            f"{sorted(KERNEL_GEOMETRIES)})"
        )
    from distributed_ba3c_tpu_torch.ops import _build

    lib = _build.load("conv_block")
    B = x.shape[0]
    y = torch.empty((B, s.Ho, s.Wo * s.Co), dtype=torch.bfloat16, device=x.device)
    if B == 0:
        return y
    with torch.cuda.device(x.device):
        rc = lib.ba3c_conv_block_fwd(
            x.data_ptr(), int(s.scale_uint8), w.data_ptr(), b.data_ptr(),
            y.data_ptr(), B, s.H, s.W, s.Ci, s.Co, s.kh, s.kw, int(s.pool),
            _BF16_INV_255, torch.cuda.current_stream(x.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"conv_block kernel launch failed: cudaError {rc} for {s}, B={B}"
        )
    conv_block_fwd.launches += 1
    return y


#: kernel launches since the count was last set to 0 (CPU calls not counted)
conv_block_fwd.launches = 0


class _ConvBlock(torch.autograd.Function):
    """Forward: the kernel (:func:`conv_block_fwd`). Backward: the VJP of
    ``plain`` recomputed from the saved ``(x, w, b)`` with the cotangent
    cast to bf16, as ``pallas_conv.py:_cb_bwd`` does."""

    @staticmethod
    def forward(ctx, x, w, b, s, plain):
        ctx.save_for_backward(x, w, b)
        ctx.spec, ctx.plain = s, plain
        return conv_block_fwd(x, w, b, s)

    @staticmethod
    def backward(ctx, g):
        x, w, b = ctx.saved_tensors
        need = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            leaves = [
                t.detach().requires_grad_(n) for t, n in zip((x, w, b), need)
            ]
            y = ctx.plain(*leaves, ctx.spec)
            wanted = [t for t, n in zip(leaves, need) if n]
            grads = iter(torch.autograd.grad(y, wanted, g.to(torch.bfloat16)))
        if g.device.type == "cuda":
            conv_block.launches += 1
        return (*(next(grads) if n else None for n in need), None, None)


def conv_block(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    s: ConvSpec,
    plain=reference_block,
) -> torch.Tensor:
    """The trainable block: :func:`conv_block_fwd` forward, and backward
    the VJP of ``plain`` (:func:`reference_block`, as JAX's ``conv_block``
    does; the model passes :func:`flax_block` where :func:`supported` is
    false). Takes what :func:`conv_block_fwd` takes; the gradients of x, w
    and b have their shapes and dtypes. The backward launches no kernel:
    JAX computes it outside Pallas, as a recompute of the plain block."""
    return _ConvBlock.apply(x, w, b, s, plain)


#: backward passes run on the card since the count was last set to 0
conv_block.launches = 0

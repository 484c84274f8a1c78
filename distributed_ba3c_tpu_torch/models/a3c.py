"""The BA3C policy/value convnet.

Port of ``distributed_ba3c_tpu/models/a3c.py`` (the Tensorpack train-atari
architecture):

    input uint8 [B, 84, 84, FRAME_HISTORY] / 255
    Conv 32@5x5 -> MaxPool 2 -> Conv 32@5x5 -> MaxPool 2
    Conv 64@4x4 -> MaxPool 2 -> Conv 64@3x3
    FC 512 + PReLU
    -> policy logits [B, A]    (FC A)
    -> value [B]               (FC 1)

Numerics follow the JAX module: NHWC uint8 states, cast and divided by 255
on the device; a torso in ``compute_dtype`` (bf16 by default) over float32
params, each cast to the compute type where it is used; the FC 512 as a
``torch.matmul`` in the compute type with its bias added after; f32 policy
and value heads. Each conv layer is one fused conv+bias+relu(+pool) block
(ops/conv_block.py): ``conv_backend="cuda"`` runs the hand-written kernel
(the default on a CUDA device; it has the four BA3C block geometries, at
any image size, and the constructor refuses other conv widths, kernels or
input channels), ``"torch"`` its plain PyTorch version (the default on the
CPU).

The forward is differentiable on both backends, with the JAX model's
``conv_backend="pallas"`` gradient rules: a block where ``supported``
holds differentiates as JAX's ``reference_block`` (relu'(0) = 1/2, a tied
pool window split evenly), every other block as flax's layers (relu'(0) =
0, the pool gradient to the first maximum). On ``cuda`` the forward is the
kernel and the backward is hand-written kernels too (``conv_block``: a
recompute that routes the cotangent by the block's tie rule, then the input
and weight gradients), held against the plain block's VJP on the card by
chip_smoke.py; on ``torch`` it is the plain block's VJP. The f32 params
take their gradients through the bf16 weight-prologue cast, as flax casts
inside the layer.

Parameters live in PyTorch's layouts: conv weights OIHW, dense weights
``[out, in]``. models/convert.py maps them to and from the flax tree.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn

from distributed_ba3c_tpu_torch.models.layers import PReLU
from distributed_ba3c_tpu_torch.ops.conv_block import (
    ConvSpec,
    conv_block,
    flax_block,
    kernel_instantiated,
    reference_block,
    supported,
)
from distributed_ba3c_tpu_torch.utils.device import resolve_device

CONV_BACKENDS = ("cuda", "torch")


class PolicyValue(NamedTuple):
    logits: torch.Tensor  # [B, A] float32
    value: torch.Tensor   # [B] float32


def conv_layout(model: "BA3CNet") -> Tuple[Tuple[int, int, bool], ...]:
    """The conv stack's (features, kernel, pooled) triples."""
    return tuple(
        zip(
            model.conv_features,
            model.conv_kernels,
            model.pooled_layers,
            strict=True,
        )
    )


def _lecun_normal_(t: torch.Tensor, fan_in: int, generator: torch.Generator):
    """flax's ``lecun_normal``: a normal of variance 1/fan_in truncated at
    two standard deviations (rescaled so the truncated variance is kept)."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(
            t, 0.0, std, -2.0 * std, 2.0 * std, generator=generator
        )


class BA3CNet(nn.Module):
    """Policy/value network with the reference's conv stack.

    ``device`` defaults to ``cuda`` and raises when no card is present.
    Parameters are drawn on the CPU from ``generator`` (a fresh generator
    seeded 0 when None) and then moved, so one seed gives the same weights
    on every device.
    """

    def __init__(
        self,
        num_actions: int,
        fc_units: int = 512,
        conv_features: Sequence[int] = (32, 32, 64, 64),
        conv_kernels: Sequence[int] = (5, 5, 4, 3),
        # maxpool after first 3 conv layers, as in the reference stack
        pooled_layers: Tuple[bool, ...] = (True, True, True, False),
        image_size: Tuple[int, int] = (84, 84),
        in_channels: int = 4,
        compute_dtype: torch.dtype = torch.bfloat16,
        conv_backend: Optional[str] = None,
        device="cuda",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        dev = resolve_device(device)
        if conv_backend is None:
            conv_backend = "cuda" if dev.type == "cuda" else "torch"
        if conv_backend not in CONV_BACKENDS:
            raise ValueError(
                f"conv_backend must be one of {CONV_BACKENDS}, got "
                f"{conv_backend!r}"
            )
        if conv_backend == "cuda" and compute_dtype != torch.bfloat16:
            raise ValueError(
                "conv_backend='cuda' is the bf16 kernel; compute_dtype "
                f"{compute_dtype} needs conv_backend='torch'"
            )
        self.num_actions = num_actions
        self.fc_units = fc_units
        self.conv_features = tuple(conv_features)
        self.conv_kernels = tuple(conv_kernels)
        self.pooled_layers = tuple(pooled_layers)
        self.image_size = tuple(image_size)
        self.in_channels = in_channels
        self.compute_dtype = compute_dtype
        self.conv_backend = conv_backend
        if generator is None:
            generator = torch.Generator().manual_seed(0)

        convs = []
        h, w = self.image_size
        ci = in_channels
        for i, (feats, k, pooled) in enumerate(conv_layout(self)):
            s = ConvSpec(H=h, W=w, Ci=ci, Co=feats, kh=k, kw=k, pool=pooled,
                         scale_uint8=False)
            if conv_backend == "cuda" and not kernel_instantiated(s):
                raise ValueError(
                    f"conv_backend='cuda': conv block {i} ({k}x{k}, {ci} -> "
                    f"{feats} channels, pool={pooled}) has no kernel "
                    "(ops.conv_block.kernel_instantiated is false); use "
                    "conv_backend='torch'"
                )
            conv = nn.utils.skip_init(nn.Conv2d, ci, feats, k)
            _lecun_normal_(conv.weight, k * k * ci, generator)
            nn.init.zeros_(conv.bias)
            convs.append(conv)
            if pooled:
                h, w = h // 2, w // 2
            ci = feats
        self.convs = nn.ModuleList(convs)
        self.fc = self._dense(h * w * ci, fc_units, generator)
        self.prelu = PReLU()
        self.policy = self._dense(fc_units, num_actions, generator)
        self.value = self._dense(fc_units, 1, generator)
        self.to(dev)

    @staticmethod
    def _dense(fan_in: int, out: int, generator: torch.Generator) -> nn.Linear:
        layer = nn.utils.skip_init(nn.Linear, fan_in, out)
        _lecun_normal_(layer.weight, fan_in, generator)
        nn.init.zeros_(layer.bias)
        return layer

    def forward(self, state: torch.Tensor) -> PolicyValue:
        """state: [B, H, W, C] uint8 (or float already scaled)."""
        cdt = self.compute_dtype
        if state.dtype == torch.uint8:
            x = state.to(cdt) / 255.0
        else:
            x = state.to(cdt)
        B = x.shape[0]
        for conv, (feats, k, pooled) in zip(self.convs, conv_layout(self)):
            _, H, W, Ci = x.shape
            s = ConvSpec(
                H=H, W=W, Ci=Ci, Co=feats, kh=k, kw=k, pool=pooled,
                scale_uint8=False,
            )
            # the weight prologue: OIHW f32 -> HWIO in the compute type
            w = conv.weight.to(cdt).permute(2, 3, 1, 0).contiguous()
            b = conv.bias.to(cdt)
            x = x.reshape(B, H, W * Ci)
            # JAX's model: the Pallas block (reference_block's VJP) where
            # supported in bf16, flax's layers everywhere else
            plain = (
                reference_block
                if cdt == torch.bfloat16 and supported(s)
                else flax_block
            )
            if self.conv_backend == "torch":
                y = plain(x, w, b, s, dtype=cdt)
            else:
                y = conv_block(x.contiguous(), w, b.contiguous(), s, plain)
            x = y.reshape(B, s.Ho, s.Wo, feats)

        x = x.reshape(B, -1)
        x = torch.matmul(x, self.fc.weight.to(cdt).t()) + self.fc.bias.to(cdt)
        x = self.prelu(x)

        h = x.float()
        logits = torch.matmul(h, self.policy.weight.float().t()) + (
            self.policy.bias.float()
        )
        value = torch.matmul(h, self.value.weight.float().t()) + (
            self.value.bias.float()
        )
        return PolicyValue(logits=logits, value=value[:, 0])

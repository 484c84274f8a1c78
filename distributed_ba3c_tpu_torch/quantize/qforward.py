"""The quantized serving/actor forward and its publish-time table build.

Port of ``distributed_ba3c_tpu/quantize/qforward.py``. Two pieces:

- :func:`quantize_params` is the PUBLISH step: a BA3CNet ``state_dict``
  in, the int8 serving table out. Each quantized layer (``Conv_0..3``,
  ``Dense_0``) becomes ``<layer>.kernel_q`` (int8), ``<layer>.w_scale``
  (f32 ``[Co]``, per output channel, symmetric), ``<layer>.bias`` (f32)
  and ``<layer>.act_scale`` (f32 ``[]``, the frozen input scale of the
  :class:`~distributed_ba3c_tpu_torch.quantize.spec.QuantSpec`). The heads
  and the PReLU pass through under their state_dict names. A conv's int8
  weights are stored as the im2col product reads them: a ``[K, Co]``
  matrix, K = kh*kw*Ci in HWI order, zero-padded to a multiple of 8 and
  K-contiguous (the int8 GEMM's layout), so a publish quantizes once and
  no forward repacks. ``models/convert.py::quant_from_flax`` and
  ``quant_to_flax`` map this table to the JAX package's and back.
- :func:`make_quant_apply` is the FORWARD: :class:`QuantBA3CNet`, an
  ``nn.Module`` whose ``forward(states) -> PolicyValue`` reads the table
  from its buffers, so ``torch.func.functional_call`` serves any table
  through it (``predict/server.py::make_fwd_sample``) and the rollout body
  (``fused/loop.py::make_rollout_body``) takes it as it takes BA3CNet.
  Its layout comes from ``models/a3c.py::conv_layout``, as the f32
  forward's does. Two arms:

  * ``int8``: each layer's input is quantized with its ``act_scale``; a
    conv forms the int8 im2col of the SAME-padded NHWC input (flax's
    padding: low ``(k-1)//2``, high ``k//2``) from ``Tensor.unfold`` views
    in one copy, multiplies it int8 x int8 -> int32 with
    ``torch._int_mm``, and applies ONE f32 epilogue
    ``acc * (act_scale * w_scale) + bias``; then relu and the 2x2 max
    pool where the layout pools. ``Dense_0`` runs the same way on the
    NHWC flatten. (``F.conv2d`` on int8 returns int8 and wraps on the
    CPU, so it is never used here.)
  * ``folded``: the conv on bf16-rounded activations and the int8 weight
    values, in f32 (the products are exact; only the sum's order differs
    from JAX's ``preferred_element_type=f32``), then ``* w_scale + bias``.

  ``auto`` resolves through :func:`int8_conv_supported`, which runs the
  int8 arm's own path once on the device and caches the answer. An
  explicit ``arm="int8"`` the device cannot run raises; it never turns
  into ``folded``.

``torch._int_mm`` on CUDA needs more than 16 rows and K and N multiples
of 8: a product of 16 rows or fewer (``Dense_0`` at serving buckets 1-16)
is padded to 32 rows and sliced, K is padded at quantization, and every
layer's Co is a multiple of 8 in the BA3C stack.

The policy/value heads and the PReLU stay f32 in both arms.

Rounding follows the JAX source as it runs op by op: ``x / 127.0`` and
``x / s`` are true divisions on every device (PyTorch's CUDA division by
a Python scalar would be a product with the reciprocal, so the divisors
are tensors), and ``torch.round`` rounds half to even as ``jnp.round``
does. The uint8 frames are scaled by the f32 reciprocal of 255, which is
what XLA compiles ``x / 255.0`` into.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from distributed_ba3c_tpu_torch.models.a3c import PolicyValue, conv_layout
from distributed_ba3c_tpu_torch.quantize.spec import QuantSpec

#: forward arms: ``auto`` resolves per device at build time
QUANT_ARMS = ("auto", "int8", "folded")

#: the int8 GEMM's alignment of K (and of N, which every BA3C layer meets)
K_ALIGN = 8
#: ``torch._int_mm`` on CUDA takes more than 16 rows; fewer are padded to this
_MIN_ROWS = 32

#: 1/255 in float32, as XLA folds the frames' ``x / 255.0``
_INV255 = float(torch.tensor(1.0) / torch.tensor(255.0))

#: the int8 arm's probe per device: True, or the reason it cannot run
_INT8_OK: Dict[str, object] = {}

#: the port's state_dict names of the f32 layers the table passes through
PASSTHROUGH = ("policy.weight", "policy.bias", "value.weight", "value.bias",
               "prelu.alpha")


def quant_layer_names(model) -> tuple:
    """The layers the int8 rung quantizes: the conv stack and the big FC
    (``Dense_0``), by the JAX package's names. The heads (``Dense_1``,
    ``Dense_2``) and ``PReLU_0`` stay f32."""
    return tuple(
        f"Conv_{i}" for i in range(len(conv_layout(model)))
    ) + ("Dense_0",)


def _state_name(layer: str) -> str:
    """A quantized layer's JAX name -> its weight's BA3CNet state_dict name."""
    if layer.startswith("Conv_"):
        return f"convs.{layer[5:]}.weight"
    if layer == "Dense_0":
        return "fc.weight"
    raise ValueError(f"the int8 rung quantizes Conv_i and Dense_0, not {layer!r}")


def k_padded(k: int) -> int:
    """K rounded up to the int8 GEMM's alignment."""
    return -(-k // K_ALIGN) * K_ALIGN


def k_major(q: torch.Tensor) -> torch.Tensor:
    """``[K, Co]`` int8 -> ``[Kp, Co]`` with K contiguous (strides (1, Kp))
    and zero rows K..Kp: the int8 product's weight layout."""
    K, co = q.shape
    out = torch.zeros((co, k_padded(K)), dtype=torch.int8, device=q.device)
    out[:, :K] = q.t()
    return out.t()


def _weight_scale(w: torch.Tensor) -> torch.Tensor:
    """Per-OUT-CHANNEL symmetric scale of a ``[K, Co]`` matrix: absmax over
    K mapped to 127. A zero-range channel gets 1.0 (its weights quantize
    to 0 either way, and the scale stays finite)."""
    absmax = w.abs().amax(dim=0)
    # a tensor divisor: PyTorch's CUDA division by a Python scalar is a
    # product with its float32 reciprocal, which is not the CPU's quotient
    q = absmax / torch.tensor(127.0, device=absmax.device)
    return torch.where(absmax > 0, q, torch.ones_like(absmax))


def _quantize_tensor(x: torch.Tensor, scale) -> torch.Tensor:
    return torch.clamp(torch.round(x / scale), -127.0, 127.0).to(torch.int8)


@torch.no_grad()
def quantize_params(params, spec: QuantSpec) -> Dict[str, torch.Tensor]:
    """A BA3CNet state_dict -> the int8 serving table, on the params'
    device (see the module docstring for its entries). Every layer the
    spec names must exist; the spec's scales ride in the table, so one
    forward serves every calibration."""
    present = {n for n in ("Dense_0",) if "fc.weight" in params}
    present |= {f"Conv_{k.split('.')[1]}" for k in params
                if k.startswith("convs.") and k.endswith(".weight")}
    missing = sorted(set(spec.act_scales) - present)
    if missing:
        raise ValueError(
            f"quant spec names layers absent from params: {missing}"
        )
    out: Dict[str, torch.Tensor] = {}
    for name in sorted(spec.act_scales):
        sname = _state_name(name)
        w = torch.as_tensor(params[sname]).detach().float()
        if w.ndim == 4:  # OIHW -> [kh*kw*Ci, Co] in HWI order
            w2 = w.permute(2, 3, 1, 0).reshape(-1, w.shape[0])
        else:  # Linear [out, in] -> [in, out]
            w2 = w.t()
        w_scale = _weight_scale(w2)
        out[f"{name}.kernel_q"] = k_major(_quantize_tensor(w2, w_scale))
        out[f"{name}.w_scale"] = w_scale
        bias = torch.as_tensor(params[sname[: -len("weight")] + "bias"])
        out[f"{name}.bias"] = bias.detach().float()
        out[f"{name}.act_scale"] = torch.tensor(
            spec.act_scales[name], dtype=torch.float32, device=w.device
        )
    for name in PASSTHROUGH:
        if name in params:
            out[name] = torch.as_tensor(params[name])
    return out


# -- the int8 arm's pieces -----------------------------------------------------


def im2col_int8(xq: torch.Tensor, k: int, kp: int) -> torch.Tensor:
    """``[B, H, W, C]`` int8 -> ``[B*H*W, kp]`` int8: the SAME-padded
    patches in (dy, dx, c) order, from ``Tensor.unfold`` views in one copy,
    zero columns K..kp."""
    B, H, W, C = xq.shape
    K = k * k * C
    lo, hi = (k - 1) // 2, k // 2
    xp = F.pad(xq, (0, 0, lo, hi, lo, hi))
    # [B, H, W, C, dy, dx] views -> (dy, dx, c)
    patches = xp.unfold(1, k, 1).unfold(2, k, 1).permute(0, 1, 2, 4, 5, 3)
    cols = torch.empty((B * H * W, kp), dtype=torch.int8, device=xq.device)
    cols[:, :K].view(B, H, W, k, k, C).copy_(patches)
    if kp != K:
        cols[:, K:] = 0
    return cols


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``[M, Kp] int8 @ [Kp, N] int8 -> [M, N] int32`` through
    ``torch._int_mm``; 16 rows or fewer are padded to 32 and sliced."""
    M = a.shape[0]
    if M > 16:
        return torch._int_mm(a, b)
    pad = torch.zeros((_MIN_ROWS, a.shape[1]), dtype=torch.int8, device=a.device)
    pad[:M] = a
    return torch._int_mm(pad, b)[:M]


def _epilogue(acc: torch.Tensor, p) -> torch.Tensor:
    # ONE f32 epilogue: int32 accumulator * (s_act * s_w[co]) + bias
    return acc.float() * (p.act_scale * p.w_scale) + p.bias


def _pool2x2(x: torch.Tensor) -> torch.Tensor:
    """flax's 2x2 max pool, stride 2, VALID, on NHWC."""
    B, H, W, C = x.shape
    Ho, Wo = H // 2, W // 2
    return x[:, : 2 * Ho, : 2 * Wo].reshape(B, Ho, 2, Wo, 2, C).amax(dim=(2, 4))


def _probe(device: torch.device) -> None:
    """The int8 arm's own path at a tiny shape: a conv's im2col with K
    padding and a product of fewer than 17 rows."""
    xq = torch.ones((1, 4, 4, 4), dtype=torch.int8, device=device)
    cols = im2col_int8(xq, 3, k_padded(36))
    w = k_major(torch.ones((36, 8), dtype=torch.int8, device=device))
    acc = int8_matmul(cols, w)
    if acc.dtype != torch.int32 or int(acc[5, 0]) != 36:  # an interior pixel
        raise RuntimeError(f"int8 product gave {acc.dtype} {int(acc[5, 0])}, not int32 36")


def int8_conv_supported(device="cpu") -> bool:
    """Can ``device`` run the int8 arm (unfold on int8, ``torch._int_mm``)?
    Probed ONCE per device by running the arm's own path; cached."""
    key = str(torch.device(device))
    ok = _INT8_OK.get(key)
    if ok is None:
        try:
            _probe(torch.device(device))
            ok = True
        except Exception as e:  # the reason is kept for the explicit-arm error
            ok = f"{type(e).__name__}: {e}"
        _INT8_OK[key] = ok
    return ok is True


def _resolve_arm(arm: str, device) -> str:
    if arm not in QUANT_ARMS:
        raise ValueError(f"quant arm must be one of {QUANT_ARMS}, got {arm!r}")
    supported = int8_conv_supported(device)
    if arm == "auto":
        return "int8" if supported else "folded"
    if arm == "int8" and not supported:
        raise RuntimeError(
            f"quant arm 'int8' cannot run on {device}: "
            f"{_INT8_OK[str(torch.device(device))]}"
        )
    return arm


# -- the module ------------------------------------------------------------------


class _QLayer(nn.Module):
    def __init__(self, kp: int, co: int, device):
        super().__init__()
        self.register_buffer("kernel_q", k_major(
            torch.zeros((kp, co), dtype=torch.int8, device=device)))
        self.register_buffer("w_scale", torch.ones(co, device=device))
        self.register_buffer("bias", torch.zeros(co, device=device))
        self.register_buffer("act_scale", torch.ones((), device=device))


class _Head(nn.Module):
    def __init__(self, out: int, fan_in: int, device):
        super().__init__()
        self.register_buffer("weight", torch.zeros((out, fan_in), device=device))
        self.register_buffer("bias", torch.zeros(out, device=device))


class _Slope(nn.Module):
    def __init__(self, device):
        super().__init__()
        self.register_buffer("alpha", torch.zeros((), device=device))


class QuantBA3CNet(nn.Module):
    """The quantized mirror of ``BA3CNet.forward`` over an int8 table.

    Its buffers ARE a table (zeros until one is copied in), named as
    :func:`quantize_params` names the entries; ``functional_call(net,
    table, (states,))`` serves another. ``quant_arm`` is the resolved arm.
    ``forward(states, record=[])`` also appends, for each quantized layer
    of the ``int8`` arm, ``(name, x_int8, acc_int32)``: the layer's int8
    input (NHWC for a conv, flat for ``Dense_0``) and its accumulators
    ``[rows, Co]``."""

    def __init__(self, model, arm: str, device):
        super().__init__()
        device = torch.device(device)
        self.quant_arm = arm
        self.layout = conv_layout(model)
        self.num_actions = model.num_actions
        h, w = model.image_size
        ci = model.in_channels
        for i, (feats, k, pooled) in enumerate(self.layout):
            setattr(self, f"Conv_{i}", _QLayer(k_padded(k * k * ci), feats, device))
            if pooled:
                h, w = h // 2, w // 2
            ci = feats
        self.Dense_0 = _QLayer(k_padded(h * w * ci), model.fc_units, device)
        self.policy = _Head(model.num_actions, model.fc_units, device)
        self.value = _Head(1, model.fc_units, device)
        self.prelu = _Slope(device)

    def load_table(self, table) -> None:
        """Copy ``table`` into the buffers, in place (on the current stream)."""
        for name, buf in self.named_buffers():
            buf.copy_(table[name])

    def _conv(self, x, p, k: int, record: Optional[list], name: str):
        B, H, W, C = x.shape
        kp = p.kernel_q.shape[0]
        if self.quant_arm == "int8":
            xq = _quantize_tensor(x, p.act_scale)
            acc = int8_matmul(im2col_int8(xq, k, kp), p.kernel_q)
            if record is not None:
                record.append((name, xq, acc))
            return _epilogue(acc, p).reshape(B, H, W, -1)
        K = k * k * C
        wf = p.kernel_q[:K].float().reshape(k, k, C, -1).permute(3, 2, 0, 1)
        lo, hi = (k - 1) // 2, k // 2
        xb = x.to(torch.bfloat16).float().permute(0, 3, 1, 2)
        y = F.conv2d(F.pad(xb, (lo, hi, lo, hi)), wf).permute(0, 2, 3, 1)
        return y * p.w_scale + p.bias

    def _dense(self, x, p, record: Optional[list]):
        B, K = x.shape
        kp = p.kernel_q.shape[0]
        if self.quant_arm == "int8":
            xq = _quantize_tensor(x, p.act_scale)
            a = xq
            if kp != K:
                a = torch.zeros((B, kp), dtype=torch.int8, device=x.device)
                a[:, :K] = xq
            acc = int8_matmul(a, p.kernel_q)
            if record is not None:
                record.append(("Dense_0", xq, acc))
            return _epilogue(acc, p)
        y = x.to(torch.bfloat16).float() @ p.kernel_q[:K].float()
        return y * p.w_scale + p.bias

    def forward(self, state: torch.Tensor, record: Optional[List] = None) -> PolicyValue:
        x = state.float()
        if state.dtype == torch.uint8:
            x = x * _INV255
        B = x.shape[0]
        for i, (_feats, k, pooled) in enumerate(self.layout):
            name = f"Conv_{i}"
            x = torch.relu(self._conv(x, getattr(self, name), k, record, name))
            if pooled:
                x = _pool2x2(x)
        x = self._dense(x.reshape(B, -1), self.Dense_0, record)
        alpha = self.prelu.alpha.float()
        x = torch.where(x >= 0, x, alpha * x)
        logits = x @ self.policy.weight.t() + self.policy.bias
        value = (x @ self.value.weight.t() + self.value.bias)[:, 0]
        return PolicyValue(logits=logits, value=value)


def make_quant_apply(model, arm: str = "auto", device=None) -> QuantBA3CNet:
    """The quantized forward of ``model``'s architecture on ``device`` (the
    model's when None): a :class:`QuantBA3CNet` with ``arm`` resolved."""
    if device is None:
        device = next(model.parameters()).device
    return QuantBA3CNet(model, _resolve_arm(arm, device), device)


def make_quant_fwd_sample(model, greedy: bool = False, arm: str = "auto",
                          device=None):
    """The int8 action server's device program: ``fwd_sample(qparams,
    states, generator)`` is ``predict.server.make_fwd_sample`` over the
    quantized forward -- the same Gumbel sampling, draw order and
    ``[3|4, B]`` packing as the f32 server. ``fwd_sample.net`` is the
    :class:`QuantBA3CNet`, ``fwd_sample.quant_arm`` its arm."""
    from distributed_ba3c_tpu_torch.predict.server import make_fwd_sample

    net = make_quant_apply(model, arm=arm, device=device)

    def fwd_sample(qparams, states, generator):
        return make_fwd_sample(net, qparams, states, generator, greedy)

    fwd_sample.net = net
    fwd_sample.quant_arm = net.quant_arm
    return fwd_sample

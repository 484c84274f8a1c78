"""Activation-scale calibration for the int8 forward.

Port of ``distributed_ba3c_tpu/quantize/calibrate.py``. One accumulator,
three feeds:

- :class:`CalibrationTap`: the live-traffic path, a ``shadow_tap`` of the
  predictor's shadow mirror (``predict/server.py``) that observes every
  served batch and freezes a :class:`QuantSpec` after N batches;
- :func:`calibrate_offline`: recorded state batches;
- :func:`calibrate_from_env`: f32 rollout windows through the fused
  trainer's own rollout body (``--quant_calibrate N`` with ``--overlap``).

The statistics forward is an f32 copy of the conv stack (not the bf16
training forward), run on the device the caller names; on CUDA its f32
convs run with TF32 off, so the card's scales are the CPU's up to the sum
order. Statistics are maxima over batches, so the same batches freeze the
same spec in any order.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from distributed_ba3c_tpu_torch.models.a3c import conv_layout
from distributed_ba3c_tpu_torch.quantize.qforward import _INV255, quant_layer_names
from distributed_ba3c_tpu_torch.quantize.spec import QUANT_METHODS, QuantSpec


def percentile(a: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.percentile(a, q)`` (linear interpolation) of a flattened
    tensor, in float32 as JAX computes the rank, from the two neighbouring
    order statistics (``torch.kthvalue``: ``torch.quantile`` refuses more
    than 2^24 elements). NaN when ``a`` holds a NaN, as JAX's."""
    flat = a.reshape(-1)
    if bool(torch.isnan(flat).any()):
        return torch.tensor(float("nan"))
    n = flat.numel()
    f32 = torch.float32
    rank = (torch.tensor(q, dtype=f32) / torch.tensor(100.0, dtype=f32)) * (
        torch.tensor(float(n), dtype=f32) - 1
    )
    low, high = torch.floor(rank), torch.ceil(rank)
    w_high = rank - low
    w_low = 1 - w_high
    lo = int(min(max(low.item(), 0), n - 1))
    hi = int(min(max(high.item(), 0), n - 1))
    v_lo = torch.kthvalue(flat, lo + 1).values.float().cpu()
    v_hi = torch.kthvalue(flat, hi + 1).values.float().cpu()
    return v_lo * w_low + v_hi * w_high


class _StatsForward:
    """Each quantized layer's INPUT statistic over one batch: the f32
    conv stack (conv + bias, relu, 2x2 pool where the layout pools) and
    the NHWC flatten ``Dense_0`` reads."""

    def __init__(self, model, params, method: str, pct: float, device):
        self.layout = conv_layout(model)
        self.device = device
        self.method, self.pct = method, pct
        self.convs = [
            (torch.as_tensor(params[f"convs.{i}.weight"]).detach().to(device, torch.float32),
             torch.as_tensor(params[f"convs.{i}.bias"]).detach().to(device, torch.float32))
            for i in range(len(self.layout))
        ]

    def stat(self, x: torch.Tensor) -> float:
        a = x.abs()
        if self.method == "absmax":
            return float(a.max())
        return float(percentile(a, self.pct))

    @torch.no_grad()
    def __call__(self, states) -> Dict[str, float]:
        s = torch.as_tensor(states).to(self.device)
        x = s.float()
        if s.dtype == torch.uint8:
            x = x * _INV255
        x = x.permute(0, 3, 1, 2)  # NCHW for the convs
        out = {}
        tf32 = torch.backends.cudnn
        with tf32.flags(enabled=tf32.enabled, benchmark=tf32.benchmark,
                        deterministic=tf32.deterministic, allow_tf32=False):
            for i, ((w, b), (_feats, k, pooled)) in enumerate(zip(self.convs, self.layout)):
                out[f"Conv_{i}"] = self.stat(x)
                lo, hi = (k - 1) // 2, k // 2
                x = F.conv2d(F.pad(x, (lo, hi, lo, hi)), w) + b[:, None, None]
                x = torch.relu(x)
                if pooled:
                    x = F.max_pool2d(x, 2)
        out["Dense_0"] = self.stat(x.permute(0, 2, 3, 1).reshape(x.shape[0], -1))
        return out


def _device_of(model, device):
    return torch.device(device) if device is not None else next(model.parameters()).device


class ActRangeAccumulator:
    """Running per-layer activation ranges -> a QuantSpec.

    ``observe(states)`` folds one batch in (the running max of the
    per-batch statistic: for absmax the global absmax, for percentile the
    max of the batches' percentiles). ``freeze()`` maps each range to the
    symmetric scale ``range / 127``, a zero range to 1.0. ``params`` is a
    BA3CNet state_dict; the statistics run on ``device`` (the model's when
    None)."""

    def __init__(self, model, params, method: str = "absmax",
                 percentile: float = 99.9, device=None):
        if method not in QUANT_METHODS:
            raise ValueError(
                f"method must be one of {QUANT_METHODS}, got {method!r}"
            )
        self._stats = _StatsForward(model, params, method, float(percentile),
                                    _device_of(model, device))
        self.method = method
        self.percentile = float(percentile)
        self._ranges = {name: 0.0 for name in quant_layer_names(model)}
        self.batches = 0
        self.rows = 0

    def observe(self, states) -> None:
        for name, v in self._stats(states).items():
            if math.isfinite(v):  # a NaN frame must not poison the spec
                self._ranges[name] = max(self._ranges[name], v)
        self.batches += 1
        self.rows += int(states.shape[0])

    def freeze(self) -> QuantSpec:
        scales = {
            name: (r / 127.0 if r > 0 else 1.0)
            for name, r in self._ranges.items()
        }
        return QuantSpec(
            act_scales=scales,
            method=self.method,
            percentile=self.percentile,
            calibration_batches=self.batches,
            calibration_rows=self.rows,
        )


class CalibrationTap:
    """A ``shadow_tap`` that calibrates: installed on a BatchedPredictor
    (which mirrors its traffic through ``set_shadow``), every served batch
    feeds the accumulator until ``batches`` are seen; then the spec
    freezes EXACTLY ONCE and ``on_freeze(spec)`` fires (the predictor's
    switch to int8).

    The tap runs on the predictor's scheduler thread (the shadow fetch),
    on its stream, so ``on_freeze`` may swap the predictor's forward and
    table with no dispatch concurrent with it."""

    def __init__(self, model, params, batches: int,
                 method: str = "absmax", percentile: float = 99.9,
                 on_freeze: Optional[Callable[[QuantSpec], None]] = None,
                 tele_role: Optional[str] = None, device=None):
        if batches < 1:
            raise ValueError(f"calibration needs >= 1 batch, got {batches}")
        self._acc = ActRangeAccumulator(
            model, params, method=method, percentile=percentile, device=device
        )
        self.batches_target = int(batches)
        self._on_freeze = on_freeze
        self.spec: Optional[QuantSpec] = None
        self._c_batches = self._c_rows = None
        if tele_role is not None:
            from distributed_ba3c_tpu_torch import telemetry

            tele = telemetry.registry(tele_role)
            self._c_batches = tele.counter("quant_calib_batches_total")
            self._c_rows = tele.counter("quant_calib_rows_total")
            tele.gauge(
                "quant_spec_frozen",
                fn=lambda: 1.0 if self.spec is not None else 0.0,
            )

    def __call__(self, states, actions, policy) -> None:
        if self.spec is not None:
            return  # frozen: the tap is inert until uninstalled
        self._acc.observe(states)
        if self._c_batches is not None:
            self._c_batches.inc()
            self._c_rows.inc(int(np.shape(states)[0]))
        if self._acc.batches >= self.batches_target:
            self.spec = self._acc.freeze()
            if self._on_freeze is not None:
                self._on_freeze(self.spec)


def calibrate_offline(model, params, batches: Iterable,
                      method: str = "absmax", percentile: float = 99.9,
                      device=None) -> QuantSpec:
    """Static-range calibration over recorded state batches (each one
    ``[B, H, W, hist]`` array or tensor)."""
    acc = ActRangeAccumulator(
        model, params, method=method, percentile=percentile, device=device
    )
    for states in batches:
        acc.observe(states)
    if acc.batches == 0:
        raise ValueError("offline calibration saw zero batches")
    return acc.freeze()


@torch.no_grad()
def calibrate_from_env(model, cfg, env, params, draws, n_envs: int,
                       batches: int, rollout_len: int = 20,
                       method: str = "absmax",
                       percentile: float = 99.9) -> QuantSpec:
    """Pre-training calibration for the fused trainer's int8 actor: run
    ``batches`` rollout windows of ``rollout_len`` steps of ``n_envs``
    fresh envs through ``fused/loop.py::make_rollout_body`` with
    ``model``'s forward over ``params`` (a state_dict), consuming
    ``draws`` (a ``GeneratorDraws``, or a replay of JAX's keys: reset
    draws first, then each step's), and feed every visited frame stack to
    the accumulator on the model's device."""
    from distributed_ba3c_tpu_torch.fused.loop import initial_stack, make_rollout_body

    if batches < 1:
        raise ValueError(f"calibration needs >= 1 window, got {batches}")
    dev = next(model.parameters()).device
    acc = ActRangeAccumulator(model, params, method=method, percentile=percentile,
                              device=dev)
    env_state = env.reset(draws.reset_noise(n_envs, dev))
    stack = initial_stack(env, env_state, cfg.frame_history)
    body = make_rollout_body(
        lambda s: functional_call(model, params, (s,)), cfg, env
    )
    carry = (
        env_state, stack, draws,
        torch.zeros(n_envs, dtype=torch.float32, device=dev),
        torch.zeros(n_envs, dtype=torch.int32, device=dev),
        torch.zeros(n_envs, dtype=torch.float32, device=dev),
    )
    for _ in range(batches):
        window = []
        for _ in range(rollout_len):
            carry, ys = body(carry)
            window.append(ys[0])
        stacks = torch.stack(window)  # [T, B, H, W, hist] uint8
        acc.observe(stacks.reshape(-1, *stacks.shape[2:]))
    return acc.freeze()

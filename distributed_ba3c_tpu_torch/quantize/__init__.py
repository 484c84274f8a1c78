"""The int8 rung of the rollout precision ladder (float32, bfloat16, int8).

Port of ``distributed_ba3c_tpu/quantize``. Per-channel symmetric int8
weights and one frozen per-tensor scale for each quantized layer's input,
for the serving and actor forward only (the learner keeps f32):

- :mod:`spec`: :class:`QuantSpec`, the frozen calibration document
  (standard library only);
- :mod:`qforward`: :func:`quantize_params` (the publish-time f32 -> int8
  table) and :func:`make_quant_apply` / :func:`make_quant_fwd_sample`
  (the quantized forward, with an ``int8`` arm, int8 x int8 -> int32
  products through ``torch._int_mm``, and a ``folded`` arm, the int8
  weights carried in bf16 with an f32 accumulator);
- :mod:`calibrate`: activation-range capture, live
  (:class:`CalibrationTap` on the predictor's shadow mirror) or offline
  (:func:`calibrate_offline`, :func:`calibrate_from_env`).

The names resolve lazily: spawned env children import :mod:`spec`, which
runs this file first, and must not import torch through it.
"""

import importlib

_WHERE = {
    "ActRangeAccumulator": "calibrate",
    "CalibrationTap": "calibrate",
    "calibrate_from_env": "calibrate",
    "calibrate_offline": "calibrate",
    "QUANT_ARMS": "qforward",
    "int8_conv_supported": "qforward",
    "make_quant_apply": "qforward",
    "make_quant_fwd_sample": "qforward",
    "quant_layer_names": "qforward",
    "quantize_params": "qforward",
    "QUANT_METHODS": "spec",
    "QuantSpec": "spec",
}

__all__ = [
    "ActRangeAccumulator",
    "CalibrationTap",
    "QUANT_ARMS",
    "QUANT_METHODS",
    "QuantSpec",
    "calibrate_from_env",
    "calibrate_offline",
    "int8_conv_supported",
    "make_quant_apply",
    "make_quant_fwd_sample",
    "quant_layer_names",
    "quantize_params",
]


def __getattr__(name):
    mod = _WHERE.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{mod}"), name)

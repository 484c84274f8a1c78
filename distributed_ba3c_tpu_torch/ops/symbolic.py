"""Symbolic helper functions.

Port of ``distributed_ba3c_tpu/ops/symbolic.py``: only ``huber_loss``,
which backs the optional robust value regression of
:func:`distributed_ba3c_tpu_torch.ops.loss.a3c_loss` (``huber_delta``).
"""

from __future__ import annotations

import torch


def huber_loss(x: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    """Elementwise Huber: quadratic within |x|<=delta, linear outside."""
    abs_x = torch.abs(x)
    quad = 0.5 * torch.square(x)
    lin = delta * (abs_x - 0.5 * delta)
    return torch.where(abs_x <= delta, quad, lin)

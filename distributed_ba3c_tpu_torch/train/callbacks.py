"""Hyperparameter schedules.

Port of ``anneal_interp`` (``distributed_ba3c_tpu/train/callbacks.py:208``),
the schedule formula of the fused loop's per-epoch ``sched``.
"""

from __future__ import annotations


def anneal_interp(v0: float, v1: float, frac: float, mode: str) -> float:
    """Interpolate a hyperparam between ``v0`` and ``v1`` at ``frac`` in
    [0, 1]. ``mode="exp"`` is geometric and needs positive endpoints."""
    frac = min(max(frac, 0.0), 1.0)
    if mode == "exp":
        if v0 <= 0 or v1 <= 0:
            raise ValueError(
                f"exp anneal needs positive endpoints, got {v0} -> {v1}"
            )
        return v0 * (v1 / v0) ** frac
    return v0 + frac * (v1 - v0)

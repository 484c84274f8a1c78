"""Hyperparameter schedules and live overrides.

Port of ``anneal_interp`` (``distributed_ba3c_tpu/train/callbacks.py:208``),
the schedule formula of the fused loop's per-epoch ``sched``, and of
``read_hyper_file`` (``:273-298``), the reader of the ``hyper.txt`` live
overrides.
"""

from __future__ import annotations

import os
from typing import Dict

from distributed_ba3c_tpu_torch.utils import logger


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


def read_hyper_file(path: str) -> Dict[str, float]:
    """Parse a hyper.txt of ``name: value`` lines ({} if absent or
    unreadable). A malformed line is skipped with a warning; the other
    lines still apply, so one typo mid-edit does not revert every
    override to its scheduled value."""
    if not os.path.isfile(path):
        return {}
    try:
        with open(path) as f:
            lines = f.readlines()
    except OSError:
        logger.warn("could not read %s", path)
        return {}
    out: Dict[str, float] = {}
    for line in lines:
        if ":" not in line:
            continue
        k, _, v = line.partition(":")
        try:
            out[k.strip()] = float(v)
        except ValueError:
            logger.warn("ignoring malformed line in %s: %r", path, line.strip())
    return out

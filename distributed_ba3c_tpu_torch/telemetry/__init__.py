"""Telemetry for the serving and actor planes: per-role metric registries,
the fleet wire and a flight-recorder ring.

The metrics core is a copy of ``distributed_ba3c_tpu/telemetry/metrics.py``
and the fleet wire (piggybacked counter deltas, :mod:`.wire`) of
``telemetry/wire.py``. :func:`record` keeps the last events in memory, as
the JAX package's flight recorder does; its postmortem dumps, exporters and
tracing spans are not ported yet.

    from distributed_ba3c_tpu_torch import telemetry
    telemetry.registry("predictor").counter("rows_total").inc(B)
    telemetry.record("predictor_callback_error", error="...")
"""

from __future__ import annotations

import collections
import time

from distributed_ba3c_tpu_torch.telemetry.metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    Registry,
    all_registries,
    all_snapshots,
    enabled,
    fleet_role,
    registry,
    reset_all,
    set_enabled,
)
from distributed_ba3c_tpu_torch.telemetry.wire import (  # noqa: F401
    PIGGYBACK_EVERY,
    DeltaTracker,
    apply_fleet_deltas,
)

#: the recorder's ring: (time.monotonic(), kind, fields), oldest first
_RING: collections.deque = collections.deque(maxlen=4096)


def export_scalars(
    roles=("master", "predictor", "learner", "fleet"), prefix: str = "tele/"
) -> dict:
    """Counters and gauges flattened to ``{"tele/<role>/<name>": value}``
    for stat.json (histograms as _count/_sum); a role matches itself and
    its dotted sub-roles (``master.f0``), as the JAX exporter's."""
    out = {}
    regs = all_registries()
    for base in roles:
        for role in sorted(regs):
            if role != base and not role.startswith(f"{base}."):
                continue
            for name, v in regs[role].scalars().items():
                out[f"{prefix}{role}/{name}"] = v
    return out


def record(kind: str, **fields) -> None:
    """Append one structured event to the ring (a GIL-atomic deque append,
    safe from any thread)."""
    if enabled():
        _RING.append((time.monotonic(), kind, fields))


def recorded(kind=None) -> list:
    """The ring's events as ``{"t_monotonic", "kind", **fields}`` dicts,
    oldest first; ``kind`` filters to one event kind."""
    return [
        {"t_monotonic": t, "kind": k, **f}
        for t, k, f in list(_RING)
        if kind is None or k == kind
    ]

"""Fleet aggregation: metric deltas piggybacked on the existing actor wire.

A copy of ``distributed_ba3c_tpu/telemetry/wire.py``. On a sampled step
(``--trace_sample``) the senders append a trace context after the deltas
slot, pinned then (possibly ``{}``): a 6th per-env element, or a second
tail element on a block header. ``tracing.stamp_wire_meta`` is the one
place that lays the tail out, for every sender of the port.

Simulator servers live in their own processes; giving each a scrape port
(or a new socket pair back to the master) would multiply the plane's file
descriptors and syscalls for data that already has a perfectly good pipe.
Instead the servers piggyback a compact ``{name: delta}`` dict on the wire
messages they already send, every :data:`PIGGYBACK_EVERY` steps:

- block wires: appended as ONE extra element on the ``pack_block`` header
  meta (``[ident, step, B, (tele)]`` / the 8-element block-shm meta + tele).
  The header is version-bumped BY LENGTH — a master reads the tele element
  only when the meta is longer than the base layout, so old headers (and
  telemetry-disabled senders, which keep the old layout) still parse.
- per-env wire: appended as an optional 5th element on the msgpack message
  (``[ident, state, reward, isOver, tele]``), same length-based versioning.

DELTAS, not cumulative values: the master just adds them into the ``fleet``
registry, so a server restart (fresh counters) loses at most one piggyback
window instead of double-counting or going backwards.
"""

from __future__ import annotations

import math
import re
import time
from typing import Dict, Optional

from distributed_ba3c_tpu_torch.telemetry import metrics

#: steps between piggybacks. At the block wire's ~100 block-steps/s/server
#: this is ~2 Hz of ~100-byte payloads — invisible next to the obs bytes.
PIGGYBACK_EVERY = 64


class DeltaTracker:
    """Sender side: counter deltas of one registry since the last call."""

    def __init__(self, reg: Optional[metrics.Registry] = None):
        self.reg = reg or metrics.registry("simulator")
        self._last: Dict[str, float] = {}

    def deltas(self) -> Dict[str, float]:
        """``{name: delta}`` for every counter that moved (possibly {})."""
        out: Dict[str, float] = {}
        for name, m in list(self.reg._metrics.items()):
            if not isinstance(m, metrics.Counter):
                continue
            v = m.value()
            d = v - self._last.get(name, 0.0)
            if d:
                # plain python floats/ints: the msgpack header codec must
                # not meet numpy scalars here
                out[name] = int(d) if float(d).is_integer() else float(d)
                self._last[name] = v
        return out


#: master side: last-seen monotonic per (fleet role, sender ident), so the
#: fleet client count reflects senders that piggybacked recently (not all
#: time) — and a multi-fleet learner's per-fleet gauges count only their
#: own senders. Keyed by (role, ident), NOT ident alone: two fleets'
#: senders may legitimately share an ident (external fleets launched with
#: launch_env_fleet's default cppsim-* prefixes collide across hosts —
#: the master knows the fleet by which pipe the message arrived on), and
#: an ident-keyed table would flap the stored role between fleets,
#: corroding BOTH reporting_clients gauges toward 0 with every server
#: healthy. ONE table across fleets: the 4096 cap is a process budget.
_FLEET_SEEN: Dict[tuple, float] = {}
_FLEET_WINDOW_S = 120.0

#: hard cap on distinct fleet series (the shipped instrumentation uses a
#: handful; 256 leaves room for growth while bounding what a stray sender
#: on the bound port can mint)
_FLEET_MAX_SERIES = 256

#: the Prometheus metric-name grammar (ASCII), minus the colon namespace
_NAME_RE = re.compile(r"[A-Za-z_][A-Za-z0-9_]*")

#: hard cap on tracked sender idents (a 64-node fleet is ~couple hundred
#: server slots; 4096 bounds what ident churn or a stray sender can cost)
_FLEET_MAX_SENDERS = 4096


def _fleet_clients(role: str = "fleet") -> int:
    now = time.monotonic()
    # read-time pruning of long-dead senders bounds the table under ident
    # churn (a restarting fleet cycles idents); entries get a long grace
    # past the liveness window so a stalled-then-recovered sender is not
    # forgotten between scrapes
    dead = [
        k for k, t in list(_FLEET_SEEN.items())
        if now - t > 10 * _FLEET_WINDOW_S
    ]
    for k in dead:
        _FLEET_SEEN.pop(k, None)
    return sum(
        1
        for (r, _), t in list(_FLEET_SEEN.items())
        if r == role and now - t < _FLEET_WINDOW_S
    )


def apply_fleet_deltas(ident: bytes, deltas, role: str = "fleet") -> None:
    """Fold one sender's piggybacked deltas into the ``role`` registry
    (``fleet`` for a single-fleet master, ``fleet.f<k>`` per fleet when a
    learner hosts several — telemetry.fleet_role is the name formula).

    Wire input is untrusted (same posture as the block decoder): anything
    that is not a {str: number} mapping is dropped without touching the
    receive loop.
    """
    if not isinstance(deltas, dict):
        return
    reg = metrics.registry(role)
    reg.gauge(
        "reporting_clients", fn=lambda r=role: _fleet_clients(r)
    )
    key = (role, bytes(ident))
    if key in _FLEET_SEEN or len(_FLEET_SEEN) < _FLEET_MAX_SENDERS:
        # bounded like the series table: a stray sender minting fresh
        # idents must not grow the table (and the gauge's O(n) read)
        # without limit — known idents always refresh
        _FLEET_SEEN[key] = time.monotonic()
    for name, d in deltas.items():
        if not isinstance(name, str) or not isinstance(d, (int, float)):
            continue
        if isinstance(d, bool) or not math.isfinite(d) or not 0 < d <= 1e15:
            # counters only move UP by finite amounts: one NaN folded into
            # a cell poisons the series for the rest of the run, and
            # negative deltas break the monotonic contract rate() needs
            continue
        if len(name) > 64 or not _NAME_RE.fullmatch(name):
            # junk names must not mint junk series: ASCII-only — str.isalnum
            # passes Unicode letters, and ONE non-grammar metric name in the
            # registry would poison every subsequent /metrics scrape
            continue
        if name not in reg._metrics and len(reg._metrics) >= _FLEET_MAX_SERIES:
            # cardinality cap, PER fleet registry: a stray sender on a
            # bound port must not be able to grow its fleet's registry
            # (and the /metrics payload) without bound by minting fresh
            # names. The cap stays per-registry rather than global because
            # fleet ROLES are trusted — only a master's configured
            # tele_role mints one — so the process total is bounded by
            # K x 256 with K operator-chosen, while a global budget would
            # let one fleet's junk senders crowd a later fleet's
            # legitimate series out entirely
            continue
        reg.counter(name).inc(d)

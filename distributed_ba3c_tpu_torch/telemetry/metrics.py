"""Sharded metrics core: Counter / Gauge / log2-bucket Histogram + Registry.

A copy of ``distributed_ba3c_tpu/telemetry/metrics.py``.

Built for the 52.8k env-steps/s/host hot path (``runs/plane_bench_r6.json``):
no locks on the write side, aggregation at read time. Each metric keeps one
cell PER WRITER THREAD; a thread only ever mutates its own cell, and
mutating a Python int/list slot under the GIL is atomic enough — a reader
summing cells mid-increment sees a value that was true a moment ago, which
is all a monitoring plane needs. The ONE rule: never take a lock, never
make a syscall on the increment path (the futex-per-op cost class that
made ``queue.Queue`` the plane's ceiling — utils/concurrency.py).

Increment cost budget: a ``Counter.inc`` is a ``threading.get_ident()`` +
dict get + int add (~0.3 us). Hot-path call sites amortize further by
incrementing ONCE PER BATCH (a block flush adds its whole datapoint count
in one ``inc(n)``), so per-env-step overhead is nanoseconds — the
``scripts/plane_bench.py --telemetry both`` gate pins the total at <=2%
(runs/plane_bench_r7.json).

Registries are per ROLE, not per process: the trainer process hosts the
``master``, ``predictor`` and ``learner`` registries side by side, plus a
``fleet`` registry the master fills from env-server piggyback deltas
(telemetry/wire.py). Exporters (telemetry/exporters.py) walk
:func:`all_registries`.

``BA3C_TELEMETRY=0`` (or :func:`set_enabled`) turns every write into a
cheap branch-and-return — the A/B lever the plane-bench overhead gate
measures against.
"""

from __future__ import annotations

import os
import threading
from typing import Callable, Dict, List, Optional

#: number of log2 buckets a histogram keeps. With unit=1e-6 (microseconds)
#: bucket 39 covers ~2^39 us ≈ 6.4 days — nothing a run produces overflows.
N_BUCKETS = 40

_enabled = os.environ.get("BA3C_TELEMETRY", "1") not in ("", "0")


def enabled() -> bool:
    return _enabled


def fleet_role(base: str, fleet: Optional[int] = None) -> str:
    """The canonical telemetry role for one fleet's plane component.

    THE single formula (docs/observability.md): ``master``/``predictor``/
    ``fleet`` for a single-fleet run (every existing dashboard keeps
    working), ``master.f<k>`` etc. when a learner hosts several fleets —
    the per-fleet scrape label ``http_signals``/``/json`` consumers key on.
    Deriving it in two places would let the exporter and the autoscaler
    address different registries.
    """
    return base if fleet is None else f"{base}.f{int(fleet)}"


def set_enabled(flag: bool) -> None:
    """Flip the process-wide write switch (child processes inherit the
    ``BA3C_TELEMETRY`` env var instead — set both when spawning)."""
    global _enabled
    _enabled = bool(flag)


class Counter:
    """Monotonic counter, sharded per writer thread.

    ``inc(n)`` touches only the calling thread's cell; ``value()`` sums all
    cells. Creating a missing cell mutates the dict, which is safe: dict
    ``__setitem__`` is GIL-atomic and each key has exactly one writer.
    """

    __slots__ = ("name", "_cells")

    def __init__(self, name: str):
        self.name = name
        self._cells: Dict[int, List[float]] = {}

    def inc(self, n: float = 1) -> None:
        if not _enabled:
            return
        tid = threading.get_ident()
        cell = self._cells.get(tid)
        if cell is None:
            self._cells[tid] = cell = [0]
        cell[0] += n

    def value(self) -> float:
        # list() snapshots the cells: a reader racing another thread's
        # FIRST inc (which inserts a new key) must not die with
        # "dictionary changed size during iteration"
        return sum(c[0] for c in list(self._cells.values()))

    def collect(self) -> dict:
        return {"type": "counter", "value": self.value()}

    def reset(self) -> None:
        self._cells = {}


class Gauge:
    """Point-in-time value: either ``set()`` by writers (last write wins,
    assignment is atomic) or backed by a zero-argument callable evaluated at
    READ time (``fn=...``) — the right shape for queue depths and client
    counts, which would otherwise need a hot-path write per change."""

    __slots__ = ("name", "_value", "_fn")

    def __init__(self, name: str, fn: Optional[Callable[[], float]] = None):
        self.name = name
        self._value = 0.0
        self._fn = fn

    def set(self, v: float) -> None:
        if not _enabled:
            return
        self._value = v

    def set_fn(self, fn: Optional[Callable[[], float]]) -> None:
        """(Re)bind the read-time callable (last binder wins — a new master
        replacing a closed one takes over the series)."""
        self._fn = fn

    def value(self) -> float:
        if self._fn is not None:
            try:
                return float(self._fn())
            except Exception:
                # a gauge over a torn-down object (closed queue, dead
                # master) must read 0, not kill the scrape
                return 0.0
        return float(self._value)

    def collect(self) -> dict:
        return {"type": "gauge", "value": self.value()}

    def reset(self) -> None:
        self._value = 0.0


class Histogram:
    """log2-bucket histogram, sharded per writer thread.

    Bucket ``i`` counts observations ``v`` with ``v/unit`` in
    ``[2^(i-1), 2^i)`` (bucket 0 takes everything below ``unit``). log2 is
    one ``int.bit_length()`` — no float math, no branching search — and 40
    buckets span nine decades, plenty for queue waits (us..minutes) and
    batch occupancies alike. ``unit`` picks the resolution floor: 1e-6 for
    second-valued latencies, 1 for counts.
    """

    __slots__ = ("name", "unit", "_cells")

    def __init__(self, name: str, unit: float = 1e-6):
        self.name = name
        self.unit = unit
        # per-thread cell: [count, sum, b0..b39]
        self._cells: Dict[int, List[float]] = {}

    def observe(self, v: float) -> None:
        if not _enabled:
            return
        tid = threading.get_ident()
        cell = self._cells.get(tid)
        if cell is None:
            self._cells[tid] = cell = [0, 0.0] + [0] * N_BUCKETS
        cell[0] += 1
        cell[1] += v
        q = int(v / self.unit)
        b = q.bit_length() if q > 0 else 0
        cell[2 + (b if b < N_BUCKETS else N_BUCKETS - 1)] += 1

    @property
    def count(self) -> int:
        # list(): see Counter.value — snapshot against first-observe races
        return int(sum(c[0] for c in list(self._cells.values())))

    @property
    def sum(self) -> float:
        return float(sum(c[1] for c in list(self._cells.values())))

    def buckets(self) -> List[int]:
        """Per-bucket (non-cumulative) counts, aggregated over threads."""
        out = [0] * N_BUCKETS
        for c in list(self._cells.values()):
            for i in range(N_BUCKETS):
                out[i] += c[2 + i]
        return out

    def collect(self) -> dict:
        return {
            "type": "histogram",
            "count": self.count,
            "sum": self.sum,
            "unit": self.unit,
            "buckets": self.buckets(),
        }

    def reset(self) -> None:
        self._cells = {}


class Registry:
    """One role's named metrics; get-or-create, read-side aggregation."""

    def __init__(self, role: str):
        self.role = role
        self._metrics: Dict[str, object] = {}
        # creation is rare (wiring time) — a lock here costs nothing and
        # keeps get-or-create race-free; the hot path never enters it
        self._lock = threading.Lock()

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str, fn: Optional[Callable[[], float]] = None) -> Gauge:
        g = self._get(name, Gauge)
        if fn is not None:
            g.set_fn(fn)
        return g

    def histogram(self, name: str, unit: float = 1e-6) -> Histogram:
        return self._get(name, lambda n: Histogram(n, unit=unit))

    def _get(self, name: str, ctor):
        m = self._metrics.get(name)
        if m is None:
            with self._lock:
                m = self._metrics.get(name)
                if m is None:
                    self._metrics[name] = m = ctor(name)
        return m

    def names(self) -> List[str]:
        return sorted(self._metrics)

    def collect(self) -> Dict[str, dict]:
        """``{name: {"type": ..., "value"/"buckets": ...}}`` snapshot."""
        return {n: self._metrics[n].collect() for n in self.names()}

    def scalars(self) -> Dict[str, float]:
        """Counters + gauges as plain floats (histograms as _count/_sum) —
        the stat.json/TB export shape (utils/stats.py)."""
        out: Dict[str, float] = {}
        for n in self.names():
            m = self._metrics[n]
            if isinstance(m, Histogram):
                out[f"{n}_count"] = float(m.count)
                out[f"{n}_sum"] = m.sum
            else:
                out[n] = float(m.value())
        return out


_registries: Dict[str, Registry] = {}
_registries_lock = threading.Lock()


def registry(role: str) -> Registry:
    """The process-wide registry for ``role`` (get-or-create)."""
    r = _registries.get(role)
    if r is None:
        with _registries_lock:
            r = _registries.get(role)
            if r is None:
                _registries[role] = r = Registry(role)
    return r


def all_registries() -> Dict[str, Registry]:
    with _registries_lock:
        return dict(_registries)


def all_snapshots() -> Dict[str, Dict[str, dict]]:
    """``{role: {name: collected}}`` over every live registry."""
    return {role: r.collect() for role, r in sorted(all_registries().items())}


def reset_all() -> None:
    """Drop every registered metric (bench harness between same-session
    runs; objects still held by old masters keep working, just unexported)."""
    with _registries_lock:
        for r in _registries.values():
            r._metrics = {}
    # the fleet-aggregation sender table resets with the registries, and
    # so do the buffered spans and peer clock offsets (per-run evidence)
    from distributed_ba3c_tpu_torch.telemetry import tracing, wire

    wire._FLEET_SEEN.clear()
    tracing.reset()

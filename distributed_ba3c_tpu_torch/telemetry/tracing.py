"""Distributed trace plane: causal block-lifetime spans across processes.

A copy of ``distributed_ba3c_tpu/telemetry/tracing.py``: the same ids,
context codec and wire layout, so a trace started by a sender of either
package continues in a master of the other. It imports no torch: spawned
env-server and simulator children import it.

The metrics core answers "how fast" and the flight recorder answers "what
broke"; neither answers "WHERE did this block's wall-clock go". The single
``e2e_ingest_latency_s`` blob (actors/simulator.py) collapses six hops —
env step, wire transit, predictor dispatch/fetch, unroll flush, queue
wait, collate, device ingest — into one number, and the pod plane adds a
whole cross-process leg no series attributes at all. This module is the
decomposition: sampled, causal, span-based tracing with the SAME
lock-free per-thread-sharded design as the metrics core.

Design constraints (the metrics core's, inherited verbatim):

- **No locks, no syscalls on the hot path.** A finished span is one
  ``time.monotonic_ns`` pair + an append to the calling thread's own
  bounded cell (deque appends are GIL-atomic). Readers aggregate at
  scrape time.
- **1-in-N block sampling.** Tracing is off (``sample_n == 0``) unless
  ``--trace_sample N`` / ``BA3C_TRACE=N`` arms it; the untraced
  (N-1)/N of block steps pay ONE modulo per block message. The sampling
  decision is deterministic in the block step counter, so a trace is
  reproducible and the off/on overhead gate
  (``scripts/plane_bench.py --trace both``) is an honest A/B.
- **``BA3C_TELEMETRY=0`` kills this plane too** — tracing is a telemetry
  layer, not a second switch to audit.

Wire format (the telemetry-delta piggyback pattern, telemetry/wire.py):
a sampled block carries a compact **trace context** as a new
length-versioned element on the existing block / block-shm / per-env
headers, and as an optional ``"tr"`` key on the pod wire's stamped
messages (pod/wire.py). The context is a plain msgpack list::

    [version, trace_id, span_id, send_mono_us, origin_dur_us]

- ``version``: integer codec version (:data:`CTX_VERSION`). A receiver
  accepts any version >= 1 and reads only the fields it knows — unknown
  NEWER versions with extra fields parse fine (forward tolerance), and
  junk parses to None without touching the receive loop.
- ``trace_id`` / ``span_id``: 63-bit ids; the span id names the sender's
  originating span so the receiver's first span parents onto it.
- ``send_mono_us``: the sender's ``time.monotonic`` in µs at send time —
  the **clock-alignment handshake**. The receiver records
  ``local_recv - send_mono_us`` per peer and keeps the MINIMUM observed
  (transit latency only ever inflates the difference, so the min
  converges on true_offset + min_transit); :func:`align` maps any remote
  stamp onto the local monotonic timeline through that offset.
- ``origin_dur_us``: how long the sender's own originating hop took
  (e.g. the env server's ``env.step``), so the receiver can synthesize
  the origin span without the sender needing a scrape endpoint.

Exports: ``GET /trace`` on the TelemetryServer returns
:func:`trace_document` (spans + per-peer clock offsets + a
monotonic/wall anchor pair); ``scripts/trace_dump.py`` merges one or
more such documents into Chrome trace-event / Perfetto JSON. Every
finished span ALSO folds its duration into a per-hop latency histogram
``hop_<name>_s`` in its role registry — the sampled breakdown that
retires the single e2e blob into named hops on ``/metrics``.
"""

from __future__ import annotations

import collections
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from distributed_ba3c_tpu_torch.telemetry import metrics as _metrics

#: trace-context codec version (bump when APPENDING fields; receivers
#: read prefix fields only, so old receivers parse new contexts)
CTX_VERSION = 1

#: spans kept PER WRITER THREAD before drop-oldest engages — a scrape
#: cadence of seconds at sampled rates never fills this; a stuck scraper
#: costs bounded memory, never a stalled hot path
DEFAULT_SPAN_CAPACITY = 4096

#: 63-bit id space: msgpack encodes them as positive fixints/uint64 and
#: they survive JSON round-trips without sign surprises
_ID_MASK = (1 << 63) - 1


def _env_sample_n() -> int:
    try:
        return max(0, int(os.environ.get("BA3C_TRACE", "0") or 0))
    except ValueError:
        return 0


_sample_n = _env_sample_n()


def sample_n() -> int:
    """The process-wide 1-in-N block sampling rate (0 = tracing off)."""
    return _sample_n


def set_sampling(n: int) -> None:
    """Arm (or disarm, n=0) sampling process-wide. Child processes
    inherit the ``BA3C_TRACE`` env var instead — set both when spawning
    (the cli.py / bench.py idiom for BA3C_TELEMETRY)."""
    global _sample_n
    _sample_n = max(0, int(n))


def enabled() -> bool:
    """Tracing is live: telemetry on AND a sampling rate armed."""
    return _sample_n > 0 and _metrics.enabled()


def sampled(step: int, n: Optional[int] = None) -> bool:
    """The deterministic 1-in-N sampling decision for block ``step``.

    Deterministic in the step counter (not RNG): the same run traces the
    same steps, the overhead gate's off arm skips exactly what the on
    arm samples, and a test can predict which steps carry context."""
    n = _sample_n if n is None else n
    return n > 0 and step % n == 0


def now_us() -> int:
    """Local monotonic µs — THE span timebase (wall clock jumps; A4)."""
    return time.monotonic_ns() // 1000


def make_id(*parts) -> int:
    """Deterministic 63-bit id from hashable parts (ident, step) — the
    trace id an env server mints without an RNG in its hot loop."""
    h = 1469598103934665603  # FNV-1a offset basis
    for p in parts:
        for b in repr(p).encode():
            h = ((h ^ b) * 1099511628211) & 0xFFFFFFFFFFFFFFFF
    return h & _ID_MASK or 1


class SpanBuffer:
    """Bounded per-thread-sharded store of finished spans.

    A span is the tuple ``(trace_id, span_id, parent_id, name, role,
    t_start_us, dur_us, tags)`` — appended to the calling thread's own
    ``deque(maxlen=...)`` (GIL-atomic, no lock, no syscall). Readers
    snapshot all cells; drop-oldest per cell bounds memory under a
    stalled scraper. ``dropped`` counts evicted spans (read-side
    estimate: appends beyond capacity)."""

    def __init__(self, capacity: int = DEFAULT_SPAN_CAPACITY):
        self.capacity = capacity
        # tid -> [append_count, deque]: ONE dict, fetched ONCE per add —
        # a concurrent reset() swapping the dict leaves a mid-add writer
        # on its old (consistent) cell instead of KeyError-ing between
        # two parallel tables (the single-dict metrics-core pattern)
        self._cells: Dict[int, list] = {}

    def add(self, span: tuple) -> None:
        tid = threading.get_ident()
        cell = self._cells.get(tid)
        if cell is None:
            self._cells[tid] = cell = [
                0, collections.deque(maxlen=self.capacity)
            ]
        cell[1].append(span)
        cell[0] += 1

    def __len__(self) -> int:
        return sum(len(c[1]) for c in list(self._cells.values()))

    @property
    def dropped(self) -> int:
        cells = list(self._cells.values())
        return max(0, sum(c[0] for c in cells) - sum(len(c[1]) for c in cells))

    def snapshot(self) -> List[dict]:
        """All buffered spans as JSON-ready dicts, sorted by start time
        (cells are per-thread, so a global causal read needs the sort)."""
        out = []
        for cell in list(self._cells.values()):
            for (tr, sp, parent, name, role, t0, dur, tags) in list(cell[1]):
                d = {
                    "trace_id": tr, "span_id": sp, "parent_id": parent,
                    "name": name, "role": role, "ts_us": t0, "dur_us": dur,
                }
                if tags:
                    d["tags"] = tags
                out.append(d)
        out.sort(key=lambda d: d["ts_us"])
        return out

    def reset(self) -> None:
        self._cells = {}


class Tracer:
    """One process's span sink + peer clock-offset table.

    ``finish_span`` is the ONE write path: it stores the span and folds
    the duration into the role registry's ``hop_<name>_s`` histogram, so
    the sampled per-hop breakdown shows up on ``/metrics`` next to the
    unsampled counters without a second instrumentation pass."""

    def __init__(self, capacity: int = DEFAULT_SPAN_CAPACITY):
        self.spans = SpanBuffer(capacity)
        # peer -> min observed (local - remote) µs; one writer thread per
        # peer in practice (the receive loop that owns that wire), and a
        # racing double-store of two near-equal minima is harmless
        self._offsets: Dict[str, int] = {}
        self._seq = [0]  # span-id nonce (GIL-atomic += under one writer)

    # -- ids ---------------------------------------------------------------
    def next_span_id(self) -> int:
        self._seq[0] += 1
        return make_id(os.getpid(), threading.get_ident(), self._seq[0])

    # -- clock alignment ---------------------------------------------------
    def observe_remote_clock(
        self, peer: str, remote_us: int, local_us: Optional[int] = None
    ) -> int:
        """Fold one handshake stamp into ``peer``'s offset; returns the
        current offset estimate (local = remote + offset). Min-filtered:
        transit latency only ever ADDS to the observed difference."""
        if local_us is None:
            local_us = now_us()
        obs = int(local_us) - int(remote_us)
        cur = self._offsets.get(peer)
        if cur is None or obs < cur:
            self._offsets[peer] = obs
            return obs
        return cur

    def clock_offset(self, peer: str) -> Optional[int]:
        return self._offsets.get(peer)

    def align(self, peer: str, remote_us: int) -> int:
        """Map a peer's monotonic stamp onto the LOCAL timeline (identity
        when no handshake has been observed yet)."""
        return int(remote_us) + self._offsets.get(peer, 0)

    # -- spans -------------------------------------------------------------
    def finish_span(
        self,
        trace_id: int,
        name: str,
        role: str,
        t_start_us: int,
        t_end_us: Optional[int] = None,
        parent_id: int = 0,
        span_id: Optional[int] = None,
        tags: Optional[dict] = None,
    ) -> int:
        """Record one completed span; returns its span id (the parent for
        the next hop). Durations clamp at >= 0: a cross-process start
        aligned through a still-converging offset must never emit a
        negative-length span into the export.

        ``BA3C_TELEMETRY=0`` gates the WRITE here, at the single sink:
        a remote sender stamping contexts at a telemetry-disabled
        receiver must not fill its span buffer (the kill-switch
        contract) — the id still mints so callers' chains stay
        well-formed if telemetry flips mid-trace."""
        if span_id is None:
            span_id = self.next_span_id()
        if not _metrics.enabled():
            return span_id
        if t_end_us is None:
            t_end_us = now_us()
        dur = max(0, int(t_end_us) - int(t_start_us))
        self.spans.add(
            (trace_id, span_id, parent_id, name, role, int(t_start_us),
             dur, tags)
        )
        # the per-hop histogram: sampled latencies, but the same log2
        # buckets/los as every other series — docs/observability.md
        _metrics.registry(role).histogram(f"hop_{name}_s").observe(dur / 1e6)
        return span_id

    def document(self) -> dict:
        """The ``/trace`` endpoint body: spans + offsets + anchor pair.

        ``anchor_monotonic_us``/``anchor_wall`` let offline tooling map
        this process's monotonic timeline to wall time (the flight
        recorder's anchor idiom); ``clock_offsets_us`` carries the
        measured per-peer handshake offsets so ``trace_dump.py`` can
        merge several processes' documents onto one timeline."""
        return {
            "pid": os.getpid(),
            "sample_n": _sample_n,
            "anchor_monotonic_us": now_us(),
            "anchor_wall": time.time(),
            "clock_offsets_us": dict(self._offsets),
            "dropped_spans": self.spans.dropped,
            "spans": self.spans.snapshot(),
        }

    def reset(self) -> None:
        self.spans.reset()
        self._offsets = {}


_tracer: Optional[Tracer] = None
_tracer_lock = threading.Lock()


def tracer() -> Tracer:
    """The process's tracer (get-or-create)."""
    global _tracer
    if _tracer is None:
        with _tracer_lock:
            if _tracer is None:
                _tracer = Tracer()
    return _tracer


def reset() -> None:
    """Drop buffered spans and offsets (bench harness between runs)."""
    if _tracer is not None:
        _tracer.reset()


# -- the active-trace thread-local (flight-recorder correlation) -----------

_active = threading.local()


def current_trace_id() -> Optional[int]:
    """The trace id in scope on this thread, if any — the flight
    recorder stamps it onto events so postmortem dumps correlate with
    traces (telemetry/recorder.py)."""
    return getattr(_active, "trace_id", None)


class trace_scope:
    """Context manager marking ``trace_id`` active on this thread (no
    span is recorded — pair with :meth:`Tracer.finish_span` for that)."""

    __slots__ = ("trace_id", "_prev")

    def __init__(self, trace_id: Optional[int]):
        self.trace_id = trace_id

    def __enter__(self):
        self._prev = getattr(_active, "trace_id", None)
        _active.trace_id = self.trace_id
        return self

    def __exit__(self, *exc):
        _active.trace_id = self._prev
        return False


class span:
    """Context-manager span: ``with tracing.span(trace, "collate",
    "learner", parent=p) as s: ...`` records on exit and exposes
    ``s.span_id`` for parenting the next hop. The ba3clint A11 rule
    (orphan-span) wants exactly this shape — or an explicit
    ``finish()`` on every exit path."""

    __slots__ = ("trace_id", "name", "role", "parent_id", "tags",
                 "t_start_us", "span_id", "_done")

    def __init__(self, trace_id, name, role, parent=0, tags=None):
        self.trace_id = trace_id
        self.name = name
        self.role = role
        self.parent_id = parent
        self.tags = tags
        self.t_start_us = now_us()
        self.span_id = tracer().next_span_id()
        self._done = False

    def __enter__(self):
        return self

    def finish(self) -> int:
        if not self._done:
            self._done = True
            tracer().finish_span(
                self.trace_id, self.name, self.role, self.t_start_us,
                parent_id=self.parent_id, span_id=self.span_id,
                tags=self.tags,
            )
        return self.span_id

    def __exit__(self, *exc):
        self.finish()
        return False


# -- the wire context codec ------------------------------------------------

class TraceContext:
    """Decoded wire context (see module docstring for the field story)."""

    __slots__ = ("version", "trace_id", "span_id", "send_us", "origin_dur_us")

    def __init__(self, trace_id, span_id, send_us, origin_dur_us=0,
                 version=CTX_VERSION):
        self.version = int(version)
        self.trace_id = int(trace_id) & _ID_MASK
        self.span_id = int(span_id) & _ID_MASK
        self.send_us = int(send_us)
        self.origin_dur_us = max(0, int(origin_dur_us))


def encode_context(
    trace_id: int,
    span_id: int,
    send_us: Optional[int] = None,
    origin_dur_us: int = 0,
) -> list:
    """The header element a sampled sender appends (plain ints — the
    msgpack header codec must not meet numpy scalars here, the
    DeltaTracker lesson)."""
    return [
        CTX_VERSION,
        int(trace_id) & _ID_MASK,
        int(span_id) & _ID_MASK,
        int(send_us if send_us is not None else now_us()),
        int(origin_dur_us),
    ]


def decode_context(elem: Any) -> Optional[TraceContext]:
    """Tolerant inverse of :func:`encode_context`.

    Wire input is untrusted (the block decoder's posture): anything that
    is not a >= 4-element list of ints headed by a version >= 1 decodes
    to None — never an exception into a receive loop. A version NEWER
    than ours with extra trailing fields decodes fine (prefix read)."""
    if not isinstance(elem, (list, tuple)) or len(elem) < 4:
        return None
    try:
        ver = int(elem[0])
        if ver < 1:
            return None
        dur = int(elem[4]) if len(elem) > 4 else 0
        return TraceContext(
            int(elem[1]), int(elem[2]), int(elem[3]), dur, version=ver
        )
    except (TypeError, ValueError):
        return None


def stamp_wire_meta(
    meta: list,
    ident,
    step: int,
    deltas: Optional[dict] = None,
    origin_dur_us: int = 0,
) -> None:
    """Sender-side: append the length-versioned wire tail in one place.

    The rule (telemetry/wire.py + this module, receiver mirror in
    ``SimulatorMaster._on_block_frames``): the piggybacked ``deltas``
    element rides when present; on 1-in-N sampled steps the trace
    context is appended AFTER it with the deltas slot PINNED (possibly
    ``{}``) so receiver positions never shift under either feature
    alone. ONE implementation for every sender — the python simulators
    and the C++ env-server wrapper must not re-derive the layout."""
    if enabled() and sampled(step):
        meta.append(deltas if deltas is not None else {})
        meta.append(encode_context(
            make_id(ident, step),
            make_id(ident, step, "origin"),
            origin_dur_us=origin_dur_us,
        ))
    elif deltas is not None:
        meta.append(deltas)


# -- receive-side helpers --------------------------------------------------

def receive_context(
    ctx: Optional[TraceContext],
    peer: str,
    role: str,
    origin_name: str = "env_step",
    wire_name: str = "wire",
    origin_always: bool = False,
) -> Optional[Tuple[int, int]]:
    """Fold one received context into the local tracer: handshake the
    clock offset, then synthesize the sender-side origin span (duration
    shipped in the context) and the wire-transit span on the LOCAL
    timeline. Returns ``(trace_id, parent_span_id)`` for the receiver's
    own hops, or None when ``ctx`` is None.

    This is what lets env servers (and pod hosts) participate in traces
    without exposing a scrape endpoint: their two numbers ride the
    header, the receiver owns the spans. The SENDER owns the sampling
    decision (a receiver without ``--trace_sample`` still serves
    remotely-sampled traces), but ``BA3C_TELEMETRY=0`` kills the
    receive side too — no handshake, no spans, None out."""
    if ctx is None or not _metrics.enabled():
        return None
    t = tracer()
    recv_us = now_us()
    t.observe_remote_clock(peer, ctx.send_us, recv_us)
    send_local = t.align(peer, ctx.send_us)
    parent = ctx.span_id
    if ctx.origin_dur_us or origin_always:
        # origin_always: the experience wires synthesize the env_step
        # span even at 0 µs (a sub-µs fake env must not break chain
        # completeness); context kinds with no origin hop (pod params /
        # experience ship) leave it off and skip on zero
        parent = t.finish_span(
            ctx.trace_id, origin_name, role,
            send_local - ctx.origin_dur_us, send_local,
            parent_id=ctx.span_id,
        )
    parent = t.finish_span(
        ctx.trace_id, wire_name, role,
        min(send_local, recv_us), recv_us, parent_id=parent,
    )
    return ctx.trace_id, parent


class TraceRef:
    """A live trace's (trace_id, parent_span_id, t_mark_us) handoff —
    what rides BlockStep / segment dicts / feed batches between hops.
    ``t_mark_us`` is the previous hop's end, so the next hop's span can
    start where the last one finished (gap-free causal chain)."""

    __slots__ = ("trace_id", "parent_id", "t_mark_us")

    def __init__(self, trace_id: int, parent_id: int,
                 t_mark_us: Optional[int] = None):
        self.trace_id = trace_id
        self.parent_id = parent_id
        self.t_mark_us = t_mark_us if t_mark_us is not None else now_us()

    def hop(self, name: str, role: str,
            t_end_us: Optional[int] = None,
            tags: Optional[dict] = None) -> "TraceRef":
        """Record the span from the last mark to now (or ``t_end_us``)
        and advance the chain: returns a new ref parented on the span
        just recorded."""
        end = t_end_us if t_end_us is not None else now_us()
        sid = tracer().finish_span(
            self.trace_id, name, role, self.t_mark_us, end,
            parent_id=self.parent_id, tags=tags,
        )
        return TraceRef(self.trace_id, sid, end)

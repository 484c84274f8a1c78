"""Device-ingest staging: one host copy, H2D overlapped behind the learner.

Port of ``distributed_ba3c_tpu/data/staging.py`` (``HostStagingRing``,
``train_spec``, ``collate_train_into``, ``acquire_stoppable``,
``DeviceIngest``), in torch's terms:

- :class:`HostStagingRing`: a small ring of preallocated slots shaped like
  one collated batch. On a CUDA run the slots are **pinned** CPU tensors,
  written through numpy views by the in-place collates
  (:func:`collate_train_into`, :func:`collate_rollout_into`, the V-trace
  trainer's time-major ``[T, B, 84, 84, 4]`` states and ``[B, ...]``
  bootstrap states): ONE host copy per batch, counted on
  ``ingest_copies_total``.
- **The fence**: a slot handed to an H2D copy is not writable again until
  the copy has consumed its bytes. The JAX package fences on the device
  arrays' readiness; here it is a CUDA event recorded on the copy stream
  after the slot's copies, and :meth:`HostStagingRing.acquire` skips a slot
  whose event has not completed.
- :class:`DeviceIngest`: the trainer claims batch k (its copies already
  issued), runs the step, then calls :meth:`DeviceIngest.prefetch`, which
  issues batch k+1's copies with ``.to(device, non_blocking=True)`` on a
  dedicated copy stream while the learner's stream runs step k. At the
  claim the learner's stream ``wait_event``s the copy, and every device
  tensor ``record_stream``s on it, so the caching allocator cannot hand
  their memory to the copy stream while the step still reads it.

On the CPU nothing is pinned (``pin_memory`` needs CUDA): the "transfer" is
a ``clone`` (a CPU ``.to`` would alias the slot) and the fence is open at
once.

A sampled trace rides a :class:`StagedBatch` as its ``trace`` attribute
(a plain batch's ``"_trace"`` key): :class:`DeviceIngest` records
``h2d_copy`` when it has issued the batch's copies on the copy stream (host
time, behind the running step when a prefetch hid it) and ``ingest`` at
the claim, and hands the ref to the trainer as ``"_trace"``.

The pod learner's ``BlockStager`` is not ported yet (ROADMAP queue A item
9).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from distributed_ba3c_tpu_torch import telemetry

#: spec: key -> (shape, numpy dtype) of one collated batch's arrays
Spec = Dict[str, Tuple[tuple, Any]]

#: prefetch-queue depth (2) + one filling + one in-flight transfer
DEFAULT_SLOTS = 4


def _counters(tele_role: str):
    tele = telemetry.registry(tele_role)
    return (
        tele.counter("ingest_copies_total"),
        tele.counter("ingest_blocks_total"),
    )


def count_legacy_copies(
    passes: float, tele_role: str = "learner", blocks: int = 1
) -> None:
    """Self-report of a non-staged collate: ``passes`` full passes over one
    batch's obs bytes, ``blocks`` batches."""
    c_copies, c_blocks = _counters(tele_role)
    c_copies.inc(passes)
    if blocks:
        c_blocks.inc(blocks)


class _Slot:
    """One staging slot: its tensors, numpy views of them, and the fence."""

    __slots__ = ("tensors", "buffers", "event", "index")

    def __init__(self, tensors: Dict[str, torch.Tensor], index: int):
        self.tensors = tensors
        self.buffers = {k: t.numpy() for k, t in tensors.items()}
        self.event = None  # torch.cuda.Event of the last H2D, or None
        self.index = index


class StagedBatch(dict):
    """A collated batch living in a staging slot (a dict of the slot's numpy
    buffers, so every ``batch[k]`` consumer works unchanged). A consumer
    MUST resolve the slot: :class:`DeviceIngest` dispatch (which calls
    ``ring.dispatched``) or :meth:`release` when the batch is abandoned."""

    def __init__(self, buffers, slot: _Slot, ring: "HostStagingRing"):
        super().__init__(buffers)
        self.slot = slot
        self.ring = ring
        self.trace = None  # tracing.TraceRef of a sampled batch

    def release(self) -> None:
        self.ring.release(self.slot)


class HostStagingRing:
    """N preallocated staging slots with the copy fence.

    A single producer (the feed's batcher thread) acquires; a single
    consumer (:class:`DeviceIngest`) attaches the fence event after
    issuing the copies, or releases. The spec is adopted at the first
    ``acquire``; a change reallocates and is counted
    (``staging_realloc_total``). ``pin_memory`` pins the slots (a CUDA
    run's H2D then is a true asynchronous DMA).
    """

    def __init__(
        self,
        slots: int = DEFAULT_SLOTS,
        tele_role: str = "learner",
        pin_memory: bool = False,
    ):
        self._n = max(2, int(slots))
        self._pin = bool(pin_memory)
        self._slots: List[_Slot] = []
        self._spec: Optional[Spec] = None
        self._cursor = 0
        self._lock = threading.Lock()
        self._free = threading.Condition(self._lock)
        self._busy: set = set()  # slot indices acquired or queued, unfenced
        self.tele_role = tele_role
        tele = telemetry.registry(tele_role)
        self._c_copies, self._c_blocks = _counters(tele_role)
        self._c_waits = tele.counter("staging_waits_total")
        self._c_realloc = tele.counter("staging_realloc_total")
        self._h_wait = tele.histogram("staging_wait_s", unit=1e-6)
        import weakref

        ref = weakref.ref(self)
        tele.gauge(
            "staging_slots",
            fn=lambda: len(r._slots) if (r := ref()) else 0,
        )

    # -- allocation --------------------------------------------------------
    def _alloc(self, spec: Spec) -> None:
        def buf(shape, dtype):
            t = torch.empty(
                shape, dtype=torch.from_numpy(np.empty(0, dtype)).dtype
            )
            return t.pin_memory() if self._pin else t

        self._slots = [
            _Slot({k: buf(shape, dtype) for k, (shape, dtype) in spec.items()}, i)
            for i in range(self._n)
        ]
        self._spec = dict(spec)
        self._busy.clear()
        self._cursor = 0

    # -- producer side -----------------------------------------------------
    def acquire(
        self,
        spec: Spec,
        timeout: Optional[float] = None,
        stop: Optional[Callable[[], bool]] = None,
    ) -> Optional[_Slot]:
        """The next writable slot, or None on timeout/stop.

        Waits (bounded) while every slot is queued downstream or still
        read by an H2D copy — the ring's backpressure."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            if self._spec != spec:
                if self._spec is not None:
                    self._c_realloc.inc()
                self._alloc(spec)
            t0 = time.monotonic()
            waited = False
            while True:
                slot = self._next_free_locked()
                if slot is not None:
                    break
                waited = True
                remaining = 0.05
                if deadline is not None:
                    remaining = min(remaining, deadline - time.monotonic())
                    if remaining <= 0:
                        return None
                self._free.wait(remaining)
                if stop is not None and stop():
                    return None
            if waited:
                self._c_waits.inc()
            self._h_wait.observe(time.monotonic() - t0)
            self._busy.add(slot.index)
            slot.event = None
            return slot

    def _next_free_locked(self) -> Optional[_Slot]:
        """First slot that is not downstream AND whose fence is open."""
        for off in range(len(self._slots)):
            slot = self._slots[(self._cursor + off) % len(self._slots)]
            if slot.index in self._busy:
                continue
            if slot.event is not None and not slot.event.query():
                continue  # the H2D copy still reads the host bytes
            self._cursor = (slot.index + 1) % len(self._slots)
            return slot
        return None

    def staged(self, slot: _Slot) -> StagedBatch:
        """Wrap an acquired (and filled) slot for the out queue."""
        return StagedBatch(slot.buffers, slot, self)

    def count_staged_copy(self) -> None:
        """The ONE host copy of a staged batch (once per batch)."""
        self._c_copies.inc(1.0)
        self._c_blocks.inc()

    # -- consumer side -----------------------------------------------------
    def _owns(self, slot: _Slot) -> bool:
        """The slot belongs to the CURRENT generation (a realloc replaces
        the slot list; a stale slot must not free a live new one)."""
        return (
            slot.index < len(self._slots)
            and self._slots[slot.index] is slot
        )

    def dispatched(self, slot: _Slot, event) -> None:
        """The slot's copies were issued: record the fence event (None: the
        copies are done) and put the slot back in rotation."""
        with self._lock:
            if not self._owns(slot):
                return
            slot.event = event
            self._busy.discard(slot.index)
            self._free.notify_all()

    def release(self, slot: _Slot) -> None:
        """Return a slot without a dispatch (shutdown / abandoned batch)."""
        with self._lock:
            if not self._owns(slot):
                return
            slot.event = None
            self._busy.discard(slot.index)
            self._free.notify_all()


def train_spec(holder: List[list]) -> Spec:
    """Spec of ``collate_train``'s output for this holder (shapes read off
    the items, nothing materialized)."""
    state = holder[0][0]
    b = len(holder)
    return {
        "state": ((b, *np.shape(state)), np.dtype(getattr(state, "dtype", np.uint8))),
        "action": ((b,), np.dtype(np.int32)),
        "return": ((b,), np.dtype(np.float32)),
    }


def rollout_spec(holder: List[dict]) -> Spec:
    """Spec of ``collate_rollout``'s output (time-major [T, B] layout)."""
    seg = holder[0]
    b = len(holder)
    t = len(seg["action"])
    state = seg["state"]  # SegStates or a [T, ...] ndarray: both have .shape
    boot = seg["bootstrap_state"]
    return {
        "state": ((t, b, *tuple(state.shape)[1:]),
                  np.dtype(getattr(state, "dtype", np.uint8))),
        "action": ((t, b), np.dtype(np.int32)),
        "reward": ((t, b), np.dtype(np.float32)),
        "done": ((t, b), np.dtype(np.float32)),
        "behavior_log_probs": ((t, b), np.dtype(np.float32)),
        "bootstrap_state": ((b, *np.shape(boot)),
                            np.dtype(getattr(boot, "dtype", np.uint8))),
    }


def _write_states(dest: np.ndarray, src) -> None:
    """One obs write: lazy sources interleave straight into ``dest``."""
    mi = getattr(src, "materialize_into", None)
    if mi is not None:
        mi(dest)
    else:
        dest[...] = src


def collate_train_into(holder: List[list], out: Dict[str, np.ndarray]) -> None:
    """In-place :func:`~distributed_ba3c_tpu_torch.data.dataflow.collate_train`:
    the same values, written into the preallocated ``out`` arrays."""
    state_out = out["state"]
    action_out = out["action"]
    return_out = out["return"]
    for i, dp in enumerate(holder):
        _write_states(state_out[i], dp[0])
        action_out[i] = dp[1]
        return_out[i] = dp[2]


def collate_rollout_into(holder: List[dict], out: Dict[str, np.ndarray]) -> None:
    """In-place :func:`~distributed_ba3c_tpu_torch.data.dataflow.collate_rollout`:
    the same time-major [T, B] values, one obs pass: each segment's (lazy)
    state column is written straight into its ``out["state"][:, i]``
    stripe."""
    state_out = out["state"]
    boot_out = out["bootstrap_state"]
    for i, seg in enumerate(holder):
        _write_states(state_out[:, i], seg["state"])
        _write_states(boot_out[i], seg["bootstrap_state"])
        for k in ("action", "reward", "done", "behavior_log_probs"):
            out[k][:, i] = seg[k]


#: feed kind -> (spec, in-place collate)
COLLATE_INTO: Dict[str, Tuple[Callable, Callable]] = {
    "train": (train_spec, collate_train_into),
    "rollout": (rollout_spec, collate_rollout_into),
}


def acquire_stoppable(
    ring: HostStagingRing, spec: Spec, stopped: Callable[[], bool]
) -> Optional[_Slot]:
    """Acquire that returns None ONLY on stop: a consumer stall longer than
    any fixed timeout pauses the batcher, never kills it (recorded once per
    long stall)."""
    stalls = 0
    while not stopped():
        slot = ring.acquire(spec, timeout=5.0, stop=stopped)
        if slot is not None:
            return slot
        stalls += 1
        if stalls == 1 or stalls % 12 == 0:
            telemetry.record(
                "staging_acquire_stall", role=ring.tele_role,
                waited_s=5.0 * stalls,
            )
    return None


class DeviceIngest:
    """Feed -> device tensors, with batch k+1's copy hidden behind step k.

    Wraps a feed (``next_batch``/``start``/``stop``/``join``/``qsize``).
    :meth:`next_batch` returns ``{key: device tensor}`` ready for the
    learner's current stream; :meth:`prefetch` (right AFTER the learner
    step is issued) takes whatever batch the feed has ready, without
    blocking, and issues its copies on the copy stream.
    """

    is_device_ingest = True

    def __init__(self, feed, device, tele_role: str = "learner"):
        self.feed = feed
        self.device = torch.device(device)
        self._copy_stream = (
            torch.cuda.Stream(self.device) if self.device.type == "cuda"
            else None
        )
        self._staged: Optional[Tuple[dict, Any, Any]] = None
        self.tele_role = tele_role
        tele = telemetry.registry(tele_role)
        self._c_prefetched = tele.counter("ingest_prefetched_total")
        self._c_dispatch_now = tele.counter("ingest_dispatch_now_total")
        self._h_claim = tele.histogram("ingest_claim_s", unit=1e-6)

    # -- feed facade -------------------------------------------------------
    def start(self) -> None:
        self.feed.start()

    def stop(self) -> None:
        self.feed.stop()
        # a held prefetched batch never reaches a step; its slot went back
        # into rotation at dispatch, behind its fence
        self._staged = None

    def join(self, timeout: Optional[float] = None) -> None:
        self.feed.join(timeout)

    def qsize(self) -> int:
        return self.feed.qsize()

    # -- device side -------------------------------------------------------
    def _host_tensors(self, batch) -> Dict[str, torch.Tensor]:
        if isinstance(batch, StagedBatch):
            return dict(batch.slot.tensors)
        return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}

    def _dispatch(self, batch) -> Tuple[dict, Any, Any]:
        """Issue the H2D copies of one host batch; returns (device dict,
        the copy's event or None, the sampled trace or None)."""
        if isinstance(batch, StagedBatch):
            trace = batch.trace
        else:
            trace = batch.pop("_trace", None)
        host = self._host_tensors(batch)
        if self._copy_stream is None:
            # CPU: a copy, since a CPU .to() would alias the slot
            out = {k: v.clone() for k, v in host.items()}
            event = None
        else:
            # no wait on the learner's stream, so the copy runs beside the
            # step just issued: the allocator hands these blocks out again
            # only on the copy stream, and only after the streams the claim
            # records them on are done with them
            with torch.cuda.stream(self._copy_stream):
                out = {k: v.to(self.device, non_blocking=True) for k, v in host.items()}
                event = torch.cuda.Event()
                event.record(self._copy_stream)
        if isinstance(batch, StagedBatch):
            batch.ring.dispatched(batch.slot, event)
        if trace is not None:
            trace = trace.hop("h2d_copy", self.tele_role)
        return out, event, trace

    def prefetch(self) -> bool:
        """Issue the NEXT batch's copies if the feed has one ready now.
        Non-blocking; True when a batch is staged in flight."""
        if self._staged is not None:
            return True
        import queue as _queue

        try:
            batch = self.feed.next_batch(timeout=0.0)
        except _queue.Empty:
            return False
        if batch is None:
            return False
        self._staged = self._dispatch(batch)
        self._c_prefetched.inc()
        return True

    def next_batch(self, timeout: Optional[float] = None) -> dict:
        """Claim the current step's device batch (issuing its copies now
        only when no prefetch landed), ordered before the learner's stream.
        A sampled trace's ``ingest`` hop is this claim, handed on as
        ``"_trace"``."""
        t0 = time.monotonic()
        if self._staged is None:
            batch = self.feed.next_batch(timeout=timeout)
            self._staged = self._dispatch(batch)
            self._c_dispatch_now.inc()
        out, event, trace = self._staged
        self._staged = None
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for v in out.values():
                v.record_stream(stream)
        self._h_claim.observe(time.monotonic() - t0)
        if trace is not None:
            out = dict(out)
            out["_trace"] = trace.hop("ingest", self.tele_role)
        return out

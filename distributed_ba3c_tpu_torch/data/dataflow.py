"""The train-queue batcher: datapoints -> collated batches on a thread.

Port of ``distributed_ba3c_tpu/data/dataflow.py:91-272`` (``_BatchFeed``,
``collate_train``, ``collate_rollout``, ``TrainFeed``, ``RolloutFeed``).
The reference's ``QueueInput``/``EnqueueThread`` job, moving batch
assembly off the learner's thread, is done by the feed's batcher thread.
``FleetMergeFeed`` (``--fleets``) is not ported yet (ROADMAP queue A item
8). The staged collate writes into the pinned ring of ``data/staging.py``.

A sampled trace (telemetry/tracing.py) rides a feed item as a trailing
``TraceRef`` (n-step datapoints) or a ``"_trace"`` key (V-trace segments);
the batcher strips it (:func:`claim_trace`), records ``queue_wait``,
``staging_wait`` (the staged path's acquire of a writable slot, a branch
under ``queue_wait``) and ``collate``, and hands the ref on with the batch.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, List, Optional

import numpy as np

from distributed_ba3c_tpu_torch.telemetry import tracing
from distributed_ba3c_tpu_torch.telemetry.tracing import TraceRef
from distributed_ba3c_tpu_torch.utils.concurrency import StoppableThread


def claim_trace(item):
    """Strip a sampled trace rider off one feed item: a ``"_trace"`` key on
    a segment dict (V-trace) or a trailing :class:`TraceRef` on a
    ``[state, action, R]`` datapoint (n-step). Returns the ref or None;
    the item is mutated, so collate never meets the ref."""
    if isinstance(item, dict):
        return item.pop("_trace", None)
    if isinstance(item, list) and item and isinstance(item[-1], TraceRef):
        return item.pop()
    return None


class _BatchFeed:
    """Batcher thread base: item queue -> ready collated batches.

    The learner calls :meth:`next_batch`; a dedicated thread keeps up to
    ``prefetch`` collated batches ready so batch assembly overlaps the
    learner step. Subclasses define :meth:`_collate` and ``_kind`` (the
    staged collate's key in ``data/staging.py::COLLATE_INTO``).
    """

    _kind: str = ""

    def __init__(
        self,
        in_queue: "queue.Queue",
        batch_size: int,
        prefetch: int = 2,
        staging=None,
    ):
        self.in_queue = in_queue
        self.batch_size = batch_size
        #: data/staging.py HostStagingRing — when set, collate writes in
        #: place into an acquired slot (ONE obs copy) instead of allocating
        #: fresh arrays per batch
        self.staging = staging
        self._out: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._thread = StoppableThread(
            target=self._loop, daemon=True, name=type(self).__name__
        )

    def _collate(self, holder: List) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def _collate_staged(self, holder: List, t: StoppableThread, trace=None):
        """Collate into a staging slot (None only on stop: the ring's
        backpressure pauses the batcher for as long as a consumer stalls).
        ``trace`` (the batch's ref after ``queue_wait``) gets the acquire's
        ``staging_wait`` span."""
        from distributed_ba3c_tpu_torch.data import staging as _staging

        spec_fn, into_fn = _staging.COLLATE_INTO[self._kind]
        t0 = tracing.now_us() if trace is not None else 0
        slot = _staging.acquire_stoppable(
            self.staging, spec_fn(holder), t.stopped
        )
        if slot is None:
            return None
        if trace is not None:
            # the wait for a writable slot: a branch under queue_wait, as
            # predict_dispatch is one under master_ingest
            tracing.tracer().finish_span(
                trace.trace_id, "staging_wait", "learner", t0,
                parent_id=trace.parent_id,
            )
        into_fn(holder, slot.buffers)
        self.staging.count_staged_copy()
        return self.staging.staged(slot)

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._thread.stop()

    def join(self, timeout: Optional[float] = None) -> None:
        """Wait for the batcher thread to exit (it polls every 0.2 s)."""
        if self._thread.is_alive():
            self._thread.join(timeout)

    def _loop(self) -> None:
        t = threading.current_thread()
        assert isinstance(t, StoppableThread)
        holder: List = []
        trace = None  # sampled trace riding the batch being assembled
        while not t.stopped():
            item = t.queue_get_stoppable(self.in_queue, timeout=0.2)
            if item is None:
                return  # stopped while the actor plane was quiet
            ref = claim_trace(item)
            if ref is not None:
                # emit -> drain is the train-queue wait; one trace per
                # batch (a second sampled item in the same holder is
                # stripped, not attributed twice)
                trace = trace or ref.hop("queue_wait", "learner")
            holder.append(item)
            if len(holder) < self.batch_size:
                continue
            if self.staging is not None:
                batch = self._collate_staged(holder, t, trace)
                if batch is None:
                    return  # stopped while every staging slot was fenced
            else:
                batch = self._collate(holder)
            holder = []
            if trace is not None:
                ref = trace.hop("collate", "learner")
                # a StagedBatch carries the ref as an attribute, a plain
                # batch as a key the trainer pops before the copy
                if self.staging is not None:
                    batch.trace = ref
                else:
                    batch["_trace"] = ref
                trace = None
            if not t.queue_put_stoppable(self._out, batch, timeout=0.2):
                if self.staging is not None:
                    batch.release()  # slot back in rotation for the join
                return  # stopped while the learner was backed up

    def next_batch(self, timeout: Optional[float] = None) -> Dict[str, np.ndarray]:
        return self._out.get(timeout=timeout)

    def qsize(self) -> int:
        return self._out.qsize()


def collate_train(holder: List[list]) -> Dict[str, np.ndarray]:
    """[state, action, R] datapoints -> flat {state, action, return} arrays.

    The compat path: fresh arrays and one obs stack pass per batch
    (self-reported to ``ingest_copies_total``); the staged path
    (data/staging.py ``collate_train_into``) writes the same bytes once
    into a reused slot."""
    from distributed_ba3c_tpu_torch.data.staging import count_legacy_copies

    count_legacy_copies(1.0)
    return {
        "state": np.stack([np.asarray(dp[0]) for dp in holder]),
        "action": np.asarray([dp[1] for dp in holder], np.int32),
        "return": np.asarray([dp[2] for dp in holder], np.float32),
    }


def collate_rollout(holder: List[dict]) -> Dict[str, np.ndarray]:
    """V-trace segment dicts -> time-major [T, B] arrays.

    The compat path, copy-accounted like :func:`collate_train`: the obs
    bytes pay a coercion pass (lazy ``SegStates`` columns), a stack pass
    and the time-major copy; the staged collate
    (``data/staging.py::collate_rollout_into``) writes them once."""
    from distributed_ba3c_tpu_torch.data.staging import count_legacy_copies

    lazy = hasattr(holder[0]["state"], "materialize_into")
    count_legacy_copies(3.0 if lazy else 2.0)
    batch = {}
    for k in ("state", "action", "reward", "done", "behavior_log_probs"):
        stacked = np.stack([np.asarray(seg[k]) for seg in holder], axis=0)  # [B,T,...]
        batch[k] = np.swapaxes(stacked, 0, 1).copy()  # [T,B,...]
    batch["bootstrap_state"] = np.stack(
        [np.asarray(seg["bootstrap_state"]) for seg in holder]
    )
    return batch


class TrainFeed(_BatchFeed):
    """[state, action, R] datapoints -> flat {state, action, return} batches."""

    _kind = "train"

    def _collate(self, holder: List[list]) -> Dict[str, np.ndarray]:
        return collate_train(holder)


class RolloutFeed(_BatchFeed):
    """V-trace segment dicts -> time-major [T, B] batches: ``batch_size``
    segments stacked on a batch axis, time in front (the reverse scan's
    layout, ops/vtrace.py)."""

    _kind = "rollout"

    def _collate(self, holder: List[dict]) -> Dict[str, np.ndarray]:
        return collate_rollout(holder)

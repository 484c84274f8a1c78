"""The port's train-queue batcher and staging ring (``data/dataflow.py``,
``data/staging.py``) held against the JAX package's, on the CPU.

The collates take one holder of datapoints (plain arrays, and the lazy
shm-ring views of either package's ``BlockStatesView``) and must write the
JAX collates' bytes. The ring's backpressure, its fence and the
``DeviceIngest`` prefetch/claim are checked on the CPU, where nothing is
pinned and the fence opens at once; a stub event stands for a CUDA event
that has not completed.
"""

from __future__ import annotations

import queue
import time

import numpy as np
import pytest
import torch

from distributed_ba3c_tpu.actors.simulator import BlockStatesView as JaxView
from distributed_ba3c_tpu.data import dataflow as jflow
from distributed_ba3c_tpu.data import staging as jstaging
from distributed_ba3c_tpu_torch import telemetry
from distributed_ba3c_tpu_torch.actors.simulator import BlockStatesView
from distributed_ba3c_tpu_torch.data import dataflow as pflow
from distributed_ba3c_tpu_torch.data import staging as pstaging


def _holder(kind: str, n: int = 6, seed: int = 0):
    rng = np.random.default_rng(seed)
    items = []
    for i in range(n):
        if kind == "arrays":
            state = rng.integers(0, 256, (12, 10, 4), dtype=np.uint8)
        else:
            window = rng.integers(0, 256, (4, 3, 12, 10), dtype=np.uint8)
            ages = np.array([0, 2, 7])
            view = (BlockStatesView if kind == "port_view" else JaxView)(window, ages)
            # a row of a view, or a lazy row (materialized by the collate)
            state = view[i % 3] if i % 2 else _Row(view, i % 3)
        items.append([state, int(rng.integers(0, 6)), np.float32(rng.normal())])
    return items


class _Row:
    """One env's lazy state of a BlockStatesView (what the staged collate
    meets when a master hands over ``states[j]`` of a lazy block)."""

    def __init__(self, view, j):
        self.view, self.j = view, j
        self.shape = view.shape[1:]
        self.dtype = view.dtype

    def __array__(self, dtype=None, copy=None):
        return np.asarray(self.view[self.j])

    def materialize_into(self, out):
        out[...] = self.view[self.j]
        return out


KINDS = ["arrays", "port_view", "jax_view"]


@pytest.mark.parametrize("kind", KINDS)
def test_collate_train_writes_the_jax_batch(kind):
    got = pflow.collate_train(_holder(kind))
    want = jflow.collate_train(_holder(kind))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("kind", KINDS)
def test_collate_train_into_writes_the_jax_batch(kind):
    holder = _holder(kind, seed=3)
    spec = pstaging.train_spec(holder)
    jspec = jstaging.train_spec(holder)
    assert {k: (s, np.dtype(d)) for k, (s, d) in spec.items()} == {
        k: (s, np.dtype(d)) for k, (s, d) in jspec.items()}
    out = {k: np.full(s, 7, d) for k, (s, d) in spec.items()}
    jout = {k: np.full(s, 7, d) for k, (s, d) in jspec.items()}
    pstaging.collate_train_into(holder, out)
    jstaging.collate_train_into(holder, jout)
    for k in out:
        np.testing.assert_array_equal(out[k], jout[k], err_msg=k)
    np.testing.assert_array_equal(out["state"], jflow.collate_train(holder)["state"])


SPEC = {"state": ((4, 3, 3, 2), np.dtype(np.uint8)),
        "action": ((4,), np.dtype(np.int32)),
        "return": ((4,), np.dtype(np.float32))}


def test_ring_backpressure_waits_for_a_slot():
    ring = pstaging.HostStagingRing(slots=2, tele_role="learner.t1")
    a = ring.acquire(SPEC, timeout=0.1)
    b = ring.acquire(SPEC, timeout=0.1)
    assert a is not None and b is not None and a.index != b.index
    assert ring.acquire(SPEC, timeout=0.1) is None  # both downstream
    ring.release(a)
    c = ring.acquire(SPEC, timeout=0.1)
    assert c is a
    assert telemetry.registry("learner.t1").counter("staging_waits_total").value() == 0
    assert ring.acquire(SPEC, timeout=0.0, stop=lambda: True) is None


class _Event:
    """Stands for a CUDA event of an H2D copy still in flight."""

    def __init__(self):
        self.done = False

    def query(self):
        return self.done


def test_slot_fence_holds_until_the_copy_completes():
    ring = pstaging.HostStagingRing(slots=2)
    a = ring.acquire(SPEC)
    b = ring.acquire(SPEC)
    ev = _Event()
    ring.dispatched(a, ev)   # a's copy in flight
    ring.release(b)
    assert ring.acquire(SPEC, timeout=0.1) is b
    assert ring.acquire(SPEC, timeout=0.1) is None  # a fenced, b downstream
    ev.done = True
    assert ring.acquire(SPEC, timeout=0.1) is a


def test_spec_change_reallocates_and_a_stale_slot_is_ignored():
    ring = pstaging.HostStagingRing(slots=2, tele_role="learner.t2")
    old = ring.acquire(SPEC)
    spec2 = dict(SPEC, action=((4,), np.dtype(np.int64)))
    new = ring.acquire(spec2)
    assert telemetry.registry("learner.t2").counter("staging_realloc_total").value() == 1
    ring.release(old)  # a pre-realloc slot must not free the new generation's
    assert ring.acquire(spec2, timeout=0.1) is not new
    assert ring.acquire(spec2, timeout=0.1) is None


def test_slots_are_tensors_written_through_numpy_views():
    ring = pstaging.HostStagingRing(slots=2)
    slot = ring.acquire(SPEC)
    assert not slot.tensors["state"].is_pinned()  # nothing pinned on the CPU
    slot.buffers["return"][:] = 2.5
    assert torch.equal(slot.tensors["return"], torch.full((4,), 2.5))
    assert slot.tensors["action"].dtype == torch.int32


def _fill(q, holder):
    for item in holder:
        q.put(item)


def _feed(staged: bool, batches: int, seed: int):
    q = queue.Queue()
    holders = [_holder("arrays", n=4, seed=seed + i) for i in range(batches)]
    for h in holders:
        _fill(q, h)
    ring = pstaging.HostStagingRing(slots=4) if staged else None
    feed = pflow.TrainFeed(q, 4, staging=ring)
    return feed, holders


@pytest.mark.parametrize("staged", [True, False])
def test_device_ingest_prefetches_and_claims_on_the_cpu(staged):
    feed, holders = _feed(staged, 3, seed=10)
    role = f"learner.t3{int(staged)}"
    ingest = pstaging.DeviceIngest(feed, "cpu", tele_role=role)
    reg = telemetry.registry(role)
    ingest.start()
    try:
        first = ingest.next_batch(timeout=10)  # nothing prefetched: dispatched now
        deadline = 50
        while not ingest.prefetch() and deadline:
            deadline -= 1
            time.sleep(0.02)
        assert reg.counter("ingest_prefetched_total").value() == 1
        second = ingest.next_batch(timeout=10)
        third = ingest.next_batch(timeout=10)
        assert reg.counter("ingest_dispatch_now_total").value() == 2
        for got, holder in zip((first, second, third), holders):
            want = jflow.collate_train(holder)
            for k in want:
                assert isinstance(got[k], torch.Tensor)
                np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
        if staged:
            # the claimed tensors are copies: rewriting every slot after
            # the (open) fence leaves the batches as they were
            for slot in feed.staging._slots:
                slot.buffers["state"][...] = 0
            want = jflow.collate_train(holders[0])["state"]
            np.testing.assert_array_equal(first["state"].numpy(), want)
    finally:
        ingest.stop()
        ingest.join(5)


def test_staged_feed_counts_one_copy_per_batch():
    feed, _ = _feed(True, 2, seed=20)
    c = telemetry.registry("learner").counter("ingest_copies_total")
    before = c.value()
    feed.start()
    try:
        a = feed.next_batch(timeout=10)
        b = feed.next_batch(timeout=10)
        assert isinstance(a, pstaging.StagedBatch) and a.slot is not b.slot
        assert c.value() - before == 2.0
        a.release()
        b.release()
    finally:
        feed.stop()
        feed.join(5)

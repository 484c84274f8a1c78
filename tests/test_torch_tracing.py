"""The port's trace plane (``telemetry/tracing.py`` and its hops through the
actor plane, the predictor, the feed, staging and the trainer), held
against the JAX package's.

- Units: the span buffer, the deterministic sampling, and, equal to JAX's
  on the same inputs, ``make_id``, the context codec, ``stamp_wire_meta``
  (byte for byte on the wire, every wire's ident type) and the receiver's
  ``env_step``/``wire`` spans and min-offset clock alignment.
- Offline span parity: the same recorded frames with trace contexts go to
  JAX's masters and the port's (n-step and V-trace, on the block,
  block-shm and per-env wires) with one stub predictor; the span
  sequences must be equal in names, roles and parent structure.
- The port's own hops: predictor dispatch/fetch, the feed's queue_wait /
  staging_wait / collate, the ingest's h2d_copy / ingest, the trainer's
  annotated learner_step, and ``capture_trace``.
- Live: a CPU sync run (cpp:pong, fc 16, block-shm, ``--trace_sample 4``)
  whose sampled blocks carry complete causal chains; a JAX env server
  whose trace the port's master continues; a spawned simulator with
  tracing armed that imports no torch.
"""

from __future__ import annotations

import functools
import json
import os
import queue
import signal
import sys
import threading
import time

import numpy as np
import pytest
import torch

from distributed_ba3c_tpu.actors import master as jmaster
from distributed_ba3c_tpu.actors import vtrace_master as jvmaster
from distributed_ba3c_tpu.envs import native as jnative
from distributed_ba3c_tpu.telemetry import tracing as jtr
from distributed_ba3c_tpu.utils import serialize as jser
from distributed_ba3c_tpu_torch import telemetry
from distributed_ba3c_tpu_torch.actors import master as pmaster
from distributed_ba3c_tpu_torch.actors import simulator as psim
from distributed_ba3c_tpu_torch.actors import vtrace_master as pvmaster
from distributed_ba3c_tpu_torch.envs import native as pnative
from distributed_ba3c_tpu_torch.telemetry import tracing as ptr
from distributed_ba3c_tpu_torch.utils import serialize as pser
from distributed_ba3c_tpu_torch.utils import shm as pshm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE = pnative.available()

#: every wire's sender ident type: a block server, a python simulator, a
#: per-env server's env, and a str (a different repr, a different id)
IDENTS = [b"cppsim-0*block", b"simulator-3", b"cppsim-1-7", "simulator-3"]


@pytest.fixture(autouse=True)
def _fresh_trace_planes():
    """Each test starts with clean tracers and sampling off, in both
    packages, and leaves the port's registries empty; nothing leaks into
    the next test."""
    for tr in (jtr, ptr):
        tr.reset()
        tr.set_sampling(0)
    yield
    for tr in (jtr, ptr):
        tr.reset()
        tr.set_sampling(0)
    # the runs' counters (learner samples, master datapoints) must not
    # reach a later test's stat.json in this process
    telemetry.reset_all()


def _arm(n):
    jtr.set_sampling(n)
    ptr.set_sampling(n)


def _pin_clock(monkeypatch, us=1_000_000):
    for tr in (jtr, ptr):
        monkeypatch.setattr(tr, "now_us", lambda: us)


def _spans(tr):
    """The buffered spans in the order they were finished (one writer
    thread per test), as raw tuples."""
    return [s for cell in list(tr.tracer().spans._cells.values()) for s in cell[1]]


def _structure(spans):
    """(trace_id, name, role, parent) per span, the parent as the index of
    the span it names, or ``("ext", id)`` for one recorded elsewhere (a
    sender's origin span)."""
    index = {s[1]: i for i, s in enumerate(spans)}
    return [
        (s[0], s[3], s[4], index.get(s[2], ("ext", s[2]))) for s in spans
    ]


# -- units ---------------------------------------------------------------------


def test_span_buffer_sharded_append_thread_exact():
    buf = ptr.SpanBuffer(capacity=10_000)
    n_threads, per = 8, 500

    def writer(k):
        for i in range(per):
            buf.add((1, k * per + i, 0, "hop", "r", i, 1, None))

    threads = [threading.Thread(target=writer, args=(k,)) for k in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert len(buf) == n_threads * per and buf.dropped == 0
    assert {s["span_id"] for s in buf.snapshot()} == set(range(n_threads * per))


def test_span_buffer_bounded_drop_oldest():
    buf = ptr.SpanBuffer(capacity=16)
    for i in range(50):
        buf.add((1, i, 0, "hop", "r", i, 1, None))
    assert len(buf) == 16 and buf.dropped == 34
    assert {s["span_id"] for s in buf.snapshot()} == set(range(34, 50))


def test_sampling_is_jax_deterministic_rule():
    _arm(8)
    assert [s for s in range(64) if ptr.sampled(s)] == [
        s for s in range(64) if jtr.sampled(s)] == [0, 8, 16, 24, 32, 40, 48, 56]
    assert ptr.enabled()
    _arm(0)
    assert not any(ptr.sampled(s) for s in range(64)) and not ptr.enabled()
    assert ptr.sampled(4, 2) and not ptr.sampled(5, 2)


@pytest.mark.parametrize("ident", IDENTS)
def test_make_id_equals_jax(ident):
    for parts in ((ident, 0), (ident, 128), (ident, 128, "origin"), (ident,)):
        assert ptr.make_id(*parts) == jtr.make_id(*parts)
    a = ptr.make_id(ident, 7)
    assert 0 < a < (1 << 63) and a != ptr.make_id(ident, 8)
    # an ident's type is part of its id: bytes and str differ
    assert ptr.make_id(b"simulator-3", 1) != ptr.make_id("simulator-3", 1)


def test_context_codec_equals_jax():
    assert ptr.encode_context(123, 456, 789, 42) == jtr.encode_context(123, 456, 789, 42)
    assert ptr.encode_context(-1, 1 << 64, 5) == jtr.encode_context(-1, 1 << 64, 5)
    dec = ptr.decode_context(ptr.encode_context(123, 456, send_us=789, origin_dur_us=42))
    assert (dec.version, dec.trace_id, dec.span_id, dec.send_us, dec.origin_dur_us) == (
        ptr.CTX_VERSION, 123, 456, 789, 42)
    # a newer sender's extra fields: the prefix is read
    newer = [99, 5, 6, 777, 10, "future-field", {"x": 1}]
    p, j = ptr.decode_context(newer), jtr.decode_context(newer)
    assert (p.version, p.trace_id, p.span_id, p.send_us, p.origin_dur_us) == (
        j.version, j.trace_id, j.span_id, j.send_us, j.origin_dur_us) == (99, 5, 6, 777, 10)


@pytest.mark.parametrize("junk", [
    None, b"junk", "junk", 42, {}, [], [1], [1, 2, 3], [0, 1, 2, 3],
    ["x", 1, 2, 3], [1, "a", "b", "c"],
])
def test_context_codec_junk_decodes_to_none(junk):
    assert ptr.decode_context(junk) is None and jtr.decode_context(junk) is None


def _wire_message(pkg, wire, ident, step, deltas, env_us):
    """One sender message of ``wire``, stamped by ``pkg``'s
    ``stamp_wire_meta`` and serialized by ``pkg``'s codec: its bytes."""
    tr, ser = (ptr, pser) if pkg == "port" else (jtr, jser)
    rew, dn = np.arange(2, dtype=np.float32), np.array([0, 1], np.uint8)
    if wire == "per-env":
        msg = [ident, np.full((4, 4, 2), 7, np.uint8), 1.0, False]
        tr.stamp_wire_meta(msg, ident, step, deltas, env_us)
        return [ser.dumps(msg)]
    if wire == "block":
        meta = [ident, step, 2]
        arrays = [np.ones((2, 2, 4, 4), np.uint8), rew, dn]
    else:
        meta = [ident, step, 2, "ba3c-ring-x", 64, 4, 4, 2]
        arrays = [rew, dn]
    tr.stamp_wire_meta(meta, ident, step, deltas, env_us)
    return [bytes(f) for f in ser.pack_block(meta, arrays)]


@pytest.mark.parametrize("wire,ident", [
    ("block", b"cppsim-0*block"), ("block-shm", b"cppsim-0*block"),
    ("per-env", b"cppsim-1-7"), ("per-env", b"simulator-3"),
])
@pytest.mark.parametrize("sample_n", [0, 8])
def test_stamp_wire_meta_is_byte_equal_to_jax(wire, ident, sample_n, monkeypatch):
    _pin_clock(monkeypatch)
    _arm(sample_n)
    for step in (0, 1, 8, 64):
        for deltas in (None, {"env_steps_total": 5}):
            got = _wire_message("port", wire, ident, step, deltas, 321)
            want = _wire_message("jax", wire, ident, step, deltas, 321)
            assert got == want, (step, deltas)
    # the layout: a sampled step pins the deltas slot, then the context
    meta = [ident, 8, 2]
    ptr.stamp_wire_meta(meta, ident, 8, None, 321)
    if sample_n:
        assert meta[3] == {} and meta[4] == ptr.encode_context(
            ptr.make_id(ident, 8), ptr.make_id(ident, 8, "origin"), 1_000_000, 321)
    else:
        assert meta == [ident, 8, 2]


def test_receive_context_and_alignment_match_jax(monkeypatch):
    _arm(1)
    _pin_clock(monkeypatch, 9_000_000)
    skew = 5_000_000  # the sender's clock 5 s behind ours
    out = {}
    for name, tr in (("jax", jtr), ("port", ptr)):
        ctx = tr.TraceContext(11, 22, 9_000_000 - skew - 700, origin_dur_us=300)
        out[name] = (tr.receive_context(ctx, "host-x", "master", origin_always=True),
                     [(s[0], s[3], s[4], s[5], s[6]) for s in _spans(tr)],
                     _structure(_spans(tr)))
    assert out["port"][1] == out["jax"][1]  # names, roles, starts, durations
    assert out["port"][2] == out["jax"][2]
    trace_id, parent = out["port"][0]
    spans = _spans(ptr)
    assert trace_id == 11 and parent == spans[-1][1]
    assert [s[3] for s in spans] == ["env_step", "wire"]
    assert spans[0][2] == 22 and spans[1][2] == spans[0][1]
    assert spans[0][6] == 300
    assert "hop_wire_s" in telemetry.registry("master").names()
    # the min-offset handshake, observation by observation
    jt, pt = jtr.Tracer(), ptr.Tracer()
    for remote, local in ((1_000, 6_000), (10_000, 11_000), (20_000, 29_000), (5, 4)):
        assert pt.observe_remote_clock("p", remote, local) == jt.observe_remote_clock(
            "p", remote, local)
        assert pt.align("p", 2_000) == jt.align("p", 2_000)
    assert pt.clock_offset("p") == jt.clock_offset("p") == -1
    assert pt.align("stranger", 2_000) == 2_000


def test_trace_ref_hop_chains_parents_and_clamps():
    ref = ptr.TraceRef(7, 100)
    ref.hop("a", "learner").hop("b", "learner")
    spans = {s["name"]: s for s in ptr.tracer().spans.snapshot()}
    assert spans["a"]["parent_id"] == 100
    assert spans["b"]["parent_id"] == spans["a"]["span_id"]
    # an end before the start (a still-converging offset) clamps at 0
    ptr.TraceRef(7, 1, t_mark_us=ptr.now_us() + 10_000).hop("c", "master")
    assert {s["name"]: s for s in ptr.tracer().spans.snapshot()}["c"]["dur_us"] == 0


def test_span_context_manager_and_flight_correlation():
    with ptr.trace_scope(4242):
        with ptr.span(4242, "collate", "learner") as s:
            pass
        telemetry.record("trace_test_event", foo=1)
    assert ptr.tracer().spans.snapshot()[-1]["span_id"] == s.span_id
    assert telemetry.recorded("trace_test_event")[-1]["trace_id"] == 4242
    telemetry.record("trace_test_event2", foo=2)
    assert "trace_id" not in telemetry.recorded("trace_test_event2")[-1]


def test_trace_disabled_paths_are_inert():
    _arm(16)
    telemetry.set_enabled(False)
    try:
        assert not ptr.enabled()
        ctx = ptr.TraceContext(1, 2, ptr.now_us(), 100)
        assert ptr.receive_context(ctx, "peer", "master") is None
        ptr.TraceRef(1, 2).hop("wire", "master")
        assert len(ptr.tracer().spans.snapshot()) == 0
    finally:
        telemetry.set_enabled(True)
    assert ptr.enabled()


# -- offline span parity: JAX's masters and the port's on the same frames -------


class _WireFrame:
    def __init__(self, buf):
        self.buffer = memoryview(bytes(buf))


class _TracePredictor:
    """Synchronous stub predictor that spends a trace as the real
    scheduler does: dispatch, then fetch, under ``predictor``."""

    num_actions = 4

    def put_block_task(self, states, cb, shed_callback=None, trace=None):
        k = len(states)
        if trace is not None:
            trace.hop("predict_dispatch", "predictor").hop("predict_fetch", "predictor")
        cb(np.arange(k, dtype=np.int32) % 4, np.zeros(k, np.float32),
           np.full(k, -1.0, np.float32))
        return True

    def put_task(self, state, cb, shed_callback=None, trace=None):
        if trace is not None:
            trace.hop("predict_dispatch", "predictor").hop("predict_fetch", "predictor")
        cb(1, 0.5, -1.0)
        return True


N_ENVS, H, W, HIST = 2, 8, 8, 2


def _masters(kind, tmp_path):
    out = {}
    for pkg, (nstep, vt) in (("jax", (jmaster, jvmaster)), ("port", (pmaster, pvmaster))):
        c2s, s2c = f"ipc://{tmp_path}/{pkg}-c", f"ipc://{tmp_path}/{pkg}-s"
        q = queue.Queue(maxsize=256)
        if kind == "nstep":
            m = nstep.BA3CSimulatorMaster(c2s, s2c, _TracePredictor(), gamma=0.5,
                                          local_time_max=3, train_queue=q)
        else:
            m = vt.VTraceSimulatorMaster(c2s, s2c, _TracePredictor(), unroll_len=3,
                                         train_queue=q)
        out[pkg] = m
    return out


def _recorded_frames(wire, n_steps, ring=None):
    """The sender side, once: per step, the frames (block wires) or the
    per-env messages, stamped by the port's sender code."""
    rng = np.random.default_rng(0)
    out = []
    for step in range(n_steps):
        rew = rng.integers(-1, 2, N_ENVS).astype(np.float32)
        dn = (rng.random(N_ENVS) < 0.15).astype(np.uint8)
        if wire == "per-env":
            msgs = []
            for j in range(N_ENVS):
                ident = f"cppsim-0-{j}".encode()
                msg = [ident, rng.integers(0, 255, (H, W, HIST), dtype=np.uint8),
                       float(rew[j]), bool(dn[j])]
                ptr.stamp_wire_meta(msg, ident, step, None, 50)
                msgs.append(pser.dumps(msg))
            out.append(msgs)
            continue
        ident = b"cppsim-0*block"
        if wire == "block":
            meta = [ident, step, N_ENVS]
            arrays = [rng.integers(0, 255, (HIST, N_ENVS, H, W), dtype=np.uint8), rew, dn]
        else:
            cap = ring.arr.shape[0]
            ring.arr[step % cap] = rng.integers(0, 255, (N_ENVS, H, W), dtype=np.uint8)
            meta = [ident, step, N_ENVS, ring.name, cap, H, W, HIST]
            arrays = [rew, dn]
        ptr.stamp_wire_meta(meta, ident, step, None, 50)
        out.append([bytes(f) for f in pser.pack_block(meta, arrays)])
    return out


def _feed(pkg, m, wire, frames):
    """What each master's receive loop does with one step's messages. The
    JAX master decodes per-env messages inline in its run loop; both
    masters get that path's steps: decode, park the trace, hand on."""
    if wire != "per-env":
        m._on_block_frames([_WireFrame(f) for f in frames])
        return
    ser = pser if pkg == "port" else jser
    for raw in frames:
        msg = ser.loads(raw)
        ident, state, reward, is_over = msg[:4]
        client = m.clients[ident]
        client.ident = ident
        if len(msg) > 5:
            client.pending_trace = m._recv_trace(ident, msg[5])
        m._on_message(ident, state, reward, is_over)


def _drain(q):
    out = []
    while True:
        try:
            out.append(q.get_nowait())
        except queue.Empty:
            return out


@pytest.mark.parametrize("wire", ["block", "block-shm", "per-env"])
@pytest.mark.parametrize("kind", ["nstep", "vtrace"])
def test_master_spans_match_jax(kind, wire, tmp_path):
    if wire == "block-shm" and not pshm.available():
        pytest.skip("no writable /dev/shm")
    _arm(4)
    masters = _masters(kind, tmp_path)
    ring = None
    try:
        if wire == "block-shm":
            ring = pshm.ShmRing.create(
                pshm.ring_name(f"ipc://{tmp_path}/c", "t"), 512, N_ENVS, H, W)
        frames = _recorded_frames(wire, 24, ring)
        for step_frames in frames:
            for pkg, m in masters.items():
                _feed(pkg, m, wire, step_frames)
        got = _structure(_spans(ptr))
        want = _structure(_spans(jtr))
        assert got == want
        names = {s[1] for s in got}
        flush = "nstep_flush" if kind == "nstep" else "unroll_flush"
        assert {"env_step", "wire", "master_ingest", "predict", "predict_dispatch",
                "predict_fetch", flush} <= names, names
        # one trace per sampled sender step, its id the sender's make_id
        tids = {s[0] for s in got}
        senders = ([f"cppsim-0-{j}".encode() for j in range(N_ENVS)]
                   if wire == "per-env" else [b"cppsim-0*block"])
        assert tids == {ptr.make_id(i, s) for i in senders for s in range(0, 24, 4)}
        # the riders: each package's feed item carries it, claimed once
        from distributed_ba3c_tpu.data.dataflow import claim_trace as jclaim
        from distributed_ba3c_tpu_torch.data.dataflow import claim_trace as pclaim

        riders = {}
        for pkg, claim in (("jax", jclaim), ("port", pclaim)):
            items = _drain(masters[pkg].queue)
            refs = [claim(it) for it in items]
            riders[pkg] = [(i, r.trace_id) for i, r in enumerate(refs) if r is not None]
            for it in items:
                assert (len(it) == 3) if kind == "nstep" else ("_trace" not in it)
        assert riders["port"] == riders["jax"] and riders["port"]
    finally:
        for m in masters.values():
            m.close()
        if ring is not None:
            ring.close(unlink=True)


def test_block_wire_trace_complete_and_causal(tmp_path):
    """The port's V-trace master and RolloutFeed: a sampled block's trace
    runs complete and causal from env_step to the feed's collate (the
    learner's hops as Trainer.run_step records them)."""
    from distributed_ba3c_tpu_torch.data.dataflow import RolloutFeed

    _arm(4)
    m = pvmaster.VTraceSimulatorMaster(f"ipc://{tmp_path}/c", f"ipc://{tmp_path}/s",
                                       _TracePredictor(), unroll_len=3,
                                       train_queue=queue.Queue(maxsize=64))
    feed = RolloutFeed(m.queue, batch_size=2)
    try:
        for step_frames in _recorded_frames("block", 8):
            _feed("port", m, "block", step_frames)
        feed.start()
        batch = feed.next_batch(timeout=10)
        ref = batch.pop("_trace")
        ref.hop("ingest", "learner").hop("learner_step", "learner")
    finally:
        feed.stop()
        feed.join(timeout=5)
        m.close()
    by = {s["name"]: s for s in ptr.tracer().spans.snapshot() if s["trace_id"] == ref.trace_id}
    chain = ["env_step", "wire", "master_ingest", "predict", "unroll_flush", "queue_wait",
             "collate", "ingest", "learner_step"]
    for prev, cur in zip(chain, chain[1:]):
        assert by[cur]["parent_id"] == by[prev]["span_id"], (prev, cur)
    assert by["predict_dispatch"]["parent_id"] == by["master_ingest"]["span_id"]
    assert [by[n]["ts_us"] for n in chain] == sorted(by[n]["ts_us"] for n in chain)
    assert (by["predict_fetch"]["role"], by["unroll_flush"]["role"],
            by["learner_step"]["role"]) == ("predictor", "master", "learner")
    assert sorted(batch) == ["action", "behavior_log_probs", "bootstrap_state", "done",
                             "reward", "state"]


def test_trace_dump_merges_two_port_documents(tmp_path):
    """Two documents of the port's tracer (one with its monotonic clock
    1000 s on) merge onto one timeline through scripts/trace_dump.py."""
    import subprocess

    _arm(1)
    ptr.TraceRef(1234, 1).hop("wire", "master").hop("predict", "master")
    doc_a = ptr.tracer().document()
    doc_b = json.loads(json.dumps(doc_a))
    for sp in doc_b["spans"]:
        sp["ts_us"] += 1_000_000_000
    doc_b["anchor_monotonic_us"] += 1_000_000_000
    (tmp_path / "a.json").write_text(json.dumps(doc_a))
    (tmp_path / "b.json").write_text(json.dumps(doc_b))
    r = subprocess.run([sys.executable, "scripts/trace_dump.py", str(tmp_path / "a.json"),
                        str(tmp_path / "b.json"), "-o", str(tmp_path / "c.json"), "--validate"],
                       capture_output=True, text=True, cwd=REPO, timeout=60)
    assert r.returncode == 0, r.stderr
    events = [e for e in json.loads((tmp_path / "c.json").read_text())["traceEvents"]
              if e.get("ph") == "X"]
    assert len(events) == 4 and {e["pid"] for e in events} == {0, 1}
    ts = {}
    for e in events:
        ts.setdefault(e["name"], []).append(e["ts"])
    assert all(abs(a - b) < 2_000_000 for a, b in ts.values())


def test_per_env_frame_decode_parks_the_trace(tmp_path):
    """The port's per-env receive path (``_on_per_env_frame``) gives the
    spans the JAX run loop's inline decode gives."""
    _arm(1)
    m = pmaster.BA3CSimulatorMaster(f"ipc://{tmp_path}/c", f"ipc://{tmp_path}/s",
                                    _TracePredictor(), gamma=0.5, local_time_max=3)
    try:
        ident = b"simulator-0"
        for step in range(5):
            msg = [ident, np.zeros((H, W, HIST), np.uint8), 1.0, False]
            ptr.stamp_wire_meta(msg, ident, step, None, 40)
            m._on_per_env_frame(_WireFrame(pser.dumps(msg)))
        names = [s[3] for s in _spans(ptr) if s[0] == ptr.make_id(ident, 0)]
        assert names[:6] == ["env_step", "wire", "master_ingest", "predict_dispatch",
                             "predict_fetch", "predict"]
        assert "nstep_flush" in names
        assert m._c_trace_ignored.value() == 0
    finally:
        m.close()


def test_untraced_block_steps_carry_no_context(tmp_path):
    masters = _masters("vtrace", tmp_path)
    try:
        frames = _recorded_frames("block", 8)
        assert all(len(pser.unpack_block(f)[0]) == 3 for f in frames)
        for step_frames in frames:
            _feed("port", masters["port"], "block", step_frames)
        assert all("_trace" not in seg for seg in _drain(masters["port"].queue))
        assert len(ptr.tracer().spans.snapshot()) == 0
    finally:
        for m in masters.values():
            m.close()


# -- the port's learner-side hops ---------------------------------------------------


def test_predictor_records_dispatch_then_fetch():
    from distributed_ba3c_tpu_torch.models.a3c import BA3CNet
    from distributed_ba3c_tpu_torch.predict.server import BatchedPredictor

    _arm(1)
    net = BA3CNet(4, fc_units=16, image_size=(16, 16), device="cpu",
                  generator=torch.Generator().manual_seed(0))
    pred = BatchedPredictor(net, net.state_dict(), batch_size=8, device="cpu",
                            tele_role="predictor.t")
    pred.start()
    try:
        done = threading.Event()
        ref = ptr.TraceRef(5, 50)
        pred.put_block_task(np.zeros((4, 16, 16, 4), np.uint8), lambda *a: done.set(),
                            trace=ref)
        untraced = threading.Event()
        pred.put_block_task(np.zeros((4, 16, 16, 4), np.uint8),
                            lambda *a: untraced.set())
        assert done.wait(30) and untraced.wait(30)
    finally:
        pred.stop()
        pred.join(5)
    spans = {s["name"]: s for s in ptr.tracer().spans.snapshot()}
    assert set(spans) == {"predict_dispatch", "predict_fetch"}
    assert spans["predict_dispatch"]["parent_id"] == 50
    assert spans["predict_fetch"]["parent_id"] == spans["predict_dispatch"]["span_id"]
    assert {s["role"] for s in spans.values()} == {"predictor.t"}
    assert spans["predict_fetch"]["ts_us"] >= spans["predict_dispatch"]["ts_us"]


@pytest.mark.parametrize("staged", [True, False], ids=["staged", "unstaged"])
def test_feed_ingest_and_trainer_hops_chain(staged):
    from distributed_ba3c_tpu_torch.config import BA3CConfig
    from distributed_ba3c_tpu_torch.data.dataflow import TrainFeed
    from distributed_ba3c_tpu_torch.data.staging import DeviceIngest, HostStagingRing
    from distributed_ba3c_tpu_torch.train.trainer import Trainer, TrainLoopConfig

    _arm(1)
    q = queue.Queue()
    head = ptr.TraceRef(9, 90)
    for i in range(8):
        item = [np.full((4, 4, 2), i, np.uint8), i % 3, np.float32(i)]
        if i == 2:
            item.append(head.hop("nstep_flush", "master"))
        q.put(item)
    feed = TrainFeed(q, 4, staging=HostStagingRing() if staged else None)
    if staged:
        feed = DeviceIngest(feed, "cpu")
    seen = []

    class _State:
        model = torch.nn.Linear(1, 1)

    def step_fn(state, batch, beta, lr):
        seen.append(sorted(batch))
        return state, {}

    trainer = Trainer(TrainLoopConfig(steps_per_epoch=2, max_epoch=1), BA3CConfig(),
                      step_fn, _State(), feed, [])
    feed.start()
    try:
        trainer.run_step()
        trainer.run_step()
    finally:
        feed.stop()
        feed.join(timeout=5)
    assert seen == [["action", "return", "state"]] * 2  # the ref never reached the step
    by = {s["name"]: s for s in ptr.tracer().spans.snapshot() if s["trace_id"] == 9}
    chain = ["nstep_flush", "queue_wait", "collate"]
    chain += ["h2d_copy", "ingest", "learner_step"] if staged else ["ingest", "learner_step"]
    for prev, cur in zip(chain, chain[1:]):
        assert by[cur]["parent_id"] == by[prev]["span_id"], (prev, cur)
    assert [by[n]["ts_us"] for n in chain] == sorted(by[n]["ts_us"] for n in chain)
    assert by["learner_step"]["tags"] == {"step": 1}
    assert {by[n]["role"] for n in chain[1:]} == {"learner"}
    if staged:  # the slot acquire: a branch under queue_wait
        assert by["staging_wait"]["parent_id"] == by["queue_wait"]["span_id"]
    else:
        assert "staging_wait" not in by


def test_capture_trace_holds_the_annotated_step(tmp_path):
    from distributed_ba3c_tpu_torch.utils import profiling

    def two_steps():
        for step in (3, 4):
            with profiling.step_annotation("train_step", step, trace_id=77, span_id=88):
                torch.ones(64, 64) @ torch.ones(64, 64)

    profiling.capture_trace(str(tmp_path), 0, two_steps)
    doc = json.loads((tmp_path / profiling.TRACE_FILE).read_text())
    names = [e.get("name", "") for e in doc["traceEvents"]]
    for step in (3, 4):
        assert profiling.annotation_name("train_step", step, 77, 88) in names
    assert "train_step step=3 trace_id=77 span_id=88" in names


# -- live ----------------------------------------------------------------------------


def _chain_ok(by, flush):
    chain = ["env_step", "wire", "master_ingest", "predict", flush, "queue_wait",
             "collate", "h2d_copy", "ingest", "learner_step"]
    for prev, cur in zip(chain, chain[1:]):
        if by[cur]["parent_id"] != by[prev]["span_id"]:
            return f"{cur} not parented on {prev}"
    if by["predict_dispatch"]["parent_id"] != by["master_ingest"]["span_id"]:
        return "predict_dispatch not under master_ingest"
    if by["predict_fetch"]["parent_id"] != by["predict_dispatch"]["span_id"]:
        return "predict_fetch not under predict_dispatch"
    if by["staging_wait"]["parent_id"] != by["queue_wait"]["span_id"]:
        return "staging_wait not under queue_wait"
    starts = [by[n]["ts_us"] for n in chain]
    if starts != sorted(starts) or min(s["dur_us"] for s in by.values()) < 0:
        return f"not causal: {starts}"
    return None


@pytest.fixture
def _restore_process_state():
    """The CLI arms sampling, the flight dir and a SIGTERM dump for its
    process and its children's environment; give them back (a later test
    of this worker spawns env servers)."""
    saved = {k: os.environ.pop(k, None) for k in ("BA3C_TRACE", "BA3C_FLIGHT_DIR")}
    handler = signal.getsignal(signal.SIGTERM)
    yield
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    signal.signal(signal.SIGTERM, handler)
    telemetry.configure(None)


@pytest.mark.skipif(not NATIVE, reason="native env core not built (make -C cpp)")
def test_live_cpu_plane_traces_complete_chains(tmp_path, _restore_process_state):
    if not pshm.available():
        pytest.skip("no writable /dev/shm")
    from distributed_ba3c_tpu_torch import cli

    rc = cli.main(["--task", "train", "--trainer", "tpu_sync_ba3c", "--env", "cpp:pong",
                   "--wire", "block-shm", "--simulator_procs", "8", "--batch_size", "16",
                   "--predict_batch_size", "8", "--fc_units", "16", "--steps_per_epoch", "6",
                   "--max_epoch", "1", "--nr_eval", "0", "--trace_sample", "4",
                   "--device", "cpu", "--logdir", str(tmp_path)])
    assert rc == 0
    assert os.environ["BA3C_TRACE"] == "4"
    traces = {}
    for s in ptr.tracer().spans.snapshot():
        traces.setdefault(s["trace_id"], {})[s["name"]] = s
    done = [by for by in traces.values() if "learner_step" in by]
    assert done, sorted({n for by in traces.values() for n in by})
    for by in done:
        assert _chain_ok(by, "nstep_flush") is None, _chain_ok(by, "nstep_flush")
    regs = {r: telemetry.registry(r).names() for r in ("master", "predictor", "learner")}
    for role, hops in (("master", ("env_step", "wire", "master_ingest", "predict",
                                   "nstep_flush")),
                       ("predictor", ("predict_dispatch", "predict_fetch")),
                       ("learner", ("queue_wait", "collate", "staging_wait", "h2d_copy",
                                    "ingest", "learner_step"))):
        for h in hops:
            assert f"hop_{h}_s" in regs[role], (role, h)
    # the run's TensorBoard events and channels
    assert any(f.startswith("events.out.tfevents") for f in os.listdir(tmp_path))
    points = [json.loads(x) for x in (tmp_path / "channels.jsonl").read_text().splitlines()]
    assert [(p["channel"], p["x"]) for p in points if p["channel"] == "fps"] == [("fps", 6)]


@pytest.mark.skipif(not NATIVE, reason="native env core not built (make -C cpp)")
def test_jax_env_server_trace_continues_in_the_port_master(tmp_path, monkeypatch):
    """Cross-plane: a JAX env server stamps (its child reads BA3C_TRACE),
    the port's master continues the same trace id."""
    monkeypatch.setenv("BA3C_TRACE", "2")
    c2s, s2c = f"ipc://{tmp_path}/c", f"ipc://{tmp_path}/s"
    # the n-step master: its flush needs no local sampling (the sender
    # owns the decision; JAX's V-trace block flush scans only when armed)
    m = pmaster.BA3CSimulatorMaster(c2s, s2c, _TracePredictor(), local_time_max=3,
                                    train_queue=queue.Queue(maxsize=512))
    srv = jnative.CppEnvServerProcess(0, c2s, s2c, game="pong", n_envs=2,
                                      frame_history=4, wire="block", ident_prefix="x")
    m.start()
    srv.start()
    try:
        want = ptr.make_id(b"x*block", 4)
        deadline = time.monotonic() + 60
        while want not in {s["trace_id"] for s in ptr.tracer().spans.snapshot()
                           if s["name"] == "nstep_flush"}:
            assert srv.is_alive() and time.monotonic() < deadline
            time.sleep(0.05)
    finally:
        srv.terminate()
        srv.join(10)
        m.close()
    names = {s["name"] for s in ptr.tracer().spans.snapshot() if s["trace_id"] == want}
    assert {"env_step", "wire", "master_ingest", "predict", "nstep_flush"} <= names
    assert jtr.make_id(b"x*block", 4) == want


PROBE = '''
import json, sys


def build(out, idx):
    roots = sorted({m.split(".")[0] for m, v in sys.modules.items() if v is not None})
    with open(out, "w") as f:
        json.dump(roots, f)
    from distributed_ba3c_tpu_torch.envs.fake import build_fake_player

    return build_fake_player(idx, image_size=(16, 16))
'''


def test_spawned_simulator_with_tracing_armed_imports_no_torch(tmp_path, monkeypatch):
    (tmp_path / "ba3c_trace_probe.py").write_text(PROBE)
    monkeypatch.syspath_prepend(str(tmp_path))
    monkeypatch.setenv("BA3C_TRACE", "1")
    import ba3c_trace_probe

    out = tmp_path / "modules.json"
    c2s, s2c = f"ipc://{tmp_path}/c", f"ipc://{tmp_path}/s"
    m = pmaster.BA3CSimulatorMaster(c2s, s2c, _TracePredictor())
    sim = psim.SimulatorProcess(0, c2s, s2c,
                                functools.partial(ba3c_trace_probe.build, str(out)))
    m.start()
    sim.start()
    try:
        deadline = time.monotonic() + 60
        while not out.exists() or not any(
                s["name"] == "wire" for s in ptr.tracer().spans.snapshot()):
            assert sim.is_alive() and time.monotonic() < deadline
            time.sleep(0.05)
    finally:
        sim.terminate()
        sim.join(10)
        m.close()
    roots = set(json.loads(out.read_text()))
    assert "distributed_ba3c_tpu_torch" in roots
    assert not roots & {"torch", "jax", "jaxlib", "distributed_ba3c_tpu"}, roots
    assert ptr.make_id(b"simulator-0", 0) in {
        s["trace_id"] for s in ptr.tracer().spans.snapshot()}
    assert sys.modules["ba3c_trace_probe"] is ba3c_trace_probe

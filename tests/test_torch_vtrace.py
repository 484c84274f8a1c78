"""The port's V-trace trainer held against the JAX package's, on the CPU.

- ``ops/vtrace.py::vtrace_returns`` against JAX's on seeded ``[T, B]``
  inputs, with and without dones, importance weights above and below both
  clips: every output within 4 float32 ulps of its largest magnitude (the
  same operations in the same order; XLA's ``exp`` and fusion move the
  last bits). On policy it equals the port's ``n_step_returns`` (the
  contract of ``tests/test_vtrace.py``).
- The masters, offline: one seeded FakeEnv trajectory under a
  deterministic stub policy fed message by message to JAX's
  ``VTraceSimulatorMaster`` and to the port's, over the per-env wire and
  the block wire, with and without ``reward_clip``. The segment lists
  (states materialised from ``SegStates``, actions, rewards, dones,
  behaviour log-probs, bootstrap states) and the scores must be equal, and
  the port's block wire must emit its per-env wire's segments.
- The live plane: a native Pong env server on the block-shm wire over ipc,
  its ring sized by the CLI, feeding the port's master: no block rejected,
  no client dropped, the block wire's segments again.
- The collates: ``collate_rollout`` and ``collate_rollout_into`` write the
  JAX collates' bytes for lazy and eager segments.
- The V-trace step: one and two updates of ``make_vtrace_train_step``
  against JAX's on a one-device CPU mesh, both on the JAX CLI's model at
  full conv width (84x84x4, ``fc_units=16``), T=5 and 4 segments, from the
  JAX params (converted): the bounds of
  ``tests/test_torch_train_step.py::test_two_updates_match_jax`` (per-leaf
  update rel-L2 < 5e-2, every metric and ``mean_rho`` within 2e-2
  relative); learning rate 0 freezes the params. One exception, measured:
  the second update's bf16-sum leaves, the conv biases and the PReLU
  slope (Conv_0's bias reads 0.118). JAX takes their gradients as sums in
  bf16 (``tests/test_torch_model.py``'s conv-bias bound), and on this
  batch its own Conv_0 bias gradient moves 12.6% when the same sum is
  taken over four env-column chunks (the chunks' mean is the full-batch
  gradient); Adam's second step then amplifies wherever the two updates'
  gradients cancel. Those leaves are held where the difference arises:
  the second update's gradients against JAX's, every leaf within the
  larger of the model test's bound (its conv-bias bound, 0.1, on the
  bf16-sum leaves) and JAX's own full-vs-chunked spread.
- The CLI: ``--trainer tpu_vtrace_ba3c --env fake`` under real lag
  (``--publish_every 8``, the flags of ``tests/test_vtrace_lag_e2e.py``)
  reaches a greedy eval of 0.75.
"""

from __future__ import annotations

import json
import os
import queue
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_ba3c_tpu.actors import simulator as jsim
from distributed_ba3c_tpu.actors import vtrace_master as jvm
from distributed_ba3c_tpu.config import BA3CConfig as JaxConfig
from distributed_ba3c_tpu.data import dataflow as jflow
from distributed_ba3c_tpu.data import staging as jstaging
from distributed_ba3c_tpu.models.a3c import BA3CNet as JaxNet
from distributed_ba3c_tpu.ops.gradproc import make_optimizer as jax_make_optimizer
from distributed_ba3c_tpu.ops.vtrace import vtrace_returns as jax_vtrace
from distributed_ba3c_tpu.parallel import train_step as jstep
from distributed_ba3c_tpu.parallel import vtrace_step as jvstep
from distributed_ba3c_tpu.parallel.mesh import make_mesh
from distributed_ba3c_tpu_torch import cli
from distributed_ba3c_tpu_torch.actors import simulator as psim
from distributed_ba3c_tpu_torch.actors import vtrace_master as pvm
from distributed_ba3c_tpu_torch.config import BA3CConfig
from distributed_ba3c_tpu_torch.data import dataflow as pflow
from distributed_ba3c_tpu_torch.data import staging as pstaging
from distributed_ba3c_tpu_torch.envs import native as pnative
from distributed_ba3c_tpu_torch.models import BA3CNet, from_flax, to_flax
from distributed_ba3c_tpu_torch.ops.returns import n_step_returns
from distributed_ba3c_tpu_torch.ops.vtrace import vtrace_returns
from distributed_ba3c_tpu_torch.parallel.train_step import create_train_state
from distributed_ba3c_tpu_torch.parallel.vtrace_step import (
    _make_vtrace_loss_fn,
    make_vtrace_train_step,
)
from distributed_ba3c_tpu_torch.utils import shm as pshm
from distributed_ba3c_tpu_torch.utils.concurrency import FastQueue
from test_torch_actor_plane import _CappedPredictor, _trajectory
from test_torch_fused import METRIC_REL, UPDATE_REL_L2, _np_tree, _update_rel_l2
from test_torch_model import CONV_BIAS_REL_L2, _bound, _rel_l2_per_leaf, pong_frames

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ULPS = 4


# -- vtrace_returns ------------------------------------------------------------

def _vtrace_inputs(seed, T, B, done_p, spread):
    rng = np.random.default_rng(seed)
    mu = (rng.normal(size=(T, B)) - 1.8).astype(np.float32)
    pi = (mu + rng.normal(scale=spread, size=(T, B))).astype(np.float32)
    return (mu, pi, rng.normal(size=(T, B)).astype(np.float32),
            (rng.random((T, B)) < done_p).astype(np.float32),
            rng.normal(size=(T, B)).astype(np.float32),
            rng.normal(size=B).astype(np.float32))


@pytest.mark.parametrize("done_p", [0.0, 0.3], ids=["no_dones", "dones"])
@pytest.mark.parametrize("clips", [(1.0, 1.0), (2.0, 0.5)], ids=["clip1", "clip2_05"])
def test_vtrace_returns_match_jax(done_p, clips):
    args = _vtrace_inputs(int(done_p * 10) + int(clips[0]), 7, 5, done_p, 0.8)
    mu, pi = args[:2]
    rhos = np.exp(pi - mu)
    # importance weights on both sides of both clips
    assert (rhos < min(clips)).any() and (rhos > max(clips)).any()
    want = jax_vtrace(*(jnp.asarray(a) for a in args), 0.9, *clips)
    got = vtrace_returns(*(torch.from_numpy(a) for a in args), 0.9, *clips)
    for name, g, w in zip(("vs", "pg_advantages", "clipped_rhos"), got, want):
        w = np.asarray(w)
        assert g.dtype == torch.float32 and g.shape == w.shape
        tol = ULPS * np.spacing(np.float32(np.abs(w).max()))
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=tol, err_msg=name)


def test_on_policy_vtrace_equals_n_step_returns():
    mu, _, rewards, _, values, boot = _vtrace_inputs(2, 6, 4, 0.0, 0.0)
    dones = (np.random.default_rng(5).random((6, 4)) < 0.25).astype(np.float32)
    t = [torch.from_numpy(a) for a in (mu, mu, rewards, dones, values, boot)]
    out = vtrace_returns(*t, 0.95)
    want = n_step_returns(t[2], t[3], t[5], 0.95)
    torch.testing.assert_close(out.vs, want, rtol=1e-4, atol=1e-5)
    assert torch.equal(out.clipped_rhos, torch.ones_like(out.clipped_rhos))


# -- the masters, offline ------------------------------------------------------

N_ACTIONS = 4


def _policy(state):
    """Deterministic (action, value, logp) from the pixels, the log-prob
    varying so the behaviour term is checked."""
    h = int(np.asarray(state, np.uint64).sum())
    return h % N_ACTIONS, (h % 8) / 8.0, -0.25 - (h % 5) / 4.0


class _Predictor:
    num_actions = N_ACTIONS

    def put_task(self, state, cb, **kw):
        cb(*_policy(state))

    def put_block_task(self, states, cb, **kw):
        outs = [_policy(states[j]) for j in range(len(states))]
        cb(*(np.asarray([o[i] for o in outs], dt)
             for i, dt in enumerate((np.int32, np.float32, np.float32))))


def _drive(master, sim, wire, traj):
    if wire == "block":
        ident = b"blk-0*block"
        master.clients[ident] = sim.BlockClientState(ident, len(traj[0][0]))
        for states, rewards, overs in traj:
            master._on_block_message(ident, states, rewards, overs)
    else:
        for states, rewards, overs in traj:
            for j in range(len(states)):
                master._on_message(f"sim-{j}".encode(), states[j], float(rewards[j]),
                                   bool(overs[j]))


def _seg_key(seg):
    return tuple(np.asarray(seg[k]).tobytes() for k in (
        "state", "action", "reward", "done", "behavior_log_probs", "bootstrap_state"))


def _segments(pkg, wire, tmp_path, traj, **kw):
    mod, sim = {"jax": (jvm, jsim), "port": (pvm, psim)}[pkg]
    m = mod.VTraceSimulatorMaster(
        f"ipc://{tmp_path}/{pkg}-{wire}-c", f"ipc://{tmp_path}/{pkg}-{wire}-s",
        _Predictor(), score_queue=queue.Queue(), **kw,
    )
    try:
        _drive(m, sim, wire, traj)
        segs, scores = [], []
        while not m.queue.empty():
            segs.append(m.queue.get_nowait())
        while not m.score_queue.empty():
            scores.append(m.score_queue.get_nowait())
        return segs, scores
    finally:
        m.close()


@pytest.mark.parametrize("kw,seed", [
    (dict(unroll_len=5), 0),
    (dict(unroll_len=3, reward_clip=0.5), 7),
], ids=["T5", "T3_clip"])
@pytest.mark.parametrize("wire", ["per-env", "block"])
def test_master_segments_match_jax(wire, kw, seed, tmp_path):
    traj = _trajectory(4, 50, seed)
    segs, scores = _segments("port", wire, tmp_path, traj, **kw)
    jsegs, jscores = _segments("jax", wire, tmp_path, traj, **kw)
    T = kw["unroll_len"]
    assert len(segs) == 4 * ((50 - 2) // T) and len(scores) > 0
    if wire == "block":
        assert all(isinstance(s["state"], psim.SegStates) for s in segs)
    for s in segs:
        assert np.asarray(s["state"]).shape == (T, 16, 16, 2)
        assert s["action"].dtype == np.int32 and s["done"].dtype == np.float32
        assert s["reward"].dtype == s["behavior_log_probs"].dtype == np.float32
    assert [_seg_key(s) for s in segs] == [_seg_key(s) for s in jsegs]
    assert scores == jscores
    assert any(s["done"].any() for s in segs)  # the unrolls cross episode ends


def test_port_block_wire_equals_its_per_env_wire(tmp_path):
    traj = _trajectory(4, 50, 11)
    block, sb = _segments("port", "block", tmp_path, traj, unroll_len=4)
    per_env, sp = _segments("port", "per-env", tmp_path, traj, unroll_len=4)
    assert sorted(map(_seg_key, block)) == sorted(map(_seg_key, per_env))
    assert sorted(sb) == sorted(sp)


def test_segment_states_match_jax():
    rng = np.random.default_rng(0)
    steps = [rng.integers(0, 256, (3, 6, 5, 2), dtype=np.uint8) for _ in range(4)]
    got, want = psim.SegStates(steps, 1), jsim.SegStates(steps, 1)
    assert got.shape == want.shape == (4, 6, 5, 2) and len(got) == 4
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    out = np.zeros(got.shape, np.uint8)
    np.testing.assert_array_equal(got.materialize_into(out), np.asarray(want))


def test_vtrace_master_pins_its_unroll_in_the_ring(tmp_path):
    """A queued segment pins T ring steps: the master's attach-time floor
    and the ring the CLI sizes both count them, so the CLI's rings pass
    the master's check, where a 1-step count would size them too small."""
    m = pvm.VTraceSimulatorMaster(f"ipc://{tmp_path}/c", f"ipc://{tmp_path}/s",
                                  _Predictor(), unroll_len=5,
                                  train_queue=FastQueue(maxsize=4096))
    try:
        assert m.ring_steps_per_item == m.queue_samples_per_item == 5
        m.feed_batch = 25
        floor = m.min_ring_cap(16, 4)
        assert floor == pshm.min_safe_cap(16, 4096, 25, 5, 5, 4)
        args = cli.make_parser().parse_args([
            "--trainer", "tpu_vtrace_ba3c", "--env", "cpp:pong", "--wire", "block-shm",
            "--simulator_procs", "32"])
        procs = cli._sync_fleet(args, BA3CConfig(num_actions=6, simulator_procs=32),
                                f"ipc://{tmp_path}/c", f"ipc://{tmp_path}/s", m)
        assert [p.n_envs for p in procs] == [16, 16]
        caps = {p.shm_ring_cap for p in procs}
        assert caps == {int(floor * 1.25) + 1}
        assert min(caps) > floor > pshm.min_safe_cap(16, 4096, 25, 1, 5, 4) * 1.25 + 1
    finally:
        m.close()


# -- the live plane ------------------------------------------------------------

N_ENVS, K_STEPS, UNROLL = 4, 16, 3


def _live_segments(wire, tmp_path):
    """A port env server of N_ENVS native Pong envs over ``wire`` feeding
    the port's V-trace master for K_STEPS answered steps, its ring sized
    by the CLI's formula; returns the segments and the master's counters."""
    from distributed_ba3c_tpu_torch import telemetry

    role = f"master.vt-{wire}"
    pred = _CappedPredictor(K_STEPS)
    c2s, s2c = f"ipc://{tmp_path}/{wire}-c", f"ipc://{tmp_path}/{wire}-s"
    m = pvm.VTraceSimulatorMaster(c2s, s2c, pred, unroll_len=UNROLL, tele_role=role)
    m.feed_batch = 8
    args = cli.make_parser().parse_args([
        "--trainer", "tpu_vtrace_ba3c", "--env", "cpp:pong", "--wire", wire,
        "--simulator_procs", str(N_ENVS)])
    (srv,) = cli._sync_fleet(
        args, BA3CConfig(num_actions=6, simulator_procs=N_ENVS), c2s, s2c, m)
    m.start()
    srv.start()
    try:
        deadline = time.monotonic() + 60
        while pred.calls < K_STEPS + 1:
            assert srv.is_alive() and time.monotonic() < deadline, (wire, pred.calls)
            time.sleep(0.02)
        time.sleep(0.1)
        segs = []
        while not m.queue.empty():
            segs.append(m.queue.get_nowait())
        return segs, telemetry.registry(role).scalars()
    finally:
        srv.terminate()
        srv.join(10)
        m.close()


@pytest.mark.skipif(not pnative.available(), reason="native env core not built (make -C cpp)")
def test_live_block_shm_plane_feeds_the_vtrace_master(tmp_path):
    if not pshm.available():
        pytest.skip("no writable /dev/shm")
    shm_segs, tele = _live_segments("block-shm", tmp_path)
    assert tele["block_shm_msgs_total"] == K_STEPS + 1
    for k in ("blocks_rejected_total", "clients_dropped_total", "corrupt_frames_total"):
        assert tele[k] == 0, k
    # K_STEPS answered steps, every one's reward attached by the next
    # message: an unroll emits once T + 1 steps follow its start
    assert len(shm_segs) == N_ENVS * ((K_STEPS - 1) // UNROLL)
    blk_segs, _ = _live_segments("block", tmp_path)
    assert sorted(map(_seg_key, shm_segs)) == sorted(map(_seg_key, blk_segs))


# -- the collates --------------------------------------------------------------

def _segment_holder(lazy: str, n=3, T=4, seed=0):
    """Segments of ``n`` env columns: eager arrays, or lazy SegStates over
    ``BlockStatesView`` steps of the port or of JAX."""
    rng = np.random.default_rng(seed)
    views = []
    for _ in range(T + 1):
        window = rng.integers(0, 256, (4, n, 10, 12), dtype=np.uint8)
        ages = rng.integers(0, 6, n)
        views.append({"port": psim.BlockStatesView, "jax": jsim.BlockStatesView,
                      "arrays": psim.BlockStatesView}[lazy](window, ages))
    segs = []
    for j in range(n):
        seg_cls = {"port": psim.SegStates, "jax": jsim.SegStates}.get(lazy)
        state = (seg_cls(views[:T], j) if seg_cls is not None
                 else np.stack([v[j] for v in views[:T]]))
        segs.append({
            "state": state,
            "action": rng.integers(0, 6, T).astype(np.int32),
            "reward": rng.normal(size=T).astype(np.float32),
            "done": (rng.random(T) < 0.3).astype(np.float32),
            "behavior_log_probs": rng.normal(size=T).astype(np.float32),
            "bootstrap_state": views[T][j],
        })
    return segs


LAZY = ["arrays", "port", "jax"]


@pytest.mark.parametrize("lazy", LAZY)
def test_collate_rollout_writes_the_jax_batch(lazy):
    got = pflow.collate_rollout(_segment_holder(lazy))
    want = jflow.collate_rollout(_segment_holder(lazy))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["state"].shape == (4, 3, 10, 12, 4)


@pytest.mark.parametrize("lazy", LAZY)
def test_collate_rollout_into_writes_the_jax_batch(lazy):
    holder = _segment_holder(lazy, seed=3)
    spec = pstaging.rollout_spec(holder)
    jspec = jstaging.rollout_spec(holder)
    assert spec == {k: (s, np.dtype(d)) for k, (s, d) in jspec.items()}
    ring = pstaging.HostStagingRing(slots=2)
    slot = ring.acquire(spec)
    assert not slot.tensors["state"].is_pinned()  # nothing pinned on the CPU
    jout = {k: np.full(s, 7, d) for k, (s, d) in jspec.items()}
    pstaging.collate_rollout_into(holder, slot.buffers)
    jstaging.collate_rollout_into(holder, jout)
    for k in jout:
        np.testing.assert_array_equal(slot.tensors[k].numpy(), jout[k], err_msg=k)
    np.testing.assert_array_equal(jout["state"], jflow.collate_rollout(holder)["state"])


def test_staged_rollout_feed_gives_device_tensors_of_the_jax_batch():
    q = queue.Queue()
    holder = _segment_holder("port", n=3, seed=5)
    for seg in holder:
        q.put(seg)
    feed = pstaging.DeviceIngest(
        pflow.RolloutFeed(q, 3, staging=pstaging.HostStagingRing(slots=2)), "cpu")
    feed.start()
    try:
        got = feed.next_batch(timeout=10)
    finally:
        feed.stop()
        feed.join(5)
    want = jflow.collate_rollout(holder)
    for k in want:
        assert isinstance(got[k], torch.Tensor)
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


# -- the V-trace step ----------------------------------------------------------

T_STEP, N_SEG = 5, 4
LRS = (1e-3, 1e-3)
STEP_METRICS = ("loss", "policy_loss", "value_loss", "entropy", "mean_rho",
                "pred_value", "grad_norm", "grad_max_abs")


def _rollout_batches(n: int):
    rng = np.random.default_rng(0)
    frames = pong_frames((T_STEP + 1) * N_SEG * n, seed=4)
    out = []
    for i in range(n):
        f = frames[i * (T_STEP + 1) * N_SEG:(i + 1) * (T_STEP + 1) * N_SEG]
        out.append({
            "state": f[:T_STEP * N_SEG].reshape(T_STEP, N_SEG, 84, 84, 4),
            "action": rng.integers(0, 6, (T_STEP, N_SEG)).astype(np.int32),
            "reward": rng.choice([-1.0, 0.0, 0.0, 1.0], (T_STEP, N_SEG)).astype(np.float32),
            "done": (rng.random((T_STEP, N_SEG)) < 0.2).astype(np.float32),
            # around log(1/6), so the importance weights fall both sides of 1
            "behavior_log_probs": (np.log(1 / 6) + rng.normal(scale=0.05, size=(T_STEP, N_SEG))
                                   ).astype(np.float32),
            "bootstrap_state": f[T_STEP * N_SEG:],
        })
    return out


@pytest.fixture(scope="module")
def jax_vtrace_run():
    """JAX's V-trace step (one compile) on its default model: the initial
    state, the state after each of two steps at 1e-3 and their metrics,
    and one step at 0 from the initial state."""
    cfg = JaxConfig(fc_units=16)
    model = JaxNet(num_actions=6, fc_units=16)
    opt = jax_make_optimizer(cfg.learning_rate, cfg.adam_epsilon, cfg.grad_clip_norm)
    step = jvstep.make_vtrace_train_step(
        model, opt, cfg, make_mesh(num_data=1, devices=jax.devices()[:1]))
    s0 = jstep.create_train_state(jax.random.PRNGKey(2), model, cfg, opt)
    host0 = _np_tree(s0)
    batches = _rollout_batches(2)

    def fresh():
        return jax.device_put(jax.tree_util.tree_map(jnp.asarray, host0), step.state_sharding)

    def put(b):
        return {k: jax.device_put(v, step.batch_sharding[k]) for k, v in b.items()}

    s, states, metrics = fresh(), [], []
    for b, lr in zip(batches, LRS):
        s, m = step(s, put(b), 0.01, lr)
        states.append(_np_tree(s))
        metrics.append({k: float(v) for k, v in m.items()})
    s0_, _ = step(fresh(), put(batches[0]), 0.01, 0.0)
    # the second update's gradients at the state after the first: over
    # the batch, and as the mean over its env columns (the same gradient)
    params1 = jax.tree_util.tree_map(jnp.asarray, states[0].params)

    def grads(b):
        loss_fn = jvstep._make_vtrace_loss_fn(
            model, cfg, {k: jnp.asarray(v) for k, v in b.items()}, 0.01)
        return _np_tree(jax.value_and_grad(loss_fn, has_aux=True)(params1)[1])

    b2 = batches[1]
    cols = [grads({k: v[c:c + 1] if k == "bootstrap_state" else v[:, c:c + 1]
                   for k, v in b2.items()}) for c in range(N_SEG)]
    chunked = jax.tree_util.tree_map(
        lambda *xs: np.mean(np.stack(xs).astype(np.float64), axis=0), *cols)
    return {"init": host0, "states": states, "metrics": metrics, "batches": batches,
            "lr0": _np_tree(s0_), "grads2": grads(b2), "grads2_chunked": chunked}


def _port_step_at(host):
    """The port's V-trace step at a JAX TrainState: its params and Adam's
    state through the bridges."""
    cfg = BA3CConfig(fc_units=16)
    net = BA3CNet(6, fc_units=16, device="cpu")
    assert net.block_rules == "xla"
    net.load_state_dict(from_flax(host.params))
    state = create_train_state(net, cfg)
    inject = host.opt_state[1]
    adam = inject.inner_state[0]
    if int(np.asarray(adam.count)):
        state.optimizer.load_state_dict({
            "count": np.asarray(adam.count), "mu": adam.mu, "nu": adam.nu,
            "learning_rate": np.asarray(inject.hyperparams["learning_rate"]),
        })
    state.step = int(host.step)
    return state, make_vtrace_train_step(net, state.optimizer, cfg)


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def bf16_sum_leaf(leaf: str) -> bool:
    """A leaf whose JAX gradient is a sum taken in bf16: the conv biases
    and the PReLU slope (``tests/test_torch_model.py``'s conv-bias note)."""
    return ("Conv_" in leaf and "bias" in leaf) or "PReLU" in leaf


def assert_grads_match(got, ref, ref_chunked) -> None:
    """Per leaf, the port's gradient ``got`` within the larger of
    ``tests/test_torch_model.py``'s bound (its conv-bias bound for every
    bf16-sum leaf, the cause it was set for) and JAX's own spread: the
    rel-L2 between JAX's gradient ``ref`` and the same gradient taken as
    the mean over env-column chunks, ``ref_chunked``."""
    errs = _rel_l2_per_leaf(got, ref)
    spread = _rel_l2_per_leaf(ref, ref_chunked)
    for k, e in errs.items():
        bound = max(CONV_BIAS_REL_L2 if bf16_sum_leaf(k) else _bound(k), spread[k])
        assert e < bound, (k, e, bound, errs, spread)


def _assert_metrics(m, ref, where):
    assert set(m) == set(ref), (set(m) ^ set(ref))
    for k in STEP_METRICS:
        got = float(m[k])
        assert abs(got - ref[k]) <= METRIC_REL * max(abs(ref[k]), 1e-6), (where, k, got, ref[k])


def test_one_and_two_vtrace_updates_match_jax(jax_vtrace_run):
    """The first update from the initial params; the second from JAX's
    state after the first (params and Adam's moments), so it compares the
    update with Adam's history in play. Then two in a row: the metrics of
    both steps within the bound."""
    run = jax_vtrace_run
    for i, host in enumerate((run["init"], run["states"][0])):
        state, step = _port_step_at(host)
        old = to_flax(state.model.state_dict())
        state, m = step(state, _t(run["batches"][i]), 0.01, LRS[i])
        assert state.step == i + 1
        assert int(state.optimizer.state_dict()["count"]) == i + 1
        _assert_metrics(m, run["metrics"][i], f"update {i + 1}")
        errs = _update_rel_l2(to_flax(state.model.state_dict()), old,
                              run["states"][i].params, host.params)
        if i == 1:
            errs = {k: v for k, v in errs.items() if not bf16_sum_leaf(k)}
        assert max(errs.values()) < UPDATE_REL_L2, (i, errs)
    # the second update's gradients, every leaf, at the model test's bounds
    state, _ = _port_step_at(run["states"][0])
    total, _ = _make_vtrace_loss_fn(state.model, BA3CConfig(fc_units=16),
                                    _t(run["batches"][1]), 0.01)()
    grads = torch.autograd.grad(total, list(state.model.parameters()))
    got = to_flax({k: g for (k, _), g in zip(state.model.named_parameters(), grads)})
    assert_grads_match(got, run["grads2"], run["grads2_chunked"])
    rho = run["metrics"][0]["mean_rho"]
    assert 0.9 < rho < 1.0  # the clip engaged: rhos on both sides of 1
    state, step = _port_step_at(run["init"])
    for i, (b, lr) in enumerate(zip(run["batches"], LRS)):
        state, m = step(state, _t(b), 0.01, lr)
        _assert_metrics(m, run["metrics"][i], f"step {i + 1} in a row")


def test_vtrace_learning_rate_zero_freezes_the_params(jax_vtrace_run):
    state, step = _port_step_at(jax_vtrace_run["init"])
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    state, m = step(state, _t(jax_vtrace_run["batches"][0]), 0.01, 0.0)
    assert state.step == 1 and all(np.isfinite(float(v)) for v in m.values())
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    for a, b in zip(jax.tree_util.tree_leaves(jax_vtrace_run["lr0"].params),
                    jax.tree_util.tree_leaves(jax_vtrace_run["init"].params)):
        np.testing.assert_array_equal(a, b)


# -- the CLI -------------------------------------------------------------------

#: tests/test_vtrace_lag_e2e.py's flags: the behaviour policy up to 8 updates stale
LAG_E2E = ["--env", "fake", "--publish_every", "8", "--simulator_procs", "4",
           "--batch_size", "32", "--image_size", "16", "--fc_units", "16",
           "--steps_per_epoch", "80", "--max_epoch", "2", "--nr_eval", "4"]


def test_vtrace_trainer_learns_the_fake_env_under_lag(tmp_path):
    """The V-trace path end to end on the CPU: FakeEnv simulators -> ZMQ ->
    the V-trace master -> RolloutFeed/DeviceIngest -> the V-trace step,
    with the predictor's params up to 8 updates stale."""
    logdir = tmp_path / "log"
    r = subprocess.run(
        [sys.executable, "-m", "distributed_ba3c_tpu_torch", "--trainer", "tpu_vtrace_ba3c",
         *LAG_E2E, "--device", "cpu", "--logdir", str(logdir)],
        capture_output=True, text=True, timeout=240, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO),
    )
    assert r.returncode == 0, r.stderr[-3000:]
    stats = json.loads((logdir / "stat.json").read_text())
    final = stats[-1]
    assert final["eval_mean_score"] >= 0.75, final
    assert final["global_step"] == 160
    # 32 // 5 = 6 segments of 5 transitions a step
    assert final["tele/learner/train_samples_total"] == 160 * 30
    assert final["tele/master/datapoints_total"] >= 160 * 30
    assert 0.0 < final["mean_rho"] <= 1.0
    assert "tpu_vtrace_ba3c on cpu" in r.stderr and "6 segments a step" in r.stderr


def test_vtrace_trainer_refuses_the_on_device_env(tmp_path):
    """The ZMQ trainers take ``jax:`` players now (host_adapter.py); the
    players still to port, ``gym:`` and ``zmq:``, exit naming their
    ROADMAP item."""
    for env in ("gym:Pong", "zmq:pong"):
        with pytest.raises(SystemExit, match="not ported yet.*item 3b"):
            cli.main(["--trainer", "tpu_vtrace_ba3c", "--env", env, "--device", "cpu",
                      "--logdir", str(tmp_path)])

"""The port's actor plane (``actors/``, ``envs/native.py::CppEnvServerProcess``)
held against the JAX package's.

Offline, in the style of ``tests/test_block_wire.py``: one seeded FakeEnv
trajectory under a deterministic stub policy is fed, message by message,
to the port's ``BA3CSimulatorMaster`` and to JAX's, over the per-env wire
and over the block wire, with and without ``reward_clip``. The emitted
datapoint multisets and the episode scores must be equal across packages,
and across wires within the port.

Live, on ipc://: env servers step the native Pong core and speak the wire
to a master whose stub predictor answers a fixed number of requests. The
port's server over each of its three wires feeds the port's master; a JAX
server feeds the port's master; and the reference is a JAX server feeding
JAX's master. All servers seed their envs ``idx * 10_000``, so every run
emits the same stream.

The spawned children import neither torch nor jax.
"""

from __future__ import annotations

import functools
import os
import queue
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

from distributed_ba3c_tpu.actors import master as jmaster
from distributed_ba3c_tpu.actors import simulator as jsim
from distributed_ba3c_tpu.envs import native as jnative
from distributed_ba3c_tpu_torch.actors import master as pmaster
from distributed_ba3c_tpu_torch.actors import simulator as psim
from distributed_ba3c_tpu_torch.envs import native as pnative
from distributed_ba3c_tpu_torch.envs.fake import build_fake_player
from distributed_ba3c_tpu_torch.utils import shm as pshm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_ACTIONS = 4
PKG = {"jax": (jmaster, jsim), "port": (pmaster, psim)}


def _policy(state, num_actions=N_ACTIONS):
    """Deterministic (action, value, logp) from the pixels."""
    h = int(np.asarray(state, np.uint64).sum())
    return h % num_actions, (h % 8) / 8.0, -1.25


class _DetPredictor:
    """Synchronous deterministic predictor stub speaking both task APIs."""

    num_actions = N_ACTIONS

    def put_task(self, state, cb, **kw):
        cb(*_policy(state, self.num_actions))

    def put_block_task(self, states, cb, **kw):
        outs = [_policy(states[j], self.num_actions) for j in range(len(states))]
        cb(np.asarray([o[0] for o in outs], np.int32),
           np.asarray([o[1] for o in outs], np.float32),
           np.asarray([o[2] for o in outs], np.float32))


def _trajectory(n_envs, n_steps, seed_base):
    """One recorded lockstep trajectory: per step the B states, and the
    rewards/dones the previous step's actions earned."""
    players = [build_fake_player(seed_base + i, image_size=(16, 16), frame_history=2,
                                 num_actions=N_ACTIONS) for i in range(n_envs)]
    rewards, overs = np.zeros(n_envs, np.float32), np.zeros(n_envs, bool)
    out = []
    for _ in range(n_steps):
        states = np.stack([p.current_state() for p in players])
        out.append((states, rewards.copy(), overs.copy()))
        for j, p in enumerate(players):
            r, o = p.action(_policy(states[j])[0])
            rewards[j], overs[j] = r, o
    return out


def _drive_per_env(master, traj):
    for states, rewards, overs in traj:
        for j in range(len(states)):
            master._on_message(f"sim-{j}".encode(), states[j], float(rewards[j]),
                               bool(overs[j]))


def _drive_block(master, sim, traj):
    ident = b"blk-0*block"
    master.clients[ident] = sim.BlockClientState(ident, len(traj[0][0]))
    for states, rewards, overs in traj:
        master._on_block_message(ident, states, rewards, overs)


def _drain(q):
    out = []
    while True:
        try:
            out.append(q.get_nowait())
        except queue.Empty:
            return out


def _dp_key(dp):
    state, action, ret = dp
    return (np.asarray(state).tobytes(), int(action), float(ret))


def _offline_stream(pkg, wire, tmp_path, traj, **kw):
    mmod, sim = PKG[pkg]
    m = mmod.BA3CSimulatorMaster(
        f"ipc://{tmp_path}/{pkg}-{wire}-c", f"ipc://{tmp_path}/{pkg}-{wire}-s",
        _DetPredictor(), score_queue=queue.Queue(), **kw,
    )
    try:
        if wire == "block":
            _drive_block(m, sim, traj)
        else:
            _drive_per_env(m, traj)
        return sorted(_dp_key(d) for d in _drain(m.queue)), sorted(_drain(m.score_queue))
    finally:
        m.close()


@pytest.mark.parametrize("kw,seed_base", [
    (dict(gamma=0.5, local_time_max=3), 0),
    (dict(gamma=0.99, local_time_max=5), 3),
    (dict(gamma=0.5, local_time_max=2, reward_clip=0.5), 7),
], ids=["n3", "n5", "clip"])
@pytest.mark.parametrize("wire", ["per-env", "block"])
def test_master_streams_match_jax(wire, kw, seed_base, tmp_path):
    traj = _trajectory(4, 50, seed_base)
    dp_port, sc_port = _offline_stream("port", wire, tmp_path, traj, **kw)
    dp_jax, sc_jax = _offline_stream("jax", wire, tmp_path, traj, **kw)
    assert len(dp_port) > 40 and len(sc_port) > 0  # episodes ended AND windows truncated
    assert dp_port == dp_jax
    assert sc_port == sc_jax


@pytest.mark.parametrize("kw", [dict(gamma=0.5, local_time_max=3),
                                dict(gamma=0.5, local_time_max=2, reward_clip=0.5)],
                         ids=["n3", "clip"])
def test_port_block_wire_equals_its_per_env_wire(kw, tmp_path):
    traj = _trajectory(4, 50, 11)
    assert (_offline_stream("port", "block", tmp_path, traj, **kw)
            == _offline_stream("port", "per-env", tmp_path, traj, **kw))


def test_block_states_view_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    window = rng.integers(0, 256, (4, 5, 6, 7), dtype=np.uint8)
    ages = np.array([0, 1, 2, 3, 9])
    got, want = psim.BlockStatesView(window, ages), jsim.BlockStatesView(window, ages)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    for j in range(5):
        np.testing.assert_array_equal(got[j], want[j])
    out = np.empty(got.shape, np.uint8)
    np.testing.assert_array_equal(got.materialize_into(out), np.asarray(want))


def test_default_pipes_live_in_the_temp_directory(tmp_path, monkeypatch):
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    c2s, s2c = psim.default_pipes()
    base = f"ipc://{tmp_path}/ba3c-{os.getpid()}"
    assert (c2s, s2c) == (f"{base}-c2s", f"{base}-s2c")


def test_corrupt_and_junk_frames_are_counted_not_fatal(tmp_path):
    from distributed_ba3c_tpu_torch import telemetry
    from distributed_ba3c_tpu_torch.utils.serialize import dumps

    m = pmaster.BA3CSimulatorMaster(f"ipc://{tmp_path}/c", f"ipc://{tmp_path}/s",
                                    _DetPredictor(), tele_role="master.t0")
    reg = telemetry.registry("master.t0")
    try:
        raw = bytearray(dumps([b"x", np.zeros(3, np.uint8), 0.0, False], crc=True))
        raw[-1] ^= 1

        class F:  # a zmq.Frame's buffer attribute
            def __init__(self, b):
                self.buffer = memoryview(bytes(b))

        m._on_per_env_frame(F(raw))
        m._on_per_env_frame(F(b"\x01\x02"))
        m._on_block_frames([F(b"junk"), F(b""), F(b"")])
        # a 6th per-env element that does not decode as a trace context is
        # counted and ignored
        m._on_per_env_frame(F(dumps([b"y", np.zeros(3, np.uint8), 0.0, False, {}, [1, 2]])))
        assert reg.counter("corrupt_frames_total").value() == 1
        assert reg.counter("blocks_rejected_total").value() == 2
        assert reg.counter("trace_contexts_ignored_total").value() == 1
        assert b"y" in m.clients and len(m.clients[b"y"].memory) == 1
    finally:
        m.close()


def test_a_reply_waits_for_its_peer_to_connect(tmp_path, monkeypatch):
    """A server's first message can beat its DEALER's handshake with the
    master's ROUTER: the reply waits for the peer instead of vanishing (a
    lockstep server would park forever), and one for a peer that never
    connects is dropped after the grace and counted."""
    import zmq

    from distributed_ba3c_tpu_torch.utils.serialize import loads

    monkeypatch.setattr(psim, "UNROUTABLE_GRACE_S", 1.0)
    m = pmaster.BA3CSimulatorMaster(f"ipc://{tmp_path}/c", f"ipc://{tmp_path}/s",
                                    _DetPredictor(), tele_role="master.late")
    ctx = zmq.Context()
    dealer = ctx.socket(zmq.DEALER)
    try:
        m.send_action(b"late", 3)
        m.send_action(b"never", 1)
        time.sleep(0.3)  # both queued, neither peer routable
        dealer.setsockopt(zmq.IDENTITY, b"late")
        dealer.connect(f"ipc://{tmp_path}/s")
        assert dealer.poll(5000), "the reply was dropped"
        assert loads(dealer.recv()) == 3
        deadline = time.monotonic() + 10
        while m._c_unroutable.value() < 1:
            assert time.monotonic() < deadline
            time.sleep(0.05)
        assert m._c_unroutable.value() == 1
    finally:
        dealer.close(0)
        ctx.term()
        m.close()


# -- live plane ----------------------------------------------------------------

N_ENVS, K_STEPS = 4, 10
NATIVE = pnative.available()


class _CappedPredictor(_DetPredictor):
    """Answers the first ``cap`` requests and then none, so a lockstep
    server stops after a fixed number of steps; counts every request."""

    num_actions = 6

    def __init__(self, cap):
        self.cap = cap
        self.calls = 0

    def put_task(self, state, cb, **kw):
        self.calls += 1
        if self.calls <= self.cap:
            super().put_task(state, cb)

    def put_block_task(self, states, cb, **kw):
        self.calls += 1
        if self.calls <= self.cap:
            super().put_block_task(states, cb)


def _live_stream(server_pkg, master_pkg, wire, tmp_path):
    """Run one server of ``server_pkg`` against ``master_pkg``'s master for
    K_STEPS answered steps; returns the datapoint multiset, the server's
    pid maps (read while it runs) and the master's message count."""
    mmod, _ = PKG[master_pkg]
    per_env = wire == "per-env"
    cap = K_STEPS * (N_ENVS if per_env else 1)
    want_calls = cap + (N_ENVS if per_env else 1)
    pred = _CappedPredictor(cap)
    tag = f"{server_pkg}-{master_pkg}-{wire}"
    c2s, s2c = f"ipc://{tmp_path}/{tag}-c", f"ipc://{tmp_path}/{tag}-s"
    m = mmod.BA3CSimulatorMaster(c2s, s2c, pred, gamma=0.9, local_time_max=3)
    m.feed_batch = 8
    server_cls = (pnative if server_pkg == "port" else jnative).CppEnvServerProcess
    srv = server_cls(0, c2s, s2c, game="pong", n_envs=N_ENVS, frame_history=4,
                     wire=wire, ident_prefix=f"t-{tag}")
    m.start()
    srv.start()
    try:
        deadline = time.monotonic() + 60
        while pred.calls < want_calls:
            assert srv.is_alive() and time.monotonic() < deadline, (tag, pred.calls)
            time.sleep(0.02)
        with open(f"/proc/{srv.pid}/maps") as f:
            maps = f.read()
        time.sleep(0.1)
        return sorted(_dp_key(d) for d in _drain(m.queue)), maps
    finally:
        srv.terminate()
        srv.join(10)
        m.close()


@pytest.fixture(scope="module")
def jax_reference_stream(tmp_path_factory):
    if not NATIVE:
        pytest.skip("native env core not built (make -C cpp)")
    dps, _ = _live_stream("jax", "jax", "block", tmp_path_factory.mktemp("ref"))
    return dps


@pytest.mark.skipif(not NATIVE, reason="native env core not built (make -C cpp)")
@pytest.mark.parametrize("server_pkg,wire", [
    ("port", "block-shm"), ("port", "block"), ("port", "per-env"), ("jax", "block"),
])
def test_live_plane_feeds_the_port_master_the_jax_stream(
    server_pkg, wire, jax_reference_stream, tmp_path
):
    if wire == "block-shm" and not pshm.available():
        pytest.skip("no writable /dev/shm")
    dps, maps = _live_stream(server_pkg, "port", wire, tmp_path)
    # N_ENVS windows of local_time_max=3 flushed per 3 steps (Pong episodes
    # outlast K_STEPS); the equality below pins the rest
    assert len(dps) == N_ENVS * 3 * ((K_STEPS - 1) // 3)
    assert dps == jax_reference_stream
    if server_pkg == "port":
        assert "libtorch" not in maps and "jaxlib" not in maps


PROBE = textwrap.dedent('''
    import json, sys


    def build(out, idx):
        import distributed_ba3c_tpu_torch.quantize.spec  # noqa: F401  torch-free
        roots = sorted({m.split(".")[0] for m, v in sys.modules.items() if v is not None})
        with open(out, "w") as f:
            json.dump(roots, f)
        from distributed_ba3c_tpu_torch.envs.fake import build_fake_player

        return build_fake_player(idx, image_size=(16, 16))
''')


def test_spawned_simulator_child_imports_neither_torch_nor_jax(tmp_path, monkeypatch):
    (tmp_path / "ba3c_probe_player.py").write_text(PROBE)
    monkeypatch.syspath_prepend(str(tmp_path))
    import ba3c_probe_player

    out = tmp_path / "modules.json"
    m = pmaster.BA3CSimulatorMaster(f"ipc://{tmp_path}/c", f"ipc://{tmp_path}/s",
                                    _DetPredictor())
    sim = psim.SimulatorProcess(0, f"ipc://{tmp_path}/c", f"ipc://{tmp_path}/s",
                                functools.partial(ba3c_probe_player.build, str(out)))
    m.start()
    sim.start()
    try:
        deadline = time.monotonic() + 60
        while not out.exists() or m._c_per_env_msgs.value() < 3:
            assert sim.is_alive() and time.monotonic() < deadline
            time.sleep(0.05)
        import json

        roots = set(json.loads(out.read_text()))
        assert "distributed_ba3c_tpu_torch" in roots and "zmq" in roots
        assert not roots & {"torch", "jax", "jaxlib", "distributed_ba3c_tpu"}, roots
    finally:
        sim.terminate()
        sim.join(10)
        m.close()


def test_plane_modules_import_no_torch():
    code = ("import sys\n"
            "import distributed_ba3c_tpu_torch.actors.master, "
            "distributed_ba3c_tpu_torch.actors.vtrace_master, "
            "distributed_ba3c_tpu_torch.envs.native, "
            "distributed_ba3c_tpu_torch.utils.shm, "
            "distributed_ba3c_tpu_torch.telemetry.wire, "
            "distributed_ba3c_tpu_torch.telemetry.tracing, "
            "distributed_ba3c_tpu_torch.telemetry.recorder, "
            "distributed_ba3c_tpu_torch.telemetry.exporters, "
            "distributed_ba3c_tpu_torch.quantize.spec\n"
            "import distributed_ba3c_tpu_torch.quantize as q\n"
            "assert q.QuantSpec is q.spec.QuantSpec\n"
            "assert 'torch' not in sys.modules, 'torch'\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=120, cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode == 0, r.stderr[-2000:]

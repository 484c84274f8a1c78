"""Simulator processes and the master's receive loop (the ZMQ actor plane).

Port of ``distributed_ba3c_tpu/actors/simulator.py`` (Tensorpack's
``SimulatorProcess``/``SimulatorMaster``, SURVEY.md §2.3). The wire is the
JAX package's, byte for byte:

    sim -> master (PUSH -> PULL):  msgpack [ident, state u8-array, reward, isOver(, deltas)]
    master -> sim (ROUTER -> DEALER, ident-routed): msgpack action

plus the block wires of the batched env servers (envs/native.py), told
apart per message by frame count. So a JAX env server can feed this master
and a port server the JAX master.

The trace plane rides the same wire (telemetry/tracing.py): a sampled
sender appends a trace context (the 6th per-env element, or the second
tail element of a block header). The master handshakes the sender's clock,
records the ``env_step`` and ``wire`` spans, and hands a ``TraceRef`` to
its subclass's hops (``master_ingest``, ``predict``, ``nstep_flush`` /
``unroll_flush``); a context that does not decode is counted on
``trace_contexts_ignored_total``. An actor prune and a client drop record
a flight event and dump the flight ring (telemetry/recorder.py). Left
out: the sanitizer's wrapped tables.

This module imports no torch: spawned simulator children import it.
"""

from __future__ import annotations

import collections
import multiprocessing as mp
import os
import queue
import tempfile
import threading
import time
import weakref
from abc import abstractmethod
from typing import Callable, Dict, List, Optional

import numpy as np
import zmq

from distributed_ba3c_tpu_torch import telemetry
from distributed_ba3c_tpu_torch.telemetry import tracing
from distributed_ba3c_tpu_torch.envs.base import RLEnvironment
from distributed_ba3c_tpu_torch.utils import logger
from distributed_ba3c_tpu_torch.utils.concurrency import (
    StoppableThread,
    queue_put_stoppable,
)
from distributed_ba3c_tpu_torch.utils.serialize import (
    CorruptFrameError,
    dumps,
    loads,
    unpack_block,
)


class TransitionExperience:
    """One (state, action, value) awaiting its reward attachment."""

    __slots__ = ("state", "action", "value", "reward", "trace")

    def __init__(self, state, action, value, reward=None, trace=None):
        self.state = state
        self.action = action
        self.value = value
        self.reward = reward
        self.trace = trace  # tracing.TraceRef when this step was sampled


class ClientState:
    """Per-simulator state held by the master, keyed by ZMQ ident."""

    __slots__ = ("memory", "ident", "score", "last_seen", "pending_trace")

    def __init__(self, ident: bytes):
        self.ident = ident
        self.memory: List[TransitionExperience] = []
        self.score = 0.0
        # a sampled message's TraceRef, parked between the receive loop
        # and the predictor callback (protocol-serialized)
        self.pending_trace = None
        # creation time, so a client that never sends again still ages out;
        # monotonic, so a wall-clock step cannot mass-expire the actors
        self.last_seen = time.monotonic()


class BlockStep:
    """One lockstep block transition: B states with their chosen actions and
    the rewards/dones that arrive one step later (the block wire's
    [B]-vectorized :class:`TransitionExperience`)."""

    __slots__ = (
        "states", "actions", "values", "logps", "rewards", "dones", "recv_t",
        "trace",
    )

    def __init__(self, states, actions, values, logps):
        self.states = states      # [B, H, W, hist] u8 (view over the frame)
        self.actions = actions    # [B] i32
        self.values = values      # [B] f32
        self.logps = logps        # [B] f32
        self.rewards = None       # [B] f32, attached by the NEXT message
        self.dones = None         # [B] bool, attached by the NEXT message
        # birth stamp of the env-step -> train-ingest latency series (0.0
        # when telemetry is off; the flush skips the observe on falsy)
        self.recv_t = time.monotonic() if telemetry.enabled() else 0.0
        # tracing.TraceRef when this step was sampled (None otherwise: the
        # flush sites branch on None, never on the sampling math)
        self.trace = None


class BlockStatesView:
    """Lazy channel-last ``[B, H, W, hist]`` states over a shm ring window.

    The block-shm wire ships only the newest obs plane per step; the master
    rebuilds each step's stacked state from ``hist`` consecutive ring slots,
    as views. Materialization happens only where the bytes are consumed:
    ``__array__`` for a serving dispatch, ``materialize_into`` at the staged
    collate, ``__getitem__`` per datapoint.

    ``ages[j]`` = env j's steps since episode reset at THIS step. Envs
    younger than ``hist-1`` have missing history planes, which are zero
    (HistoryFramePlayer semantics): those rows take a small copy-and-zero
    path. The window stays valid until the ring wraps onto its slots, which
    the master's attach-time capacity check makes unreachable while the
    consumers drain (utils/shm.py).
    """

    __slots__ = ("window", "ages", "shape")

    def __init__(self, window: np.ndarray, ages: np.ndarray):
        self.window = window  # [hist, B, H, W] (ring view, or small copy)
        self.ages = ages      # [B] i64 snapshot for this step
        hist, b, h, w = window.shape
        self.shape = (b, h, w, hist)

    def __len__(self) -> int:
        return self.shape[0]

    @property
    def dtype(self):
        return self.window.dtype

    def __array__(self, dtype=None, copy=None):
        out = np.empty(self.shape, self.window.dtype)
        self.materialize_into(out)
        if dtype is not None and dtype != out.dtype:
            out = out.astype(dtype)
        return out

    def materialize_into(self, out: np.ndarray) -> np.ndarray:
        """The channel interleave written into a preallocated buffer (one
        copy pass, no allocation)."""
        hist = self.window.shape[0]
        np.copyto(out, self.window.transpose(1, 2, 3, 0))
        for j in np.nonzero(self.ages < hist - 1)[0]:
            out[j, :, :, : hist - 1 - int(self.ages[j])] = 0
        return out

    def __getitem__(self, j: int) -> np.ndarray:
        hist = self.window.shape[0]
        age = int(self.ages[j])
        if age >= hist - 1:
            return self.window[:, j].transpose(1, 2, 0)  # zero-copy view
        # young env: the zeroed history planes need a (small) private copy
        arr = np.ascontiguousarray(self.window[:, j].transpose(1, 2, 0))
        arr[..., : hist - 1 - age] = 0
        return arr


class SegStates:
    """Lazy ``[T, H, W, hist]`` states of ONE env column over T block steps
    (a V-trace segment's ``"state"``).

    The flush keeps references to the T per-step state objects (ring
    window views on the block-shm wire) instead of stacking the column, so
    the bytes are copied once, where they are consumed:
    ``materialize_into`` writes the column into a staging stripe,
    ``__array__`` serves every other consumer. Holding the views until
    collate is what the ring's capacity formula budgets: a queued segment
    counts ``ring_steps_per_item = unroll_len`` ring steps.
    """

    __slots__ = ("states", "j", "shape")

    def __init__(self, states: list, j: int):
        self.states = states  # T per-step [B, H, W, hist] state objects
        self.j = int(j)
        self.shape = (len(states), *tuple(np.shape(states[0]))[1:])

    @property
    def dtype(self):
        return getattr(self.states[0], "dtype", np.dtype(np.uint8))

    def __len__(self) -> int:
        return self.shape[0]

    def __array__(self, dtype=None, copy=None):
        out = np.stack([s[self.j] for s in self.states])
        if dtype is not None and dtype != out.dtype:
            out = out.astype(dtype)
        return out

    def materialize_into(self, out: np.ndarray) -> np.ndarray:
        """Write the env column into ``out[T, H, W, hist]`` (a staging
        stripe view) in one pass."""
        j = self.j
        for t, s in enumerate(self.states):
            out[t] = s[j]
        return out


class BlockClientState:
    """Per-BLOCK state: one env-server process = one wire client = B envs.

    Heartbeat and prune happen per block (a server is alive or dead as a
    unit); the experience buffers stay per env: ``steps`` is the block's
    shared lockstep history and ``start[j]`` indexes env j's first
    unflushed transition in it. ``ring``/``ages`` serve the block-shm wire.
    """

    __slots__ = (
        "ident", "n_envs", "scores", "steps", "start", "last_seen",
        "ring", "ages", "last_step", "pending_trace",
    )

    def __init__(self, ident: bytes, n_envs: int):
        self.ident = ident
        self.n_envs = n_envs
        self.scores = np.zeros(n_envs, np.float64)  # RAW episode scores
        self.steps: List[BlockStep] = []
        self.start = np.zeros(n_envs, np.int64)
        self.last_seen = time.monotonic()
        self.ring = None  # utils.shm.ShmRing once attached (block-shm wire)
        self.ages = np.full(n_envs, -1, np.int64)  # -1: first state pending
        # newest wire step seen; a step that goes BACKWARDS means the server
        # restarted under this ident (the master resets the incarnation)
        self.last_step = -1
        # the current message's TraceRef, parked between the receive loop
        # and the predictor callback that creates its BlockStep (the
        # lockstep protocol admits no second message from this ident
        # before that callback ran)
        self.pending_trace = None

    def close(self) -> None:
        if self.ring is not None:
            self.ring.close()
            self.ring = None


def default_pipes(name: str = "ba3c") -> tuple[str, str]:
    """ipc:// pipe pair for one host, in the temp directory (TMPDIR), unique
    per pid so tests can nest."""
    base = f"ipc://{os.path.join(tempfile.gettempdir(), name)}-{os.getpid()}"
    return f"{base}-c2s", f"{base}-s2c"


_spawn_ctx = mp.get_context("spawn")

#: seconds a reply waits for its peer to become routable (a server's first
#: message can beat its DEALER's handshake with the master's ROUTER)
UNROUTABLE_GRACE_S = 5.0


def _decode_action(raw: bytes, fallback, counter):
    """Decode an action reply; a corrupt reply repeats the previous action
    and ticks ``corrupt_action_replies_total`` instead of killing the
    simulator's episode."""
    try:
        return loads(raw)
    except Exception:
        counter.inc()
        return fallback


class SimulatorProcess(_spawn_ctx.Process):  # type: ignore[name-defined]
    """One OS process owning one player; loop: send state, await action, step.

    ``build_player`` must be picklable (a top-level function or a
    functools.partial). Spawned, not forked: the trainer process is
    multithreaded (CUDA, predictor, master). The child imports numpy, zmq
    and msgpack, never torch.
    """

    def __init__(
        self,
        idx: int,
        pipe_c2s: str,
        pipe_s2c: str,
        build_player: Callable[[int], RLEnvironment],
    ):
        super().__init__(daemon=True, name=f"simulator-{idx}")
        self.idx = idx
        self.c2s = pipe_c2s
        self.s2c = pipe_s2c
        self._build_player = build_player

    def run(self) -> None:
        player = self._build_player(self.idx)
        ident = f"simulator-{self.idx}".encode()
        context = zmq.Context()
        c2s = context.socket(zmq.PUSH)
        c2s.setsockopt(zmq.IDENTITY, ident)
        c2s.set_hwm(4)
        c2s.connect(self.c2s)
        s2c = context.socket(zmq.DEALER)
        s2c.setsockopt(zmq.IDENTITY, ident)
        s2c.connect(self.s2c)

        # the same counters as the C++ env servers' (envs/native.py), sent
        # as deltas on every PIGGYBACK_EVERY-th message (5th element)
        tele = telemetry.registry("simulator")
        c_steps = tele.counter("env_steps_total")
        c_eps = tele.counter("episodes_total")
        c_rew_pos = tele.counter("reward_pos_sum")
        c_rew_neg = tele.counter("reward_neg_sum")
        c_bad = tele.counter("corrupt_action_replies_total")
        tracker = telemetry.DeltaTracker(tele)

        state = player.current_state()
        reward, is_over = 0.0, False
        action = 0  # repeated on a corrupt reply (see _decode_action)
        step = 0
        env_us = 0  # last env-step duration, shipped in the trace context
        try:
            while True:
                msg = [ident, state, reward, is_over]
                d = None
                if (
                    telemetry.enabled()
                    and step and step % telemetry.PIGGYBACK_EVERY == 0
                ):
                    d = tracker.deltas() or None
                # length-versioned tail: deltas 5th element, a sampled
                # step's trace context 6th (the one layout: tracing.py)
                tracing.stamp_wire_meta(msg, ident, step, d, env_us)
                c2s.send(dumps(msg))
                action = _decode_action(s2c.recv(), action, c_bad)
                t_env = tracing.now_us() if tracing.enabled() else 0
                reward, is_over = player.action(action)
                c_steps.inc()
                if is_over:
                    c_eps.inc()
                if reward > 0:
                    c_rew_pos.inc(reward)
                elif reward < 0:
                    c_rew_neg.inc(-reward)
                state = player.current_state()
                if t_env:
                    env_us = tracing.now_us() - t_env
                step += 1
        except (KeyboardInterrupt, zmq.ContextTerminated):
            pass
        finally:
            c2s.close(0)
            s2c.close(0)
            context.term()


class SimulatorMaster(threading.Thread):
    """Master thread: multiplexes all simulators, dispatches subclass hooks.

    Per message: attach the incoming reward to the previous transition,
    fire ``_on_episode_over`` / ``_on_datapoint``, then ``_on_state`` for
    the fresh state (``_on_block_*`` for block messages). A dedicated send
    thread drains ``send_queue`` so predictor callbacks never block on the
    socket.
    """

    #: ring steps one queued train item pins (see :meth:`min_ring_cap`)
    ring_steps_per_item = 1

    def __init__(
        self,
        pipe_c2s: str,
        pipe_s2c: str,
        actor_timeout: Optional[float] = None,
        reward_clip: float = 0.0,
        tele_role: str = "master",
    ):
        """``actor_timeout``: seconds of silence after which a client's
        state is dropped (None: never). ``reward_clip``: clip the LEARNING
        reward to [-c, c] (0 = off); episode scores accumulate raw rewards.
        ``tele_role``: this master's telemetry registry."""
        super().__init__(daemon=True, name=f"SimulatorMaster-{tele_role}")
        self.actor_timeout = actor_timeout
        assert reward_clip >= 0, (
            f"reward_clip must be >= 0, got {reward_clip} (a negative bound "
            "would silently map every learning reward to a constant)"
        )
        self.reward_clip = reward_clip
        self._last_prune = 0.0
        self.context = zmq.Context()
        self.c2s_socket = self.context.socket(zmq.PULL)
        self.c2s_socket.bind(pipe_c2s)
        self.c2s_socket.set_hwm(32)
        self.s2c_socket = self.context.socket(zmq.ROUTER)
        # identity handover: a restarted env server reconnects with its
        # predecessor's identity; without handover libzmq rejects it and
        # the replies go nowhere
        self.s2c_socket.setsockopt(zmq.ROUTER_HANDOVER, 1)
        # an unroutable reply raises instead of vanishing: a server sends
        # its first message before the ROUTER has registered its DEALER,
        # and a reply dropped then would park it forever (send_loop)
        self.s2c_socket.setsockopt(zmq.ROUTER_MANDATORY, 1)
        self.s2c_socket.bind(pipe_s2c)
        self.s2c_socket.set_hwm(32)

        # the receive loop owns the table's structure; the send queue has
        # exactly one drain thread
        self.clients: Dict[bytes, ClientState] = collections.defaultdict(
            lambda: ClientState(b"")
        )
        self.send_queue: "queue.Queue[list]" = queue.Queue(maxsize=1024)
        self._stop_evt = threading.Event()
        # block-shm ring sizing input (the attach-time safety check): the
        # downstream batcher's collate-holder capacity, whose items left the
        # queue but still pin ring views
        self.feed_batch = 0

        self.tele_role = tele_role
        # env-server piggyback deltas fold into the matching fleet role
        self._fleet_tele_role = (
            "fleet" if tele_role == "master"
            else tele_role.replace("master", "fleet", 1)
        )
        tele = telemetry.registry(tele_role)
        self._c_per_env_msgs = tele.counter("per_env_msgs_total")
        self._c_block_msgs = tele.counter("block_msgs_total")
        self._c_block_shm_msgs = tele.counter("block_shm_msgs_total")
        self._c_datapoints = tele.counter("datapoints_total")
        self._c_pruned = tele.counter("clients_pruned_total")
        self._c_dropped = tele.counter("clients_dropped_total")
        self._c_rejected = tele.counter("blocks_rejected_total")
        self._c_corrupt = tele.counter("corrupt_frames_total")
        self._c_incarnation = tele.counter("incarnation_resets_total")
        self._c_blocked_puts = tele.counter("queue_blocked_puts_total")
        self._c_trace_ignored = tele.counter("trace_contexts_ignored_total")
        self._c_unroutable = tele.counter("unroutable_replies_total")
        self._h_put_wait = tele.histogram("queue_put_wait_s", unit=1e-6)
        self._h_ingest = tele.histogram("e2e_ingest_latency_s", unit=1e-6)
        # rows answered with the uniform-random fallback after the
        # predictor shed the task
        self._c_shed_fallbacks = tele.counter("predictor_shed_fallbacks_total")
        # sheds may be delivered from two threads; numpy Generators are not
        # thread-safe
        self._shed_rng = np.random.default_rng(0)
        self._shed_lock = threading.Lock()
        ref = weakref.ref(self)
        tele.gauge(
            "clients", fn=lambda: len(m.clients) if (m := ref()) else 0
        )
        tele.gauge(
            "send_queue_depth",
            fn=lambda: m.send_queue.qsize() if (m := ref()) else 0,
        )
        # subclasses create self.queue after super().__init__ — read late
        tele.gauge(
            "train_queue_depth",
            fn=lambda: (
                q.qsize()
                if (m := ref()) and (q := getattr(m, "queue", None))
                else 0
            ),
        )
        tele.gauge(
            "train_queue_capacity",
            fn=lambda: (
                int(getattr(q, "maxsize", 0) or 0)
                if (m := ref()) and (q := getattr(m, "queue", None))
                else 0
            ),
        )
        tele.gauge(
            "block_backlog_steps",
            fn=lambda: max(
                (
                    len(c.steps)
                    for c in list(getattr(ref(), "clients", {}).values())
                    if isinstance(c, BlockClientState)
                ),
                default=0,
            ),
        )

        def send(msg) -> bool:
            """One reply; False while its peer is not routable yet. Never
            blocks: a peer past its HWM drops the reply, as without
            ROUTER_MANDATORY."""
            try:
                self.s2c_socket.send_multipart(msg, flags=zmq.NOBLOCK)
            except zmq.ZMQError as e:
                if e.errno == zmq.EHOSTUNREACH:
                    return False
                if e.errno != zmq.EAGAIN:
                    raise
            return True

        def send_loop():
            t = threading.current_thread()
            assert isinstance(t, StoppableThread)
            # [deadline, msg] of replies whose peer is still connecting,
            # retried for UNROUTABLE_GRACE_S, then dropped and counted (a
            # peer that died after its message)
            waiting: collections.deque = collections.deque()
            while not t.stopped():
                try:
                    msg = self.send_queue.get(timeout=0.005 if waiting else 0.2)
                except queue.Empty:
                    msg = None
                try:
                    for _ in range(len(waiting)):
                        deadline, old = waiting.popleft()
                        if send(old):
                            continue
                        if time.monotonic() < deadline:
                            waiting.append((deadline, old))
                        else:
                            self._c_unroutable.inc()
                    if msg is not None and not send(msg):
                        waiting.append(
                            (time.monotonic() + UNROUTABLE_GRACE_S, msg)
                        )
                except zmq.ZMQError:
                    if t.stopped() or self._stop_evt.is_set():
                        return  # socket closed during teardown
                    raise

        self.send_thread = StoppableThread(
            target=send_loop, daemon=True, name="SimulatorMaster-send"
        )
        self.send_thread.start()

    def run(self) -> None:
        poller = zmq.Poller()
        poller.register(self.c2s_socket, zmq.POLLIN)
        try:
            while not self._stop_evt.is_set():
                # prune on every iteration (it rate-limits itself)
                self._prune_dead_actors()
                if not poller.poll(timeout=200):
                    continue
                # wire autodetect per message: per-env is ONE msgpack
                # frame, block is multipart. copy=False: the payload frames
                # back the numpy views directly
                frames = self.c2s_socket.recv_multipart(copy=False)
                if len(frames) == 1:
                    self._on_per_env_frame(frames[0])
                else:
                    self._on_block_frames(frames)
        except zmq.ContextTerminated:
            logger.info("SimulatorMaster context terminated")
        except zmq.ZMQError:
            # teardown race: close() destroyed the sockets while we polled
            if not self._stop_evt.is_set():
                raise
            logger.info("SimulatorMaster socket closed during shutdown")

    def _on_per_env_frame(self, frame) -> None:
        try:
            msg = loads(frame.buffer)
            ident, state, reward, is_over = msg[:4]
        except CorruptFrameError as e:
            # typed integrity reject: count it, keep the loop alive (the
            # sender parks in recv and is pruned like any dead actor)
            self._c_corrupt.inc()
            telemetry.record("corrupt_frame", wire="per-env", error=str(e)[:200])
            logger.error("dropping corrupt per-env frame: %s", e)
            return
        except Exception as e:
            # untrusted wire input must not kill the loop for every client
            self._c_rejected.inc()
            telemetry.record("per_env_reject", error=str(e)[:200])
            logger.error("dropping undecodable per-env message: %s", e)
            return
        if len(msg) > 4:
            # element 5: the sender's piggybacked counter deltas
            telemetry.apply_fleet_deltas(
                ident, msg[4], role=self._fleet_tele_role
            )
        self._c_per_env_msgs.inc()
        client = self.clients[ident]
        client.ident = ident
        client.last_seen = time.monotonic()
        if len(msg) > 5:
            # element 6: a sampled trace context — park its ref for the
            # predictor callback's transition record
            client.pending_trace = self._recv_trace(ident, msg[5])
        self._on_message(ident, state, reward, is_over)

    def _prune_dead_actors(self) -> None:
        """Drop the state of clients silent for > actor_timeout (the partial
        rollout is discarded, training continues)."""
        if self.actor_timeout is None:
            return
        now = time.monotonic()
        if now - self._last_prune < self.actor_timeout / 4:
            return
        self._last_prune = now
        dead = [
            ident
            for ident, c in self.clients.items()
            if now - c.last_seen > self.actor_timeout
        ]
        # account first, remove last: an observer of the table must find
        # the counter ticked by the time the client is gone
        for ident in dead:
            client = self.clients[ident]
            self._c_pruned.inc()
            telemetry.record(
                "prune",
                ident=repr(ident),
                silent_s=round(now - client.last_seen, 3),
                block=isinstance(client, BlockClientState),
            )
            logger.warn(
                "actor %s silent for >%.0fs — dropped its client state",
                ident,
                self.actor_timeout,
            )
        if dead:
            # a prune is the postmortem moment: the evidence goes to disk
            telemetry.dump("actor prune")
        for ident in dead:
            client = self.clients.pop(ident)
            if isinstance(client, BlockClientState):
                client.close()  # release the shm ring mapping, if any

    def _on_message(self, ident: bytes, state, reward: float, is_over: bool) -> None:
        """Handle one simulator message (runs in the master thread): attach
        the reward to the previous transition, fire the episode/datapoint
        hooks, then request an action for the new state. Per-client order
        is serialized by the protocol: the simulator waits for its action.
        """
        client = self.clients[ident]
        if len(client.memory) > 0:
            client.memory[-1].reward = self._learn_reward(reward)
            client.score += reward  # scores stay RAW
            if is_over:
                self._on_episode_over(ident)
            else:
                self._on_datapoint(ident)
        self._on_state(state, ident)

    def _learn_reward(self, reward: float) -> float:
        """The LEARNING reward: clipped to [-c, c] when reward_clip is set."""
        c = self.reward_clip
        return max(-c, min(c, reward)) if c else reward

    def _learn_reward_block(self, rewards: np.ndarray) -> np.ndarray:
        """[B]-vectorized :meth:`_learn_reward`."""
        c = self.reward_clip
        return np.clip(rewards, -c, c) if c else rewards

    # -- block wire ingest -------------------------------------------------
    def _on_block_frames(self, frames) -> None:
        """Decode one block message and dispatch the block hooks.

        - 4 frames (``block``): ``[header, obs[hist,B,H,W] u8, rewards[B]
          f32, dones[B] u8]``; the obs frame is consumed as a transposed
          view ([B,H,W,hist]).
        - 3 frames (``block-shm``): ``[header, rewards, dones]``, the header
          naming a /dev/shm ring and this step's slot; the states are a
          lazy :class:`BlockStatesView` over the ring window.
        """
        bufs = [f.buffer for f in frames]
        try:
            if len(bufs) == 4:
                meta, (obs, rewards, dones) = unpack_block(bufs)
                base_meta_len = 3  # [ident, step, B]
                self._c_block_msgs.inc()
            else:
                meta, (rewards, dones) = unpack_block(bufs)
                obs = None
                base_meta_len = 8  # [ident, step, B, ring, cap, h, w, hist]
                self._c_block_shm_msgs.inc()
            ident, step, n_envs = bytes(meta[0]), int(meta[1]), int(meta[2])
            if rewards.shape != (n_envs,) or dones.shape != (n_envs,):
                raise ValueError(
                    f"block payload shapes {rewards.shape}/{dones.shape} "
                    f"do not match header n_envs={n_envs}"
                )
            if len(meta) > base_meta_len:
                # length-versioned header: the piggybacked counter deltas
                telemetry.apply_fleet_deltas(
                    ident, meta[base_meta_len], role=self._fleet_tele_role
                )
            # a sampled step appends the trace context after a (possibly
            # empty) deltas slot, so positions never shift
            trace_elem = (
                meta[base_meta_len + 1]
                if len(meta) > base_meta_len + 1 else None
            )
        except CorruptFrameError as e:
            self._c_corrupt.inc()
            telemetry.record("corrupt_frame", wire="block", error=str(e)[:200])
            logger.error("dropping corrupt block frame: %s", e)
            return
        except (ValueError, TypeError, IndexError) as e:
            # untrusted wire input: skip the message; a real env server
            # parks in recv() and gets pruned
            self._c_rejected.inc()
            telemetry.record("block_reject", error=str(e)[:200])
            logger.error("dropping undecodable block message: %s", e)
            return
        blk = self.clients.get(ident)
        if blk is not None and step <= blk.last_step:
            # step went backwards: the server restarted under this ident —
            # its pre-crash state would misalign every datapoint
            self._c_incarnation.inc()
            telemetry.record(
                "incarnation_reset",
                ident=repr(ident), step=step, last_step=blk.last_step,
            )
            logger.warn(
                "block client %s restarted (step %d after %d) — resetting "
                "its state", ident, step, blk.last_step,
            )
            blk.close()
            blk = None
        if blk is None:
            # created explicitly: the defaultdict factory makes per-env states
            blk = BlockClientState(ident, n_envs)
            self.clients[ident] = blk
        blk.last_seen = time.monotonic()
        blk.last_step = step
        if trace_elem is not None:
            blk.pending_trace = self._recv_trace(ident, trace_elem)
        dones = dones.astype(bool)
        try:
            if obs is not None:
                states = obs.transpose(1, 2, 3, 0)  # [B,H,W,hist] view
            else:
                states = self._shm_states(blk, meta, step, dones)
            self._on_block_message(ident, states, rewards, dones)
        except (ValueError, NotImplementedError) as e:
            # a misconfigured client (ring too small, or a block speaker
            # against a per-env-only master): drop it, keep serving others
            self._c_dropped.inc()
            telemetry.record("client_drop", ident=repr(ident), error=str(e)[:200])
            logger.error(
                "dropping block client %s (it will get no reply and stay "
                "blocked): %s", ident, e,
            )
            del self.clients[ident]
            blk.close()
            telemetry.dump("client drop")

    def min_ring_cap(self, n_envs: int, hist: int) -> float:
        """The block-shm ring capacity floor of this master's buffering
        (``utils/shm.py::min_safe_cap``): the attach-time check refuses a
        ring at or below it, and the CLI sizes the rings it creates from
        it. A queued item pins ``ring_steps_per_item`` ring steps (1 for an
        n-step datapoint, the unroll for a V-trace segment)."""
        from distributed_ba3c_tpu_torch.utils.shm import min_safe_cap

        maxsize = int(getattr(getattr(self, "queue", None), "maxsize", 0) or 0)
        if maxsize <= 0:
            raise ValueError(
                "block-shm wire needs a BOUNDED train queue: queue "
                "backpressure is what stops ring slots from being "
                "overwritten under live datapoints"
            )
        horizon = int(
            getattr(self, "local_time_max", 0) or getattr(self, "unroll_len", 0)
        )
        return min_safe_cap(
            n_envs, maxsize, int(self.feed_batch),
            int(self.ring_steps_per_item), horizon, hist,
        )

    def _shm_states(self, blk, meta, step: int, dones: np.ndarray):
        """Build the step's lazy states view from the client's shm ring."""
        n_envs, ring_name, cap, h, w, hist = meta[2:8]
        if blk.ring is None:
            from distributed_ba3c_tpu_torch.utils.shm import ShmRing

            # safety contract (utils/shm.py): a datapoint's backing slot
            # must not be reusable while the datapoint can still be alive
            needed = self.min_ring_cap(n_envs, hist)
            if cap <= needed:
                raise ValueError(
                    f"shm ring cap {cap} too small for train queue "
                    f"maxsize {self.queue.maxsize} (+{self.feed_batch} feed "
                    f"holder) x {self.ring_steps_per_item} steps/item at "
                    f"B={n_envs}: need > {needed:.0f} — shrink the queue or "
                    "pass a larger shm_ring_cap to the env server"
                )
            blk.ring = ShmRing.attach(ring_name, cap, n_envs, h, w)
            telemetry.record(
                "ring_attach", ident=repr(blk.ident), ring=str(ring_name),
                cap=int(cap),
            )
        ring = blk.ring.arr
        slot = step % cap
        if step >= hist - 1 and slot >= hist - 1:
            window = ring[slot - hist + 1 : slot + 1]  # zero-copy view
        else:
            # wrapped (or pre-history) window: a small stack copy
            window = np.stack(
                [ring[(step - k) % cap] for k in range(hist - 1, -1, -1)]
            )
        ages = np.where(dones, 0, blk.ages + 1)
        blk.ages = ages
        return BlockStatesView(window, ages)

    def _on_block_message(
        self,
        ident: bytes,
        states: np.ndarray,
        rewards: np.ndarray,
        dones: np.ndarray,
    ) -> None:
        """Block analogue of :meth:`_on_message`: attach (rewards, dones) to
        the previous block step, account episode scores, fire the flush
        hook, then request actions for the fresh states. Per-block order is
        serialized by the protocol, as on the per-env wire."""
        blk = self.clients[ident]
        if blk.pending_trace is not None:
            # flight events recorded while this sampled block is flushed
            # and dispatched carry its trace id (telemetry/recorder.py)
            with tracing.trace_scope(blk.pending_trace.trace_id):
                self._dispatch_block(blk, states, rewards, dones, ident)
        else:
            self._dispatch_block(blk, states, rewards, dones, ident)

    def _dispatch_block(self, blk, states, rewards, dones, ident) -> None:
        if blk.steps:
            last = blk.steps[-1]
            last.rewards = self._learn_reward_block(rewards)
            last.dones = dones
            blk.scores += rewards  # scores stay RAW
            if dones.any():
                score_q = getattr(self, "score_queue", None)
                for j in np.nonzero(dones)[0]:
                    if score_q is not None:
                        try:
                            score_q.put_nowait(float(blk.scores[j]))
                        except queue.Full:
                            pass
                blk.scores[dones] = 0.0
            self._on_block_flush(ident)
        self._on_block_state(states, ident)

    def _on_block_state(self, states: np.ndarray, ident: bytes) -> None:
        """Fresh [B,...] states arrived: request B actions in ONE predictor
        call and record the block transition (subclass hook)."""
        raise NotImplementedError(
            f"{type(self).__name__} does not implement the block wire — "
            "run its env servers with wire='per-env'"
        )

    def _on_block_flush(self, ident: bytes) -> None:
        """Rewards/dones were attached to the newest block step: emit any
        completed experience per env (subclass hook)."""
        raise NotImplementedError(
            f"{type(self).__name__} does not implement the block wire — "
            "run its env servers with wire='per-env'"
        )

    def _drop_flushed_prefix(self, blk: BlockClientState) -> None:
        """Free block steps every env has consumed (and their zmq frames)."""
        m = int(blk.start.min())
        if m:
            del blk.steps[:m]
            blk.start -= m

    # -- serving-plane shed fallbacks --------------------------------------
    def _shed_fallback_block(self, cb, k: int):
        """Reply for a shed block task (the predictor's typed ShedReject):
        uniform-random actions, so the lockstep server keeps stepping. The
        recorded log-prob is the fallback policy's (log 1/A), value 0."""

        def shed(reject):
            A = int(getattr(self.predictor, "num_actions", 0) or 0)
            if A <= 0:
                telemetry.record("shed_no_fallback", reason=reject.reason)
                return
            with self._shed_lock:
                acts = self._shed_rng.integers(0, A, k)
            self._c_shed_fallbacks.inc(k)
            cb(
                np.ascontiguousarray(acts, np.int32),
                np.zeros(k, np.float32),
                np.full(k, -np.log(A), np.float32),
            )

        return shed

    def _shed_fallback_row(self, cb):
        """Per-env-wire analogue of :meth:`_shed_fallback_block`."""

        def shed(reject):
            A = int(getattr(self.predictor, "num_actions", 0) or 0)
            if A <= 0:
                telemetry.record("shed_no_fallback", reason=reject.reason)
                return
            with self._shed_lock:
                a = int(self._shed_rng.integers(0, A))
            self._c_shed_fallbacks.inc()
            cb(a, 0.0, float(-np.log(A)))

        return shed

    def _recv_trace(self, ident: bytes, trace_elem):
        """Decode one received trace-context element: handshake the
        sender's monotonic clock, record its ``env_step`` span (duration
        shipped in the context) and the ``wire`` span, and return a
        TraceRef for this master's own hops. None, counted on
        ``trace_contexts_ignored_total``, for a context that does not
        decode (wire input is untrusted) or with telemetry off."""
        out = tracing.receive_context(
            tracing.decode_context(trace_elem),
            peer=repr(ident), role=self.tele_role, origin_always=True,
        )
        if out is None:
            self._c_trace_ignored.inc()
            return None
        trace_id, parent = out
        return tracing.TraceRef(trace_id, parent)

    def send_action(self, ident: bytes, action: int) -> None:
        self._put_stoppable(self.send_queue, [ident, dumps(int(action))])

    def send_block_actions(self, ident: bytes, actions: np.ndarray) -> None:
        """One batched action reply for a whole block: a raw int32[B] frame
        (no msgpack on the reply side)."""
        self._put_stoppable(
            self.send_queue,
            [ident, np.ascontiguousarray(actions, np.int32).tobytes()],
        )

    def _put_stoppable(self, q: queue.Queue, item, timeout: float = 0.5) -> bool:
        """Backpressure that stays shutdown-responsive: bounded-timeout puts
        re-checking the stop flag. Returns False if the master stopped while
        waiting. Only a put that actually waits pays for its telemetry."""
        if self._stop_evt.is_set():
            return False
        try:
            q.put_nowait(item)
            return True
        except queue.Full:
            pass
        self._c_blocked_puts.inc()
        t0 = time.monotonic()
        ok = queue_put_stoppable(q, item, self._stop_evt, timeout)
        waited = time.monotonic() - t0
        self._h_put_wait.observe(waited)
        if waited >= 0.05:
            telemetry.record("queue_wait", wait_s=round(waited, 4))
        return ok

    def stop(self) -> None:
        self._stop_evt.set()
        self.send_thread.stop()

    def close(self) -> None:
        """Stop the threads and tear down ZMQ without lingering sends.
        Idempotent; joins the receive loop BEFORE destroying the context so
        no ZMQ background thread outlives the master."""
        self._stop_evt.set()
        self.send_thread.stop()
        self.send_thread.join(timeout=2)
        if self.is_alive():
            self.join(timeout=2)
        try:
            self.context.destroy(linger=0)
        except zmq.ZMQError:
            pass  # already destroyed
        for client in list(self.clients.values()):
            if isinstance(client, BlockClientState):
                client.close()  # release shm ring mappings, if any

    @abstractmethod
    def _on_state(self, state, ident: bytes) -> None:
        """A fresh state arrived: request an action and record the transition."""

    @abstractmethod
    def _on_episode_over(self, ident: bytes) -> None:
        """The client's episode ended (reward already attached)."""

    @abstractmethod
    def _on_datapoint(self, ident: bytes) -> None:
        """A mid-episode transition completed (reward already attached)."""

    def __del__(self):
        try:
            self._stop_evt.set()
            self.send_thread.stop()
            self.context.destroy(0)
        except Exception:
            pass

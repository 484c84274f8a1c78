"""ctypes binding for the C++ batched env core, and its env-server process.

A copy of ``distributed_ba3c_tpu/envs/native.py``. It loads the repo's
native core ``cpp/libba3c_env.so`` (build: ``make -C cpp``), which exposes
a BATCHED step API so one process drives dozens of envs per call.

Three integration surfaces:
- :class:`CppBatchedEnv` — raw batched stepper (numpy in/out, zero copies
  beyond the ctypes call).
- :func:`build_cpp_player` — single-env player (envs/base.py protocol) for
  wrappers and eval.
- :class:`CppEnvServerProcess` — one spawned process stepping B envs in
  lockstep and speaking the actor plane's ZMQ wire (``block-shm``,
  ``block`` or ``per-env``) to a master. Its wire is byte-compatible with
  the JAX package's server: either side's server feeds either side's
  master. On a sampled step (``--trace_sample``, ``BA3C_TRACE`` in the
  child) it appends the trace context after the deltas slot, as the JAX
  server does, on all three wires.

This module imports no torch: the env-server children import it.
"""

import ctypes
import multiprocessing as mp
import os
from typing import Optional, Tuple

import numpy as np

_LIB_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "cpp",
    "libba3c_env.so",
)

_lib = None


def _try_build() -> bool:
    """Attempt `make -C cpp` once (the .so is a build artifact, not committed)."""
    import subprocess

    try:
        subprocess.run(
            ["make", "-C", os.path.dirname(_LIB_PATH)],
            check=True,
            capture_output=True,
            timeout=120,
        )
    except (OSError, subprocess.SubprocessError):
        return False
    return os.path.isfile(_LIB_PATH)


def _load():
    global _lib
    if _lib is None:
        if not os.path.isfile(_LIB_PATH) and not _try_build():
            raise ImportError(
                f"native env core not built: {_LIB_PATH} missing (run `make -C cpp`)"
            )
        lib = ctypes.CDLL(_LIB_PATH)
        lib.ba3c_env_create.restype = ctypes.c_void_p
        lib.ba3c_env_create.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_uint64]
        lib.ba3c_env_destroy.argtypes = [ctypes.c_void_p]
        lib.ba3c_env_num_actions.argtypes = [ctypes.c_void_p]
        lib.ba3c_env_num_actions.restype = ctypes.c_int
        lib.ba3c_env_size.argtypes = [ctypes.c_void_p]
        lib.ba3c_env_size.restype = ctypes.c_int
        lib.ba3c_env_reset.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8)]
        lib.ba3c_env_step.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.ba3c_obs_height.restype = ctypes.c_int
        lib.ba3c_obs_width.restype = ctypes.c_int
        _lib = lib
    return _lib


def available() -> bool:
    return os.path.isfile(_LIB_PATH) or _try_build()


class CppBatchedEnv:
    """N native envs stepped in one call. Obs are uint8 [N, 84, 84]."""

    def __init__(self, name: str, n: int, seed: int = 0):
        lib = _load()
        self._lib = lib
        self._handle = lib.ba3c_env_create(name.encode(), n, seed)
        if not self._handle:
            raise ValueError(f"unknown native env {name!r}")
        self.n = n
        self.h = lib.ba3c_obs_height()
        self.w = lib.ba3c_obs_width()
        self.num_actions = lib.ba3c_env_num_actions(self._handle)
        self._obs = np.zeros((n, self.h, self.w), np.uint8)
        self._rew = np.zeros(n, np.float32)
        self._done = np.zeros(n, np.uint8)

    def reset(self) -> np.ndarray:
        self._lib.ba3c_env_reset(
            self._handle,
            self._obs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        )
        return self._obs

    def step(
        self, actions: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """actions int32 [N] -> (obs [N,84,84] u8, rewards [N] f32, dones [N] u8).

        Returned arrays are internal buffers reused every call — copy if kept.
        """
        actions = np.ascontiguousarray(actions, np.int32)
        assert actions.shape == (self.n,)
        self._lib.ba3c_env_step(
            self._handle,
            actions.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            self._obs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            self._rew.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self._done.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        )
        return self._obs, self._rew, self._done

    def close(self):
        if self._handle:
            self._lib.ba3c_env_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def build_cpp_player(idx: int, name: str = "pong", frame_history: int = 4):
    """Single native env as a history-stacked player (wire-compatible with
    build_fake_player; used by SimulatorProcess/eval parity paths)."""
    from distributed_ba3c_tpu_torch.envs.base import RLEnvironment
    from distributed_ba3c_tpu_torch.envs.wrappers import HistoryFramePlayer

    class _CppPlayer(RLEnvironment):
        def __init__(self):
            self.env = CppBatchedEnv(name, 1, seed=idx)
            self.env.reset()
            self.score = 0.0
            super().__init__()

        def current_state(self):
            return self.env._obs[0].copy()

        def get_action_space_size(self):
            return self.env.num_actions

        def action(self, act):
            _, rew, done = self.env.step(np.array([act], np.int32))
            r, over = float(rew[0]), bool(done[0])
            self.score += r
            if over:
                self.finish_episode(self.score)
                self.score = 0.0
            return r, over

        def restart_episode(self):
            self.env.reset()
            self.score = 0.0

    return HistoryFramePlayer(_CppPlayer(), frame_history)



def _decode_actions(raw: bytes, fallback: np.ndarray, counter) -> np.ndarray:
    """Decode a batched action-reply frame; junk must not kill the loop.

    A corrupt or short reply frame repeats the previous actions, makes the
    drop visible on ``corrupt_action_replies_total``, and keeps the
    lockstep loop alive instead of raising out of ``_run_block*``.
    """
    try:
        actions = np.frombuffer(raw, np.int32)
    except Exception:
        counter.inc()
        return fallback
    if actions.shape != fallback.shape:
        counter.inc()
        return fallback
    return actions


def _decode_action(raw: bytes, fallback: int, counter) -> int:
    """Per-env twin of :func:`_decode_actions` for the ``per-env`` wire."""
    from distributed_ba3c_tpu_torch.utils.serialize import loads

    try:
        return int(loads(raw))
    except Exception:
        counter.inc()
        return fallback


class CppEnvServerProcess(mp.get_context("spawn").Process):  # type: ignore[misc]
    """One process, B native envs, lockstep-batched stepping, ZMQ transport.

    Three wire modes, as in the JAX package:

    - ``wire="block-shm"``: control over ZMQ, observation bytes through a
      /dev/shm ring (utils/shm.py). ONE tiny multipart message per STEP —
      ``[header, rewards[B], dones[B]]``, the header naming the ring and
      the step's slot — and one raw ``int32[B]`` action reply. The server
      writes each step's obs plane into ``ring[step % cap]``; the master
      reads frame-history windows as numpy views. Same host only.
    - ``wire="block"``: ONE multipart message per STEP for the whole block
      — ``[header, obs[hist,B,H,W], rewards[B], dones[B]]`` as raw
      zero-copy frames — and one raw ``int32[B]`` action reply, routed by
      the block's DEALER identity ``<prefix>*block``. The history stack is
      ``[hist, B, H, W]`` so the per-step shift is a contiguous memmove;
      the master consumes transposed views.
    - ``wire="per-env"``: each env has its own DEALER identity
      ``<prefix>-<i>`` and speaks SimulatorProcess's per-env msgpack
      protocol: send [ident, stacked_state, reward, isOver], await action.

    Each server seeds its envs ``idx * 10_000``, as the JAX server does.
    Every ``PIGGYBACK_EVERY`` steps the header (block wires) or env 0's
    message (per-env) carries the counter deltas of the ``simulator``
    registry (telemetry/wire.py).
    """

    #: default block-shm ring sizing: capacity (in steps) chosen so the
    #: ring is ~8192 env-steps deep regardless of B (~57 MB at 84x84)
    SHM_RING_STEPS = 8192
    SHM_RING_MIN_CAP = 64

    def __init__(
        self,
        idx: int,
        pipe_c2s: str,
        pipe_s2c: str,
        game: str = "pong",
        n_envs: int = 16,
        frame_history: int = 4,
        ident_prefix: Optional[str] = None,
        wire: str = "block",
        shm_ring_cap: Optional[int] = None,
    ):
        super().__init__(daemon=True, name=f"cpp-env-server-{idx}")
        assert wire in ("block-shm", "block", "per-env"), wire
        self.idx = idx
        self.c2s = pipe_c2s
        self.s2c = pipe_s2c
        self.game = game
        self.n_envs = n_envs
        self.frame_history = frame_history
        self.ident_prefix = ident_prefix or f"cppsim-{idx}"
        self.wire = wire
        self.shm_ring_cap = shm_ring_cap or max(
            self.SHM_RING_MIN_CAP, self.SHM_RING_STEPS // max(1, n_envs)
        )

    def run(self) -> None:  # child process: no torch
        if self.wire == "block-shm":
            self._run_block_shm()
        elif self.wire == "block":
            self._run_block()
        else:
            self._run_per_env()

    def _tele_setup(self):
        """Child-side telemetry: ``(count_step, piggyback, extend_meta,
        c_bad)``.

        ``count_step(rew, dn)`` runs once per lockstep step;
        ``piggyback(step)`` returns the deltas dict to append to the wire
        (or None, which keeps the message at its base length);
        ``extend_meta(meta, step, env_us)`` appends the block header's
        length-versioned tail: the deltas and, on a sampled step, the trace
        context carrying this server's monotonic stamp and its last
        ``env.step`` duration (``tracing.stamp_wire_meta``); ``c_bad`` is
        the ``corrupt_action_replies_total`` counter the decoders tick."""
        from distributed_ba3c_tpu_torch import telemetry
        from distributed_ba3c_tpu_torch.telemetry import tracing

        tele = telemetry.registry("simulator")
        c_steps = tele.counter("env_steps_total")
        c_eps = tele.counter("episodes_total")
        # reward split by sign: both halves stay monotonic counters
        c_rew_pos = tele.counter("reward_pos_sum")
        c_rew_neg = tele.counter("reward_neg_sum")
        c_bad = tele.counter("corrupt_action_replies_total")
        tracker = telemetry.DeltaTracker(tele)
        B = self.n_envs

        def count_step(rew, dn) -> None:
            c_steps.inc(B)
            n_done = int(dn.sum())
            if n_done:
                c_eps.inc(n_done)
            pos = float(rew[rew > 0].sum())
            neg = -float(rew[rew < 0].sum())
            if pos:
                c_rew_pos.inc(pos)
            if neg:
                c_rew_neg.inc(neg)

        def piggyback(step: int):
            if not telemetry.enabled():
                return None
            if step == 0 or step % telemetry.PIGGYBACK_EVERY:
                return None
            return tracker.deltas() or None

        ident = f"{self.ident_prefix}*block".encode()

        def extend_meta(meta: list, step: int, env_us: int) -> None:
            tracing.stamp_wire_meta(meta, ident, step, piggyback(step), env_us)

        return count_step, piggyback, extend_meta, c_bad

    def _sockets(self, idents, hwm: int):
        """A PUSH to the master's c2s and one DEALER per ident on s2c."""
        import zmq

        ctx = zmq.Context()
        push = ctx.socket(zmq.PUSH)
        push.set_hwm(hwm)
        push.connect(self.c2s)
        dealers = []
        for ident in idents:
            s = ctx.socket(zmq.DEALER)
            s.setsockopt(zmq.IDENTITY, ident)
            s.connect(self.s2c)
            dealers.append(s)
        return ctx, push, dealers

    def _run_block_shm(self) -> None:
        import signal

        import zmq

        from distributed_ba3c_tpu_torch.telemetry import tracing
        from distributed_ba3c_tpu_torch.utils import shm as shm_mod
        from distributed_ba3c_tpu_torch.utils.serialize import pack_block

        # terminate() must run the finally block so the ring file is
        # unlinked (a SIGKILLed server's stale file is renamed over at the
        # next create)
        def _term(*_):
            raise SystemExit(0)

        signal.signal(signal.SIGTERM, _term)

        env = CppBatchedEnv(self.game, self.n_envs, seed=self.idx * 10_000)
        obs = env.reset()
        B, H, W, hist = self.n_envs, env.h, env.w, self.frame_history
        cap = self.shm_ring_cap
        ident = f"{self.ident_prefix}*block".encode()
        # stable across restarts of this server slot (utils/shm.py)
        ring_name = shm_mod.ring_name(self.c2s, self.ident_prefix)
        ring = shm_mod.ShmRing.create(ring_name, cap, B, H, W)
        rewards = np.zeros(B, np.float32)
        dones = np.zeros(B, np.uint8)
        actions = np.zeros(B, np.int32)  # fallback on a corrupt reply
        ctx, push, (dealer,) = self._sockets([ident], 4)  # blocks are big
        count_step, _, extend_meta, c_bad = self._tele_setup()
        step = 0
        env_us = 0  # last env.step duration, shipped in the trace context
        try:
            while True:
                # the step's obs plane goes into the ring; the wire carries
                # only the header + rewards + dones
                ring.arr[step % cap] = obs
                meta = [ident, step, B, ring_name, cap, H, W, hist]
                extend_meta(meta, step, env_us)  # length-versioned tail
                # lockstep protocol: park in send/recv awaiting the reply
                push.send_multipart(pack_block(meta, [rewards, dones]), copy=False)
                actions = _decode_actions(dealer.recv(), actions, c_bad)
                t_env = tracing.now_us() if tracing.enabled() else 0
                obs, rew, dn = env.step(actions)
                if t_env:
                    env_us = tracing.now_us() - t_env
                rewards[:] = rew
                dones[:] = dn
                count_step(rew, dn)
                step += 1
        except (KeyboardInterrupt, SystemExit, zmq.ContextTerminated):
            pass
        finally:
            dealer.close(0)
            push.close(0)
            ctx.term()
            ring.close(unlink=True)

    def _run_block(self) -> None:
        import zmq

        from distributed_ba3c_tpu_torch.telemetry import tracing
        from distributed_ba3c_tpu_torch.utils.serialize import pack_block

        env = CppBatchedEnv(self.game, self.n_envs, seed=self.idx * 10_000)
        obs = env.reset()
        B, H, W, hist = self.n_envs, env.h, env.w, self.frame_history
        # [hist, B, H, W]: oldest..newest planes, contiguous — the shift is
        # one contiguous memmove and the whole stack is ONE wire frame
        stacks = np.zeros((hist, B, H, W), np.uint8)
        stacks[-1] = obs
        rewards = np.zeros(B, np.float32)
        dones = np.zeros(B, np.uint8)
        actions = np.zeros(B, np.int32)  # fallback on a corrupt reply
        ident = f"{self.ident_prefix}*block".encode()
        ctx, push, (dealer,) = self._sockets([ident], 4)  # blocks are big
        count_step, _, extend_meta, c_bad = self._tele_setup()
        step = 0
        env_us = 0  # last env.step duration, shipped in the trace context
        try:
            while True:
                meta = [ident, step, B]
                extend_meta(meta, step, env_us)  # length-versioned tail
                # copy=False hands zmq the arrays' own buffers: safe because
                # the master cannot reply before it has received the
                # message, and the buffers change only after the reply
                push.send_multipart(
                    pack_block(meta, [stacks, rewards, dones]), copy=False
                )
                actions = _decode_actions(dealer.recv(), actions, c_bad)
                t_env = tracing.now_us() if tracing.enabled() else 0
                obs, rew, dn = env.step(actions)
                if t_env:
                    env_us = tracing.now_us() - t_env
                rewards[:] = rew
                dones[:] = dn
                count_step(rew, dn)
                # shift history; clear across episode boundaries so the
                # first post-reset state is [0,...,0,obs]
                stacks[:-1] = stacks[1:]
                stacks[-1] = obs
                if dn.any():
                    d = dn.astype(bool)
                    stacks[:-1, d] = 0
                step += 1
        except (KeyboardInterrupt, zmq.ContextTerminated):
            pass
        finally:
            dealer.close(0)
            push.close(0)
            ctx.term()

    def _run_per_env(self) -> None:
        import zmq

        from distributed_ba3c_tpu_torch.telemetry import tracing
        from distributed_ba3c_tpu_torch.utils.serialize import dumps

        env = CppBatchedEnv(self.game, self.n_envs, seed=self.idx * 10_000)
        obs = env.reset()
        B, H, W = self.n_envs, env.h, env.w
        stacks = np.zeros((B, H, W, self.frame_history), np.uint8)
        stacks[..., -1] = obs
        rewards = np.zeros(B, np.float32)
        dones = np.zeros(B, bool)
        idents = [f"{self.ident_prefix}-{i}".encode() for i in range(B)]
        ctx, push, dealers = self._sockets(idents, B + 4)
        count_step, piggyback, _, c_bad = self._tele_setup()
        actions = np.zeros(B, np.int32)
        step = 0
        env_us = 0  # last env.step duration, shipped in the trace context
        try:
            while True:
                tele = piggyback(step)
                # telemetry rides env 0's message as an optional 5th
                # element; on a sampled step every env's message carries
                # its own trace context 6th (each env is a wire client)
                for i in range(B):
                    msg = [idents[i], stacks[i], float(rewards[i]), bool(dones[i])]
                    tracing.stamp_wire_meta(
                        msg, idents[i], step, tele if i == 0 else None, env_us
                    )
                    push.send(dumps(msg))
                for i in range(B):
                    actions[i] = _decode_action(
                        dealers[i].recv(), int(actions[i]), c_bad
                    )
                t_env = tracing.now_us() if tracing.enabled() else 0
                obs, rew, dn = env.step(actions)
                if t_env:
                    env_us = tracing.now_us() - t_env
                rewards[:] = rew
                dones[:] = dn.astype(bool)
                count_step(rew, dn)
                step += 1
                # shift history; clear across episode boundaries
                stacks[..., :-1] = stacks[..., 1:]
                stacks[..., -1] = obs
                if dones.any():
                    stacks[dones] = 0
                    stacks[dones, :, :, -1] = obs[dones]
        except (KeyboardInterrupt, zmq.ContextTerminated):
            pass
        finally:
            for s in dealers:
                s.close(0)
            push.close(0)
            ctx.term()

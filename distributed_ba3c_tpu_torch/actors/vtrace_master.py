"""VTraceSimulatorMaster: fixed-length rollout segments with behaviour log-probs.

Port of ``distributed_ba3c_tpu/actors/vtrace_master.py`` (``_Step``,
``VTraceSimulatorMaster``). The V-trace learner
(``parallel/vtrace_step.py``) consumes IMPALA-style unrolls: segments of
exactly ``unroll_len`` transitions that run straight across episode
boundaries (``done`` flags mark them; the reverse scan zeroes the discount
there), so every learner batch has one shape.

A sampled step's trace (telemetry/tracing.py) records ``master_ingest``,
``predict`` and ``unroll_flush`` here and rides the segment as a
``"_trace"`` key, which the feed strips before collate. Left out:
``record_values`` (the ``behavior_values`` key that only the pod master
emits, ROADMAP queue A item 9).

This module imports no torch; its predictor is duck-typed (``put_task``,
``put_block_task``, ``num_actions``).
"""

from __future__ import annotations

import queue
import time
from typing import Optional

import numpy as np

from distributed_ba3c_tpu_torch.actors.simulator import (
    BlockClientState,
    BlockStep,
    SegStates,
    SimulatorMaster,
)
from distributed_ba3c_tpu_torch.telemetry import tracing
from distributed_ba3c_tpu_torch.utils.concurrency import FastQueue


class _Step:
    """One per-env transition: the state, the served action with its
    log-prob (and value), then the reward and done the next message
    brings."""

    __slots__ = ("state", "action", "logp", "value", "reward", "done",
                 "trace")

    def __init__(self, state, action, logp, value=0.0, trace=None):
        self.state = state
        self.action = action
        self.logp = logp
        self.value = value
        self.reward = 0.0
        self.done = False
        self.trace = trace  # tracing.TraceRef when this step was sampled


class VTraceSimulatorMaster(SimulatorMaster):
    """Emits segment dicts onto ``queue``:

    ``{"state": [T,...], "action": [T], "reward": [T], "done": [T],
       "behavior_log_probs": [T], "bootstrap_state": [...]}``
    """

    def __init__(
        self,
        pipe_c2s: str,
        pipe_s2c: str,
        predictor,
        unroll_len: int = 5,
        train_queue: Optional[queue.Queue] = None,
        score_queue: Optional[queue.Queue] = None,
        actor_timeout: Optional[float] = None,
        reward_clip: float = 0.0,
        tele_role: str = "master",
    ):
        super().__init__(
            pipe_c2s, pipe_s2c, actor_timeout=actor_timeout,
            reward_clip=reward_clip, tele_role=tele_role,
        )
        self.predictor = predictor
        self.unroll_len = unroll_len
        # a queued segment's states and bootstrap state pin the ring views
        # of a whole unroll: the ring's capacity must count T steps an item
        self.ring_steps_per_item = unroll_len
        # a queued item is a whole unroll: a consumer turning queue depth
        # into a sample backlog multiplies by unroll_len
        self.queue_samples_per_item = unroll_len
        self.queue: queue.Queue = train_queue or FastQueue(maxsize=1024)
        self.score_queue = score_queue

    def _on_state(self, state: np.ndarray, ident: bytes) -> None:
        # claim the receive loop's parked trace ref (None when unsampled)
        client0 = self.clients[ident]
        ref, client0.pending_trace = client0.pending_trace, None
        if ref is not None:
            ref = ref.hop("master_ingest", self.tele_role)

        def cb(action: int, value: float, logp: float):
            client = self.clients[ident]
            # safe cross-thread append: the simulator waits for this very
            # action, so the master cannot reslice client.memory until
            # send_action below releases it
            trace = ref.hop("predict", self.tele_role) if ref else None
            client.memory.append(_Step(state, action, logp, value, trace))
            self.send_action(ident, action)

        # the shed fallback's uniform log-prob is the TRUE behaviour policy
        # of that row, so V-trace stays exact. trace= only when sampled
        if ref is None:
            self.predictor.put_task(
                state, cb, shed_callback=self._shed_fallback_row(cb)
            )
        else:
            self.predictor.put_task(
                state, cb, shed_callback=self._shed_fallback_row(cb),
                trace=ref,
            )

    def _on_datapoint(self, ident: bytes) -> None:
        pass  # segment emission happens in _on_message

    def _on_episode_over(self, ident: bytes) -> None:
        client = self.clients[ident]
        if self.score_queue is not None:
            try:
                self.score_queue.put_nowait(client.score)
            except queue.Full:
                pass
        client.score = 0.0

    def _on_message(self, ident: bytes, state, reward: float, is_over: bool) -> None:
        """Attach (reward, done) to the newest transition, emit full
        unrolls, then request the next action (all in the master thread,
        before the next predict task can append to ``client.memory``)."""
        client = self.clients[ident]
        if len(client.memory) > 0:
            step = client.memory[-1]
            step.reward = self._learn_reward(reward)
            step.done = is_over
            client.score += reward  # scores stay RAW
            if is_over:
                self._on_episode_over(ident)
            self._maybe_emit(ident)
        self._on_state(state, ident)

    def _maybe_emit(self, ident: bytes) -> None:
        """When T+1 completed transitions exist, emit the first T. The
        (T+1)-th transition's state is the bootstrap state AND the first
        transition of the next segment: unrolls tile time with no gaps."""
        client = self.clients[ident]
        T = self.unroll_len
        if len(client.memory) < T + 1:
            return
        seg, rest = client.memory[:T], client.memory[T:]
        segment = {
            "state": np.stack([s.state for s in seg]),
            "action": np.asarray([s.action for s in seg], np.int32),
            "reward": np.asarray([s.reward for s in seg], np.float32),
            "done": np.asarray([s.done for s in seg], np.float32),
            "behavior_log_probs": np.asarray([s.logp for s in seg], np.float32),
            "bootstrap_state": rest[0].state,
        }
        # a sampled step inside this unroll hands its trace to the segment
        # (claimed once; the feed strips it before collate)
        for s in seg:
            if s.trace is not None:
                segment["_trace"] = s.trace.hop("unroll_flush", self.tele_role)
                s.trace = None
                break
        client.memory = rest
        # backpressure pauses actors, but stays shutdown-responsive
        self._put_stoppable(self.queue, segment)
        self._c_datapoints.inc(T)

    # -- block wire (one message per env server per step) ------------------
    def _on_block_state(self, states: np.ndarray, ident: bytes) -> None:
        blk = self.clients[ident]
        # claim the receive loop's parked trace ref (None when unsampled)
        ref, blk.pending_trace = blk.pending_trace, None
        if ref is not None:
            ref = ref.hop("master_ingest", self.tele_role)

        def cb(actions: np.ndarray, values: np.ndarray, logps: np.ndarray):
            # safe cross-thread append: the env server waits for this very
            # action block (protocol serialization, as on the per-env wire)
            st = BlockStep(states, actions, values, logps)
            if ref is not None:
                st.trace = ref.hop("predict", self.tele_role)
            blk.steps.append(st)
            self.send_block_actions(ident, actions)

        if ref is None:
            self.predictor.put_block_task(
                states, cb,
                shed_callback=self._shed_fallback_block(cb, len(states)),
            )
        else:
            self.predictor.put_block_task(
                states, cb,
                shed_callback=self._shed_fallback_block(cb, len(states)),
                trace=ref,
            )

    def _on_block_flush(self, ident: bytes) -> None:
        """Per-env unroll emission over the block's shared step list (the
        block analogue of :meth:`_maybe_emit`). Unrolls run across episode
        boundaries, so every env of a block emits at the same tick; the
        loop stays per env and pointer-driven (``blk.start``) all the same."""
        blk: BlockClientState = self.clients[ident]
        T = self.unroll_len
        t_end = len(blk.steps)
        # the per-segment trace scan runs only while sampling is armed
        trace_on = tracing.enabled()
        for j in range(blk.n_envs):
            while t_end - blk.start[j] >= T + 1:
                s = int(blk.start[j])
                seg = blk.steps[s : s + T]
                segment = {
                    # the lazy env column: its bytes cross the host once,
                    # at the (staged) collate
                    "state": SegStates([st.states for st in seg], j),
                    "action": np.asarray([st.actions[j] for st in seg], np.int32),
                    "reward": np.asarray([st.rewards[j] for st in seg], np.float32),
                    "done": np.asarray([st.dones[j] for st in seg], np.float32),
                    "behavior_log_probs": np.asarray(
                        [st.logps[j] for st in seg], np.float32
                    ),
                    # the (T+1)-th step's state: bootstrap AND next head
                    "bootstrap_state": blk.steps[s + T].states[j],
                }
                if trace_on:
                    # a sampled step's trace continues on the FIRST
                    # segment that flushes it (one block lifetime = one
                    # trace; the other B-1 envs share the step object)
                    for st in seg:
                        if st.trace is not None:
                            segment["_trace"] = st.trace.hop(
                                "unroll_flush", self.tele_role
                            )
                            st.trace = None
                            break
                blk.start[j] = s + T
                if not self._put_stoppable(self.queue, segment):
                    return  # master stopped while the learner was backed up
                self._c_datapoints.inc(T)
                if seg[0].recv_t:
                    self._h_ingest.observe(time.monotonic() - seg[0].recv_t)
        self._drop_flushed_prefix(blk)

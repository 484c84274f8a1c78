"""BA3CSimulatorMaster: the master-trainer bridge with n-step assembly.

Port of ``distributed_ba3c_tpu/actors/master.py`` (the reference's
``MySimulatorMaster``, SURVEY.md §3.2): on each state request a batched
prediction, record the (state, action, value) transition, and on episode
end or ``local_time_max`` truncation fold the client's memory into
discounted n-step returns pushed to the train queue. The block wire's flush
is vectorized per cohort with the same float64 return scan, so both wires
emit identical streams (``tests/test_torch_actor_plane.py``). A sampled
step's trace (telemetry/tracing.py) records ``master_ingest``,
``predict`` and ``nstep_flush`` here, and rides the first datapoint its
flush emits as a 4th element, ``[state, action, R, ref]``, which the feed
strips before collate (``data/dataflow.py::claim_trace``).

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
    SimulatorMaster,
    TransitionExperience,
)
from distributed_ba3c_tpu_torch.utils.concurrency import FastQueue


class BA3CSimulatorMaster(SimulatorMaster):
    """Feeds the train queue with [state, action, n-step return] triples."""

    def __init__(
        self,
        pipe_c2s: str,
        pipe_s2c: str,
        predictor,
        gamma: float = 0.99,
        local_time_max: int = 5,
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
        self.gamma = gamma
        self.local_time_max = local_time_max
        # bounded: backpressure pauses the actors. FastQueue (no futex per
        # op) because the block wire pushes tens of thousands of items/s
        self.queue: queue.Queue = train_queue or FastQueue(maxsize=4096)
        self.score_queue = score_queue

    def _on_state(self, state: np.ndarray, ident: bytes) -> None:
        # claim the receive loop's parked trace ref (None when unsampled)
        client0 = self.clients[ident]
        ref, client0.pending_trace = client0.pending_trace, None
        if ref is not None:
            # receive -> dispatch: decode and the previous step's flush,
            # backpressure stalls included, stay a master hop
            ref = ref.hop("master_ingest", self.tele_role)

        def cb(action: int, value: float, logp: float):
            client = self.clients[ident]
            # safe cross-thread append: the simulator waits for this very
            # action, so the master cannot touch client.memory until
            # send_action below releases it
            trace = ref.hop("predict", self.tele_role) if ref else None
            client.memory.append(
                TransitionExperience(state, action, value, trace=trace)
            )
            self.send_action(ident, action)

        # a shed task answers with a uniform-random action instead of
        # wedging the simulator; without deadlines it never fires. trace=
        # only when sampled: duck-typed predictors need no new keyword
        if ref is None:
            self.predictor.put_task(
                state, cb, shed_callback=self._shed_fallback_row(cb)
            )
        else:
            self.predictor.put_task(
                state, cb, shed_callback=self._shed_fallback_row(cb),
                trace=ref,
            )

    def _on_episode_over(self, ident: bytes) -> None:
        client = self.clients[ident]
        if self.score_queue is not None:
            try:
                self.score_queue.put_nowait(client.score)
            except queue.Full:
                pass
        client.score = 0.0
        self._parse_memory(0.0, ident, is_over=True)

    def _on_datapoint(self, ident: bytes) -> None:
        client = self.clients[ident]
        if len(client.memory) == self.local_time_max + 1:
            # bootstrap from the newest transition's value estimate
            self._parse_memory(client.memory[-1].value, ident, is_over=False)

    def _parse_memory(self, init_r: float, ident: bytes, is_over: bool) -> None:
        client = self.clients[ident]
        mem = client.memory
        if not is_over:
            last = mem[-1]
            mem = mem[:-1]
        # a sampled step's trace continues on the FIRST datapoint this
        # flush emits (the per-env mirror of _flush_cohort's claim)
        rider = None
        for k in mem:
            if k.trace is not None:
                rider, k.trace = k.trace.hop("nstep_flush", self.tele_role), None
                break
        R = float(init_r)
        for k in reversed(mem):
            R = k.reward + self.gamma * R
            item = [k.state, k.action, np.float32(R)]
            if rider is not None:
                item.append(rider)
                rider = None
            # backpressure pauses actors, but stays shutdown-responsive
            if not self._put_stoppable(self.queue, item):
                return  # master stopped while the learner was backed up
        self._c_datapoints.inc(len(mem))  # one batched inc per flush
        client.memory = [] if is_over else [last]

    # -- block wire (one message per env server per step) ------------------
    def _on_block_state(self, states: np.ndarray, ident: bytes) -> None:
        blk = self.clients[ident]
        # claim the receive loop's parked trace ref (None when unsampled)
        ref, blk.pending_trace = blk.pending_trace, None
        if ref is not None:
            ref = ref.hop("master_ingest", self.tele_role)

        def cb(actions: np.ndarray, values: np.ndarray, logps: np.ndarray):
            # safe cross-thread append: the env server waits for this very
            # action block (protocol serialization, as on the per-env
            # wire); blk is captured by object, so a pruned block is never
            # resurrected through the defaultdict from this thread
            st = BlockStep(states, actions, values, logps)
            if ref is not None:
                # the serve round trip (recv -> actions in hand); the
                # predictor's dispatch/fetch spans ride the same trace
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
        """Per-env n-step emission over the block's shared step list.

        :meth:`_on_episode_over`/:meth:`_on_datapoint` semantics, env by
        env: a done env flushes its whole pending window with R=0; an env
        whose pending window reached ``local_time_max``+1 flushes the first
        ``local_time_max`` transitions bootstrapping from the newest value
        and keeps the newest transition as the next window's head.
        """
        blk: BlockClientState = self.clients[ident]
        t_end = len(blk.steps)
        last = blk.steps[-1]
        dones, values = last.dones, last.values
        T = self.local_time_max
        start = blk.start
        # episode boundaries leave `start` ragged, so the flush runs
        # vectorized PER COHORT: envs sharing a window [s, e) flush
        # together with one f64 return scan (bit-identical to the per-env
        # f64 chain)
        pending = t_end - start
        flush_done = np.nonzero(dones)[0]
        flush_trunc = np.nonzero(~dones & (pending == T + 1))[0]
        for idx, e_off, bootstrap in (
            (flush_done, 0, False),
            (flush_trunc, 1, True),
        ):
            if idx.size == 0:
                continue
            for s in np.unique(start[idx]):
                cohort = idx[start[idx] == s]
                if not self._flush_cohort(
                    blk, cohort, int(s), t_end - e_off,
                    values if bootstrap else None,
                ):
                    return  # master stopped while the learner backed up
        start[flush_done] = t_end
        start[flush_trunc] = t_end - 1
        self._drop_flushed_prefix(blk)

    def _flush_cohort(
        self,
        blk: BlockClientState,
        cohort: np.ndarray,
        s: int,
        e: int,
        bootstrap_values,
    ) -> bool:
        """Emit steps [s, e) for the envs in ``cohort``, newest first (the
        order of :meth:`_parse_memory`). ``bootstrap_values`` is None for
        episode-end flushes (R starts at 0)."""
        if bootstrap_values is None:
            R = np.zeros(cohort.size, np.float64)
        else:
            R = bootstrap_values[cohort].astype(np.float64)
        g, q, put = self.gamma, self.queue, self._put_stoppable
        js = cohort.tolist()
        for t in range(e - 1, s - 1, -1):
            st = blk.steps[t]
            R = st.rewards[cohort].astype(np.float64) + g * R
            R32 = R.astype(np.float32)
            states = st.states
            acts = st.actions[cohort].tolist()
            # a sampled step's trace continues on the FIRST datapoint its
            # flush emits (one block lifetime = one trace, claimed once)
            ref, st.trace = st.trace, None
            if ref is not None:
                ref = ref.hop("nstep_flush", self.tele_role)
            for i, j in enumerate(js):
                item = [states[j], acts[i], R32[i]]
                if ref is not None:
                    item.append(ref)
                    ref = None
                if not put(q, item):
                    return False
        # telemetry per cohort: the datapoint count, and the env-step ->
        # train-ingest latency of the cohort's oldest step
        self._c_datapoints.inc((e - s) * cohort.size)
        if blk.steps[s].recv_t:
            self._h_ingest.observe(time.monotonic() - blk.steps[s].recv_t)
        return True

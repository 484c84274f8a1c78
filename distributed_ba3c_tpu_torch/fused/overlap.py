"""The fused step split in two: an actor and a learner on two CUDA streams.

Port of ``distributed_ba3c_tpu/fused/overlap.py:93-728`` on one device.
The fused step (``fused/loop.py``) runs the small-batch rollout forwards
and the large-batch learner one after the other; here the actor rolls
window k+1 while the learner updates on window k's trajectory block
(policy lag 1), and V-trace's clipped importance weights correct the lag.

    actor:   rollout over T steps with the snapshot of the params of
             update k-1 -> a TrajBlock (states, actions, clipped rewards,
             dones, behaviour log-probs and values, bootstrap stack)
    learner: V-trace fwd+bwd over the block (ONE forward over T*B + B
             states), global-norm clip, Adam

The torch design:

- **The snapshot.** Adam writes ``model``'s parameters in place, so the
  actor runs its own ``BA3CNet`` (a copy of ``model``; ``bfloat16``
  storage under ``rollout_dtype="bfloat16"``, the heads computing in f32
  either way; under ``"int8"`` the quantized forward of
  ``quantize/qforward.py``, whose table the snapshot fills by quantizing
  the learner's params with the run's ``QuantSpec``: quantize-on-snapshot).
  Its params are refreshed at the head of every window,
  issued on the actor's stream after the learner's pending work:
  window k+1's copy queues behind window k's rollout on the same stream,
  so it never overwrites params a running window reads. The learner's
  stream waits for the copy's event before its Adam can write the source.
- **Two streams.** The learner runs on the caller's current stream (so the
  epoch loop's metric reads and checkpoints need no extra ordering), the
  actor on its own stream. The learner's stream ``wait_event``s the
  block's completion event, and every block tensor (allocated on the
  actor's stream) is ``record_stream``'d on the learner's, so the caching
  allocator cannot hand its memory out while the learner reads it. Two
  blocks alternate: the one the learner reads, the one the actor writes.
- **The host.** One Python thread issues both, and a rollout step is
  ~250 small launches, so the window's issue is host-bound. Each iteration
  therefore issues the snapshot copy, then learner k (a few hundred
  launches of large kernels), then window k+1: the card runs the learner
  while the host is still issuing the window, and the snapshot taken
  first keeps the window at lag 1. How much of the window the learner
  hides is measured (``probe_overlap``), not assumed.
- **Draws.** The actor consumes the draw source of ``FusedState.draws``
  in the fused step's order (the shared ``make_rollout_body``), so a lag-0
  run with frozen params is bit-exact with the fused step.

Nothing falls back: a failed stream or event call fails the run. On the
CPU there are no streams and the two halves run in turn.

Left out: ``macro_fleets > 1`` (``--fleet_accum``, the macro learner,
ROADMAP queue A item 8); it raises.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from distributed_ba3c_tpu_torch.config import BA3CConfig
from distributed_ba3c_tpu_torch.fused.loop import (
    CUMULATIVE_METRICS,
    FusedState,
    make_rollout_body,
)
from distributed_ba3c_tpu_torch.models.a3c import BA3CNet
from distributed_ba3c_tpu_torch.ops.gradproc import ClipAdam, grad_summaries
from distributed_ba3c_tpu_torch.ops.vtrace import vtrace_returns
from distributed_ba3c_tpu_torch.parallel.train_step import TrainState

ROLLOUT_DTYPES = ("float32", "bfloat16", "int8")


@dataclasses.dataclass
class ActorState:
    """The env-side carry of the actor (FusedState minus train)."""

    env_state: Any              # batched env state, leaves [B, ...]
    obs_stack: torch.Tensor     # [B, H, W, hist] uint8
    draws: Any                  # the draw source
    ep_return: torch.Tensor     # [B] running episode return
    ep_count: torch.Tensor      # [B] int32 completed episodes per env
    ep_return_sum: torch.Tensor  # [B] float32 sum of completed returns


@dataclasses.dataclass
class TrajBlock:
    """One rollout's trajectory, time-major (the reverse scan's layout),
    handed from the actor to the learner."""

    states: torch.Tensor              # [T, B, H, W, hist] uint8
    actions: torch.Tensor             # [T, B] int32
    rewards: torch.Tensor             # [T, B] f32 (clipped learning rewards)
    dones: torch.Tensor               # [T, B] f32
    behavior_log_probs: torch.Tensor  # [T, B] f32  log mu(a_t|s_t)
    behavior_values: torch.Tensor     # [T, B] f32  V_mu(s_t) (lag diagnostic)
    bootstrap_state: torch.Tensor     # [B, H, W, hist] uint8 (post-rollout)
    ready: Any = None                 # the actor stream's event after the block (CUDA)

    def tensors(self) -> Tuple[torch.Tensor, ...]:
        return (self.states, self.actions, self.rewards, self.dones,
                self.behavior_log_probs, self.behavior_values,
                self.bootstrap_state)


@dataclasses.dataclass
class OverlapState:
    """What the overlap step threads through the epoch loop."""

    train: TrainState
    actor: ActorState
    block: Optional[TrajBlock] = None  # in flight (lag 1), None at lag 0 or fresh


def n_env_chunks(T: int, B: int, grad_chunk_samples: int) -> int:
    """Env-column chunks of at most ``grad_chunk_samples`` samples (T a
    column), rounded up until they divide B; never more than B."""
    n_chunks = min(max(1, -(-(T * B) // grad_chunk_samples)), B)
    while B % n_chunks:
        n_chunks += 1
    return n_chunks


def make_block_grads(
    model: BA3CNet, cfg: BA3CConfig, grad_chunk_samples: int = 4096
) -> Callable[[TrajBlock, Any], Tuple[List[torch.Tensor], Dict[str, torch.Tensor]]]:
    """``block_grads(block, entropy_beta) -> (grads, aux)``: the V-trace
    gradients of ``model``'s params (in parameter order) over a block,
    with the loss terms.

    The block is chunked over ENV COLUMNS: V-trace's reverse scan couples
    a column in time but never two columns, so the mean of the chunk
    gradients is the full-batch gradient. The loss mirrors ``a3c_loss``
    (Huber value loss when ``cfg.value_huber_delta`` is set), so at lag 0
    (rho = c = 1, the targets the n-step returns) it is the fused step's
    objective."""
    params = list(model.parameters())

    def chunk_loss(states, actions, rewards, dones, mu_lp, mu_v, boot, entropy_beta):
        T, Bc = actions.shape
        flat = states.reshape(T * Bc, *states.shape[2:])
        out = model(torch.cat([flat, boot], dim=0))
        logits = out.logits[: T * Bc].reshape(T, Bc, -1)
        values = out.value[: T * Bc].reshape(T, Bc)
        bootstrap_value = out.value[T * Bc:]

        log_probs = torch.log_softmax(logits, dim=-1)
        probs = torch.softmax(logits, dim=-1)
        target_lp = torch.gather(log_probs, -1, actions.long()[..., None])[..., 0]

        vt = vtrace_returns(
            behaviour_log_probs=mu_lp,
            target_log_probs=target_lp.detach(),
            rewards=rewards,
            dones=dones,
            values=values.detach(),
            bootstrap_value=bootstrap_value.detach(),
            gamma=cfg.gamma,
        )
        policy_loss = -torch.mean(target_lp * vt.pg_advantages)
        if cfg.value_huber_delta is not None:
            from distributed_ba3c_tpu_torch.ops.symbolic import huber_loss

            value_loss = torch.mean(huber_loss(values - vt.vs, cfg.value_huber_delta))
        else:
            value_loss = 0.5 * torch.mean(torch.square(values - vt.vs))
        entropy = -torch.mean(torch.sum(probs * log_probs, dim=-1))
        total = (
            policy_loss
            + cfg.value_loss_coef * value_loss
            - entropy_beta * entropy
        )
        aux = {
            "loss": total,
            "policy_loss": policy_loss,
            "value_loss": value_loss,
            "entropy": entropy,
            "mean_rho": torch.mean(vt.clipped_rhos),
            "pred_value": torch.mean(values),
            # how far the value function moved across the policy lag
            "value_lag_mae": torch.mean(torch.abs(values.detach() - mu_v)),
        }
        return total, aux

    def block_grads(block: TrajBlock, entropy_beta):
        T, B = block.actions.shape
        n_chunks = n_env_chunks(T, B, grad_chunk_samples)
        Bc = B // n_chunks
        grads, aux = None, None
        for c in range(n_chunks):
            cols = slice(c * Bc, (c + 1) * Bc)
            total, a = chunk_loss(
                block.states[:, cols], block.actions[:, cols],
                block.rewards[:, cols], block.dones[:, cols],
                block.behavior_log_probs[:, cols],
                block.behavior_values[:, cols], block.bootstrap_state[cols],
                entropy_beta,
            )
            g = torch.autograd.grad(total, params)
            a = {k: v.detach() for k, v in a.items()}
            if grads is None:
                grads, aux = list(g), a
            else:
                grads = [x + y for x, y in zip(grads, g)]
                aux = {k: aux[k] + a[k] for k in aux}
        if n_chunks > 1:
            grads = [g / n_chunks for g in grads]
            aux = {k: v / n_chunks for k, v in aux.items()}
        return grads, aux

    return block_grads


def make_finish_update(optimizer: ClipAdam) -> Callable:
    """The learner's tail: ``finish_update(train, grads, aux, rewards,
    learning_rate) -> (train, metrics)``: the gradient summaries, the
    learning rate, the global-norm clip and Adam (in place on the params
    ``optimizer`` holds), the step bump and the metrics."""

    def finish_update(train: TrainState, grads, aux, rewards, learning_rate):
        metrics = {
            **aux,
            **grad_summaries(grads),
            "reward_per_step": torch.mean(rewards),
        }
        optimizer.set_learning_rate(learning_rate)
        optimizer.step(grads)
        return dataclasses.replace(train, step=train.step + 1), metrics

    return finish_update


def make_overlap_step(
    model: BA3CNet,
    optimizer: ClipAdam,
    cfg: BA3CConfig,
    env,
    rollout_len: int = 20,
    grad_chunk_samples: int = 4096,
    steps_per_dispatch: int = 1,
    lag: int = 1,
    rollout_dtype: str = "float32",
    macro_fleets: int = 1,
    quant_spec=None,
) -> Callable:
    """Build the overlapped step: ``fn(state, entropy_beta,
    learning_rate=None) -> (state, metrics)``, the fused step's call shape,
    over an :class:`OverlapState` (``fn.put`` makes one from a
    :class:`FusedState`). ``steps_per_dispatch`` actor/learner pairs run per
    call.

    ``lag=1``: window k+1 rolls (actor stream) beside learner k (the
    caller's stream). ``lag=0``: each window's block is learned right after
    it rolls, the fused step's schedule. ``rollout_dtype`` is the actor
    snapshot's storage; ``"int8"`` needs ``quant_spec`` (a calibrated
    :class:`~distributed_ba3c_tpu_torch.quantize.spec.QuantSpec`), and the
    learner stays f32 either way.

    ``optimizer`` must be the one over ``model``'s params (the state's)."""
    if lag not in (0, 1):
        raise ValueError(f"lag must be 0 or 1, got {lag}")
    if rollout_dtype not in ROLLOUT_DTYPES:
        raise ValueError(
            f"rollout_dtype must be one of {ROLLOUT_DTYPES}, got {rollout_dtype!r}"
        )
    if rollout_dtype == "int8" and quant_spec is None:
        raise ValueError(
            "rollout_dtype='int8' needs a calibrated quant_spec (load one "
            "with QuantSpec.load, or calibrate via quantize.calibrate)"
        )
    if macro_fleets != 1:
        raise NotImplementedError(
            f"macro_fleets={macro_fleets} (--fleet_accum) is not ported yet: "
            "the macro learner waits for ROADMAP queue A item 8"
        )
    device = next(model.parameters()).device
    # the actor's own net: the learner's Adam never writes what it reads
    if rollout_dtype == "int8":
        from distributed_ba3c_tpu_torch.quantize.qforward import (
            make_quant_apply,
            quantize_params,
        )
        from distributed_ba3c_tpu_torch.utils import logger

        actor_net = make_quant_apply(model, arm="auto", device=device)
        logger.info("overlap actor: int8 forward, arm %s on %s, quant spec %s",
                    actor_net.quant_arm, device, quant_spec.sha256()[:12])
    else:
        actor_net = copy.deepcopy(model).requires_grad_(False)
        if rollout_dtype == "bfloat16":
            actor_net.to(torch.bfloat16)
    actor_params = list(actor_net.parameters())
    learner_params = list(model.parameters())
    rollout_body = make_rollout_body(actor_net, cfg, env, record_log_probs=True)
    block_grads = make_block_grads(model, cfg, grad_chunk_samples)
    finish_update = make_finish_update(optimizer)
    actor_stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def _on_actor():
        return (torch.cuda.stream(actor_stream) if actor_stream is not None
                else contextlib.nullcontext())

    def snapshot():
        """Copy the learner's params into the actor's net; returns the
        copy's event (None on the CPU). On the actor's stream, after the
        caller's pending work (the last update) and behind the previous
        window, so a running window's params are never overwritten."""
        snapped = None
        if actor_stream is not None:
            actor_stream.wait_stream(torch.cuda.current_stream(device))
        with _on_actor(), torch.no_grad():
            if rollout_dtype == "int8":
                # quantize-on-snapshot: the f32 learner params become the
                # actor's int8 table
                actor_net.load_table(quantize_params(model.state_dict(), quant_spec))
            for dst, src in zip(actor_params, learner_params):
                dst.copy_(src)
            if actor_stream is not None:
                snapped = torch.cuda.Event()
                snapped.record(actor_stream)
        return snapped

    def rollout(astate: ActorState) -> Tuple[ActorState, TrajBlock]:
        """One rollout window with the actor's net (on the actor's stream):
        the new carry and the block."""
        with _on_actor(), torch.no_grad():
            carry = (
                astate.env_state, astate.obs_stack, astate.draws,
                astate.ep_return, astate.ep_count, astate.ep_return_sum,
            )
            traj = []
            for _ in range(rollout_len):
                carry, ys = rollout_body(carry)
                traj.append(ys)
            env_state, stack, draws, ep_ret, ep_cnt, ep_sum = carry
            states_t, actions_t, rewards_t, dones_t, lp_t, bv_t = (
                torch.stack(x) for x in zip(*traj)
            )
            block = TrajBlock(
                states=states_t, actions=actions_t, rewards=rewards_t,
                dones=dones_t, behavior_log_probs=lp_t,
                behavior_values=bv_t, bootstrap_state=stack,
            )
            if actor_stream is not None:
                block.ready = torch.cuda.Event()
                block.ready.record(actor_stream)
        new = ActorState(
            env_state=env_state, obs_stack=stack, draws=draws,
            ep_return=ep_ret, ep_count=ep_cnt, ep_return_sum=ep_sum,
        )
        return new, block

    def learn(train: TrainState, block: TrajBlock, snapped, entropy_beta, learning_rate):
        """A learner update on the caller's stream, after the block is
        complete and after the snapshot copy that reads the params its
        Adam writes."""
        if actor_stream is not None:
            stream = torch.cuda.current_stream(device)
            stream.wait_event(block.ready)
            if snapped is not None:
                stream.wait_event(snapped)
            for t in block.tensors():
                t.record_stream(stream)
        grads, aux = block_grads(block, entropy_beta)
        return finish_update(train, grads, aux, block.rewards, learning_rate)

    def pair(train, astate, block, entropy_beta, learning_rate):
        """One lag-1 iteration: the snapshot of update k-1's params, then
        learner k, then rollout k+1. The learner is issued before the
        window's ~T x 250 small launches, so the card runs it while the
        host is still issuing the window; the snapshot taken first keeps
        the window at lag 1."""
        snapped = snapshot()
        train, m = learn(train, block, snapped, entropy_beta, learning_rate)
        astate, next_block = rollout(astate)
        return train, m, astate, next_block

    def episode_metrics(astate: ActorState) -> Dict[str, torch.Tensor]:
        """The cumulative episode counters off the latest carry, read on
        the caller's stream once the actor's last window is done."""
        if actor_stream is not None:
            stream = torch.cuda.current_stream(device)
            stream.wait_stream(actor_stream)
            astate.ep_count.record_stream(stream)
            astate.ep_return_sum.record_stream(stream)
        return {"episodes": torch.sum(astate.ep_count),
                "episode_return_sum": torch.sum(astate.ep_return_sum)}

    def step(state: OverlapState, entropy_beta, learning_rate=None):
        if learning_rate is None:
            learning_rate = cfg.learning_rate
        train, astate, block = state.train, state.actor, state.block
        if lag and block is None:
            # prime the pipeline: learner k always finds block k-1 ready
            snapshot()
            astate, block = rollout(astate)
        ms = []
        for _ in range(steps_per_dispatch):
            if lag:
                train, m, astate, block = pair(
                    train, astate, block, entropy_beta, learning_rate
                )
            else:
                snapped = snapshot()
                astate, block = rollout(astate)
                train, m = learn(train, block, snapped, entropy_beta, learning_rate)
            ms.append(m)
        if len(ms) == 1:
            metrics = dict(ms[0])
        else:
            metrics = {k: torch.stack([m[k] for m in ms]).float().mean() for k in ms[0]}
        metrics.update(episode_metrics(astate))
        assert set(CUMULATIVE_METRICS) <= set(metrics)
        return OverlapState(train=train, actor=astate, block=block if lag else None), metrics

    def put(state: FusedState) -> OverlapState:
        """A :class:`FusedState` (``create_fused_state``'s) split into the
        train state and the actor's carry; on CUDA the carry's tensors are
        re-made on the actor's stream, which owns them from here on."""
        carry = (state.env_state, state.obs_stack, state.ep_return,
                 state.ep_count, state.ep_return_sum)
        if actor_stream is not None:
            actor_stream.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(actor_stream):
                carry = tuple(_map_tensors(torch.clone, x) for x in carry)
        env_state, stack, ep_ret, ep_cnt, ep_sum = carry
        return OverlapState(
            train=state.train,
            actor=ActorState(
                env_state=env_state, obs_stack=stack, draws=state.draws,
                ep_return=ep_ret, ep_count=ep_cnt, ep_return_sum=ep_sum,
            ),
            block=None,
        )

    def reset_episode_stats(state: OverlapState) -> OverlapState:
        """Zero the per-env episode accumulators for the next epoch (the
        running episode return is kept, as the fused loop keeps it)."""
        a = state.actor
        with _on_actor():
            fresh = dataclasses.replace(
                a,
                ep_count=torch.zeros_like(a.ep_count),
                ep_return_sum=torch.zeros_like(a.ep_return_sum),
            )
        return dataclasses.replace(state, actor=fresh)

    def _sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def probe_overlap(state: OverlapState, entropy_beta, learning_rate=None,
                      reps: int = 3):
        """Time the actor window alone, the learner alone, and the pair
        issued as the step issues them; returns (advanced state, numbers)
        and sets the ``learner`` gauges ``actor_program_ms``,
        ``learner_program_ms``, ``overlap_pair_ms`` and
        ``overlap_efficiency`` = (actor + learner - pair) / actor, the
        share of the actor window the learner hides. Host clock around
        work that ends in a device synchronize; it advances the state it
        is given (no experience is replayed). Outside the training loop:
        the synchronizes are the serialization the step avoids."""
        if learning_rate is None:
            learning_rate = cfg.learning_rate
        train, astate, block = state.train, state.actor, state.block
        if block is None:
            snapshot()
            astate, block = rollout(astate)
        t_actor, t_learner, t_pair = [], [], []
        for _ in range(max(1, reps)):
            # the actor alone: the snapshot of the current params and a window
            _sync()
            t0 = time.perf_counter()
            snapshot()
            astate, next_block = rollout(astate)
            _sync()
            t_actor.append(time.perf_counter() - t0)
            # the learner alone, on the block the step would give it
            t0 = time.perf_counter()
            train, _ = learn(train, block, None, entropy_beta, learning_rate)
            _sync()
            t_learner.append(time.perf_counter() - t0)
            block = next_block
            # the pair, issued as the step issues it
            t0 = time.perf_counter()
            train, _, astate, block = pair(
                train, astate, block, entropy_beta, learning_rate
            )
            _sync()
            t_pair.append(time.perf_counter() - t0)
        med = lambda xs: sorted(xs)[len(xs) // 2]  # noqa: E731
        a_ms, l_ms, p_ms = (med(t_actor) * 1e3, med(t_learner) * 1e3, med(t_pair) * 1e3)
        hidden = (a_ms + l_ms - p_ms) / a_ms if a_ms > 0 else 0.0
        coverage = min(1.0, l_ms / a_ms) if a_ms > 0 else None
        from distributed_ba3c_tpu_torch import telemetry

        reg = telemetry.registry("learner")
        reg.gauge("actor_program_ms").set(a_ms)
        reg.gauge("learner_program_ms").set(l_ms)
        reg.gauge("overlap_pair_ms").set(p_ms)
        reg.gauge("overlap_efficiency").set(hidden)
        out = {
            "actor_ms": a_ms,
            "learner_ms": l_ms,
            "pair_ms": p_ms,
            "overlap_efficiency": hidden,
            "learner_window_coverage": coverage,
            "reps": max(1, reps),
        }
        return OverlapState(train=train, actor=astate, block=block), out

    step.put = put
    step.rollout_dtype = rollout_dtype
    step.quant_spec = quant_spec
    step.steps_per_dispatch = steps_per_dispatch
    step.actor_net = actor_net
    step.reset_episode_stats = reset_episode_stats
    step.probe_overlap = probe_overlap
    return step


def _map_tensors(fn, x):
    """``fn`` over the tensor leaves of ``x`` (a tensor or a NamedTuple of
    tensors, the envs' state)."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    return type(x)(*(_map_tensors(fn, v) for v in x))

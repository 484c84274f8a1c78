"""The fused rollout+update step and its training loop, on one device.

Port of ``distributed_ba3c_tpu/fused/loop.py``. One step, as there:

    T rollout steps (a Python loop for the lax.scan), without gradients:
        forward the policy on the frame stacks (the conv-block kernel)
        sample actions: argmax(logits + Gumbel noise)
        env.step: physics + uint8 render for B envs (envs/jaxenv/)
        update frame stacks and episode-return accumulators
    bootstrap value on the final stacks
    n-step returns (reverse loop, done-masked)       ops/returns.py
    a3c loss over the flat [T*B] batch, in grad_chunk_samples chunks;
        the gradient is the mean of the chunk gradients
        (parallel/train_step.py::learner_grads, the sync step's too)
    grad_summaries of the unclipped gradients; global-norm clip, then Adam

It runs on one device with no mesh: the data-axis mean over one shard is
the identity. The JAX step's random key becomes a draw source
(:class:`GeneratorDraws`): every random number of the step comes from it,
so a test can hand the step the draws JAX made from its keys.

``run_fused_training`` is the JAX loop's lifecycle on one device: ``--load``
restores the learner state and the epoch counter continues from its step
(the anneal with it), ``<logdir>/hyper.txt`` overrides the learning rate
and entropy beta each epoch, and every epoch ends in a checkpoint under
``<logdir>/checkpoints`` (keep-best on the greedy eval). ``--overlap``
swaps the step for ``fused/overlap.py``'s actor/learner pair on two CUDA
streams (a checkpoint holds the train state only; a resumed overlap run
re-primes the block in flight); ``--rollout_dtype int8`` (with
``--overlap``) quantizes the actor's forward, its ``QuantSpec`` loaded
from ``--quant_spec`` or calibrated over ``--quant_calibrate`` f32
rollout windows from the run's starting params (the restored ones under
``--load``). It leaves out what the JAX loop adds for multi-host runs
(collective saves, the watchdog, ``BA3C_PARAM_DIGEST``) and
``fleet_accum`` (ROADMAP queue A). The loop has no actor plane,
but ``--telemetry_port`` serves its learner counters and flight ring while
it runs, and each epoch's record also goes to TensorBoard events and to
``<logdir>/channels.jsonl``.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Dict, Optional

import torch

from distributed_ba3c_tpu_torch.config import BA3CConfig
from distributed_ba3c_tpu_torch.models.a3c import BA3CNet
from distributed_ba3c_tpu_torch.ops.gradproc import ClipAdam, grad_summaries
from distributed_ba3c_tpu_torch.ops.returns import n_step_returns
from distributed_ba3c_tpu_torch.parallel.train_step import (
    TrainState,
    create_train_state,
    learner_grads,
)

#: metrics that accumulate in the state across an epoch (reset by the outer
#: loop): a K-step dispatch takes their LAST value, every other metric is
#: the mean over the dispatch window
CUMULATIVE_METRICS = ("episodes", "episode_return_sum")


class GeneratorDraws:
    """The fused trainer's random draws, from one ``torch.Generator``.

    The counterpart of the JAX step's key. A draw source has three
    methods, called in this order by each rollout step: ``action_noise``
    (Gumbel noise for the actions) and ``env_noise`` (the env's step
    draws, ``env.step_noise``); ``reset_noise`` (``env.reset_noise``)
    serves fresh envs. The env's draws are opaque here: a tensor or a
    ``NamedTuple`` of tensors that only the env's ``step``/``reset`` read.
    """

    def __init__(self, env, generator: torch.Generator):
        self.env = env
        self.generator = generator

    def action_noise(self, shape, device) -> torch.Tensor:
        """Gumbel(0, 1) noise, ``-log(-log(u))`` as ``jax.random.gumbel``."""
        u = torch.rand(shape, generator=self.generator, device=device)
        return -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))

    def env_noise(self, n: int, device):
        return self.env.step_noise(n, self.generator, device)

    def reset_noise(self, n: int, device):
        return self.env.reset_noise(n, self.generator, device)


def device_draws(env, seed: int, device) -> GeneratorDraws:
    """A :class:`GeneratorDraws` on ``device`` seeded with ``seed``."""
    return GeneratorDraws(env, torch.Generator(device=device).manual_seed(seed))


@dataclasses.dataclass
class FusedState:
    train: TrainState
    env_state: Any              # batched env state, leaves [B, ...]
    obs_stack: torch.Tensor     # [B, H, W, hist] uint8
    draws: Any                  # the draw source (the JAX state's key)
    ep_return: torch.Tensor     # [B] running episode return
    ep_count: torch.Tensor      # [B] int32 completed episodes per env
    ep_return_sum: torch.Tensor  # [B] float32 sum of completed returns per env


def _param_device(model: BA3CNet) -> torch.device:
    return next(model.parameters()).device


def initial_stack(env, env_state, frame_history: int) -> torch.Tensor:
    obs = env.render(env_state)  # [B, H, W]
    stack = torch.zeros(
        (*obs.shape, frame_history), dtype=torch.uint8, device=obs.device
    )
    stack[..., -1] = obs
    return stack


def create_fused_state(
    seed: int,
    model: BA3CNet,
    cfg: BA3CConfig,
    env,
    n_envs: int,
    optimizer: Optional[ClipAdam] = None,
) -> FusedState:
    """The fused state on the model's device: the train state over the
    model's (seeded) params, ``n_envs`` fresh envs, and a draw source
    seeded ``seed + 1`` (so it is not the params' stream)."""
    dev = _param_device(model)
    draws = device_draws(env, seed + 1, dev)
    env_state = env.reset(draws.reset_noise(n_envs, dev))
    return FusedState(
        train=create_train_state(model, cfg, optimizer),
        env_state=env_state,
        obs_stack=initial_stack(env, env_state, cfg.frame_history),
        draws=draws,
        ep_return=torch.zeros(n_envs, dtype=torch.float32, device=dev),
        ep_count=torch.zeros(n_envs, dtype=torch.int32, device=dev),
        ep_return_sum=torch.zeros(n_envs, dtype=torch.float32, device=dev),
    )


def push_frame(stack, obs, done):
    """Drop the oldest frame and append ``obs``; a done env's history is
    zeroed so it does not leak into the new episode."""
    keep = (~done).to(stack.dtype)[:, None, None, None]
    return torch.cat([stack[..., 1:] * keep, obs[..., None]], dim=-1)


def make_rollout_body(
    model: BA3CNet, cfg: BA3CConfig, env, record_log_probs: bool = False
) -> Callable:
    """One rollout step: ``body(carry) -> (carry, (stack, actions,
    r_learn, donef))`` with ``carry = (env_state, stack, draws, ep_ret,
    ep_cnt, ep_sum)``. Call it without gradients.

    The ONE body of the fused step and the overlap actor
    (``fused/overlap.py``): both consume the draws in the same order, which
    is what makes a lag-0 overlap run with frozen params bit-exact with
    the fused step. With ``record_log_probs`` the trajectory tuple also
    carries the sampled action's ``log_softmax`` (the V-trace behaviour
    term) and the value; without it the body is unchanged."""

    def rollout_body(carry):
        env_state, stack, draws, ep_ret, ep_cnt, ep_sum = carry
        B = stack.shape[0]
        out = model(stack)
        g = draws.action_noise(out.logits.shape, stack.device)
        actions = torch.argmax(out.logits + g, dim=-1).to(torch.int32)
        env_state, obs, reward, done = env.step(
            env_state, actions, draws.env_noise(B, stack.device)
        )
        new_stack = push_frame(stack, obs, done)
        # episode bookkeeping (done => env auto-restarted inside step);
        # scores accumulate RAW rewards, the learner sees clipped ones
        ep_ret = ep_ret + reward
        donef = done.to(torch.float32)
        ep_sum = ep_sum + ep_ret * donef
        ep_cnt = ep_cnt + done.to(torch.int32)
        ep_ret = ep_ret * (1.0 - donef)
        r_learn = (
            torch.clamp(reward, -cfg.reward_clip, cfg.reward_clip)
            if cfg.reward_clip
            else reward
        )
        carry = (env_state, new_stack, draws, ep_ret, ep_cnt, ep_sum)
        ys = (stack, actions, r_learn, donef)
        if record_log_probs:
            lp = torch.gather(
                torch.log_softmax(out.logits, dim=-1), -1,
                actions.long()[:, None],
            )[:, 0]
            ys = ys + (lp, out.value)
        return carry, ys

    return rollout_body


def make_fused_step(
    model: BA3CNet,
    optimizer: ClipAdam,
    cfg: BA3CConfig,
    env,
    rollout_len: int = 20,
    grad_chunk_samples: int = 4096,
    steps_per_dispatch: int = 1,
) -> Callable:
    """Build ``fn(state, entropy_beta, learning_rate=None) -> (state,
    metrics)``; the metrics are 0-dim tensors on the device.

    ``optimizer`` must be the one over ``model``'s params (the state's
    train.optimizer). ``steps_per_dispatch`` > 1 runs that many updates
    per call, as the JAX step's ``lax.scan`` does.
    """
    rollout_body = make_rollout_body(model, cfg, env)

    def local_step(state: FusedState, entropy_beta, learning_rate):
        carry = (
            state.env_state, state.obs_stack, state.draws,
            state.ep_return, state.ep_count, state.ep_return_sum,
        )
        traj = []
        with torch.no_grad():
            for _ in range(rollout_len):
                carry, ys = rollout_body(carry)
                traj.append(ys)
            env_state, stack, draws, ep_ret, ep_cnt, ep_sum = carry
            states_t, actions_t, rewards_t, dones_t = (
                torch.stack(x) for x in zip(*traj)
            )  # [T, B, ...]
            # bootstrap from the post-rollout stack (no gradient)
            bootstrap = model(stack).value
            returns_t = n_step_returns(rewards_t, dones_t, bootstrap, cfg.gamma)

        T, B = actions_t.shape
        flat = lambda x: x.reshape(T * B, *x.shape[2:])  # noqa: E731
        grads, aux = learner_grads(
            model, cfg, flat(states_t), flat(actions_t), flat(returns_t),
            entropy_beta, grad_chunk_samples,
        )
        summaries = grad_summaries(grads)
        optimizer.set_learning_rate(learning_rate)
        optimizer.step(grads)

        new_state = dataclasses.replace(
            state,
            train=dataclasses.replace(state.train, step=state.train.step + 1),
            env_state=env_state,
            obs_stack=stack,
            draws=draws,
            ep_return=ep_ret,
            ep_count=ep_cnt,
            ep_return_sum=ep_sum,
        )
        metrics = {
            "loss": aux.total,
            "policy_loss": aux.policy_loss,
            "value_loss": aux.value_loss,
            "entropy": aux.entropy,
            "pred_value": aux.pred_value,
            **summaries,
            "reward_per_step": torch.mean(rewards_t),
            "episodes": torch.sum(ep_cnt),
            "episode_return_sum": torch.sum(ep_sum),
        }
        return new_state, metrics

    def step(state: FusedState, entropy_beta, learning_rate=None):
        if learning_rate is None:
            learning_rate = cfg.learning_rate
        window = []
        for _ in range(steps_per_dispatch):
            state, m = local_step(state, entropy_beta, learning_rate)
            window.append(m)
        if steps_per_dispatch == 1:
            return state, window[0]
        # cumulative-in-state metrics: the LAST step's value is "so far";
        # loss-like metrics average over the dispatch window
        return state, {
            k: (
                window[-1][k] if k in CUMULATIVE_METRICS
                else torch.stack([m[k] for m in window]).float().mean()
            )
            for k in window[0]
        }

    def reset_episode_stats(state: FusedState) -> FusedState:
        """Zero the per-env episode accumulators for the next epoch."""
        return dataclasses.replace(
            state,
            ep_count=torch.zeros_like(state.ep_count),
            ep_return_sum=torch.zeros_like(state.ep_return_sum),
        )

    step.steps_per_dispatch = steps_per_dispatch
    step.reset_episode_stats = reset_episode_stats
    return step


def make_greedy_eval(
    model: BA3CNet,
    cfg: BA3CConfig,
    env,
    n_envs: int,
    max_steps: int = 3000,
) -> Callable:
    """Build ``fn(seed) -> (mean_return, max_return, n_episodes)``: greedy
    (argmax) episodes of ``n_envs`` fresh envs in lockstep for
    ``max_steps`` steps on the model's device. Each env contributes its
    FIRST completed episode, so long episodes do not lose weight to short
    ones; an env with none contributes nothing."""

    def evaluate(seed: int):
        dev = _param_device(model)
        draws = device_draws(env, seed, dev)
        env_state = env.reset(draws.reset_noise(n_envs, dev))
        stack = initial_stack(env, env_state, cfg.frame_history)
        ep_ret = torch.zeros(n_envs, dtype=torch.float32, device=dev)
        done_ret = torch.zeros_like(ep_ret)
        done_mask = torch.zeros(n_envs, dtype=torch.bool, device=dev)
        with torch.no_grad():
            for _ in range(max_steps):
                actions = torch.argmax(model(stack).logits, dim=-1)
                env_state, obs, reward, done = env.step(
                    env_state, actions.to(torch.int32),
                    draws.env_noise(n_envs, dev),
                )
                ep_ret = ep_ret + reward
                first_done = done & ~done_mask
                done_ret = torch.where(first_done, ep_ret, done_ret)
                done_mask = done_mask | done
                ep_ret = ep_ret * (1.0 - done.to(torch.float32))
                stack = push_frame(stack, obs, done)
        n = int(done_mask.sum())
        s = float(torch.where(done_mask, done_ret, 0.0).sum())
        mx = float(torch.where(done_mask, done_ret, float("-inf")).max())
        return s / max(n, 1), mx, n

    return evaluate


def run_fused_training(args, cfg: BA3CConfig) -> int:
    """``--task train --trainer tpu_fused_ba3c`` (``--env jax:<name>``)."""
    from distributed_ba3c_tpu_torch.envs import jaxenv
    from distributed_ba3c_tpu_torch.train.callbacks import anneal_interp
    from distributed_ba3c_tpu_torch.train.checkpoint import (
        CheckpointManager,
        restore_train_state,
    )
    from distributed_ba3c_tpu_torch.utils import logger
    from distributed_ba3c_tpu_torch.utils.stats import StatHolder

    if not args.env.startswith("jax:"):
        raise SystemExit("--trainer=tpu_fused_ba3c requires --env jax:<name>")
    env = jaxenv.get_env(args.env.split(":", 1)[1])
    cfg = cfg.replace(num_actions=env.num_actions, image_size=env.obs_shape)
    if args.steps_per_epoch % args.steps_per_dispatch:
        raise SystemExit(
            f"--steps_per_dispatch {args.steps_per_dispatch} must divide "
            f"--steps_per_epoch {args.steps_per_epoch}"
        )
    model = BA3CNet(
        num_actions=cfg.num_actions,
        fc_units=cfg.fc_units,
        image_size=cfg.image_size,
        in_channels=cfg.state_shape[2],
        conv_backend=args.conv_backend,
        device=args.device,
        generator=torch.Generator().manual_seed(args.seed),
    )
    rollout_len = args.rollout_len
    n_envs = max(1, cfg.batch_size // rollout_len)
    # only the learner state is restored: the envs start fresh from --seed
    state = create_fused_state(args.seed, model, cfg, env, n_envs)
    if args.load:
        mgr = CheckpointManager(args.load)
        state.train = restore_train_state(state.train, mgr)
        logger.info("resumed train state at step %d", state.train.step)
    quant_spec = None
    if getattr(args, "rollout_dtype", "float32") == "int8":
        # the calibration source (cli.py checked exactly one): a frozen
        # spec file, or N f32 rollout windows through the actor's own
        # rollout body, from the params this run starts with
        from distributed_ba3c_tpu_torch.quantize.calibrate import calibrate_from_env
        from distributed_ba3c_tpu_torch.quantize.spec import QuantSpec

        if args.quant_spec:
            quant_spec = QuantSpec.load(args.quant_spec)
        else:
            dev = _param_device(model)
            with torch.no_grad():
                quant_spec = calibrate_from_env(
                    model, cfg, env, model.state_dict(),
                    device_draws(env, args.seed, dev), n_envs=n_envs,
                    batches=args.quant_calibrate, rollout_len=rollout_len,
                )
        logger.info(
            "int8 rollout forward: quant spec %s (%d calibration batches)",
            quant_spec.sha256()[:12], quant_spec.calibration_batches,
        )
    if args.overlap:
        # the actor and the learner on two streams: rollout k+1 beside
        # learner k, the one-update lag corrected by V-trace
        from distributed_ba3c_tpu_torch.fused.overlap import make_overlap_step

        step = make_overlap_step(
            model, state.train.optimizer, cfg, env, rollout_len,
            grad_chunk_samples=args.grad_chunk_samples,
            steps_per_dispatch=args.steps_per_dispatch,
            rollout_dtype=args.rollout_dtype,
            quant_spec=quant_spec,
        )
        state = step.put(state)
    else:
        step = make_fused_step(
            model, state.train.optimizer, cfg, env, rollout_len,
            grad_chunk_samples=args.grad_chunk_samples,
            steps_per_dispatch=args.steps_per_dispatch,
        )
    run_shape = {
        "steps_per_epoch": args.steps_per_epoch,
        "batch_size": cfg.batch_size,
        "rollout_len": rollout_len,
        "max_epoch": args.max_epoch,
    }
    shape_mismatch = False
    if args.load:
        # the resumed epoch is step // steps_per_epoch: another shape
        # stretches or shifts the anneal
        prev = mgr.read_run_meta()
        for k, v in run_shape.items():
            if k in prev and prev[k] != v:
                shape_mismatch = True
                logger.warn(
                    "resume shape mismatch: %s was %s at save time, now %s — "
                    "the LR/beta anneal will NOT continue where it left off",
                    k, prev[k], v,
                )
    evaluate = make_greedy_eval(
        model, cfg, env, max(args.nr_eval, 1), max_steps=args.eval_max_steps
    )
    holder = StatHolder(args.logdir)
    ckpt = CheckpointManager(
        os.path.join(args.logdir, "checkpoints"), max_to_keep=args.max_to_keep
    )
    if not shape_mismatch:
        # after a mismatch the saved shape stays on record, so the warning
        # fires again on every later resume
        ckpt.write_run_meta(**run_shape)
    logger.set_logger_dir(args.logdir)
    samples_per_iter = n_envs * rollout_len
    logger.info(
        "fused training%s: %d envs x %d rollout = %d samples/iter on %s",
        " (overlap, lag 1)" if args.overlap else "", n_envs, rollout_len,
        samples_per_iter, _param_device(model),
    )

    # runtime-scheduled hyperparams: anneal over epochs when *_final is set
    def sched(v0, v1, epoch, mode=None):
        if v1 is None or args.max_epoch <= 1:
            return v0
        f = (epoch - 1) / (args.max_epoch - 1)
        return anneal_interp(v0, v1, f, mode or args.anneal)

    from distributed_ba3c_tpu_torch import telemetry
    from distributed_ba3c_tpu_torch.train.experiment import ChannelWriter

    tele_server = None
    if getattr(args, "telemetry_port", 0):
        tele_server = telemetry.TelemetryServer(args.telemetry_port)
        tele_server.start()
    channels = ChannelWriter(os.path.join(args.logdir, "channels.jsonl"))
    try:
        _fused_epoch_loop(
            args, cfg, step, state, holder, ckpt, samples_per_iter, sched,
            evaluate, channels,
        )
    finally:
        if tele_server is not None:
            tele_server.stop()
            tele_server.join(timeout=2)
            tele_server.close()
        channels.close()
        holder.close()
    return 0


def _fused_epoch_loop(
    args, cfg, step, state, holder, ckpt, samples_per_iter, sched, evaluate,
    channels,
) -> None:
    import numpy as np

    from distributed_ba3c_tpu_torch import telemetry
    from distributed_ba3c_tpu_torch.train.callbacks import read_hyper_file
    from distributed_ba3c_tpu_torch.train.checkpoint import train_state_payload
    from distributed_ba3c_tpu_torch.train.experiment import CHANNELS
    from distributed_ba3c_tpu_torch.utils import logger

    # a resume continues the schedule: the epoch counter derives from the
    # restored step, so --max_epoch is the run's total across resumes
    epoch0 = state.train.step // max(args.steps_per_epoch, 1)
    if epoch0 > 0:
        logger.info(
            "resume: continuing at epoch %d/%d (restored step %d)",
            epoch0 + 1, args.max_epoch, state.train.step,
        )
    if epoch0 >= args.max_epoch:
        logger.warn(
            "loaded step %d already covers --max_epoch %d x %d steps: "
            "nothing to train (raise --max_epoch to extend the run)",
            state.train.step, args.max_epoch, args.steps_per_epoch,
        )
    hyper_path = os.path.join(args.logdir, "hyper.txt")

    def live_hyper(lr, beta):
        """The scheduled values, overridden by <logdir>/hyper.txt."""
        overrides = read_hyper_file(hyper_path)
        return (overrides.get("learning_rate", lr),
                overrides.get("entropy_beta", beta))

    tele = telemetry.registry("learner")
    c_steps = tele.counter("train_steps_total")
    c_samples = tele.counter("train_samples_total")
    c_episodes = tele.counter("episodes_total")
    h_epoch = tele.histogram("epoch_s", unit=1e-3)
    best = -np.inf
    for epoch in range(epoch0 + 1, args.max_epoch + 1):
        beta = sched(cfg.entropy_beta, args.entropy_beta_final, epoch, args.anneal_beta)
        lr = sched(cfg.learning_rate, args.learning_rate_final, epoch, args.anneal_lr)
        lr, beta = live_hyper(lr, beta)
        t0 = time.monotonic()
        metrics: Dict[str, torch.Tensor] = {}
        for _ in range(args.steps_per_epoch // step.steps_per_dispatch):
            state, metrics = step(state, beta, lr)
        # one device->host fetch per epoch
        metrics = {k: float(v) for k, v in metrics.items()}
        dt = time.monotonic() - t0
        fps = args.steps_per_epoch * samples_per_iter / dt
        c_steps.inc(args.steps_per_epoch)
        c_samples.inc(args.steps_per_epoch * samples_per_iter)
        c_episodes.inc(int(metrics["episodes"]))
        h_epoch.observe(dt)
        mean_ret = (
            metrics["episode_return_sum"] / metrics["episodes"]
            if metrics["episodes"] > 0
            else float("nan")
        )
        state = step.reset_episode_stats(state)
        # greedy eval: the number the north-star (Pong >= 18) is defined on
        eval_mean = float("nan")
        if epoch % max(args.eval_every, 1) == 0:
            eval_mean, eval_max, eval_n = evaluate(1000 + epoch)
            if eval_n > 0:
                holder.add_stat("eval_mean_score", eval_mean)
                holder.add_stat("eval_max_score", eval_max)
            else:
                # no episode finished inside the eval horizon: report nothing
                eval_mean = float("nan")
        holder.add_stat("epoch", epoch)
        holder.add_stat("global_step", state.train.step)
        holder.add_stat("fps", fps)
        if np.isfinite(mean_ret):
            holder.add_stat("mean_score", mean_ret)
        if metrics["episodes"] > 0:
            holder.add_stat(
                "ep_len_approx",
                args.steps_per_epoch * samples_per_iter / metrics["episodes"],
            )
        for k in ("loss", "policy_loss", "value_loss", "entropy", "grad_norm"):
            holder.add_stat(k, metrics[k])
        for k in ("mean_rho", "value_lag_mae"):
            # --overlap: how hard V-trace clips, and how far the value
            # function moved across the lag
            if k in metrics:
                holder.add_stat(k, metrics[k])
        if telemetry.enabled():
            holder.add_stats({
                f"tele/learner/{k}": v for k, v in tele.scalars().items()
            })
        rec = holder.finalize()
        for ch in CHANNELS:
            if ch in rec:
                channels.send(ch, rec["global_step"], rec[ch])
        logger.info(
            "epoch %d | env-steps/s %.0f | mean_score %.2f (%d eps) | eval %.2f | loss %.4f entropy %.3f",
            epoch, fps, mean_ret, int(metrics["episodes"]), eval_mean,
            metrics["loss"], metrics["entropy"],
        )
        # the epoch's checkpoint; keep-best on the greedy eval
        ckpt.save(train_state_payload(state.train), state.train.step)
        telemetry.record("checkpoint", step=state.train.step)
        if np.isfinite(eval_mean) and eval_mean > best:
            best = eval_mean
            ckpt.mark_best(state.train.step, eval_mean)

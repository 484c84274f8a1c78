"""Command line of the port: train, eval and play of a BA3C policy.

Port of the JAX package's ``cli.py``: ``--task train`` with ``--trainer
tpu_sync_ba3c`` (the default: the ZMQ actor plane and the synchronous
learner, ``_run_sync``), ``tpu_vtrace_ba3c`` (the same plane feeding
V-trace rollout segments to the V-trace learner, also ``_run_sync``) or
``tpu_fused_ba3c`` (the fused on-device rollout+update; with ``--overlap``
the actor and the learner on two CUDA streams, lag 1 corrected by
V-trace), ``--task eval`` (``_run_eval``) and ``--task play``
(``_run_play``)::

    python -m distributed_ba3c_tpu_torch --env cpp:pong
    python -m distributed_ba3c_tpu_torch --trainer tpu_vtrace_ba3c --env cpp:pong
    python -m distributed_ba3c_tpu_torch --task train --trainer tpu_fused_ba3c --env jax:pong
    python -m distributed_ba3c_tpu_torch --trainer tpu_fused_ba3c --overlap --env jax:pong
    python -m distributed_ba3c_tpu_torch --task play --env cpp:pong
    python -m distributed_ba3c_tpu_torch --task eval --env fake --nr_eval 8

Everything runs on ``--device`` (``cuda`` by default; a missing card
raises). eval and play serve the policy through :class:`BatchedPredictor`
(``predict_batch``, greedy), with the params of the latest checkpoint in
``--load <logdir>/checkpoints``, or of a seeded init (``--seed``) without
it. ``--task train --load`` resumes a run from its checkpoints.

The sync and V-trace trainers run one local fleet (``fake`` or ``jax:``
simulators, or ``cpp:`` env servers) started with the trainer, as
Tensorpack did; a ``jax:<game>`` simulator steps one env of the on-device
game on CPU tensors (``envs/jaxenv/host_adapter.py``), and so do eval and
play. The fused trainer runs the same games batched on the card. The JAX
CLI's fleet supervision and autoscaling, ``--fleets``, ``--fleet_accum``,
remote fleets (``--env zmq:``), ``gym:`` players and the serving plane's
replicas (``--serve_replicas``, ``--serve_replicas_max``,
``--canary_autopromote``) are not ported yet (ROADMAP queue A)::

    python -m distributed_ba3c_tpu_torch --trainer tpu_fused_ba3c --env jax:coinrun
        --batch_size 20480 --rollout_len 20 --gamma 0.999 --eval_max_steps 2000
    python -m distributed_ba3c_tpu_torch --env jax:breakout --simulator_procs 16
    python -m distributed_ba3c_tpu_torch --task eval --env jax:coinrun --load <logdir>/checkpoints

The rollout precision ladder: ``--rollout_dtype float32|bfloat16|int8``
is the serving table's precision on the ZMQ trainers and the actor's on
``--overlap`` (the learner stays f32). int8 takes exactly one calibration
source: ``--quant_spec spec.json`` (a frozen ``QuantSpec``), or
``--quant_calibrate N``, which on the ZMQ trainers serves f32 while the
shadow mirror calibrates on the first N served batches and then switches
the plane to int8 in place, and on ``--overlap`` calibrates on N f32
rollout windows before training. The ZMQ trainers' single serving plane
takes ``--serve_slo_ms`` (deadline admission and shedding),
``--canary_load <ckpt dir> --canary_fraction F`` (a second policy on a
fraction F of the traffic) and ``--shadow_load <ckpt dir>`` (a policy
mirroring every served batch, its results dropped). eval and play always
serve float32, as the JAX CLI's do::

    python -m distributed_ba3c_tpu_torch --env cpp:pong --rollout_dtype int8 --quant_calibrate 8
    python -m distributed_ba3c_tpu_torch --trainer tpu_fused_ba3c --overlap --env jax:pong \
        --rollout_dtype int8 --quant_spec spec.json
    python -m distributed_ba3c_tpu_torch --env cpp:pong --serve_slo_ms 200 \
        --canary_load runs/b/checkpoints --canary_fraction 0.25 --shadow_load runs/c/checkpoints

Every trainer takes the telemetry plane's flags: ``--telemetry_port``
serves ``/metrics``, ``/json``, ``/flight`` and ``/trace`` while the run
lasts, and ``--trace_sample N`` traces 1 in N block steps of the ZMQ
trainers from the env step to the learner step. A run keeps
``flight-<pid>.json`` (on SIGTERM, an actor prune or a client drop),
TensorBoard events and ``channels.jsonl`` in its ``--logdir``::

    python -m distributed_ba3c_tpu_torch --env cpp:pong --simulator_procs 64 \
        --trace_sample 8 --telemetry_port 9100 --logdir runs/t
"""

from __future__ import annotations

import argparse
import functools
from typing import Optional

from distributed_ba3c_tpu_torch.config import BA3CConfig

#: the JAX CLI's trainers, every one ported
TRAINERS = ("tpu_sync_ba3c", "tpu_vtrace_ba3c", "tpu_fused_ba3c")


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m distributed_ba3c_tpu_torch",
        description="Train, eval and play a BA3C policy on an H100 (PyTorch/CUDA)",
    )
    p.add_argument("--task", default="train", choices=["train", "eval", "play"])
    p.add_argument(
        "--trainer", default="tpu_sync_ba3c", choices=TRAINERS,
        help="learner backend for --task train: tpu_sync_ba3c (the ZMQ "
        "actor plane and the synchronous learner), tpu_vtrace_ba3c (the "
        "same plane, V-trace off-policy learner over rollout segments) or "
        "tpu_fused_ba3c (the fused on-device rollout+update)",
    )
    p.add_argument(
        "--env", default="fake",
        help="fake (the chain MDP), cpp:<game> (the native core, e.g. "
        "cpp:pong; build it with `make -C cpp`) or jax:<game> (an on-device "
        "game: pong, breakout, seaquest, qbert, coinrun, space_invaders, "
        "boxing, assault; batched on the card by the fused trainer, one env "
        "on the CPU a simulator or eval/play player)",
    )
    p.add_argument(
        "--nr_eval", type=int, default=None,
        help="episodes to run (eval/play, default 8); greedy-eval episodes "
        "(train, 0 = no eval)",
    )
    p.add_argument(
        "--max_steps", type=int, default=None,
        help="step cap per episode (default: the config's "
        "episode_length_cap for play, 100000 for eval)",
    )
    p.add_argument(
        "--predict_batch_size", type=int, default=None,
        help="serving bucket (default: nr_eval for eval, 1 for play, the "
        "config's 16 for the sync trainer)",
    )
    # -- the sync trainer's actor plane (the JAX CLI's names and defaults) ---
    p.add_argument("--simulator_procs", type=int, default=None,
                   help="envs of the local fleet (config default 50)")
    p.add_argument("--local_time_max", type=int, default=None, help="n-step truncation")
    p.add_argument("--predictor_threads", type=int, default=None,
                   help="accepted as the JAX CLI accepts it; no effect (the "
                        "predictor's continuous-batching scheduler is one thread)")
    p.add_argument("--frame_history", type=int, default=None)
    p.add_argument(
        "--wire", default="auto", choices=["auto", "block-shm", "block", "per-env"],
        help="cpp: env servers' wire: block-shm (obs through a /dev/shm "
        "ring), block (one zero-copy multipart message per server step), "
        "per-env (B msgpack messages per step); auto = block-shm where "
        "/dev/shm is writable, else block. fake simulators speak per-env",
    )
    p.add_argument(
        "--wire_crc", action="store_true",
        help="CRC32 framing on every wire codec (exported as BA3C_WIRE_CRC=1 "
        "to the spawned env servers)",
    )
    p.add_argument("--pipe_c2s", default=None, help="master experience-plane bind address (default: per-pid ipc://)")
    p.add_argument("--pipe_s2c", default=None, help="master action-plane bind address (default: per-pid ipc://)")
    p.add_argument("--actor_timeout", type=float, default=120.0, help="seconds of actor silence before its state is dropped (0=off)")
    p.add_argument("--publish_every", type=int, default=1, help="params -> predictor every N learner steps")
    p.add_argument(
        "--telemetry_port", type=int, default=0,
        help="serve the telemetry scrape endpoint on this port (0=off): "
        "/metrics Prometheus text, /json raw snapshots, /flight the live "
        "flight-recorder ring, /trace the span buffer",
    )
    p.add_argument(
        "--trace_sample", type=int, default=0,
        help="trace 1 in N block steps through the trace plane (0=off): "
        "causal spans env_step -> learner_step, folded into "
        "hop_<name>_s histograms and scraped at /trace (render with "
        "scripts/trace_dump.py)",
    )
    p.add_argument(
        "--profiler_port", type=int, default=0,
        help="the JAX CLI's jax.profiler server; the port has none and "
        "exits (capture with utils/profiling.py::capture_trace)",
    )
    p.add_argument(
        "--ingest_staging", default="on", choices=["on", "off"],
        help="on: collate into pinned staging slots and issue the next "
        "batch's H2D behind the running step (data/staging.py); off: "
        "collate fresh arrays and copy them at the head of the step",
    )
    p.add_argument(
        "--rollout_dtype", default="float32", choices=["float32", "bfloat16", "int8"],
        help="rollout/serving forward precision (the learner keeps f32): the "
        "serving table on the ZMQ trainers, the actor's snapshot with "
        "--overlap; int8 quantizes weights per channel and needs one "
        "calibration source, --quant_spec or --quant_calibrate (the heads "
        "stay f32)",
    )
    p.add_argument(
        "--quant_spec", default=None,
        help="int8: a frozen QuantSpec JSON of per-layer activation scales. "
        "Exactly one of --quant_spec / --quant_calibrate with --rollout_dtype int8",
    )
    p.add_argument(
        "--quant_calibrate", type=int, default=0,
        help="int8: calibrate the activation scales on the first N served "
        "batches (ZMQ trainers: f32 until the spec freezes, then int8 in "
        "place) or on N f32 rollout windows (--overlap). 0 = off",
    )
    # -- the serving plane (one replica) -------------------------------------
    p.add_argument(
        "--serve_slo_ms", type=float, default=0.0,
        help="predictor deadline budget in ms (0 = off): tasks that cannot "
        "make it are shed with a typed reject (the masters answer a "
        "uniform-random action) and a full admission queue rejects fast",
    )
    p.add_argument(
        "--canary_load", default=None,
        help="checkpoint dir served as the 'canary' policy on "
        "--canary_fraction of the predict traffic (policy_canary_rows_total)",
    )
    p.add_argument(
        "--canary_fraction", type=float, default=0.0,
        help="fraction of predict traffic routed to --canary_load "
        "(deterministic group-granular split, no RNG)",
    )
    p.add_argument(
        "--shadow_load", default=None,
        help="checkpoint dir served as the 'shadow' policy: it mirrors every "
        "served batch and its results reach no caller (shadow_* series)",
    )
    p.add_argument(
        "--conv_backend", default=None, choices=["cuda", "torch"],
        help="conv blocks: the hand-written kernel (cuda, the default on a "
        "CUDA device) or their plain PyTorch version (torch)",
    )
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--seed", type=int, default=0, help="param init seed")
    p.add_argument("--load", default=None, help="checkpoint dir to resume from")
    p.add_argument(
        "--num_actions", type=int, default=4,
        help="action space of --env fake (cpp: games set their own)",
    )
    p.add_argument("--image_size", type=int, default=None, help="square observation size")
    p.add_argument("--fc_units", type=int, default=None)
    # -- training (the JAX CLI's names and defaults) -------------------------
    p.add_argument("--logdir", default="train_log/ba3c")
    for name in ("learning_rate", "entropy_beta", "gamma", "grad_clip_norm",
                 "adam_epsilon", "reward_clip"):
        p.add_argument(f"--{name}", type=float, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--steps_per_epoch", type=int, default=1000)
    p.add_argument("--max_epoch", type=int, default=100)
    p.add_argument("--eval_every", type=int, default=1, help="epochs between greedy evals")
    p.add_argument("--max_to_keep", type=int, default=3, help="checkpoints retained (besides best)")
    p.add_argument(
        "--eval_max_steps", type=int, default=10000,
        help="greedy-eval step horizon (must cover a full episode)",
    )
    p.add_argument("--rollout_len", type=int, default=20, help="rollout length per update")
    p.add_argument(
        "--grad_chunk_samples", type=int, default=4096,
        help="learner chunk size (caps the activations of one fwd+bwd)",
    )
    p.add_argument(
        "--steps_per_dispatch", type=int, default=1,
        help="updates per step call (must divide --steps_per_epoch); with "
        "--overlap, actor/learner pairs per call",
    )
    p.add_argument(
        "--overlap", action="store_true",
        help="fused trainer: split the fused step into an actor and a "
        "learner on two CUDA streams -- rollout k+1 runs beside learner k "
        "(policy lag 1, V-trace-corrected)",
    )
    p.add_argument("--entropy_beta_final", type=float, default=None, help="anneal entropy beta to this over max_epoch")
    p.add_argument("--learning_rate_final", type=float, default=None, help="anneal LR to this over max_epoch")
    p.add_argument("--anneal", default="linear", choices=["linear", "exp"], help="shape of the *_final anneals")
    p.add_argument("--anneal_lr", default=None, choices=["linear", "exp"], help="override --anneal for learning_rate only")
    p.add_argument("--anneal_beta", default=None, choices=["linear", "exp"], help="override --anneal for entropy_beta only")
    return p


def env_num_actions(args) -> int:
    """The action-space size of the selected env."""
    if args.env.startswith("jax:"):
        from distributed_ba3c_tpu_torch.envs import jaxenv

        return jaxenv.get_env(args.env.split(":", 1)[1]).num_actions
    if args.env.startswith("cpp:"):
        from distributed_ba3c_tpu_torch.envs import native

        if not native.available():
            raise SystemExit(
                f"--env {args.env}: native core not built — run `make -C cpp`"
            )
        return native.CppBatchedEnv(args.env.split(":", 1)[1], 1).num_actions
    return args.num_actions


def build_config(args) -> BA3CConfig:
    over = {"num_actions": env_num_actions(args)}
    for f in (
        "learning_rate entropy_beta gamma batch_size fc_units grad_clip_norm "
        "adam_epsilon reward_clip local_time_max simulator_procs "
        "predict_batch_size predictor_threads frame_history"
    ).split():
        v = getattr(args, f)
        if v is not None:
            over[f] = v
    if args.image_size is not None:
        over["image_size"] = (args.image_size, args.image_size)
    return BA3CConfig().replace(**over)


def _build_player_factory(args, cfg: BA3CConfig):
    if args.env == "fake" or args.env.startswith("fake:"):
        from distributed_ba3c_tpu_torch.envs.fake import build_fake_player

        return functools.partial(
            build_fake_player,
            image_size=cfg.image_size,
            frame_history=cfg.frame_history,
            num_actions=cfg.num_actions,
        )
    if args.env.startswith("jax:"):
        from distributed_ba3c_tpu_torch.envs.jaxenv.host_adapter import (
            build_jax_player,
        )

        return functools.partial(
            build_jax_player,
            name=args.env.split(":", 1)[1],
            frame_history=cfg.frame_history,
        )
    if args.env.startswith("cpp:"):
        from distributed_ba3c_tpu_torch.envs import native

        return functools.partial(
            native.build_cpp_player,
            name=args.env.split(":", 1)[1],
            frame_history=cfg.frame_history,
        )
    raise SystemExit(f"unknown --env {args.env!r} (fake, jax:<game> or cpp:<game>)")


def _sync_fleet(args, cfg: BA3CConfig, c2s: str, s2c: str, master) -> list:
    """The local fleet's processes (not started): ``cpp:`` env servers of
    up to 16 envs each, or one python simulator per env."""
    if args.env.startswith("cpp:"):
        from distributed_ba3c_tpu_torch.envs import native
        from distributed_ba3c_tpu_torch.utils import shm

        game = args.env.split(":", 1)[1]
        wire = args.wire
        if wire == "auto":
            wire = "block-shm" if shm.available() else "block"
        total = cfg.simulator_procs
        per = min(16, total)
        if wire != "per-env" and per > cfg.predict_batch_size:
            # fail at startup, not inside the master's receive loop: a
            # block is served in one predictor call
            raise SystemExit(
                f"--predict_batch_size {cfg.predict_batch_size} is smaller "
                f"than the env-server block size {per}: the block wire "
                "serves a whole block in one predictor call — raise "
                f"--predict_batch_size to >= {per} or use --wire per-env"
            )

        def ring_cap(b: int):
            # sized from this run's buffering by the formula the master's
            # attach-time check uses (a V-trace segment pins its whole
            # unroll), with 25% headroom
            if wire != "block-shm":
                return None
            need = master.min_ring_cap(b, cfg.frame_history)
            return max(
                native.CppEnvServerProcess.SHM_RING_MIN_CAP,
                native.CppEnvServerProcess.SHM_RING_STEPS // max(1, b),
                int(need * 1.25) + 1,
            )

        procs = []
        for i in range((total + per - 1) // per):
            n = min(per, total - i * per)
            procs.append(native.CppEnvServerProcess(
                i, c2s, s2c, game=game, n_envs=n,
                frame_history=cfg.frame_history, wire=wire,
                shm_ring_cap=ring_cap(n),
            ))
        return procs
    from distributed_ba3c_tpu_torch.actors.simulator import SimulatorProcess
    from distributed_ba3c_tpu_torch.envs.wrappers import guarded_player

    # train-mode episode guards around the simulators (the reference's
    # get_player(train=True)); eval stays unguarded
    sim_build_player = functools.partial(
        guarded_player,
        base_build=_build_player_factory(args, cfg),
        episode_length_cap=cfg.episode_length_cap,
        stuck_limit=30,
        stuck_action=1,
    )
    return [
        SimulatorProcess(i, c2s, s2c, sim_build_player)
        for i in range(cfg.simulator_procs)
    ]


def _run_sync(args, cfg: BA3CConfig) -> int:
    """``--task train --trainer tpu_sync_ba3c``: the local fleet -> ZMQ ->
    :class:`BA3CSimulatorMaster` (n-step returns) -> the train queue ->
    :class:`TrainFeed` (staged collate) -> :class:`DeviceIngest` -> the
    sync learner step, with the params published to the
    :class:`BatchedPredictor` that serves the fleet.

    ``--trainer tpu_vtrace_ba3c`` swaps three parts of that path: the
    :class:`VTraceSimulatorMaster` (``local_time_max``-step segments with
    the served log-probs), the :class:`RolloutFeed` of ``n_seg =
    batch_size // local_time_max`` segments, and the V-trace step."""
    import os
    import queue

    import torch

    from distributed_ba3c_tpu_torch.actors.master import BA3CSimulatorMaster
    from distributed_ba3c_tpu_torch.actors.simulator import default_pipes
    from distributed_ba3c_tpu_torch.actors.vtrace_master import VTraceSimulatorMaster
    from distributed_ba3c_tpu_torch.data.dataflow import RolloutFeed, TrainFeed
    from distributed_ba3c_tpu_torch.models.a3c import BA3CNet
    from distributed_ba3c_tpu_torch.parallel.train_step import (
        create_train_state,
        make_train_step,
    )
    from distributed_ba3c_tpu_torch.parallel.vtrace_step import make_vtrace_train_step
    from distributed_ba3c_tpu_torch.predict.server import BatchedPredictor
    from distributed_ba3c_tpu_torch.train.callbacks import (
        Evaluator,
        HumanHyperParamSetter,
        MaxSaver,
        ModelSaver,
        PeriodicTrigger,
        ScheduledHyperParamSetter,
        StartProcOrThread,
        StatPrinter,
    )
    from distributed_ba3c_tpu_torch.train.trainer import Trainer, TrainLoopConfig
    from distributed_ba3c_tpu_torch.utils import logger
    from distributed_ba3c_tpu_torch.utils.device import resolve_device

    if args.env.startswith(("gym:", "zmq:")):
        raise SystemExit(
            f"--trainer {args.trainer} --env {args.env}: not ported yet (the "
            "port's ZMQ trainers run fake, jax:<game> or cpp:<game>; gym: "
            "and zmq: players are ROADMAP queue A item 3b)"
        )
    vtrace = args.trainer == "tpu_vtrace_ba3c"
    device = resolve_device(args.device)
    if args.wire_crc:
        # here AND in the env var: spawned env servers read it at import
        from distributed_ba3c_tpu_torch.utils.serialize import set_wire_crc

        set_wire_crc(True)
        os.environ["BA3C_WIRE_CRC"] = "1"

    def build_net():
        return BA3CNet(
            num_actions=cfg.num_actions,
            fc_units=cfg.fc_units,
            image_size=cfg.image_size,
            in_channels=cfg.state_shape[2],
            conv_backend=args.conv_backend,
            device=device,
            generator=torch.Generator().manual_seed(args.seed),
        )

    model = build_net()
    state = create_train_state(model, cfg)
    if vtrace:
        step = make_vtrace_train_step(model, state.optimizer, cfg)
        # segments a learner batch: ~batch_size transitions
        per_step_items = max(1, cfg.batch_size // cfg.local_time_max)
        samples_per_step = per_step_items * cfg.local_time_max
    else:
        step = make_train_step(model, state.optimizer, cfg)
        per_step_items = samples_per_step = cfg.batch_size
    if args.pipe_c2s and args.pipe_s2c:
        c2s, s2c = args.pipe_c2s, args.pipe_s2c
    elif args.pipe_c2s or args.pipe_s2c:
        raise SystemExit("--pipe_c2s and --pipe_s2c must be given together")
    else:
        c2s, s2c = default_pipes()
    score_q: queue.Queue = queue.Queue(maxsize=4096)
    # canary and shadow policies from their checkpoints, and the int8
    # rung's frozen spec, loaded once
    extras = []
    for name, root, fraction in (("canary", args.canary_load, args.canary_fraction),
                                 ("shadow", args.shadow_load, None)):
        if root:
            from distributed_ba3c_tpu_torch.train.checkpoint import restore_params

            net = build_net()
            step_k = restore_params(net, root)
            logger.info("%s policy: step %d of %s", name, step_k, root)
            extras.append((name, net.state_dict(), fraction))
    quant_spec = None
    if args.quant_spec:
        from distributed_ba3c_tpu_torch.quantize.spec import QuantSpec

        quant_spec = QuantSpec.load(args.quant_spec)
    # the serving forward swaps the served params into its own module
    predictor = BatchedPredictor(
        build_net(), model.state_dict(), batch_size=cfg.predict_batch_size,
        slo_ms=args.serve_slo_ms, rollout_dtype=args.rollout_dtype,
        quant_spec=quant_spec, quant_calibrate=args.quant_calibrate,
        device=device,
    )
    # the learner's publishes touch only 'default'; the canary and the
    # shadow are pinned policies behind the same scheduler
    for name, params_k, fraction in extras:
        predictor.add_policy(name, params_k)
        if name == "canary":
            predictor.set_canary("canary", fraction)
        else:
            predictor.set_shadow("shadow")
    # every serving bucket once now, not under the fleet's first requests
    predictor.warmup(cfg.state_shape)
    if vtrace:
        master = VTraceSimulatorMaster(
            c2s, s2c, predictor, unroll_len=cfg.local_time_max,
            score_queue=score_q, actor_timeout=args.actor_timeout or None,
            reward_clip=cfg.reward_clip,
        )
    else:
        master = BA3CSimulatorMaster(
            c2s, s2c, predictor, gamma=cfg.gamma,
            local_time_max=cfg.local_time_max, score_queue=score_q,
            actor_timeout=args.actor_timeout or None,
            reward_clip=cfg.reward_clip,
        )
    # ring-safety input: the feed's collate holder pins ring views too
    master.feed_batch = per_step_items
    try:
        procs = _sync_fleet(args, cfg, c2s, s2c, master)
    except BaseException:
        master.close()
        raise
    staging = None
    if args.ingest_staging == "on":
        from distributed_ba3c_tpu_torch.data.staging import (
            DeviceIngest,
            HostStagingRing,
        )

        staging = HostStagingRing(pin_memory=device.type == "cuda")
    feed_cls = RolloutFeed if vtrace else TrainFeed
    feed = feed_cls(master.queue, per_step_items, staging=staging)
    if staging is not None:
        feed = DeviceIngest(feed, device)
    logger.info(
        "%s on %s: %d %s over %s, %d %s a step, local_time_max %d",
        args.trainer, device, len(procs),
        type(procs[0]).__name__ if procs else "processes", c2s,
        per_step_items, "segments" if vtrace else "datapoints",
        cfg.local_time_max,
    )

    run_eval = args.nr_eval > 0
    # the scrape endpoint starts and stops with the plane (it follows
    # StartProcOrThread's start/stop/join/close protocol)
    tele_servers = []
    if args.telemetry_port:
        from distributed_ba3c_tpu_torch.telemetry import TelemetryServer

        tele_servers.append(TelemetryServer(args.telemetry_port))
    callbacks = [
        StartProcOrThread(tele_servers + procs + [predictor, master, feed]),
        HumanHyperParamSetter("learning_rate", shared_dir=args.logdir),
        HumanHyperParamSetter("entropy_beta", shared_dir=args.logdir),
        StatPrinter(),
        ModelSaver(
            ckpt_dir=os.path.join(args.logdir, "checkpoints"),
            max_to_keep=args.max_to_keep,
        ),
        MaxSaver(monitor="eval_mean_score" if run_eval else "mean_score"),
    ]
    if run_eval:
        # before StatPrinter, so the eval stats land in this epoch's record
        # (MaxSaver reads it)
        callbacks.insert(3, PeriodicTrigger(
            Evaluator(args.nr_eval, _build_player_factory(args, cfg)),
            every_k_epochs=args.eval_every,
        ))
    if args.learning_rate_final is not None:
        callbacks.append(ScheduledHyperParamSetter(
            "learning_rate",
            [(1, cfg.learning_rate), (args.max_epoch, args.learning_rate_final)],
            interp=args.anneal_lr or args.anneal,
        ))
    if args.entropy_beta_final is not None:
        callbacks.append(ScheduledHyperParamSetter(
            "entropy_beta",
            [(1, cfg.entropy_beta), (args.max_epoch, args.entropy_beta_final)],
            interp=args.anneal_beta or args.anneal,
        ))
    from distributed_ba3c_tpu_torch.train.experiment import ExperimentLogger

    # after StatPrinter: it reads the epoch's finalized record
    callbacks.append(ExperimentLogger())
    trainer = Trainer(
        TrainLoopConfig(
            steps_per_epoch=args.steps_per_epoch,
            max_epoch=args.max_epoch,
            log_dir=args.logdir,
            publish_every=args.publish_every,
        ),
        cfg, step, state, feed, callbacks,
        predictor=predictor, score_queue=score_q,
        samples_per_step=samples_per_step,
    )
    if args.load:
        trainer.restore(args.load)
    trainer.train()
    return 0


def _run_eval(args, cfg, model, params) -> int:
    from distributed_ba3c_tpu_torch.predict.server import BatchedPredictor
    from distributed_ba3c_tpu_torch.train.eval import eval_model
    from distributed_ba3c_tpu_torch.utils import logger

    # eval scores the float32 policy whatever --rollout_dtype says, as the
    # JAX CLI's does
    predictor = BatchedPredictor(
        model, params,
        batch_size=args.predict_batch_size or max(args.nr_eval, 1),
        greedy=True, device=args.device,
    )
    build_player = _build_player_factory(args, cfg)

    def predict(states):
        actions, _, _ = predictor.predict_batch(states)
        return actions

    mean, mx = eval_model(
        predict, build_player, args.nr_eval, max_steps=args.max_steps or 100000
    )
    logger.info("eval over %d episodes: mean=%.2f max=%.2f", args.nr_eval, mean, mx)
    print(f"mean_score={mean:.3f} max_score={mx:.3f}")
    return 0


def _run_play(args, cfg, model, params) -> int:
    """Replay mode: run ``--nr_eval`` greedy episodes one at a time, printing
    per-step action/reward (the step trace IS the visualization)."""
    import numpy as np

    from distributed_ba3c_tpu_torch.predict.server import BatchedPredictor

    # float32, whatever --rollout_dtype says (as eval)
    predictor = BatchedPredictor(
        model, params, batch_size=args.predict_batch_size or 1, greedy=True,
        device=args.device,
    )
    build_player = _build_player_factory(args, cfg)
    cap = args.max_steps or cfg.episode_length_cap

    for ep in range(max(args.nr_eval, 1)):
        player = build_player(ep)
        score, t = 0.0, 0
        while True:
            s = np.asarray(player.current_state())[None]
            actions, values, _ = predictor.predict_batch(s)
            a = int(actions[0])
            r, is_over = player.action(a)
            score += r
            if r != 0 or t % 50 == 0:
                print(
                    f"episode {ep} step {t:5d} | action {a} | reward {r:+.1f} "
                    f"| score {score:+.1f} | V(s) {float(values[0]):+.3f}"
                )
            t += 1
            if is_over or t >= cap:
                break
        print(f"episode {ep} finished: score {score:+.1f} in {t} steps")
    return 0


def _arm_telemetry(args) -> None:
    """Flight dumps into the logdir and sampling armed, in this process and,
    through the environment, in the children it spawns; a training run
    also dumps the flight ring on SIGTERM."""
    import os

    from distributed_ba3c_tpu_torch import telemetry

    telemetry.configure(args.logdir)
    if args.logdir:
        # spawned env servers and simulators read this at import
        os.environ["BA3C_FLIGHT_DIR"] = args.logdir
    if args.trace_sample > 0:
        # here AND in the environment: the children read BA3C_TRACE at
        # import (telemetry/tracing.py)
        telemetry.tracing.set_sampling(args.trace_sample)
        os.environ["BA3C_TRACE"] = str(args.trace_sample)
    if args.task == "train":
        telemetry.install_signal_dump()


def check_flags(parser: argparse.ArgumentParser, args) -> None:
    """The JAX CLI's rules for the int8 and serving flags (its
    ``orchestrate/topology.py``, ``ModeTopology``, ``ServingTopology`` and
    ``TopologySpec``), under its messages, as usage errors (exit 2)."""
    if args.quant_calibrate < 0:
        parser.error(
            f"mode.quant_calibrate must be >= 0, got {args.quant_calibrate}"
        )
    if args.rollout_dtype == "int8":
        if bool(args.quant_spec) == bool(args.quant_calibrate):
            parser.error(
                "rollout_dtype int8 needs exactly ONE calibration "
                "source: a frozen quant_spec file OR quant_calibrate N "
                "live batches (docs/ingest.md)"
            )
    elif args.quant_spec or args.quant_calibrate:
        parser.error(
            "quant_spec/quant_calibrate calibrate the int8 rung — "
            f"they do not apply to rollout_dtype {args.rollout_dtype!r}"
        )
    if (args.serve_slo_ms or args.canary_load or args.shadow_load
            or args.canary_fraction > 0):
        if bool(args.canary_load) != bool(args.canary_fraction > 0):
            parser.error(
                "serving.canary_load and serving.canary_fraction come "
                "together: the checkpoint names WHAT to canary, the "
                "fraction names HOW MUCH traffic it gets"
            )
        if not 0 <= args.canary_fraction <= 1:
            parser.error(
                "serving.canary_fraction must be a traffic fraction in "
                f"[0, 1], got {args.canary_fraction}"
            )
    if (args.rollout_dtype == "int8" and args.trainer == "tpu_fused_ba3c"
            and not args.overlap):
        parser.error(
            "rollout_dtype int8 on the fused trainer quantizes the "
            "ACTOR program's params snapshot — it requires overlap "
            "(the monolithic fused program has no separate actor "
            "forward to quantize)"
        )


def main(argv: Optional[list] = None) -> int:
    import torch

    from distributed_ba3c_tpu_torch.models.a3c import BA3CNet

    parser = make_parser()
    args = parser.parse_args(argv)
    if args.nr_eval is None:
        args.nr_eval = 8
    check_flags(parser, args)
    if args.profiler_port:
        raise SystemExit(
            "--profiler_port: the port has no profiler server (the JAX CLI's "
            "is jax.profiler's); capture a run's CPU and CUDA activity with "
            "distributed_ba3c_tpu_torch.utils.profiling.capture_trace"
        )
    if args.overlap and not (
        args.task == "train" and args.trainer == "tpu_fused_ba3c"
    ):
        parser.error("--overlap needs --task train --trainer tpu_fused_ba3c")
    _arm_telemetry(args)
    if args.task == "train":
        if args.trainer != "tpu_fused_ba3c":
            return _run_sync(args, build_config(args))
        from distributed_ba3c_tpu_torch.fused.loop import run_fused_training

        return run_fused_training(args, build_config(args))
    cfg = build_config(args)
    model = BA3CNet(
        num_actions=cfg.num_actions,
        fc_units=cfg.fc_units,
        image_size=cfg.image_size,
        in_channels=cfg.state_shape[2],
        conv_backend=args.conv_backend,
        device=args.device,
        generator=torch.Generator().manual_seed(args.seed),
    )
    if args.load:
        from distributed_ba3c_tpu_torch.train.checkpoint import restore_params
        from distributed_ba3c_tpu_torch.utils import logger

        step = restore_params(model, args.load)
        logger.info("loaded params of step %d from %s", step, args.load)
    params = model.state_dict()
    if args.task == "eval":
        return _run_eval(args, cfg, model, params)
    return _run_play(args, cfg, model, params)

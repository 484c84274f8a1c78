"""Command line of the port: train, eval and play of a BA3C policy.

Port of the JAX package's ``cli.py``: ``--task train`` with ``--trainer
tpu_fused_ba3c`` (``_run_fused``), ``--task eval`` (``_run_eval``) and
``--task play`` (``_run_play``)::

    python -m distributed_ba3c_tpu_torch --task train --trainer tpu_fused_ba3c --env jax:pong
    python -m distributed_ba3c_tpu_torch --task play --env cpp:pong
    python -m distributed_ba3c_tpu_torch --task eval --env fake --nr_eval 8

Everything runs on ``--device`` (``cuda`` by default; a missing card
raises). eval and play serve the policy through :class:`BatchedPredictor`
(``predict_batch``, greedy), with the params of the latest checkpoint in
``--load <logdir>/checkpoints``, or of a seeded init (``--seed``) without
it. ``--task train --load`` resumes a fused run from its checkpoints.
"""

from __future__ import annotations

import argparse
import functools
from typing import Optional

from distributed_ba3c_tpu_torch.config import BA3CConfig

#: the JAX CLI's trainers, and what each waits for in the port
TRAINERS = {
    "tpu_fused_ba3c": None,
    "tpu_sync_ba3c": "ROADMAP queue A item 3 (the sync trainer and the ZMQ actor plane)",
    "tpu_vtrace_ba3c": "ROADMAP queue A item 4 (the V-trace trainer, after item 3's actor plane)",
}


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m distributed_ba3c_tpu_torch",
        description="Greedy eval/play of a BA3C policy on an H100 (PyTorch/CUDA)",
    )
    p.add_argument("--task", default="eval", choices=["train", "eval", "play"])
    p.add_argument(
        "--trainer", default="tpu_sync_ba3c", choices=sorted(TRAINERS),
        help="learner backend for --task train; only tpu_fused_ba3c (the "
        "fused on-device rollout+update) is ported",
    )
    p.add_argument(
        "--env", default="fake",
        help="fake (the chain MDP), cpp:<game> (the native core, e.g. "
        "cpp:pong; build it with `make -C cpp`) or jax:pong (the on-device "
        "env of the fused trainer)",
    )
    p.add_argument(
        "--nr_eval", type=int, default=8,
        help="episodes to run (eval/play); greedy-eval envs (train)",
    )
    p.add_argument(
        "--max_steps", type=int, default=None,
        help="step cap per episode (default: the config's "
        "episode_length_cap for play, 100000 for eval)",
    )
    p.add_argument(
        "--predict_batch_size", type=int, default=None,
        help="serving bucket (default: nr_eval for eval, 1 for play)",
    )
    p.add_argument(
        "--rollout_dtype", default="float32", choices=["float32", "bfloat16"],
        help="param storage of the serving table (the heads stay f32)",
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
        help="updates per step call (must divide --steps_per_epoch)",
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
        "adam_epsilon reward_clip"
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
    if args.env.startswith("cpp:"):
        from distributed_ba3c_tpu_torch.envs import native

        return functools.partial(
            native.build_cpp_player,
            name=args.env.split(":", 1)[1],
            frame_history=cfg.frame_history,
        )
    raise SystemExit(f"unknown --env {args.env!r} (fake or cpp:<game>)")


def _run_eval(args, cfg, model, params) -> int:
    from distributed_ba3c_tpu_torch.predict.server import BatchedPredictor
    from distributed_ba3c_tpu_torch.train.eval import eval_model
    from distributed_ba3c_tpu_torch.utils import logger

    predictor = BatchedPredictor(
        model, params,
        batch_size=args.predict_batch_size or max(args.nr_eval, 1),
        greedy=True, rollout_dtype=args.rollout_dtype, device=args.device,
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

    predictor = BatchedPredictor(
        model, params, batch_size=args.predict_batch_size or 1, greedy=True,
        rollout_dtype=args.rollout_dtype, device=args.device,
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


def main(argv: Optional[list] = None) -> int:
    import torch

    from distributed_ba3c_tpu_torch.models.a3c import BA3CNet

    parser = make_parser()
    args = parser.parse_args(argv)
    if args.task == "train":
        waits_for = TRAINERS[args.trainer]
        if waits_for is not None:
            parser.error(
                f"--trainer {args.trainer} is not ported yet: it waits for "
                f"{waits_for}; --trainer tpu_fused_ba3c is"
            )
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

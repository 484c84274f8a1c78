"""Checkpoint evaluation on the device.

Port of ``distributed_ba3c_tpu/train/eval_tools.py`` on one device: one
construction path for the (CheckpointManager, model, greedy evaluator)
that a script evaluating a run's checkpoints needs.
"""

from __future__ import annotations

from distributed_ba3c_tpu_torch.config import BA3CConfig
from distributed_ba3c_tpu_torch.envs import jaxenv
from distributed_ba3c_tpu_torch.fused.loop import make_greedy_eval
from distributed_ba3c_tpu_torch.models.a3c import BA3CNet
from distributed_ba3c_tpu_torch.train.checkpoint import (
    CheckpointManager,
    load_params,
)


def make_checkpoint_evaluator(
    env_spec: str,
    load: str,
    nr_eval: int,
    max_steps: int,
    fc_units: int = 512,
    device="cuda",
):
    """Returns ``(mgr, model, evaluate, n_eval)``.

    ``evaluate(params, seed)`` loads ``params`` (a checkpoint payload's
    ``params``) into ``model`` and runs the greedy eval of
    :func:`make_greedy_eval` over ``n_eval = max(nr_eval, 1)`` envs of
    ``env_spec`` (``jax:<name>``): ``(mean_return, max_return,
    n_episodes)``.
    """
    env = jaxenv.get_env(env_spec.split(":", 1)[1])
    cfg = BA3CConfig(num_actions=env.num_actions, fc_units=fc_units)
    model = BA3CNet(num_actions=cfg.num_actions, fc_units=cfg.fc_units,
                    device=device)
    mgr = CheckpointManager(load)
    n_eval = max(nr_eval, 1)
    greedy = make_greedy_eval(model, cfg, env, n_eval, max_steps=max_steps)

    def evaluate(params, seed: int):
        load_params(model, params)
        return greedy(seed)

    return mgr, model, evaluate, n_eval

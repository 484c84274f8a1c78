"""Environments batched on the device, in PyTorch.

The counterpart of ``distributed_ba3c_tpu/envs/jaxenv/`` (the name is
kept so a reader finds it; nothing here imports JAX). A game is a module
with the protocol, batched over a leading ``[B]`` dimension::

    env.reset(reset_draws) -> state
    env.step(state, action [B], step_draws) -> (state, obs uint8
        [B, H, W], reward float32 [B], done bool [B])
    env.step_noise(n, generator, device) -> step_draws
    env.reset_noise(n, generator, device) -> reset_draws
    env.render(state) -> obs uint8 [B, H, W]
    env.num_actions, env.obs_shape, env.FRAME_SKIP

Every random draw is an input: ``step_noise``/``reset_noise`` return a
tensor or a ``NamedTuple`` of tensors with leading dimension ``n``, drawn
from a ``torch.Generator`` on ``device``, and a test can hand ``step`` and
``reset`` the draws JAX made from its keys instead. A Bernoulli draw is
taken as its uniform (compared with p in the game), a ``randint`` draw as
an int32. Episodes auto-restart on done, from the step's own draws.

========== =========================== ======================================
game       a step's draws              a reset's draws
========== =========================== ======================================
pong       ``[n, 5, 2]`` serve (angle, ``[n, 2]`` one serve
           jitter) per substep + reset
breakout   ``[n, 4]`` launch angle     none (``[n, 0]``)
           per substep
seaquest   the reset's (``Spawn``)     ``Spawn``: fish_x, direction
                                       uniform, ``[n, 4]`` each
qbert      ``[n]`` the ball's hop      none
           uniform
coinrun    a whole ``Level``           ``Level``: goal randint, diff,
                                       steps randint ``[n, 64]``, gap
                                       and spike uniforms ``[n, 64]``
space_inv. ``Bombs``: column randint,  none
           drop uniform ``[n, 4]``
boxing     ``Jabs``: jitter            none
           ``[n, 4, 2]``, punch
           uniform ``[n, 4]``
assault    ``Raid``: spawn uniform,    none
           lane randint, bomb
           uniform ``[n, 4]`` each
========== =========================== ======================================

The game modules import torch; this package imports each on first use,
so the host adapter (``host_adapter.py``) stays torch-free at import.
"""

import importlib

#: every on-device game of the JAX package
GAMES = (
    "pong", "breakout", "seaquest", "qbert", "coinrun", "space_invaders",
    "boxing", "assault",
)


def get_env(name: str):
    if name not in GAMES:
        raise ValueError(f"unknown jax env {name!r}; have {sorted(GAMES)}")
    return importlib.import_module(f"{__name__}.{name}")

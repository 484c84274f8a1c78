"""Environments batched on the device, in PyTorch.

The counterpart of ``distributed_ba3c_tpu/envs/jaxenv/`` (the name is
kept so a reader finds it; nothing here imports JAX). An env is a module
with the protocol, batched over a leading ``[B]`` dimension::

    env.reset(noise [B, 2]) -> state
    env.step(state, action [B], noise [B, k, 2]) -> (state, obs uint8
        [B, H, W], reward float32 [B], done bool [B])
    env.sample_noise(n, k, generator, device) -> noise [n, k, 2]
    env.num_actions, env.obs_shape, env.FRAME_SKIP

Every random draw is an input (``noise``), so a test can replay another
implementation's draws. Episodes auto-restart on done.
"""

from distributed_ba3c_tpu_torch.envs.jaxenv import pong

#: the JAX package's other on-device games, not ported yet
_NOT_PORTED = (
    "breakout", "seaquest", "qbert", "coinrun", "space_invaders", "boxing",
    "assault",
)


def get_env(name: str):
    if name == "pong":
        return pong
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"jax:{name} is not ported yet (ROADMAP queue A item 9, the "
            "remaining games); jax:pong is"
        )
    raise ValueError(
        f"unknown jax env {name!r}; have {sorted(('pong',) + _NOT_PORTED)}"
    )

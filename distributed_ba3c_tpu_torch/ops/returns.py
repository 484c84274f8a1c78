"""n-step discounted returns over a time-major rollout.

Port of ``distributed_ba3c_tpu/ops/returns.py`` (``discounted_returns``,
``n_step_returns``): the reverse ``lax.scan`` becomes a reverse loop over
T on ``[T, B]`` tensors, with the same per-step arithmetic
``r_t + d_t * R_{t+1}``.
"""

from __future__ import annotations

import torch


def discounted_returns(
    rewards: torch.Tensor, bootstrap: torch.Tensor, discounts: torch.Tensor
) -> torch.Tensor:
    """R_t = r_t + discount_t * R_{t+1},  R_T = bootstrap.

    Args:
      rewards:   [T, ...] rewards (time-major).
      bootstrap: [...] value estimate of the state after the last transition.
      discounts: [T, ...] per-step discount (gamma * (1 - done)).
    """
    out = torch.empty_like(rewards)
    acc = bootstrap
    for t in range(rewards.shape[0] - 1, -1, -1):
        acc = rewards[t] + discounts[t] * acc
        out[t] = acc
    return out


def n_step_returns(
    rewards: torch.Tensor,
    dones: torch.Tensor,
    bootstrap_value: torch.Tensor,
    gamma: float,
) -> torch.Tensor:
    """n-step returns over a [T, B] rollout, the discount zeroed at
    terminal steps so credit does not leak across episode boundaries."""
    discounts = gamma * (1.0 - dones.to(rewards.dtype))
    return discounted_returns(rewards, bootstrap_value, discounts)

"""V-trace off-policy correction (IMPALA, Espeholt et al. 2018).

Port of ``distributed_ba3c_tpu/ops/vtrace.py``: the reverse ``lax.scan``
becomes a reverse loop over T on time-major ``[T, B]`` tensors, with JAX's
order of operations (the importance weights, their clips, the discounts,
then the scan), so equal float32 inputs give outputs a few ulps apart.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class VTraceOut(NamedTuple):
    vs: torch.Tensor             # [T, B] V-trace value targets
    pg_advantages: torch.Tensor  # [T, B] policy-gradient advantages
    clipped_rhos: torch.Tensor   # [T, B] clipped importance weights


def vtrace_returns(
    behaviour_log_probs: torch.Tensor,
    target_log_probs: torch.Tensor,
    rewards: torch.Tensor,
    dones: torch.Tensor,
    values: torch.Tensor,
    bootstrap_value: torch.Tensor,
    gamma: float,
    rho_clip: float = 1.0,
    c_clip: float = 1.0,
) -> VTraceOut:
    """V-trace targets and advantages.

    Args:
      behaviour_log_probs: [T, B] log mu(a_t|s_t) of the actor policy.
      target_log_probs:    [T, B] log pi(a_t|s_t) of the learner policy.
      rewards:             [T, B].
      dones:               [T, B] episode-termination flags (after step t).
      values:              [T, B] learner V(s_t).
      bootstrap_value:     [B]    learner V(s_T).
      gamma:               discount.
      rho_clip, c_clip:    importance-weight clips (rho_bar >= c_bar).

    Returns ``vs_t`` and ``rho_t * (r_t + gamma * vs_{t+1} - V(s_t))``.
    No input takes a gradient through this function: the caller passes
    detached values and target log-probs, as JAX's ``stop_gradient``.
    """
    rhos = torch.exp(target_log_probs - behaviour_log_probs)
    clipped_rhos = torch.clamp_max(rhos, rho_clip)
    cs = torch.clamp_max(rhos, c_clip)
    discounts = gamma * (1.0 - dones.to(values.dtype))

    values_tp1 = torch.cat([values[1:], bootstrap_value[None]], dim=0)
    deltas = clipped_rhos * (rewards + discounts * values_tp1 - values)

    vs_minus_v = torch.empty_like(deltas)
    acc = torch.zeros_like(bootstrap_value)
    for t in range(deltas.shape[0] - 1, -1, -1):
        acc = deltas[t] + discounts[t] * cs[t] * acc
        vs_minus_v[t] = acc
    vs = vs_minus_v + values

    vs_tp1 = torch.cat([vs[1:], bootstrap_value[None]], dim=0)
    pg_advantages = clipped_rhos * (rewards + discounts * vs_tp1 - values)
    return VTraceOut(vs=vs, pg_advantages=pg_advantages, clipped_rhos=clipped_rhos)

"""The BA3C loss: policy gradient + value regression + entropy bonus.

Port of ``distributed_ba3c_tpu/ops/loss.py``, in float32:

    L = -log pi(a|s) * stop_grad(R - V)  +  c * L2(V, R)  -  beta * H(pi)

All statistics are batch means.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch


class A3CLossOut(NamedTuple):
    total: torch.Tensor        # scalar loss to differentiate
    policy_loss: torch.Tensor  # scalar, for logging
    value_loss: torch.Tensor   # scalar
    entropy: torch.Tensor      # scalar mean policy entropy (positive)
    advantage: torch.Tensor    # scalar mean advantage
    pred_value: torch.Tensor   # scalar mean predicted value


def a3c_loss(
    logits: torch.Tensor,
    values: torch.Tensor,
    actions: torch.Tensor,
    returns: torch.Tensor,
    entropy_beta: Union[float, torch.Tensor] = 0.01,
    value_loss_coef: Union[float, torch.Tensor] = 0.5,
    huber_delta: Optional[float] = None,
) -> A3CLossOut:
    """The A3C objective over a flat batch.

    Args:
      logits:  [B, A] unnormalised policy logits.
      values:  [B] state-value predictions V(s).
      actions: [B] integer actions taken by the behaviour policy.
      returns: [B] n-step discounted returns R.
      entropy_beta: entropy bonus coefficient (scheduled at run time).
      value_loss_coef: weight on the value L2 term.
      huber_delta: if set, the value loss is Huber(delta) instead of L2.
    """
    logits = logits.float()
    values = values.float()
    returns = returns.float()

    log_probs = torch.log_softmax(logits, dim=-1)
    probs = torch.softmax(logits, dim=-1)
    action_log_probs = torch.gather(
        log_probs, -1, actions.long()[:, None]
    )[:, 0]

    advantage = returns - values.detach()
    policy_loss = -torch.mean(action_log_probs * advantage)

    if huber_delta is not None:
        from distributed_ba3c_tpu_torch.ops.symbolic import huber_loss

        value_loss = torch.mean(huber_loss(values - returns, huber_delta))
    else:
        value_loss = 0.5 * torch.mean(torch.square(values - returns))

    entropy = -torch.mean(torch.sum(probs * log_probs, dim=-1))

    total = policy_loss + value_loss_coef * value_loss - entropy_beta * entropy
    return A3CLossOut(
        total=total,
        policy_loss=policy_loss,
        value_loss=value_loss,
        entropy=entropy,
        advantage=torch.mean(advantage),
        pred_value=torch.mean(values),
    )

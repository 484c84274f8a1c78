"""The V-trace (IMPALA-style) train step over rollout batches.

Port of ``distributed_ba3c_tpu/parallel/vtrace_step.py:47-167``
(``_make_vtrace_loss_fn``, ``make_vtrace_train_step``) on one device: the
data-axis mean over one shard is the identity, and the tail is the sync
step's ``apply_grads``. Batch layout (time-major, the reverse scan's):

    state:              [T, B, H, W, C] uint8
    action:             [T, B] int32
    reward:             [T, B] float32
    done:               [T, B] float32
    behavior_log_probs: [T, B] float32  (log mu(a|s) recorded by the actor)
    bootstrap_state:    [B, H, W, C] uint8 (s_T for the value bootstrap)

The model runs ONE forward over the ``T*B + B`` states (150 at the CLI's
defaults), so the conv blocks see one batch. The multi-fleet macro step
(``make_vtrace_macro_step``, ``--fleets``) is not ported yet (ROADMAP
queue A item 8).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from distributed_ba3c_tpu_torch.config import BA3CConfig
from distributed_ba3c_tpu_torch.models.a3c import BA3CNet
from distributed_ba3c_tpu_torch.ops.gradproc import ClipAdam, grad_summaries
from distributed_ba3c_tpu_torch.ops.vtrace import vtrace_returns
from distributed_ba3c_tpu_torch.parallel.train_step import TrainState, apply_grads


def _make_vtrace_loss_fn(
    model: BA3CNet,
    cfg: BA3CConfig,
    batch: Dict[str, torch.Tensor],
    entropy_beta,
) -> Callable[[], Tuple[torch.Tensor, Dict[str, torch.Tensor]]]:
    """The per-batch V-trace loss closure over the model's current params:
    ``loss_fn() -> (total, aux)``. The value loss is ``0.5 * square``
    always, as JAX's (the overlap learner's takes ``value_huber_delta``)."""
    T, B = batch["action"].shape

    def loss_fn():
        flat = batch["state"].reshape(T * B, *batch["state"].shape[2:])
        all_states = torch.cat([flat, batch["bootstrap_state"]], dim=0)
        out = model(all_states)
        logits = out.logits[: T * B].reshape(T, B, -1)
        values = out.value[: T * B].reshape(T, B)
        bootstrap_value = out.value[T * B:]

        log_probs = torch.log_softmax(logits, dim=-1)
        probs = torch.softmax(logits, dim=-1)
        target_lp = torch.gather(log_probs, -1, batch["action"].long()[..., None])[..., 0]

        vt = vtrace_returns(
            behaviour_log_probs=batch["behavior_log_probs"],
            target_log_probs=target_lp.detach(),
            rewards=batch["reward"],
            dones=batch["done"],
            values=values.detach(),
            bootstrap_value=bootstrap_value.detach(),
            gamma=cfg.gamma,
        )

        policy_loss = -torch.mean(target_lp * vt.pg_advantages)
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
        }
        return total, aux

    return loss_fn


def make_vtrace_train_step(
    model: BA3CNet,
    optimizer: ClipAdam,
    cfg: BA3CConfig,
) -> Callable[..., Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """Build ``step(state, batch, entropy_beta, learning_rate=None) ->
    (state, metrics)``, the sync step's call shape: the V-trace loss's
    gradients over ``batch`` (device tensors, the layout above), their
    summaries, the global-norm clip and Adam. The metrics are 0-dim device
    tensors under JAX's names: ``loss``, ``policy_loss``, ``value_loss``,
    ``entropy``, ``mean_rho``, ``pred_value``, ``grad_norm`` and
    ``grad_max_abs``.

    ``optimizer`` must be the one over ``model``'s params (the state's)."""
    params = list(model.parameters())

    def step(state: TrainState, batch, entropy_beta, learning_rate=None):
        if learning_rate is None:
            learning_rate = cfg.learning_rate
        total, aux = _make_vtrace_loss_fn(model, cfg, batch, entropy_beta)()
        grads = list(torch.autograd.grad(total, params))
        metrics = {
            **{k: v.detach() for k, v in aux.items()},
            **grad_summaries(grads),
        }
        new_state = apply_grads(optimizer, state, grads, learning_rate)
        return new_state, metrics

    return step

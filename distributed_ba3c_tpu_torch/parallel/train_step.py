"""The learner's state, its objective and the synchronous train step.

Port of ``distributed_ba3c_tpu/parallel/train_step.py:74-197``
(``TrainState``, ``create_train_state``, ``_make_loss_fn``,
``apply_grads``, ``make_train_step``) on one device. There is no mesh: the
data-axis mean of the gradients over one shard is the identity. The params
live in the model (``BA3CNet``), the optimizer state in the optimizer;
Adam updates the model's own tensors in place (where JAX makes new
buffers), so whoever reads them on another stream (the predictor's
publish) orders itself against the step.

:func:`learner_grads` is the ONE definition of the learner's objective and
its gradients: the sync step runs it on a batch, the fused step
(``fused/loop.py``) on its rollout.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch

from distributed_ba3c_tpu_torch.config import BA3CConfig
from distributed_ba3c_tpu_torch.models.a3c import BA3CNet
from distributed_ba3c_tpu_torch.ops.gradproc import (
    ClipAdam,
    grad_summaries,
    make_optimizer,
)
from distributed_ba3c_tpu_torch.ops.loss import A3CLossOut, a3c_loss


@dataclasses.dataclass
class TrainState:
    """Learner state: the model (its params), the optimizer (its state,
    bound to those params) and the update count."""

    step: int
    model: BA3CNet
    optimizer: ClipAdam


def create_train_state(
    model: BA3CNet, cfg: BA3CConfig, optimizer: Optional[ClipAdam] = None
) -> TrainState:
    """A fresh TrainState over ``model``'s params (seeded at its build);
    the optimizer is :func:`make_optimizer` of ``cfg`` when not given."""
    if optimizer is None:
        optimizer = make_optimizer(
            model.named_parameters(), cfg.learning_rate, cfg.adam_epsilon,
            cfg.grad_clip_norm,
        )
    return TrainState(step=0, model=model, optimizer=optimizer)


def _make_loss_fn(
    model: BA3CNet,
    cfg: BA3CConfig,
    batch: Dict[str, torch.Tensor],
    entropy_beta,
) -> Callable[[], A3CLossOut]:
    """The per-(sub-)batch A3C loss closure over the model's current params
    (``batch``: ``state`` uint8 [B, H, W, C], ``action``, ``return``)."""

    def loss_fn() -> A3CLossOut:
        out = model(batch["state"])
        return a3c_loss(
            out.logits,
            out.value,
            batch["action"],
            batch["return"],
            entropy_beta=entropy_beta,
            value_loss_coef=cfg.value_loss_coef,
            huber_delta=cfg.value_huber_delta,
        )

    return loss_fn


def n_grad_chunks(n: int, grad_chunk_samples: int) -> int:
    """The fewest equal chunks of at most ``grad_chunk_samples`` (rounded
    up until they divide ``n``), as the JAX fused step counts them."""
    n_chunks = max(1, -(-n // grad_chunk_samples))
    while n % n_chunks:
        n_chunks += 1
    return n_chunks


def learner_grads(
    model: BA3CNet,
    cfg: BA3CConfig,
    states: torch.Tensor,
    actions: torch.Tensor,
    returns: torch.Tensor,
    entropy_beta,
    grad_chunk_samples: int = 4096,
) -> Tuple[List[torch.Tensor], A3CLossOut]:
    """The a3c loss's gradients over a flat batch, in parameter order,
    with the loss terms: the mean over equal chunks of at most
    ``grad_chunk_samples`` (which equals the full-batch gradient)."""
    params = list(model.parameters())
    n_chunks = n_grad_chunks(states.shape[0], grad_chunk_samples)
    grads, aux = None, None
    for s, a, r in zip(
        states.chunk(n_chunks), actions.chunk(n_chunks), returns.chunk(n_chunks)
    ):
        loss = _make_loss_fn(
            model, cfg, {"state": s, "action": a, "return": r}, entropy_beta
        )()
        g = torch.autograd.grad(loss.total, params)
        terms = [t.detach() for t in loss]
        if grads is None:
            grads, aux = list(g), terms
        else:
            grads = [x + y for x, y in zip(grads, g)]
            aux = [x + y for x, y in zip(aux, terms)]
    if n_chunks > 1:
        grads = [x / n_chunks for x in grads]
        aux = [x / n_chunks for x in aux]
    return grads, A3CLossOut(*aux)


def apply_grads(
    optimizer: ClipAdam,
    state: TrainState,
    grads: List[torch.Tensor],
    learning_rate: float,
) -> TrainState:
    """Shared tail of every learner step: the learning rate, the clip and
    Adam (in place on the model's params), the step bump."""
    optimizer.set_learning_rate(learning_rate)
    optimizer.step(grads)
    return dataclasses.replace(state, step=state.step + 1)


def make_train_step(
    model: BA3CNet,
    optimizer: ClipAdam,
    cfg: BA3CConfig,
    grad_chunk_samples: int = 4096,
) -> Callable[..., Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """Build ``step(state, batch, entropy_beta, learning_rate=None) ->
    (state, metrics)``: the A3C loss's gradients over ``batch`` (device
    tensors), their summaries, the global-norm clip and Adam. The metrics
    are 0-dim device tensors under the JAX step's names: ``loss``,
    ``policy_loss``, ``value_loss``, ``entropy``, ``advantage``,
    ``pred_value``, ``grad_norm`` and ``grad_max_abs``.

    ``optimizer`` must be the one over ``model``'s params (the state's)."""

    def step(state: TrainState, batch, entropy_beta, learning_rate=None):
        if learning_rate is None:
            learning_rate = cfg.learning_rate
        grads, aux = learner_grads(
            model, cfg, batch["state"], batch["action"], batch["return"],
            entropy_beta, grad_chunk_samples,
        )
        summaries = grad_summaries(grads)
        new_state = apply_grads(optimizer, state, grads, learning_rate)
        metrics = {
            "loss": aux.total,
            "policy_loss": aux.policy_loss,
            "value_loss": aux.value_loss,
            "entropy": aux.entropy,
            "advantage": aux.advantage,
            "pred_value": aux.pred_value,
            **summaries,
        }
        return new_state, metrics

    return step

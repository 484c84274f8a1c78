"""The learner's state.

Port of ``TrainState`` and ``create_train_state`` of
``distributed_ba3c_tpu/parallel/train_step.py``. The params live in the
model (``BA3CNet``), the optimizer state in the optimizer; the step
function itself waits for the sync trainer (ROADMAP queue A item 3).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from distributed_ba3c_tpu_torch.config import BA3CConfig
from distributed_ba3c_tpu_torch.models.a3c import BA3CNet
from distributed_ba3c_tpu_torch.ops.gradproc import ClipAdam, make_optimizer


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

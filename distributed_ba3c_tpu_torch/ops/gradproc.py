"""Gradient processing: summaries, the global-norm clip, and the optimizer.

Port of ``distributed_ba3c_tpu/ops/gradproc.py``. ``make_optimizer`` there
is ``optax.chain(clip_by_global_norm, inject_hyperparams(adam))``; here it
is :class:`ClipAdam`: the clip by optax's rule, then ``torch.optim.Adam``
(whose update equals optax's ``adam`` up to rounding), with the learning
rate settable at run time (:meth:`ClipAdam.set_learning_rate`, the
counterpart of ``inject_learning_rate``).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence

import torch


def global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of every leaf's squared entries), as ``optax.global_norm``."""
    return torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads))


def grad_summaries(grads: Sequence[torch.Tensor]) -> Dict[str, torch.Tensor]:
    """tensorpack ``SummaryGradient`` equivalent: global/max statistics,
    left on the device."""
    gmax = torch.max(torch.stack([torch.max(torch.abs(g)) for g in grads]))
    return {"grad_norm": global_norm(grads), "grad_max_abs": gmax}


def global_norm_clip(
    grads: Sequence[torch.Tensor], max_norm: float
) -> List[torch.Tensor]:
    """``optax.clip_by_global_norm``'s rule: ``g`` if ``||g|| < max_norm``,
    else ``g / ||g|| * max_norm``. (``torch.nn.utils.clip_grad_norm_``
    divides by ``||g|| + 1e-6`` and is not this function.)"""
    norm = global_norm(grads)
    keep = norm < max_norm
    return [torch.where(keep, g, g / norm.to(g.dtype) * max_norm) for g in grads]


class ClipAdam:
    """Global-norm clip, then Adam(``eps=adam_epsilon``), on ``params``.

    :meth:`step` takes the gradients as a list in ``params``' order.
    """

    def __init__(
        self,
        params: Iterable[torch.nn.Parameter],
        learning_rate: float,
        adam_epsilon: float = 1e-3,
        grad_clip_norm: float = 0.5,
    ):
        self.params = list(params)
        self.grad_clip_norm = grad_clip_norm
        self.adam = torch.optim.Adam(
            self.params, lr=learning_rate, betas=(0.9, 0.999),
            eps=adam_epsilon,
        )

    def set_learning_rate(self, learning_rate: float) -> None:
        """Set the learning rate of the next :meth:`step`s (the runtime
        schedule's hook, as ``inject_learning_rate`` is in JAX)."""
        for group in self.adam.param_groups:
            group["lr"] = float(learning_rate)

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        for p, g in zip(
            self.params, global_norm_clip(grads, self.grad_clip_norm),
            strict=True,
        ):
            p.grad = g
        self.adam.step()
        for p in self.params:
            p.grad = None


def make_optimizer(
    params: Iterable[torch.nn.Parameter],
    learning_rate: float,
    adam_epsilon: float = 1e-3,
    grad_clip_norm: float = 0.5,
) -> ClipAdam:
    """Adam + global-norm clip, learning rate settable at run time."""
    return ClipAdam(params, learning_rate, adam_epsilon, grad_clip_norm)

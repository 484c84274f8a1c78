"""Gradient processing: summaries, the global-norm clip, and the optimizer.

Port of ``distributed_ba3c_tpu/ops/gradproc.py``. ``make_optimizer`` there
is ``optax.chain(clip_by_global_norm, inject_hyperparams(adam))``; here it
is :class:`ClipAdam`: the clip by optax's rule, then ``torch.optim.Adam``
(whose update equals optax's ``adam`` up to rounding), with the learning
rate settable at run time (:meth:`ClipAdam.set_learning_rate`, the
counterpart of ``inject_learning_rate``). Its state crosses to and from
optax's (``ScaleByAdamState`` inside the ``InjectHyperparamsState``) by
:meth:`ClipAdam.state_dict` and :meth:`ClipAdam.load_state_dict`;
``global_norm_clip`` has none.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Tuple

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
    """Global-norm clip, then Adam(``eps=adam_epsilon``), on the params of
    ``named_params`` (``model.named_parameters()``).

    :meth:`step` takes the gradients as a list in the params' order. The
    names are the params' BA3CNet state_dict names, under which
    :meth:`state_dict` and :meth:`load_state_dict` carry the state.
    """

    def __init__(
        self,
        named_params: Iterable[Tuple[str, torch.nn.Parameter]],
        learning_rate: float,
        adam_epsilon: float = 1e-3,
        grad_clip_norm: float = 0.5,
    ):
        named = list(named_params)
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
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

    @property
    def learning_rate(self) -> float:
        return float(self.adam.param_groups[0]["lr"])

    def _named(self) -> Dict[str, torch.nn.Parameter]:
        return dict(zip(self.names, self.params, strict=True))

    def state_dict(self) -> dict:
        """optax's Adam state under the flax names, on the CPU: ``count``
        (int32), ``mu``, ``nu`` (trees of float32 tensors) and
        ``learning_rate`` (float32), the hyperparam the JAX optimizer
        carries. Before the first step, count 0 and zero moments, as
        ``optax.adam``'s init."""
        from distributed_ba3c_tpu_torch.models.convert import adam_to_optax, tree_to_torch

        state = {}
        for name, p in self._named().items():
            st = self.adam.state.get(p)
            state[name] = st if st else {
                "step": torch.zeros((), dtype=torch.float32),
                "exp_avg": torch.zeros_like(p),
                "exp_avg_sq": torch.zeros_like(p),
            }
        count, mu, nu = adam_to_optax(state)
        return {
            "count": torch.from_numpy(count),
            "mu": tree_to_torch(mu),
            "nu": tree_to_torch(nu),
            "learning_rate": torch.tensor(self.learning_rate, dtype=torch.float32),
        }

    def load_state_dict(self, state: dict) -> None:
        """Take :meth:`state_dict`'s layout (tensors or numpy arrays): the
        moments move to each param's device, the step count and the
        learning rate are set."""
        from distributed_ba3c_tpu_torch.models.convert import adam_from_optax, tree_to_numpy

        per_param = adam_from_optax(
            torch.as_tensor(state["count"]).cpu().numpy(),
            tree_to_numpy(state["mu"]),
            tree_to_numpy(state["nu"]),
        )
        named = self._named()
        if per_param.keys() != named.keys():
            raise ValueError(
                f"optimizer state for {sorted(per_param)}, params "
                f"{sorted(named)}"
            )
        self.adam.state.clear()
        for name, p in named.items():
            st = per_param[name]
            self.adam.state[p] = {
                "step": st["step"],
                "exp_avg": st["exp_avg"].to(p.device, p.dtype).contiguous(),
                "exp_avg_sq": st["exp_avg_sq"].to(p.device, p.dtype).contiguous(),
            }
        self.set_learning_rate(float(torch.as_tensor(state["learning_rate"])))

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
    named_params: Iterable[Tuple[str, torch.nn.Parameter]],
    learning_rate: float,
    adam_epsilon: float = 1e-3,
    grad_clip_norm: float = 0.5,
) -> ClipAdam:
    """Adam + global-norm clip, learning rate settable at run time."""
    return ClipAdam(named_params, learning_rate, adam_epsilon, grad_clip_norm)

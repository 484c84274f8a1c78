"""The weight bridge between the JAX package's flax params and BA3CNet.

The flax tree is a nested dict of numpy arrays, named as
``distributed_ba3c_tpu/models/a3c.py`` names them:

- ``Conv_0..3/{kernel,bias}``: kernel HWIO ``[kh, kw, Ci, Co]``, which maps
  to the port's OIHW ``convs.i.weight``;
- ``Dense_0`` (FC 512), ``Dense_1`` (logits), ``Dense_2`` (value): kernel
  ``[in, out]``, which maps to ``fc``/``policy``/``value.weight``
  ``[out, in]``;
- ``PReLU_0/alpha``: a scalar, ``prelu.alpha``.

Both directions are pure permutations, so the round trip is exact.

The int8 rung's serving table crosses too (:func:`quant_from_flax`,
:func:`quant_to_flax`): the JAX package's ``{Conv_i, Dense_0}:
{kernel_q, w_scale, bias, act_scale}`` tree with HWIO / ``[in, out]``
int8 kernels, and the port's flat table of ``quantize/qforward.py``, whose
kernels are ``[K, Co]`` im2col matrices, K-contiguous and zero-padded to a
multiple of 8.

The optimizer's state crosses the same way. optax's ``ScaleByAdamState``
(``count``, and ``mu`` and ``nu`` as trees of the params' names) maps one
to one onto torch Adam's per-parameter ``step``, ``exp_avg`` and
``exp_avg_sq``: :func:`adam_from_optax` and :func:`adam_to_optax`.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

_DENSE = (("Dense_0", "fc"), ("Dense_1", "policy"), ("Dense_2", "value"))


def _num_convs(names) -> int:
    return sum(1 for n in names if n.startswith("Conv_"))


def from_flax(params) -> Dict[str, torch.Tensor]:
    """flax params (nested dicts of arrays) -> a BA3CNet state_dict (CPU)."""

    def t(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, copy=True))

    sd: Dict[str, torch.Tensor] = {}
    for i in range(_num_convs(params)):
        p = params[f"Conv_{i}"]
        sd[f"convs.{i}.weight"] = t(p["kernel"]).permute(3, 2, 0, 1).contiguous()
        sd[f"convs.{i}.bias"] = t(p["bias"])
    for flax_name, name in _DENSE:
        sd[f"{name}.weight"] = t(params[flax_name]["kernel"]).t().contiguous()
        sd[f"{name}.bias"] = t(params[flax_name]["bias"])
    sd["prelu.alpha"] = t(params["PReLU_0"]["alpha"])
    return sd


def to_flax(state_dict) -> dict:
    """A BA3CNet state_dict -> flax params (nested dicts of numpy arrays)."""

    def a(x: torch.Tensor) -> np.ndarray:
        return x.detach().cpu().contiguous().numpy().copy()

    convs = sorted(
        {int(k.split(".")[1]) for k in state_dict if k.startswith("convs.")}
    )
    out: dict = {}
    for i in convs:
        out[f"Conv_{i}"] = {
            "kernel": a(state_dict[f"convs.{i}.weight"].permute(2, 3, 1, 0)),
            "bias": a(state_dict[f"convs.{i}.bias"]),
        }
    for flax_name, name in _DENSE:
        out[flax_name] = {
            "kernel": a(state_dict[f"{name}.weight"].t()),
            "bias": a(state_dict[f"{name}.bias"]),
        }
    out["PReLU_0"] = {"alpha": a(state_dict["prelu.alpha"])}
    return out


def tree_to_torch(tree) -> dict:
    """A flax tree of numpy arrays -> the same tree of CPU tensors."""
    return {k: {n: torch.from_numpy(np.asarray(a)) for n, a in v.items()}
            for k, v in tree.items()}


def tree_to_numpy(tree) -> dict:
    """A flax tree of tensors (any device) or arrays -> numpy arrays."""
    return {k: {n: torch.as_tensor(a).cpu().numpy() for n, a in v.items()}
            for k, v in tree.items()}


def adam_from_optax(count, mu, nu) -> Dict[str, Dict[str, torch.Tensor]]:
    """optax's Adam state (``count``; ``mu``, ``nu`` as flax trees of
    arrays) -> torch Adam's state per parameter, keyed by BA3CNet
    state_dict names: ``{"step", "exp_avg", "exp_avg_sq"}`` (CPU; ``step``
    a float32 scalar, as torch Adam keeps it)."""
    m, v = from_flax(mu), from_flax(nu)
    step = float(np.asarray(count))
    return {
        k: {
            "step": torch.tensor(step, dtype=torch.float32),
            "exp_avg": m[k],
            "exp_avg_sq": v[k],
        }
        for k in m
    }


def adam_to_optax(state) -> Tuple[np.ndarray, dict, dict]:
    """The inverse of :func:`adam_from_optax`: torch Adam's state per
    parameter name -> ``(count, mu, nu)``, count an int32 scalar and ``mu``,
    ``nu`` flax trees of numpy arrays. Every parameter must have taken the
    same number of steps."""
    steps = {float(s["step"]) for s in state.values()}
    if len(steps) != 1:
        raise ValueError(f"parameters at different Adam steps: {sorted(steps)}")
    count = np.asarray(int(steps.pop()), np.int32)
    mu = to_flax({k: s["exp_avg"] for k, s in state.items()})
    nu = to_flax({k: s["exp_avg_sq"] for k, s in state.items()})
    return count, mu, nu


_QUANT_LEAVES = ("w_scale", "bias", "act_scale")


def quant_from_flax(table) -> Dict[str, torch.Tensor]:
    """The JAX package's int8 serving table -> the port's (CPU tensors)."""
    from distributed_ba3c_tpu_torch.quantize.qforward import k_major

    def t(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, copy=True))

    out: Dict[str, torch.Tensor] = {}
    for name, leaves in table.items():
        if "kernel_q" in leaves:
            kq = t(leaves["kernel_q"])
            out[f"{name}.kernel_q"] = k_major(kq.reshape(-1, kq.shape[-1]))
            for leaf in _QUANT_LEAVES:
                out[f"{name}.{leaf}"] = t(leaves[leaf])
    for flax_name, name in _DENSE[1:]:
        out[f"{name}.weight"] = t(table[flax_name]["kernel"]).t().contiguous()
        out[f"{name}.bias"] = t(table[flax_name]["bias"])
    out["prelu.alpha"] = t(table["PReLU_0"]["alpha"])
    return out


def quant_to_flax(table, in_channels: int = 4) -> dict:
    """The inverse of :func:`quant_from_flax`: the port's int8 table ->
    the JAX package's tree of numpy arrays. A conv's kernel size is read
    off its padded K: ``k*k*Ci`` is the one value in ``(Kp - 8, Kp]``, Ci
    being ``in_channels`` for ``Conv_0`` and the previous conv's Co after."""

    def a(x: torch.Tensor) -> np.ndarray:
        return x.detach().cpu().contiguous().numpy().copy()

    out: dict = {}
    ci = in_channels
    n_convs = sum(1 for k in table if k.startswith("Conv_") and k.endswith(".kernel_q"))
    for name in [f"Conv_{i}" for i in range(n_convs)] + ["Dense_0"]:
        if f"{name}.kernel_q" not in table:
            continue
        kq = table[f"{name}.kernel_q"]
        kp, co = kq.shape
        if name == "Dense_0":
            kernel = a(kq)
        else:
            k = max(k for k in range(1, kp + 1) if k * k * ci <= kp)
            if k * k * ci <= kp - 8:
                raise ValueError(f"{name}: no k with k*k*{ci} in ({kp - 8}, {kp}]")
            kernel = a(kq[: k * k * ci]).reshape(k, k, ci, co)
            ci = co
        out[name] = {"kernel_q": kernel,
                     **{leaf: a(table[f"{name}.{leaf}"]) for leaf in _QUANT_LEAVES}}
    for flax_name, name in _DENSE[1:]:
        out[flax_name] = {"kernel": a(table[f"{name}.weight"].t()),
                          "bias": a(table[f"{name}.bias"])}
    out["PReLU_0"] = {"alpha": a(table["prelu.alpha"])}
    return out

"""What the batched games share: float32 constants as XLA folds them,
the pixel grid, the auto-reset select and the draw samplers."""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


def inv32(d: float) -> float:
    """1 / d computed in float32. XLA compiles a division by a constant as
    a product with its float32 reciprocal (and so does PyTorch on CUDA);
    multiplying by it makes the CPU, the card and the JAX reference round
    alike."""
    return float(torch.tensor(1.0) / torch.tensor(d, dtype=torch.float32))


def pixel_grid(obs_shape: Tuple[int, int], device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(Y [1, h, 1], X [1, 1, w])`` float32 pixel centres in the unit
    square, ``(arange + 0.5) / n`` with the division folded as XLA does."""
    h, w = obs_shape
    ys = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) * inv32(h)
    xs = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) * inv32(w)
    return ys[None, :, None], xs[None, None, :]


def auto_reset(done: torch.Tensor, fresh: NamedTuple, state: NamedTuple) -> NamedTuple:
    """Field by field, ``fresh`` where ``done [B]`` else ``state``."""
    return type(state)(*(
        torch.where(done.view(-1, *([1] * (old.dim() - 1))), new, old)
        for new, old in zip(fresh, state)
    ))


def uniform(shape, generator: torch.Generator, device, lo: float = 0.0,
            hi: float = 1.0) -> torch.Tensor:
    """float32 ``U(lo, hi)`` draws from ``generator`` (on ``device``)."""
    u = torch.rand(shape, generator=generator, device=device)
    return u if (lo, hi) == (0.0, 1.0) else lo + u * (hi - lo)


def randint(lo: int, hi: int, shape, generator: torch.Generator, device) -> torch.Tensor:
    """int32 draws from ``[lo, hi)``, as ``jax.random.randint``."""
    return torch.randint(lo, hi, shape, generator=generator, device=device,
                         dtype=torch.int32)


def no_draws(n: int, device) -> torch.Tensor:
    """The draws of a step or reset that takes none: an empty ``[n, 0]``
    tensor, which carries the batch size and the device."""
    return torch.zeros((n, 0), dtype=torch.float32, device=device)


def full(B: int, value, dtype, device) -> torch.Tensor:
    return torch.full((B,), value, dtype=dtype, device=device)


def rows(B: int, values, dtype, device) -> torch.Tensor:
    """``[B, len(values)]``: ``values`` repeated for every env."""
    return torch.tensor(values, dtype=dtype, device=device).expand(B, -1).clone()

"""Boxing on the device, batched over ``[B]`` tensors, in PyTorch.

Port of ``distributed_ba3c_tpu/envs/jaxenv/boxing.py``: two boxers in a
top-down ring, +1 per punch landed and -1 per punch taken; a KO (100
landed by either side) or ``MAX_T`` steps ends the episode. The opponent
pursues with a random sidestep and punches with a cooldown.
``FRAME_SKIP`` 4. Actions (18): 0 noop, 1 punch, 2 up, 3 right, 4 left, 5
down, 6-9 diagonals, 10-17 punch + move.

Draws, per substep (:class:`Jabs`): the opponent's sidestep jitter, two
``U(0, 1)``, and its punch attempt, a Bernoulli(``OPP_PUNCH_P``) as its
uniform. The reset takes none (``[B, 0]``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from distributed_ba3c_tpu_torch.envs.jaxenv._common import (
    auto_reset,
    inv32,
    no_draws,
    pixel_grid,
    rows,
    uniform,
)

num_actions = 18
obs_shape = (84, 84)

RING_LO, RING_HI = 0.08, 0.92
MOVE = 0.022
OPP_MOVE = 0.014
PUNCH_RANGE = 0.10
PUNCH_CD = 4          # substeps between punches
OPP_PUNCH_P = 0.25    # per-substep punch attempt probability when in range
KO = 100
FRAME_SKIP = 4
MAX_T = 2000

# action -> (dx, dy): move rows for actions 2..9 (10..17 punch + move)
_MOVES = (
    (0, 0), (0, 0),                      # noop, punch
    (0, -1), (1, 0), (-1, 0), (0, 1),    # up right left down
    (1, -1), (-1, -1), (1, 1), (-1, 1),  # diagonals (ALE order approx)
)

_INV_KO = inv32(KO)


class State(NamedTuple):
    me: torch.Tensor        # [B, 2] float32 player position
    opp: torch.Tensor       # [B, 2] float32
    my_score: torch.Tensor  # [B] int32 punches landed
    op_score: torch.Tensor  # [B] int32
    my_cd: torch.Tensor     # [B] int32 punch cooldown
    op_cd: torch.Tensor     # [B] int32
    t: torch.Tensor         # [B] int32


class Jabs(NamedTuple):
    """The draws of a step, per substep."""

    jitter: torch.Tensor   # [n, FRAME_SKIP, 2] float32 U(0, 1)
    punch_u: torch.Tensor  # [n, FRAME_SKIP] float32 U(0, 1): the opponent tries where < OPP_PUNCH_P


def step_noise(n: int, generator: torch.Generator, device) -> Jabs:
    return Jabs(
        jitter=uniform((n, FRAME_SKIP, 2), generator, device),
        punch_u=uniform((n, FRAME_SKIP), generator, device),
    )


def reset_noise(n: int, generator: torch.Generator, device) -> torch.Tensor:
    return no_draws(n, device)


def _decode(action: torch.Tensor):
    punch_combo = action >= 10
    base = torch.where(punch_combo, action - 8, action).clamp(0, 9)
    d = torch.tensor(_MOVES, dtype=torch.float32, device=action.device)[base.long()]
    punch = (action == 1) | punch_combo
    return d[:, 0], d[:, 1], punch


def reset(noise: torch.Tensor) -> State:
    """noise: ``[B, 0]`` (the reset draws nothing) -> B fresh bouts."""
    B, dev = noise.shape[0], noise.device
    zero = torch.zeros(B, dtype=torch.int32, device=dev)
    return State(
        me=rows(B, [0.3, 0.5], torch.float32, dev),
        opp=rows(B, [0.7, 0.5], torch.float32, dev),
        my_score=zero, op_score=zero.clone(), my_cd=zero.clone(),
        op_cd=zero.clone(), t=zero.clone(),
    )


def _norm(v: torch.Tensor) -> torch.Tensor:
    """The length of ``v [B, 2]``, as ``jnp.linalg.norm``: sqrt(x^2 + y^2)."""
    return torch.sqrt(v[:, 0] * v[:, 0] + v[:, 1] * v[:, 1])


def _substep(state: State, dx, dy, punch, jitter, punch_u):
    me = torch.clamp(state.me + torch.stack([dx, dy], dim=1) * MOVE, RING_LO, RING_HI)

    # opponent AI: pursue with a random lateral jitter
    delta = me - state.opp
    dist = (_norm(delta) + 1e-6)[:, None]
    chase = delta / dist * OPP_MOVE
    opp = torch.clamp(state.opp + chase + (jitter - 0.5) * OPP_MOVE, RING_LO, RING_HI)

    in_range = _norm(me - opp) <= PUNCH_RANGE
    my_land = punch & in_range & (state.my_cd <= 0)
    op_land = (punch_u < OPP_PUNCH_P) & in_range & (state.op_cd <= 0)

    # landing a punch knocks the punched boxer AWAY from the puncher
    # (delta = me - opp, so -delta/dist points from me toward opp)
    knock = torch.where(dist > 0, delta / dist, 0.0) * 0.05
    opp = torch.clamp(opp - torch.where(my_land[:, None], knock, 0.0), RING_LO, RING_HI)
    me = torch.clamp(me + torch.where(op_land[:, None], knock, 0.0), RING_LO, RING_HI)

    reward = my_land.to(torch.float32) - op_land.to(torch.float32)
    cd = torch.tensor(PUNCH_CD, dtype=torch.int32, device=me.device)
    return State(
        me=me,
        opp=opp,
        my_score=state.my_score + my_land.to(torch.int32),
        op_score=state.op_score + op_land.to(torch.int32),
        my_cd=torch.where(my_land, cd, (state.my_cd - 1).clamp(min=0)),
        op_cd=torch.where(op_land, cd, (state.op_cd - 1).clamp(min=0)),
        t=state.t,
    ), reward


def step(state: State, action: torch.Tensor, noise: Jabs):
    """One agent step = FRAME_SKIP substeps. Returns (state, obs uint8 [B,
    84, 84], reward float32 [B], done bool [B])."""
    dx, dy, punch = _decode(action)
    reward = torch.zeros_like(dx)
    for k in range(FRAME_SKIP):
        state, r = _substep(state, dx, dy, punch, noise.jitter[:, k], noise.punch_u[:, k])
        reward = reward + r
    state = state._replace(t=state.t + 1)

    done = (state.my_score >= KO) | (state.op_score >= KO) | (state.t >= MAX_T)
    state = auto_reset(done, reset(no_draws(done.shape[0], done.device)), state)
    return state, render(state), reward, done


def render(state: State) -> torch.Tensor:
    Y, X = pixel_grid(obs_shape, state.me.device)

    def col(v):  # [B] -> [B, 1, 1]
        return v[:, None, None]

    ring = (
        (torch.abs(X - RING_LO) < 0.008)
        | (torch.abs(X - RING_HI) < 0.008)
        | (torch.abs(Y - RING_LO) < 0.008)
        | (torch.abs(Y - RING_HI) < 0.008)
    )
    me = (torch.abs(X - col(state.me[:, 0])) <= 0.03) & (
        torch.abs(Y - col(state.me[:, 1])) <= 0.03
    )
    opp = (torch.abs(X - col(state.opp[:, 0])) <= 0.03) & (
        torch.abs(Y - col(state.opp[:, 1])) <= 0.03
    )
    # score bars along the top edge (white=mine, grey=opponent) so the net
    # can see the count, like ALE's on-screen score
    my_bar = (Y < 0.04) & (X < col(state.my_score.to(torch.float32) * _INV_KO))
    op_bar = (Y > 0.96) & (X < col(state.op_score.to(torch.float32) * _INV_KO))

    frame = me.to(torch.uint8) * 255
    frame = torch.maximum(frame, opp.to(torch.uint8) * 150)
    frame = torch.maximum(frame, ring.to(torch.uint8) * 80)
    frame = torch.maximum(frame, my_bar.to(torch.uint8) * 255)
    return torch.maximum(frame, op_bar.to(torch.uint8) * 120)

"""A Q*bert-like game on the device, batched over ``[B]`` tensors, in
PyTorch.

Port of ``distributed_ba3c_tpu/envs/jaxenv/qbert.py``: a 6-row pyramid of
21 cubes; hopping onto a cube flips it (+25 the first time), flipping
every cube clears the board (+100, the board refills), hopping off the
pyramid or meeting the bouncing ball costs a life, 3 lives. One agent step
is one hop (``FRAME_SKIP`` 1). Actions: 0 noop, 1 up-right, 2 down-right,
3 down-left, 4 up-left. Cube (r, c), c in [0, r], has the flat index
r (r + 1) / 2 + c.

Draws: the ball's sideways hop, a Bernoulli(0.5) taken as its uniform (+1
column where ``< 0.5``): :func:`step` takes ``noise [B]``; the reset takes
none (``[B, 0]``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from distributed_ba3c_tpu_torch.envs.jaxenv._common import (
    auto_reset,
    full,
    no_draws,
    pixel_grid,
    rows,
    uniform,
)

num_actions = 5
obs_shape = (84, 84)

ROWS = 6
N_CUBES = ROWS * (ROWS + 1) // 2  # 21
CUBE_POINTS = 25.0
CLEAR_BONUS = 100.0
LIVES = 3
FRAME_SKIP = 1
MAX_T = 2000

_ROW_OF = tuple(r for r in range(ROWS) for _ in range(r + 1))
_COL_OF = tuple(c for r in range(ROWS) for c in range(r + 1))


class State(NamedTuple):
    pos: torch.Tensor        # [B, 2] int32 (row, col) of the agent
    flipped: torch.Tensor    # [B, N_CUBES] bool
    ball: torch.Tensor       # [B, 2] int32 (row, col) of the enemy ball
    ball_live: torch.Tensor  # [B] bool
    lives: torch.Tensor      # [B] int32
    boards: torch.Tensor     # [B] int32 boards cleared (difficulty counter)
    t: torch.Tensor          # [B] int32


def step_noise(n: int, generator: torch.Generator, device) -> torch.Tensor:
    """``[n]`` float32 U(0, 1): the ball hops a column right where < 0.5."""
    return uniform((n,), generator, device)


def reset_noise(n: int, generator: torch.Generator, device) -> torch.Tensor:
    return no_draws(n, device)


def reset(noise: torch.Tensor) -> State:
    """noise: ``[B, 0]`` (the reset draws nothing) -> B fresh games."""
    B, dev = noise.shape[0], noise.device
    zero = torch.zeros(B, dtype=torch.int32, device=dev)
    return State(
        pos=rows(B, [0, 0], torch.int32, dev),
        flipped=torch.zeros((B, N_CUBES), dtype=torch.bool, device=dev),
        ball=rows(B, [1, 0], torch.int32, dev),
        ball_live=torch.zeros(B, dtype=torch.bool, device=dev),
        lives=full(B, LIVES, torch.int32, dev),
        boards=zero,
        t=zero.clone(),
    )


def _hop(pos: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
    """Diagonal lattice moves, rows growing downward: up-right (1) (-1, 0),
    down-right (2) (+1, +1), down-left (3) (+1, 0), up-left (4) (-1, -1)."""
    dr = torch.where((action == 2) | (action == 3), 1,
                     torch.where((action == 1) | (action == 4), -1, 0))
    dc = torch.where(action == 2, 1, torch.where(action == 4, -1, 0))
    return pos + torch.stack([dr, dc], dim=1).to(torch.int32)


def step(state: State, action: torch.Tensor, noise: torch.Tensor):
    """One hop; ``noise [B]``. Returns (state, obs uint8 [B, 84, 84],
    reward float32 [B], done bool [B])."""
    dev = action.device
    new_pos = _hop(state.pos, action)
    moved = action != 0
    row, col = new_pos[:, 0], new_pos[:, 1]
    on_board = (row >= 0) & (row < ROWS) & (col >= 0) & (col <= row)
    fell = moved & ~on_board
    pos = torch.where(on_board[:, None], new_pos, state.pos)

    # flip the landed cube (a one-hot mask over the cubes)
    idx = (pos[:, 0] * (pos[:, 0] + 1)) // 2 + pos[:, 1]
    cube = torch.arange(N_CUBES, device=dev) == idx[:, None]
    landed = moved & on_board
    newly = landed & ~(state.flipped & cube).any(1)
    flipped = state.flipped | (cube & landed[:, None])
    reward = torch.where(newly, CUBE_POINTS, 0.0)

    # board clear
    cleared = flipped.all(1)
    reward = reward + torch.where(cleared, CLEAR_BONUS, 0.0)
    flipped = flipped & ~cleared[:, None]
    boards = state.boards + cleared.to(torch.int32)

    # enemy ball: spawns at the top, hops downward randomly; falls off bottom
    spawn = ~state.ball_live
    bdc = (noise < 0.5).to(torch.int32)
    top = torch.tensor([1, 0], dtype=torch.int32, device=dev)
    hopped = state.ball + torch.stack([torch.ones_like(bdc), bdc], dim=1)
    ball = torch.where(spawn[:, None], top, hopped)
    ball_live = ball[:, 0] < ROWS
    ball = torch.where(ball_live[:, None], ball, top)
    # clamp col onto the row
    ball = torch.stack([
        ball[:, 0], torch.minimum(ball[:, 1].clamp(min=0), ball[:, 0])
    ], dim=1)

    caught = ball_live & (ball == pos).all(1)
    lost_life = fell | caught
    lives = state.lives - lost_life.to(torch.int32)
    pos = torch.where(lost_life[:, None], 0, pos)

    t = state.t + 1
    done = (lives <= 0) | (t >= MAX_T)
    new_state = State(
        pos=pos, flipped=flipped, ball=ball, ball_live=ball_live | spawn,
        lives=lives, boards=boards, t=t,
    )
    new_state = auto_reset(done, reset(no_draws(*noise.shape, dev)), new_state)
    return new_state, render(new_state), reward, done


def _at(pos: torch.Tensor):
    """The screen position of lattice cells ``pos [B, 2]``: ``[B, 1, 1]``."""
    r, c = pos[:, 0].to(torch.float32), pos[:, 1].to(torch.float32)
    px = 0.5 + (c - r * 0.5) * 0.13
    py = 0.18 + r * 0.13 - 0.05
    return px[:, None, None], py[:, None, None]


def render(state: State) -> torch.Tensor:
    """Isometric-ish pyramid: cube (r, c) centred at x = 0.5 + (c - r/2) *
    0.13, y = 0.18 + r * 0.13; uint8 [B, 84, 84]."""
    dev = state.lives.device
    Y, X = pixel_grid(obs_shape, dev)
    r = torch.tensor(_ROW_OF, dtype=torch.float32, device=dev)
    c = torch.tensor(_COL_OF, dtype=torch.float32, device=dev)
    cx = (0.5 + (c - r * 0.5) * 0.13)[:, None, None]
    cy = (0.18 + r * 0.13)[:, None, None]

    # cubes: dim if unflipped, bright if flipped; max over the cubes
    cube_px = (torch.abs(X - cx) <= 0.05) & (torch.abs(Y - cy) <= 0.045)  # [N, H, W]
    shade = torch.where(state.flipped, 200, 100).to(torch.uint8)          # [B, N]
    frame = torch.amax(cube_px[None] * shade[:, :, None, None], dim=1)

    ax, ay = _at(state.pos)
    agent = (torch.abs(X - ax) <= 0.025) & (torch.abs(Y - ay) <= 0.025)
    frame = torch.maximum(frame, agent.to(torch.uint8) * 255)
    bx, by = _at(state.ball)
    ball = ((torch.abs(X - bx) <= 0.02) & (torch.abs(Y - by) <= 0.02)
            & state.ball_live[:, None, None])
    return torch.maximum(frame, ball.to(torch.uint8) * 160)

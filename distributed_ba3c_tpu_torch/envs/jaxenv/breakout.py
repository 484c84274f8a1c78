"""Breakout on the device, batched over ``[B]`` tensors, in PyTorch.

Port of ``distributed_ba3c_tpu/envs/jaxenv/breakout.py``: 6 rows x 18
columns of bricks worth 7, 7, 4, 4, 1, 1 points from the top, 5 lives,
losing the ball costs one, a cleared wall refills, done when the lives run
out (or at ``MAX_T`` steps). Actions: 0 noop, 1 fire, 2 right, 3 left. One
agent step is ``FRAME_SKIP`` substeps; the ball rides the paddle until
fire.

Draws: a launch angle ``U(0.25 pi, 0.75 pi)`` per substep (used when the
ball is fired): :func:`step` takes ``noise [B, FRAME_SKIP]``; the reset
takes none (``[B, 0]``). The launch's cos and sin are taken in float64 and
rounded to float32, so the card and the CPU give the same velocity (their
float32 sin/cos differ by an ulp on some arguments, as XLA's do).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from distributed_ba3c_tpu_torch.envs.jaxenv._common import (
    auto_reset,
    full,
    inv32,
    no_draws,
    pixel_grid,
    rows,
    uniform,
)

num_actions = 4
obs_shape = (84, 84)

ROWS, COLS = 6, 18
BRICK_TOP = 0.15     # y of the top brick row
BRICK_H = 0.03
BRICK_REGION_H = ROWS * BRICK_H
PADDLE_Y = 0.92
PADDLE_H = 0.02
PADDLE_W = 0.08
BALL_R = 0.012
PADDLE_SPEED = 0.04
BALL_SPEED = 0.035
LIVES = 5
FRAME_SKIP = 4
MAX_T = 10000  # safety cap on episode length (agent steps)

# ALE row scores, top row first (top rows worth most)
ROW_POINTS = (7.0, 7.0, 4.0, 4.0, 1.0, 1.0)
#: (low, high) of the launch angle
LAUNCH_RANGE = (0.25 * math.pi, 0.75 * math.pi)

_INV_BRICK_H = inv32(BRICK_H)
_INV_HALF_PADDLE = inv32(PADDLE_W / 2)
_SERVE_Y = PADDLE_Y - 0.05


class State(NamedTuple):
    ball_xy: torch.Tensor   # [B, 2] float32
    ball_v: torch.Tensor    # [B, 2] float32
    paddle_x: torch.Tensor  # [B] float32
    bricks: torch.Tensor    # [B, ROWS, COLS] bool
    lives: torch.Tensor     # [B] int32
    in_play: torch.Tensor   # [B] bool (ball launched?)
    t: torch.Tensor         # [B] int32


def step_noise(n: int, generator: torch.Generator, device) -> torch.Tensor:
    """``[n, FRAME_SKIP]`` float32 launch angles."""
    return uniform((n, FRAME_SKIP), generator, device, *LAUNCH_RANGE)


def reset_noise(n: int, generator: torch.Generator, device) -> torch.Tensor:
    return no_draws(n, device)


def reset(noise: torch.Tensor) -> State:
    """noise: ``[B, 0]`` (the reset draws nothing) -> B fresh games."""
    B, dev = noise.shape[0], noise.device
    return State(
        ball_xy=rows(B, [0.5, _SERVE_Y], torch.float32, dev),
        ball_v=torch.zeros((B, 2), dtype=torch.float32, device=dev),
        paddle_x=full(B, 0.5, torch.float32, dev),
        bricks=torch.ones((B, ROWS, COLS), dtype=torch.bool, device=dev),
        lives=full(B, LIVES, torch.int32, dev),
        in_play=torch.zeros(B, dtype=torch.bool, device=dev),
        t=torch.zeros(B, dtype=torch.int32, device=dev),
    )


def _launch(angle: torch.Tensor) -> torch.Tensor:
    a = angle.double()
    return torch.stack([
        BALL_SPEED * torch.cos(a).float(), -BALL_SPEED * torch.sin(a).float()
    ], dim=1)


def _brick_index(x: torch.Tensor, y: torch.Tensor):
    """(row, col, inside) for ball positions."""
    row = torch.floor((y - BRICK_TOP) * _INV_BRICK_H).to(torch.int32)
    col = torch.floor(x * COLS).to(torch.int32)
    inside = (row >= 0) & (row < ROWS) & (col >= 0) & (col < COLS)
    return row.clamp(0, ROWS - 1), col.clamp(0, COLS - 1), inside


def _substep(state: State, move, fire, angle):
    B, dev = move.shape[0], move.device
    paddle_x = torch.clamp(
        state.paddle_x + move * PADDLE_SPEED, PADDLE_W / 2, 1 - PADDLE_W / 2
    )

    # serve: ball rides the paddle until fire
    launch_v = torch.where(fire[:, None], _launch(angle), 0.0)
    v = torch.where(state.in_play[:, None], state.ball_v, launch_v)
    in_play = state.in_play | fire
    on_paddle = torch.stack([paddle_x, torch.full_like(paddle_x, _SERVE_Y)], dim=1)
    xy = torch.where(in_play[:, None], state.ball_xy + v, on_paddle)
    x, y = xy[:, 0], xy[:, 1]
    vx, vy = v[:, 0], v[:, 1]

    # walls
    hit_side = (x < BALL_R) | (x > 1 - BALL_R)
    vx = torch.where(hit_side, -vx, vx)
    x = torch.clamp(x, BALL_R, 1 - BALL_R)
    hit_top = y < BALL_R
    vy = torch.where(hit_top, -vy, vy)
    y = torch.clamp(y, BALL_R, 1.0)

    # paddle
    aligned = torch.abs(x - paddle_x) <= PADDLE_W / 2 + BALL_R
    hit_paddle = (y >= PADDLE_Y - PADDLE_H) & (vy > 0) & aligned & in_play
    offset = (x - paddle_x) * _INV_HALF_PADDLE
    vx = torch.where(hit_paddle, BALL_SPEED * offset, vx)
    vy = torch.where(hit_paddle, -torch.abs(vy), vy)
    y = torch.where(hit_paddle, PADDLE_Y - PADDLE_H - BALL_R, y)

    # bricks
    row, col, inside = _brick_index(x, y)
    cell = (
        (torch.arange(ROWS, device=dev) == row[:, None])[:, :, None]
        & (torch.arange(COLS, device=dev) == col[:, None])[:, None, :]
    )  # [B, ROWS, COLS] one-hot
    brick_alive = (state.bricks & cell).flatten(1).any(1) & inside & in_play
    points = torch.tensor(ROW_POINTS, dtype=torch.float32, device=dev)[row.long()]
    reward = torch.where(brick_alive, points, 0.0)
    bricks = state.bricks & ~(cell & brick_alive[:, None, None])
    # reflect AND expel the ball from the cell, else it drills through the
    # wall destroying a brick per substep
    from_below = vy < 0
    rowf = row.to(torch.float32)
    expel_y = torch.where(
        from_below,
        BRICK_TOP + (rowf + 1.0) * BRICK_H + BALL_R,
        BRICK_TOP + rowf * BRICK_H - BALL_R,
    )
    y = torch.where(brick_alive, expel_y, y)
    vy = torch.where(brick_alive, -vy, vy)

    # wall cleared -> refill (ALE second wall)
    cleared = ~bricks.flatten(1).any(1)
    bricks = bricks | cleared[:, None, None]

    # ball lost
    lost = y >= 1.0 - 1e-6
    lives = state.lives - lost.to(torch.int32)
    in_play = in_play & ~lost
    on_paddle = torch.stack([paddle_x, torch.full_like(paddle_x, _SERVE_Y)], dim=1)
    xy = torch.where(lost[:, None], on_paddle, torch.stack([x, y], dim=1))
    v = torch.where(lost[:, None], 0.0, torch.stack([vx, vy], dim=1))

    return (
        State(ball_xy=xy, ball_v=v, paddle_x=paddle_x, bricks=bricks,
              lives=lives, in_play=in_play, t=state.t),
        reward,
    )


def step(state: State, action: torch.Tensor, noise: torch.Tensor):
    """One agent step = FRAME_SKIP substeps; ``noise [B, FRAME_SKIP]``.
    Returns (state, obs uint8 [B, 84, 84], reward float32 [B], done bool
    [B]); a game auto-restarts when its lives hit 0."""
    move = torch.where(action == 2, 1.0, torch.where(action == 3, -1.0, 0.0))
    fire = action == 1
    reward = torch.zeros_like(state.paddle_x)
    for k in range(FRAME_SKIP):
        state, r = _substep(state, move, fire, noise[:, k])
        reward = reward + r
    state = state._replace(t=state.t + 1)

    done = (state.lives <= 0) | (state.t >= MAX_T)
    state = auto_reset(done, reset(noise[:, :0]), state)
    return state, render(state), reward, done


def render(state: State) -> torch.Tensor:
    """uint8 [B, 84, 84] (rows = y, cols = x), by masks."""
    dev = state.paddle_x.device
    Y, X = pixel_grid(obs_shape, dev)

    # bricks: each pixel's (row, col), a gather at constant indices
    prow = torch.floor((Y[0, :, 0] - BRICK_TOP) * _INV_BRICK_H).to(torch.int64)
    pcol = torch.floor(X[0, 0] * COLS).to(torch.int64)
    in_region = (
        ((prow >= 0) & (prow < ROWS))[:, None] & ((pcol >= 0) & (pcol < COLS))[None, :]
    )
    alive = state.bricks[:, prow.clamp(0, ROWS - 1)[:, None], pcol.clamp(0, COLS - 1)[None, :]]
    brick_px = in_region[None] & alive

    bx, by = state.ball_xy[:, 0, None, None], state.ball_xy[:, 1, None, None]
    ball = (torch.abs(X - bx) <= BALL_R) & (torch.abs(Y - by) <= BALL_R)
    paddle = (torch.abs(X - state.paddle_x[:, None, None]) <= PADDLE_W / 2) & (
        torch.abs(Y - PADDLE_Y) <= PADDLE_H
    )
    frame = (ball | paddle).to(torch.uint8) * 255
    frame = torch.maximum(frame, brick_px.to(torch.uint8) * 180)
    wall = Y < 0.02
    return torch.maximum(frame, wall.to(torch.uint8) * 80)

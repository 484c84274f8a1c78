"""A Seaquest-like game on the device, batched over ``[B]`` tensors, in
PyTorch.

Port of ``distributed_ba3c_tpu/envs/jaxenv/seaquest.py``: the submarine
moves in 2D under water, a fish streams across each of 4 lanes,
torpedoes destroy them for 20 points, and an oxygen meter forces
surfacing; a fish collision or running out of oxygen costs a life, 3
lives. ``FRAME_SKIP`` 4. Actions: 0 noop, 1 fire, 2 up, 3 down, 4 left, 5
right.

Draws: the reset places the fish, ``fish_x ~ U(0, 1)`` and a direction
Bernoulli(0.5) (its uniform, +1 where ``< 0.5``) per lane (:class:`Spawn`).
A step takes the draws of its auto-reset, a :class:`Spawn`. The JAX
substep also draws a ``respawn_x`` per lane and discards it (``del
respawn_x``); the port draws nothing for it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from distributed_ba3c_tpu_torch.envs.jaxenv._common import (
    auto_reset,
    full,
    inv32,
    pixel_grid,
    rows,
    uniform,
)

num_actions = 6
obs_shape = (84, 84)

N_LANES = 4           # enemy lanes at fixed depths
LANE_Y = (0.35, 0.5, 0.65, 0.8)
SURFACE_Y = 0.15      # above this = surfacing (refills oxygen)
SUB_SPEED = 0.03
FISH_SPEED = 0.02
TORP_SPEED = 0.08
SUB_R = 0.03          # collision half-extent
FISH_R = 0.025
OXY_MAX = 200.0       # substeps of oxygen
OXY_SURFACE_REFILL = 8.0
LIVES = 3
FISH_POINTS = 20.0
FRAME_SKIP = 4
MAX_T = 5000

_INV_OXY_MAX = inv32(OXY_MAX)


class State(NamedTuple):
    sub_xy: torch.Tensor      # [B, 2] float32
    fish_x: torch.Tensor      # [B, N_LANES] float32 x of the lane's fish
    fish_dir: torch.Tensor    # [B, N_LANES] float32 -1/+1
    fish_alive: torch.Tensor  # [B, N_LANES] bool
    torp_xy: torch.Tensor     # [B, 2] float32 torpedo position
    torp_dir: torch.Tensor    # [B] float32 -1/+1 (fires horizontally, sub's facing)
    torp_live: torch.Tensor   # [B] bool
    facing: torch.Tensor      # [B] float32 -1/+1 last horizontal direction
    oxygen: torch.Tensor      # [B] float32
    lives: torch.Tensor       # [B] int32
    t: torch.Tensor           # [B] int32


class Spawn(NamedTuple):
    """The draws of a reset."""

    fish_x: torch.Tensor  # [n, N_LANES] float32 U(0, 1)
    dir_u: torch.Tensor   # [n, N_LANES] float32 U(0, 1): direction +1 where < 0.5


def reset_noise(n: int, generator: torch.Generator, device) -> Spawn:
    return Spawn(
        fish_x=uniform((n, N_LANES), generator, device),
        dir_u=uniform((n, N_LANES), generator, device),
    )


#: a step's draws are those of its auto-reset
step_noise = reset_noise


def reset(noise: Spawn) -> State:
    B, dev = noise.fish_x.shape[0], noise.fish_x.device
    return State(
        sub_xy=rows(B, [0.5, 0.5], torch.float32, dev),
        fish_x=noise.fish_x,
        fish_dir=torch.where(noise.dir_u < 0.5, 1.0, -1.0),
        fish_alive=torch.ones((B, N_LANES), dtype=torch.bool, device=dev),
        torp_xy=torch.zeros((B, 2), dtype=torch.float32, device=dev),
        torp_dir=full(B, 1.0, torch.float32, dev),
        torp_live=torch.zeros(B, dtype=torch.bool, device=dev),
        facing=full(B, 1.0, torch.float32, dev),
        oxygen=full(B, OXY_MAX, torch.float32, dev),
        lives=full(B, LIVES, torch.int32, dev),
        t=torch.zeros(B, dtype=torch.int32, device=dev),
    )


def _substep(state: State, action: torch.Tensor):
    up = action == 2
    down = action == 3
    left = action == 4
    right = action == 5
    fire = action == 1
    lane_y = torch.tensor(LANE_Y, dtype=torch.float32, device=action.device)

    dx = torch.where(right, 1.0, 0.0) - torch.where(left, 1.0, 0.0)
    dy = torch.where(down, 1.0, 0.0) - torch.where(up, 1.0, 0.0)
    facing = torch.where(dx != 0, torch.sign(dx), state.facing)
    sub = torch.stack([
        torch.clamp(state.sub_xy[:, 0] + dx * SUB_SPEED, 0.05, 0.95),
        torch.clamp(state.sub_xy[:, 1] + dy * SUB_SPEED, 0.08, 0.92),
    ], dim=1)

    # fish advance; an off-screen fish wraps around, alive again
    fish_x = state.fish_x + state.fish_dir * FISH_SPEED
    off = (fish_x < -0.05) | (fish_x > 1.05)
    fish_x = torch.where(off, torch.where(state.fish_dir > 0, -0.05, 1.05), fish_x)
    fish_alive = state.fish_alive | off

    # torpedo
    torp_live = state.torp_live | (fire & ~state.torp_live)
    flying = torch.stack([
        state.torp_xy[:, 0] + state.torp_dir * TORP_SPEED, state.torp_xy[:, 1]
    ], dim=1)
    torp_xy = torch.where(
        state.torp_live[:, None], flying,
        torch.where(fire[:, None], sub, state.torp_xy),
    )
    torp_dir = torch.where(state.torp_live, state.torp_dir, facing)
    tx, ty = torp_xy[:, 0], torp_xy[:, 1]
    torp_live = torp_live & (tx > 0.0) & (tx < 1.0)

    # torpedo hits fish (same lane band, x overlap)
    hit = (
        fish_alive
        & torp_live[:, None]
        & (torch.abs(fish_x - tx[:, None]) < FISH_R + 0.02)
        & (torch.abs(lane_y - ty[:, None]) < 0.04)
    )
    reward = hit.sum(1).to(torch.float32) * FISH_POINTS
    fish_alive = fish_alive & ~hit
    torp_live = torp_live & ~hit.any(1)

    # fish hits sub
    collide = (
        fish_alive
        & (torch.abs(fish_x - sub[:, 0, None]) < FISH_R + SUB_R)
        & (torch.abs(lane_y - sub[:, 1, None]) < FISH_R + SUB_R)
    ).any(1)

    # oxygen
    surfaced = sub[:, 1] <= SURFACE_Y
    oxygen = torch.where(
        surfaced,
        torch.clamp(state.oxygen + OXY_SURFACE_REFILL, max=OXY_MAX),
        state.oxygen - 1.0,
    )
    suffocate = oxygen <= 0.0

    lost_life = collide | suffocate
    lives = state.lives - lost_life.to(torch.int32)
    # life reset: sub to center, oxygen refilled
    sub = torch.where(lost_life[:, None], 0.5, sub)
    oxygen = torch.where(lost_life, OXY_MAX, oxygen)

    return State(
        sub_xy=sub, fish_x=fish_x, fish_dir=state.fish_dir,
        fish_alive=fish_alive, torp_xy=torp_xy, torp_dir=torp_dir,
        torp_live=torp_live, facing=facing, oxygen=oxygen, lives=lives,
        t=state.t,
    ), reward


def step(state: State, action: torch.Tensor, noise: Spawn):
    """One agent step = FRAME_SKIP substeps; ``noise`` serves the
    auto-reset. Returns (state, obs uint8 [B, 84, 84], reward float32
    [B], done bool [B])."""
    reward = torch.zeros_like(state.oxygen)
    for _ in range(FRAME_SKIP):
        state, r = _substep(state, action)
        reward = reward + r
    state = state._replace(t=state.t + 1)
    done = (state.lives <= 0) | (state.t >= MAX_T)
    state = auto_reset(done, reset(noise), state)
    return state, render(state), reward, done


def render(state: State) -> torch.Tensor:
    Y, X = pixel_grid(obs_shape, state.oxygen.device)

    def rect(cx, cy, hw_, hh_):
        return (torch.abs(X - cx) <= hw_) & (torch.abs(Y - cy) <= hh_)

    def col(v):  # [B] -> [B, 1, 1]
        return v[:, None, None]

    # surface line
    frame = (torch.abs(Y - SURFACE_Y) < 0.012).to(torch.uint8) * 80
    # oxygen bar along the top, width proportional to oxygen
    frac = torch.clamp(state.oxygen * _INV_OXY_MAX, 0.0, 1.0)
    frame = torch.maximum(frame, ((Y < 0.04) & (X < col(frac))).to(torch.uint8) * 140)
    # fish per lane
    fish = torch.zeros((1, 1, 1), dtype=torch.bool, device=X.device)
    for i in range(N_LANES):
        fish = fish | (
            rect(col(state.fish_x[:, i]), LANE_Y[i], FISH_R, FISH_R)
            & col(state.fish_alive[:, i])
        )
    frame = torch.maximum(frame, fish.to(torch.uint8) * 180)
    # torpedo
    torp = rect(col(state.torp_xy[:, 0]), col(state.torp_xy[:, 1]), 0.015, 0.008)
    frame = torch.maximum(frame, (torp & col(state.torp_live)).to(torch.uint8) * 220)
    # submarine
    sub = rect(col(state.sub_xy[:, 0]), col(state.sub_xy[:, 1]), SUB_R, SUB_R)
    return torch.maximum(frame, sub.to(torch.uint8) * 255)

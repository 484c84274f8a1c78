"""A CoinRun-like procedurally generated platformer on the device, batched
over ``[B]`` tensors, in PyTorch (BASELINE.json config #5).

Port of ``distributed_ba3c_tpu/envs/jaxenv/coinrun.py``: every episode's
level is generated from its draws -- terrain heights (a random walk),
gaps, spikes, the coin's distance and a per-level difficulty that scales
the gap and spike densities. Run right, jump gaps and spikes, touch the
coin for +10; a fall or a spike ends the episode with 0. ``FRAME_SKIP`` 1.
Actions: 0 noop, 1 left, 2 right, 3 jump, 4 right+jump.

Draws: a whole level (:class:`Level`) for every env at every step, kept
only where the episode ends (the JAX step generates ``reset(key)`` from
its step key). The level's Bernoulli draws are their uniforms (a gap
where ``gap_u < GAP_P * diff``), its ``randint`` draws integers.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from distributed_ba3c_tpu_torch.envs.jaxenv._common import (
    auto_reset,
    randint,
    uniform,
)

num_actions = 5
obs_shape = (84, 84)

LEVEL_LEN = 64        # tiles
MAX_HEIGHT = 5.0      # terrain height in tiles
GAP_P = 0.12          # per-tile gap probability
SPIKE_P = 0.10        # per-tile spike probability (on ground tiles)
GRAVITY = 0.02
JUMP_V = 0.22
RUN_V = 0.12          # tiles per tick
COIN_REWARD = 10.0
MAX_T = 1000
FRAME_SKIP = 1

VIEW_TILES = 12.0     # horizontal tiles visible
VIEW_H_TILES = 8.0    # vertical tiles visible

#: [low, high) of the coin tile's randint draw
GOAL_RANGE = (6, LEVEL_LEN - 1)


class State(NamedTuple):
    xy: torch.Tensor       # [B, 2] float32 (x tiles, y tiles above ground-0)
    vy: torch.Tensor       # [B] float32 vertical velocity
    heights: torch.Tensor  # [B, LEVEL_LEN] float32 terrain height (0 = gap)
    spikes: torch.Tensor   # [B, LEVEL_LEN] bool
    goal: torch.Tensor     # [B] float32 coin tile (6..LEVEL_LEN-2)
    t: torch.Tensor        # [B] int32


class Level(NamedTuple):
    """The draws of one level per env."""

    goal: torch.Tensor     # [n] int32 in GOAL_RANGE
    diff: torch.Tensor     # [n] float32 U(0, 1) difficulty
    steps: torch.Tensor    # [n, LEVEL_LEN] int32 in {-1, 0, 1}: the terrain walk
    gap_u: torch.Tensor    # [n, LEVEL_LEN] float32 U(0, 1): a gap where < GAP_P * diff
    spike_u: torch.Tensor  # [n, LEVEL_LEN] float32 U(0, 1): a spike where < SPIKE_P * diff


def reset_noise(n: int, generator: torch.Generator, device) -> Level:
    return Level(
        goal=randint(*GOAL_RANGE, (n,), generator, device),
        diff=uniform((n,), generator, device),
        steps=randint(-1, 2, (n, LEVEL_LEN), generator, device),
        gap_u=uniform((n, LEVEL_LEN), generator, device),
        spike_u=uniform((n, LEVEL_LEN), generator, device),
    )


#: a step's draws are a fresh level, used where the episode ends
step_noise = reset_noise


def _gen_level(level: Level):
    diff = level.diff[:, None]
    goal = level.goal.to(torch.float32)
    heights = torch.clamp(
        2.0 + torch.cumsum(level.steps, dim=1).to(torch.float32), 1.0, MAX_HEIGHT
    )
    gaps = level.gap_u < GAP_P * diff
    # spawn platform and everything from the coin platform on stays solid;
    # no double gaps
    idx = torch.arange(LEVEL_LEN, device=goal.device)
    protected = (idx < 4) | (idx.to(torch.float32) >= (goal - 2.0)[:, None])
    gaps = gaps & ~protected & ~torch.roll(gaps, 1, dims=1)
    heights = torch.where(gaps, 0.0, heights)
    spikes = (
        (level.spike_u < SPIKE_P * diff)
        & ~gaps
        & ~protected
        & ~torch.roll(gaps, 1, dims=1)
        & ~torch.roll(gaps, -1, dims=1)
    )
    return heights, spikes, goal


def reset(level: Level) -> State:
    heights, spikes, goal = _gen_level(level)
    B = heights.shape[0]
    return State(
        xy=torch.stack([torch.full_like(goal, 1.5), heights[:, 1]], dim=1),
        vy=torch.zeros_like(goal),
        heights=heights,
        spikes=spikes,
        goal=goal,
        t=torch.zeros(B, dtype=torch.int32, device=goal.device),
    )


def _tile(x: torch.Tensor) -> torch.Tensor:
    """The tile under ``x`` (truncation, as ``astype(int32)``), clipped."""
    return x.to(torch.int32).clamp(0, LEVEL_LEN - 1).long()


def _ground_at(heights: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return heights.gather(1, _tile(x)[:, None])[:, 0]


def step(state: State, action: torch.Tensor, level: Level):
    """One agent step; ``level`` is a fresh level for every env. Returns
    (state, obs uint8 [B, 84, 84], reward float32 [B], done bool [B])."""
    left = action == 1
    right = (action == 2) | (action == 4)
    jump = (action == 3) | (action == 4)

    x, y = state.xy[:, 0], state.xy[:, 1]
    ground = _ground_at(state.heights, x)
    grounded = (y <= ground + 1e-4) & (ground > 0)

    vx = torch.where(right, RUN_V, 0.0) - torch.where(left, RUN_V, 0.0)
    vy = torch.where(grounded & jump, JUMP_V, state.vy - GRAVITY)
    vy = torch.where(grounded & ~jump, torch.clamp(vy, min=0.0), vy)

    new_x = torch.clamp(x + vx, 0.5, LEVEL_LEN - 0.5)
    new_ground = _ground_at(state.heights, new_x)
    new_y = y + vy
    # land on terrain (only when falling onto it)
    landing = (vy <= 0) & (new_y <= new_ground) & (new_ground > 0)
    new_y = torch.where(landing, new_ground, new_y)
    vy = torch.where(landing, 0.0, vy)
    # can't run through a wall higher than current altitude: stay put
    blocked = (new_ground > y + 0.51) & (new_ground > 0)
    new_x = torch.where(blocked, x, new_x)
    new_ground = _ground_at(state.heights, new_x)

    # deaths: fell into a gap below zero, or touched a spike while grounded
    fell = new_y < -0.5
    on_spike = state.spikes.gather(1, _tile(new_x)[:, None])[:, 0] & (
        new_y <= new_ground + 0.1
    )
    # win: reach this level's coin platform
    won = new_x >= state.goal - 0.5
    reward = torch.where(won, COIN_REWARD, 0.0)

    t = state.t + 1
    done = fell | on_spike | won | (t >= MAX_T)

    new_state = State(
        xy=torch.stack([new_x, new_y], dim=1), vy=vy, heights=state.heights,
        spikes=state.spikes, goal=state.goal, t=t,
    )
    # a NEW procedurally generated level every episode
    new_state = auto_reset(done, reset(level), new_state)
    return new_state, render(new_state), reward, done


def render(state: State) -> torch.Tensor:
    """A scrolling viewport centred on the agent: uint8 [B, 84, 84]."""
    h, w = obs_shape
    dev = state.vy.device
    x0 = state.xy[:, 0] - VIEW_TILES / 2
    # world coords of each pixel
    wx = x0[:, None] + (
        (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) * (VIEW_TILES / w)
    )  # [B, W]
    wy = VIEW_H_TILES - (
        (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) * (VIEW_H_TILES / h)
    )  # [H] top-down
    WY = wy[None, :, None]

    tile = wx.to(torch.int32).clamp(0, LEVEL_LEN - 1).long()
    col_h = state.heights.gather(1, tile)[:, None, :]    # [B, 1, W]
    col_spike = state.spikes.gather(1, tile)[:, None, :]

    ground_px = WY <= col_h
    frame = ground_px.to(torch.uint8) * 110
    spike_px = ground_px & col_spike & (WY > col_h - 0.6)
    frame = torch.maximum(frame, spike_px.to(torch.uint8) * 180)

    # coin at this level's goal platform (a one-hot height lookup)
    coin_x = state.goal[:, None, None]
    goal_oh = torch.arange(LEVEL_LEN, device=dev).to(torch.float32) == state.goal[:, None]
    coin_y = (state.heights * goal_oh).sum(1)[:, None, None] + 0.6
    WX = wx[:, None, :]
    coin = (torch.abs(WX - coin_x) <= 0.4) & (torch.abs(WY - coin_y) <= 0.4)
    frame = torch.maximum(frame, coin.to(torch.uint8) * 220)

    # agent
    ax, ay = state.xy[:, 0, None, None], state.xy[:, 1, None, None]
    agent = (torch.abs(WX - ax) <= 0.35) & (torch.abs(WY - (ay + 0.45)) <= 0.45)
    return torch.maximum(frame, agent.to(torch.uint8) * 255)

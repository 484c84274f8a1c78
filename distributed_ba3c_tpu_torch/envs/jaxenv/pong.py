"""Pong on the device, batched over ``[B]`` tensors, in PyTorch.

Port of ``distributed_ba3c_tpu/envs/jaxenv/pong.py`` (it keeps that
module's name so a reader finds its counterpart; it imports no JAX). The
constants, the state fields and the step order are the JAX module's: a
match is first to 21 points, reward +1 when the right (agent) paddle
scores and -1 when the scripted left opponent does; one agent step is
``FRAME_SKIP`` physics substeps, each re-serving after a point, then an
auto-reset when a side reaches 21, then the render. The ALE 6-action map:
{0,1} hold, {2,4} up, {3,5} down.

Every random draw is an input. A serve takes an ``angle ~ U(-0.7, 0.7)``
and a ``jitter ~ U(-0.1, 0.1)``: :func:`step` takes ``noise [B,
FRAME_SKIP + 1, 2]``, one (angle, jitter) pair for each substep's serve
and one for the reset, and :func:`reset` takes ``noise [B, 2]``.
:func:`step_noise` and :func:`reset_noise` (the draw protocol of
``envs/jaxenv/__init__.py``) draw them from a ``torch.Generator`` through
:func:`sample_noise`; a test feeds the draws JAX made from its keys
instead. Everything is branch-free tensor arithmetic (``torch.where``
masks).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from distributed_ba3c_tpu_torch.envs.jaxenv._common import auto_reset, inv32, pixel_grid

num_actions = 6
obs_shape = (84, 84)

# court geometry (unit square; render maps to 84x84)
PADDLE_H = 0.16
PADDLE_W = 0.02
AGENT_X = 0.95  # right paddle (the learner)
OPP_X = 0.05    # left paddle (scripted)
BALL_R = 0.015
PADDLE_SPEED = 0.05   # per substep
OPP_SPEED = 0.035     # scripted opponent max speed (slower => beatable)
BALL_SPEED = 0.04
WIN_SCORE = 21
FRAME_SKIP = 4

#: (low, high) of a serve's two uniform draws: angle, then jitter
NOISE_RANGES = ((-0.7, 0.7), (-0.1, 0.1))

_INV_HALF_PADDLE = inv32(PADDLE_H / 2)


class State(NamedTuple):
    ball_xy: torch.Tensor      # [B, 2] float32
    ball_v: torch.Tensor       # [B, 2] float32
    agent_y: torch.Tensor      # [B] float32
    opp_y: torch.Tensor        # [B] float32
    agent_score: torch.Tensor  # [B] int32
    opp_score: torch.Tensor    # [B] int32
    t: torch.Tensor            # [B] int32 steps in episode


def sample_noise(
    n: int, serves: int, generator: torch.Generator, device
) -> torch.Tensor:
    """``[n, serves, 2]`` float32 serve draws (angle, jitter) from
    ``generator`` (which must live on ``device``)."""
    u = torch.rand((n, serves, 2), generator=generator, device=device)
    lo = torch.tensor([r[0] for r in NOISE_RANGES], device=device)
    hi = torch.tensor([r[1] for r in NOISE_RANGES], device=device)
    return lo + u * (hi - lo)


def step_noise(n: int, generator: torch.Generator, device) -> torch.Tensor:
    """The draws of one :func:`step` of ``n`` envs: ``[n, FRAME_SKIP + 1, 2]``."""
    return sample_noise(n, FRAME_SKIP + 1, generator, device)


def reset_noise(n: int, generator: torch.Generator, device) -> torch.Tensor:
    """The draws of one :func:`reset` of ``n`` envs: ``[n, 2]``."""
    return sample_noise(n, 1, generator, device)[:, 0]


def _serve(noise: torch.Tensor, towards_agent: torch.Tensor):
    """Ball at center, the drawn angle, horizontal direction per the
    server. noise: [B, 2] (angle, jitter) -> (xy [B, 2], v [B, 2])."""
    angle, jitter = noise[:, 0], noise[:, 1]
    vy = BALL_SPEED * torch.sin(angle)
    vx = BALL_SPEED * torch.cos(angle) * torch.where(towards_agent, 1.0, -1.0)
    xy = torch.stack([torch.full_like(jitter, 0.5), 0.5 + jitter], dim=1)
    return xy, torch.stack([vx, vy], dim=1)


def reset(noise: torch.Tensor) -> State:
    """noise: [B, 2] -> a fresh State for B envs."""
    B, dev = noise.shape[0], noise.device
    xy, v = _serve(noise, torch.ones(B, dtype=torch.bool, device=dev))
    half = torch.full((B,), 0.5, dtype=torch.float32, device=dev)
    zero = torch.zeros(B, dtype=torch.int32, device=dev)
    return State(
        ball_xy=xy, ball_v=v, agent_y=half, opp_y=half.clone(),
        agent_score=zero, opp_score=zero.clone(), t=zero.clone(),
    )


def _paddle_bounce(x, y, vx, vy, paddle_x, paddle_y, moving_right: bool):
    """Crossing the paddle plane while vertically aligned reflects vx; the
    deflection angle scales with the contact offset."""
    if moving_right:
        crossing = x >= paddle_x - PADDLE_W
        toward = vx > 0
        bounce_x = paddle_x - PADDLE_W - BALL_R
    else:
        crossing = x <= paddle_x + PADDLE_W
        toward = vx < 0
        bounce_x = paddle_x + PADDLE_W + BALL_R
    aligned = torch.abs(y - paddle_y) <= PADDLE_H / 2 + BALL_R
    hit = crossing & aligned & toward
    offset = (y - paddle_y) * _INV_HALF_PADDLE
    new_vx = torch.where(hit, -vx, vx)
    new_vy = torch.where(hit, BALL_SPEED * 0.9 * offset, vy)
    new_x = torch.where(hit, bounce_x, x)
    return new_x, new_vx, new_vy


def _substep(
    state: State, move: torch.Tensor, noise: torch.Tensor
) -> Tuple[State, torch.Tensor]:
    """One physics tick. move in {-1,0,+1}. Returns (state, point_reward)."""
    lo, hi = PADDLE_H / 2, 1 - PADDLE_H / 2
    agent_y = torch.clamp(state.agent_y + move * PADDLE_SPEED, lo, hi)
    opp_dy = torch.clamp(state.ball_xy[:, 1] - state.opp_y, -OPP_SPEED, OPP_SPEED)
    opp_y = torch.clamp(state.opp_y + opp_dy, lo, hi)

    # ball advance
    xy = state.ball_xy + state.ball_v
    x, y = xy[:, 0], xy[:, 1]
    vx, vy = state.ball_v[:, 0], state.ball_v[:, 1]

    # wall bounce (top/bottom)
    hit_wall = (y < BALL_R) | (y > 1 - BALL_R)
    vy = torch.where(hit_wall, -vy, vy)
    y = torch.clamp(y, BALL_R, 1 - BALL_R)

    x, vx, vy = _paddle_bounce(x, y, vx, vy, AGENT_X, agent_y, True)
    x, vx, vy = _paddle_bounce(x, y, vx, vy, OPP_X, opp_y, False)

    # scoring: ball passes an end wall
    agent_point = x <= 0.0   # opponent missed
    opp_point = x >= 1.0     # agent missed
    scored = (agent_point | opp_point)[:, None]
    reward = torch.where(
        agent_point, 1.0, torch.where(opp_point, -1.0, 0.0)
    )

    # re-serve after a point (loser serves toward the scorer, like ALE)
    serve_xy, serve_v = _serve(noise, towards_agent=opp_point)
    xy = torch.where(scored, serve_xy, torch.stack([x, y], dim=1))
    v = torch.where(scored, serve_v, torch.stack([vx, vy], dim=1))

    return (
        State(
            ball_xy=xy,
            ball_v=v,
            agent_y=agent_y,
            opp_y=opp_y,
            agent_score=state.agent_score + agent_point.to(torch.int32),
            opp_score=state.opp_score + opp_point.to(torch.int32),
            t=state.t,
        ),
        reward,
    )


def _action_to_move(action: torch.Tensor) -> torch.Tensor:
    """ALE 6-action map: 2/4 -> up (-y), 3/5 -> down (+y), else hold."""
    up = (action == 2) | (action == 4)
    down = (action == 3) | (action == 5)
    return torch.where(up, -1.0, torch.where(down, 1.0, 0.0))


def step(
    state: State, action: torch.Tensor, noise: torch.Tensor
) -> Tuple[State, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One agent step = FRAME_SKIP physics substeps (ALE frameskip parity).

    noise: [B, FRAME_SKIP + 1, 2]. Returns (state, obs uint8 [B, 84, 84],
    reward float32 [B], done bool [B]); an env auto-restarts when either
    side reaches WIN_SCORE.
    """
    move = _action_to_move(action)
    reward = torch.zeros_like(state.agent_y)
    for k in range(FRAME_SKIP):
        state, r = _substep(state, move, noise[:, k])
        reward = reward + r
    state = state._replace(t=state.t + 1)

    done = (state.agent_score >= WIN_SCORE) | (state.opp_score >= WIN_SCORE)
    state = auto_reset(done, reset(noise[:, FRAME_SKIP]), state)
    return state, render(state), reward, done


def render(state: State) -> torch.Tensor:
    """Rasterize to uint8 [B, 84, 84] (rows = y, cols = x), by masks."""
    Y, X = pixel_grid(obs_shape, state.agent_y.device)

    def rect(cx, cy, half_w, half_h):
        if isinstance(cx, torch.Tensor):
            cx = cx[:, None, None]
        return (torch.abs(X - cx) <= half_w) & (
            torch.abs(Y - cy[:, None, None]) <= half_h
        )

    ball = rect(state.ball_xy[:, 0], state.ball_xy[:, 1], BALL_R, BALL_R)
    agent = rect(AGENT_X, state.agent_y, PADDLE_W, PADDLE_H / 2)
    opp = rect(OPP_X, state.opp_y, PADDLE_W, PADDLE_H / 2)
    frame = (ball | agent | opp).to(torch.uint8) * 255
    # dim background texture so conv nets see court bounds (walls)
    wall = (Y < 0.02) | (Y > 0.98)
    return torch.maximum(frame, wall.to(torch.uint8) * 80)

"""Assault on the device, batched over ``[B]`` tensors, in PyTorch.

Port of ``distributed_ba3c_tpu/envs/jaxenv/assault.py``: a mothership
cruises the top spawning attackers that descend in three lanes and strafe
toward the player's turret; the turret moves sideways and fires upward.
21 points per attacker, 42 for a mothership hit. Firing heats the cannon:
at the cap it jams until the gauge cools below 0.3 (venting, action up,
cools fast). 4 lives; a bomb hit or an attacker reaching the turret row
costs one. ``FRAME_SKIP`` 4. Actions: 0 noop, 1 fire, 2 up (vent), 3
right, 4 left, 5 right+fire, 6 left+fire.

Draws, per substep (:class:`Raid`): a spawn's Bernoulli(``SPAWN_P``) as
its uniform, the spawn lane ``randint[0, N_LANES)`` and a bomb's
Bernoulli(``BOMB_P``) as its uniform. The reset takes none (``[B, 0]``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from distributed_ba3c_tpu_torch.envs.jaxenv._common import (
    auto_reset,
    full,
    no_draws,
    pixel_grid,
    randint,
    uniform,
)

num_actions = 7
obs_shape = (84, 84)

N_LANES = 3
LANE_X = (0.25, 0.5, 0.75)
MOTHER_Y = 0.08
MOTHER_W = 0.10
MOTHER_SPEED = 0.006
ATTACKER_W = 0.035
ATTACKER_H = 0.025
DESCEND_SPEED = 0.008
STRAFE = 0.006
SPAWN_P = 0.08
PLAYER_Y = 0.93
PLAYER_W = 0.05
PLAYER_SPEED = 0.03
SHOT_SPEED = 0.06
BOMB_SPEED = 0.02
BOMB_P = 0.04
HEAT_PER_SHOT = 0.45   # a few consecutive shot-cycles overheat
COOL = 0.015           # slower than the ~0.45/15-substep firing duty cycle
VENT_COOL = 0.12
LIVES = 4
FRAME_SKIP = 4
MAX_T = 10000

ATTACKER_POINTS = 21.0
MOTHER_POINTS = 42.0


class State(NamedTuple):
    mother_x: torch.Tensor    # [B] float32
    mother_dir: torch.Tensor  # [B] float32
    att_pos: torch.Tensor     # [B, N_LANES, 2] float32 attacker positions
    att_live: torch.Tensor    # [B, N_LANES] bool
    bomb: torch.Tensor        # [B, 2] float32
    bomb_live: torch.Tensor   # [B] bool
    player_x: torch.Tensor    # [B] float32
    shot: torch.Tensor        # [B, 2] float32
    shot_live: torch.Tensor   # [B] bool
    heat: torch.Tensor        # [B] float32 in [0, 1]; >= 1 jams
    jammed: torch.Tensor      # [B] bool
    lives: torch.Tensor       # [B] int32
    t: torch.Tensor           # [B] int32


class Raid(NamedTuple):
    """The draws of a step, per substep."""

    spawn_u: torch.Tensor  # [n, FRAME_SKIP] float32 U(0, 1): a spawn where < SPAWN_P
    lane: torch.Tensor     # [n, FRAME_SKIP] int32 in [0, N_LANES)
    bomb_u: torch.Tensor   # [n, FRAME_SKIP] float32 U(0, 1): a bomb drops where < BOMB_P


def step_noise(n: int, generator: torch.Generator, device) -> Raid:
    return Raid(
        spawn_u=uniform((n, FRAME_SKIP), generator, device),
        lane=randint(0, N_LANES, (n, FRAME_SKIP), generator, device),
        bomb_u=uniform((n, FRAME_SKIP), generator, device),
    )


def reset_noise(n: int, generator: torch.Generator, device) -> torch.Tensor:
    return no_draws(n, device)


def reset(noise: torch.Tensor) -> State:
    """noise: ``[B, 0]`` (the reset draws nothing) -> B fresh games."""
    B, dev = noise.shape[0], noise.device
    lanes = torch.tensor(LANE_X, dtype=torch.float32, device=dev)
    att = torch.stack([lanes, torch.full_like(lanes, MOTHER_Y + 0.05)], dim=-1)
    zero2 = torch.zeros((B, 2), dtype=torch.float32, device=dev)
    no = torch.zeros(B, dtype=torch.bool, device=dev)
    return State(
        mother_x=full(B, 0.5, torch.float32, dev),
        mother_dir=full(B, 1.0, torch.float32, dev),
        att_pos=att.expand(B, -1, -1).clone(),
        att_live=torch.zeros((B, N_LANES), dtype=torch.bool, device=dev),
        bomb=zero2, bomb_live=no, player_x=full(B, 0.5, torch.float32, dev),
        shot=zero2.clone(), shot_live=no.clone(),
        heat=torch.zeros(B, dtype=torch.float32, device=dev), jammed=no.clone(),
        lives=full(B, LIVES, torch.int32, dev),
        t=torch.zeros(B, dtype=torch.int32, device=dev),
    )


def _substep(state: State, move, fire, vent, spawn_u, lane, bomb_u):
    dev = move.device
    player_x = torch.clamp(
        state.player_x + move * PLAYER_SPEED, PLAYER_W, 1 - PLAYER_W
    )

    # mothership patrol
    mother_x = state.mother_x + state.mother_dir * MOTHER_SPEED
    bounce = (mother_x > 1 - MOTHER_W) | (mother_x < MOTHER_W)
    mother_dir = torch.where(bounce, -state.mother_dir, state.mother_dir)
    mother_x = torch.clamp(mother_x, MOTHER_W, 1 - MOTHER_W)

    # spawn an attacker in a random free lane, dropping from the mothership
    lane_oh = torch.arange(N_LANES, device=dev) == lane[:, None]      # [B, N_LANES]
    can = ~(state.att_live & lane_oh).any(1)
    spawn = (spawn_u < SPAWN_P) & can
    spawn_oh = lane_oh & spawn[:, None]
    drop_at = torch.stack([mother_x, torch.full_like(mother_x, MOTHER_Y + 0.05)], dim=1)
    att_pos = torch.where(spawn_oh[:, :, None], drop_at[:, None, :], state.att_pos)
    att_live = state.att_live | spawn_oh

    # attackers descend and strafe toward the player
    dx = torch.sign(player_x[:, None] - att_pos[..., 0]) * STRAFE
    att_pos = torch.stack([
        att_pos[..., 0] + torch.where(att_live, dx, 0.0),
        att_pos[..., 1] + torch.where(att_live, DESCEND_SPEED, 0.0),
    ], dim=2)

    # cannon heat: venting (action up) cools fast; a jam persists until the
    # gauge cools below 0.3, and trips when a shot pushes it to the cap
    heat = torch.clamp(state.heat - torch.where(vent, VENT_COOL, COOL), min=0.0)
    jammed = state.jammed & (heat > 0.3)
    can_fire = fire & ~state.shot_live & ~jammed
    heat = heat + torch.where(can_fire, HEAT_PER_SHOT, 0.0)
    jammed = jammed | (heat >= 1.0)
    heat = torch.clamp(heat, max=1.0)

    shot = torch.where(
        can_fire[:, None],
        torch.stack([player_x, torch.full_like(player_x, PLAYER_Y - 0.03)], dim=1),
        state.shot,
    )
    flying = state.shot_live | can_fire
    shot = torch.stack(
        [shot[:, 0], shot[:, 1] + torch.where(flying, -SHOT_SPEED, 0.0)], dim=1
    )
    shot_live = flying & (shot[:, 1] > 0.0)

    # shot vs attackers
    hit_att = (
        att_live
        & shot_live[:, None]
        & (torch.abs(att_pos[..., 0] - shot[:, 0, None]) <= ATTACKER_W)
        & (torch.abs(att_pos[..., 1] - shot[:, 1, None]) <= ATTACKER_H)
    )
    reward = hit_att.sum(1).to(torch.float32) * ATTACKER_POINTS
    att_live = att_live & ~hit_att
    shot_live = shot_live & ~hit_att.any(1)

    # shot vs mothership
    hit_mom = (
        shot_live
        & (torch.abs(mother_x - shot[:, 0]) <= MOTHER_W)
        & (shot[:, 1] <= MOTHER_Y + 0.02)
    )
    reward = reward + torch.where(hit_mom, MOTHER_POINTS, 0.0)
    shot_live = shot_live & ~hit_mom

    # bombs from the first live attacker (a one-hot contraction)
    first = att_live.to(torch.int32).argmax(1)
    src_oh = (torch.arange(N_LANES, device=dev) == first[:, None]).to(torch.float32)
    src_pos = (att_pos * src_oh[:, :, None]).sum(1)
    drop = (bomb_u < BOMB_P) & att_live.any(1) & ~state.bomb_live
    bomb = torch.where(drop[:, None], src_pos, state.bomb)
    falling = state.bomb_live | drop
    bomb = torch.stack(
        [bomb[:, 0], bomb[:, 1] + torch.where(falling, BOMB_SPEED, 0.0)], dim=1
    )
    bomb_live = falling & (bomb[:, 1] < 1.0)

    # hits on the player: bomb, or an attacker reaching the turret row
    bomb_hit = (
        bomb_live
        & (torch.abs(bomb[:, 0] - player_x) <= PLAYER_W)
        & (bomb[:, 1] >= PLAYER_Y - 0.02)
    )
    reached = att_live & (att_pos[..., 1] >= PLAYER_Y - 0.02)
    lives = state.lives - (bomb_hit | reached.any(1)).to(torch.int32)
    bomb_live = bomb_live & ~bomb_hit
    att_live = att_live & ~reached

    return State(
        mother_x=mother_x, mother_dir=mother_dir, att_pos=att_pos,
        att_live=att_live, bomb=bomb, bomb_live=bomb_live,
        player_x=player_x, shot=shot, shot_live=shot_live, heat=heat,
        jammed=jammed, lives=lives, t=state.t,
    ), reward


def step(state: State, action: torch.Tensor, noise: Raid):
    """One agent step = FRAME_SKIP substeps. Returns (state, obs uint8 [B,
    84, 84], reward float32 [B], done bool [B])."""
    move = torch.where(
        (action == 3) | (action == 5), 1.0,
        torch.where((action == 4) | (action == 6), -1.0, 0.0),
    )
    fire = (action == 1) | (action == 5) | (action == 6)
    vent = action == 2
    reward = torch.zeros_like(state.player_x)
    for k in range(FRAME_SKIP):
        state, r = _substep(state, move, fire, vent, noise.spawn_u[:, k],
                            noise.lane[:, k], noise.bomb_u[:, k])
        reward = reward + r
    state = state._replace(t=state.t + 1)

    done = (state.lives <= 0) | (state.t >= MAX_T)
    state = auto_reset(done, reset(no_draws(done.shape[0], done.device)), state)
    return state, render(state), reward, done


def render(state: State) -> torch.Tensor:
    Y, X = pixel_grid(obs_shape, state.player_x.device)

    def col(v):  # [B] -> [B, 1, 1]
        return v[:, None, None]

    mother = (torch.abs(X - col(state.mother_x)) <= MOTHER_W) & (
        torch.abs(Y - MOTHER_Y) <= 0.02
    )
    atts = torch.zeros_like(mother)
    for i in range(N_LANES):
        atts = atts | (
            col(state.att_live[:, i])
            & (torch.abs(X - col(state.att_pos[:, i, 0])) <= ATTACKER_W)
            & (torch.abs(Y - col(state.att_pos[:, i, 1])) <= ATTACKER_H)
        )
    player = (torch.abs(X - col(state.player_x)) <= PLAYER_W) & (
        torch.abs(Y - PLAYER_Y) <= 0.02
    )
    shot = (
        col(state.shot_live)
        & (torch.abs(X - col(state.shot[:, 0])) <= 0.006)
        & (torch.abs(Y - col(state.shot[:, 1])) <= 0.015)
    )
    bomb = (
        col(state.bomb_live)
        & (torch.abs(X - col(state.bomb[:, 0])) <= 0.008)
        & (torch.abs(Y - col(state.bomb[:, 1])) <= 0.012)
    )
    # heat gauge strip on the right edge; full height = jammed
    gauge = (X > 0.97) & (Y > 1.0 - col(state.heat))

    frame = (player | shot).to(torch.uint8) * 255
    frame = torch.maximum(frame, mother.to(torch.uint8) * 200)
    frame = torch.maximum(frame, atts.to(torch.uint8) * 160)
    frame = torch.maximum(frame, bomb.to(torch.uint8) * 120)
    return torch.maximum(frame, gauge.to(torch.uint8) * 90)

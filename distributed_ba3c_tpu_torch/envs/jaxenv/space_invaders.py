"""Space Invaders on the device, batched over ``[B]`` tensors, in PyTorch.

Port of ``distributed_ba3c_tpu/envs/jaxenv/space_invaders.py``: a 6x6
alien grid marching sideways and descending a row at each edge, rows worth
30, 25, 20, 15, 10, 5 from the top, one player shot in flight, up to 3
alien bombs, 3 lives; the episode ends when the lives run out or the fleet
lands, and a cleared fleet respawns one step lower. ``FRAME_SKIP`` 4.
Actions: 0 noop, 1 fire, 2 right, 3 left, 4 right+fire, 5 left+fire.

Draws, per substep (:class:`Bombs`): the column a bomb may drop from,
``randint[0, COLS)``, and the drop's Bernoulli(``BOMB_P``) as its
uniform. The reset takes none (``[B, 0]``). The lookups are uniform-grid
arithmetic and one-hot masks, as in the JAX module.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from distributed_ba3c_tpu_torch.envs.jaxenv._common import (
    auto_reset,
    full,
    inv32,
    no_draws,
    pixel_grid,
    randint,
    rows,
    uniform,
)

num_actions = 6
obs_shape = (84, 84)

ROWS, COLS = 6, 6
ALIEN_W = 0.07       # half-extent of an alien cell hitbox (x)
ALIEN_H = 0.03       # half-extent (y)
GRID_DX = 0.11       # horizontal spacing between alien columns
GRID_DY = 0.07       # vertical spacing between alien rows
MARCH_SPEED = 0.004
DESCEND = 0.05
PLAYER_Y = 0.93
PLAYER_W = 0.05
PLAYER_SPEED = 0.03
SHOT_SPEED = 0.05
BOMB_SPEED = 0.025
BOMB_P = 0.06        # per-substep probability a bomb drops
N_BOMBS = 3
LIVES = 3
FRAME_SKIP = 4
MAX_T = 10000

# points by row, TOP row first (ALE: bottom row 5 ... top row 30)
ROW_POINTS = (30.0, 25.0, 20.0, 15.0, 10.0, 5.0)

_INV_GRID_DX = inv32(GRID_DX)
_INV_GRID_DY = inv32(GRID_DY)
_INV_CELLS = inv32(ROWS * COLS)


class State(NamedTuple):
    aliens: torch.Tensor      # [B, ROWS, COLS] bool
    origin: torch.Tensor      # [B, 2] float32 top-left alien center (x, y)
    dir: torch.Tensor         # [B] float32 march direction (+1/-1)
    player_x: torch.Tensor    # [B] float32
    shot: torch.Tensor        # [B, 2] float32 player shot position
    shot_live: torch.Tensor   # [B] bool
    bombs: torch.Tensor       # [B, N_BOMBS, 2] float32
    bombs_live: torch.Tensor  # [B, N_BOMBS] bool
    lives: torch.Tensor       # [B] int32
    t: torch.Tensor           # [B] int32


class Bombs(NamedTuple):
    """The draws of a step, per substep."""

    col: torch.Tensor     # [n, FRAME_SKIP] int32 in [0, COLS)
    drop_u: torch.Tensor  # [n, FRAME_SKIP] float32 U(0, 1): a bomb drops where < BOMB_P


def step_noise(n: int, generator: torch.Generator, device) -> Bombs:
    return Bombs(
        col=randint(0, COLS, (n, FRAME_SKIP), generator, device),
        drop_u=uniform((n, FRAME_SKIP), generator, device),
    )


def reset_noise(n: int, generator: torch.Generator, device) -> torch.Tensor:
    return no_draws(n, device)


def reset(noise: torch.Tensor) -> State:
    """noise: ``[B, 0]`` (the reset draws nothing) -> B fresh games."""
    B, dev = noise.shape[0], noise.device
    return State(
        aliens=torch.ones((B, ROWS, COLS), dtype=torch.bool, device=dev),
        origin=rows(B, [0.18, 0.12], torch.float32, dev),
        dir=full(B, 1.0, torch.float32, dev),
        player_x=full(B, 0.5, torch.float32, dev),
        shot=torch.zeros((B, 2), dtype=torch.float32, device=dev),
        shot_live=torch.zeros(B, dtype=torch.bool, device=dev),
        bombs=torch.zeros((B, N_BOMBS, 2), dtype=torch.float32, device=dev),
        bombs_live=torch.zeros((B, N_BOMBS), dtype=torch.bool, device=dev),
        lives=full(B, LIVES, torch.int32, dev),
        t=torch.zeros(B, dtype=torch.int32, device=dev),
    )


def _alien_centers(origin: torch.Tensor):
    """``(cx [B, COLS], cy [B, ROWS])`` world positions of the grid."""
    dev = origin.device
    cx = origin[:, 0, None] + torch.arange(COLS, dtype=torch.float32, device=dev) * GRID_DX
    cy = origin[:, 1, None] + torch.arange(ROWS, dtype=torch.float32, device=dev) * GRID_DY
    return cx, cy


def _substep(state: State, move, fire, bomb_col, drop_u):
    dev = move.device
    player_x = torch.clamp(
        state.player_x + move * PLAYER_SPEED, PLAYER_W, 1 - PLAYER_W
    )

    # fleet march: speed scales up as the fleet thins (classic cadence)
    n_alive = state.aliens.flatten(1).sum(1).to(torch.float32)
    speed = MARCH_SPEED * (1.0 + 2.0 * (1.0 - n_alive * _INV_CELLS))
    cx, cy = _alien_centers(state.origin)
    col_alive = state.aliens.any(1)  # [B, COLS]
    # extreme live columns decide the edge bounce
    left = torch.where(col_alive, cx, float("inf")).amin(1)
    right = torch.where(col_alive, cx, float("-inf")).amax(1)
    hit_edge = ((right + ALIEN_W >= 0.98) & (state.dir > 0)) | (
        (left - ALIEN_W <= 0.02) & (state.dir < 0)
    )
    new_dir = torch.where(hit_edge, -state.dir, state.dir)
    march = torch.stack([speed * state.dir, torch.zeros_like(speed)], dim=1)
    descend = torch.tensor([0.0, DESCEND], dtype=torch.float32, device=dev)
    origin = state.origin + torch.where(hit_edge[:, None], descend, march)

    # player shot: launch if idle and firing; fly upward
    launch = fire & ~state.shot_live
    shot = torch.where(
        launch[:, None],
        torch.stack([player_x, torch.full_like(player_x, PLAYER_Y - 0.03)], dim=1),
        state.shot,
    )
    flying = state.shot_live | launch
    shot = torch.stack(
        [shot[:, 0], shot[:, 1] + torch.where(flying, -SHOT_SPEED, 0.0)], dim=1
    )
    shot_live = flying & (shot[:, 1] > 0.0)

    # shot vs fleet: the nearest grid cell by arithmetic, one-hot masks
    colf = torch.round((shot[:, 0] - origin[:, 0]) * _INV_GRID_DX).clamp(0.0, COLS - 1.0)
    rowf = torch.round((shot[:, 1] - origin[:, 1]) * _INV_GRID_DY).clamp(0.0, ROWS - 1.0)
    cx_near = origin[:, 0] + colf * GRID_DX
    cy_near = origin[:, 1] + rowf * GRID_DY
    in_cell = (
        (torch.abs(cx_near - shot[:, 0]) <= ALIEN_W)
        & (torch.abs(cy_near - shot[:, 1]) <= ALIEN_H)
        & shot_live
    )
    row_oh = torch.arange(ROWS, device=dev) == rowf.to(torch.int32)[:, None]  # [B, ROWS]
    col_oh = torch.arange(COLS, device=dev) == colf.to(torch.int32)[:, None]  # [B, COLS]
    cell = row_oh[:, :, None] & col_oh[:, None, :]                           # [B, ROWS, COLS]
    hit = in_cell & (state.aliens & cell).flatten(1).any(1)
    points = torch.tensor(ROW_POINTS, dtype=torch.float32, device=dev)
    reward = torch.where(hit, (points * row_oh).sum(1), 0.0)
    aliens = state.aliens & ~(cell & hit[:, None, None])
    shot_live = shot_live & ~hit

    # bombs: lowest live alien of a random column may drop one
    bcol_oh = torch.arange(COLS, device=dev) == bomb_col[:, None]           # [B, COLS]
    alien_col = (aliens & bcol_oh[:, None, :]).any(2)                      # [B, ROWS]
    col_has = alien_col.any(1)
    low_row = torch.where(alien_col, torch.arange(ROWS, device=dev), -1).amax(1)
    drop = (drop_u < BOMB_P) & col_has & ~state.bombs_live.all(1)
    # the first free slot (argmin of a bool takes the first False)
    slot = (~state.bombs_live).to(torch.int32).argmax(1)
    slot_oh = torch.arange(N_BOMBS, device=dev) == slot[:, None]
    new_bomb = torch.stack([
        origin[:, 0] + bomb_col.to(torch.float32) * GRID_DX,
        origin[:, 1] + low_row.to(torch.float32) * GRID_DY + ALIEN_H,
    ], dim=1)
    place = slot_oh & drop[:, None]
    bombs = torch.where(place[:, :, None], new_bomb[:, None, :], state.bombs)
    bombs_live = state.bombs_live | place
    bombs = torch.stack(
        [bombs[..., 0], bombs[..., 1] + torch.where(bombs_live, BOMB_SPEED, 0.0)], dim=2
    )

    # bombs vs player
    hit_player = (
        bombs_live
        & (torch.abs(bombs[..., 0] - player_x[:, None]) <= PLAYER_W)
        & (bombs[..., 1] >= PLAYER_Y - 0.02)
    )
    lives = state.lives - hit_player.any(1).to(torch.int32)
    bombs_live = bombs_live & ~hit_player & (bombs[..., 1] < 1.0)

    # fleet landed -> all lives lost (game over); the POST-march rows, so
    # an edge-descend triggers it this substep
    _, cy_post = _alien_centers(origin)
    landed = (aliens & ((cy_post + ALIEN_H) >= PLAYER_Y - 0.02)[:, :, None]).flatten(1).any(1)
    lives = torch.where(landed, 0, lives)

    # wave cleared -> fresh fleet, slightly lower start
    cleared = ~aliens.flatten(1).any(1)
    aliens = aliens | cleared[:, None, None]
    lower = torch.tensor([0.18, 0.16], dtype=torch.float32, device=dev)
    origin = torch.where(cleared[:, None], lower, origin)

    return State(
        aliens=aliens, origin=origin, dir=new_dir, player_x=player_x,
        shot=shot, shot_live=shot_live, bombs=bombs, bombs_live=bombs_live,
        lives=lives, t=state.t,
    ), reward


def step(state: State, action: torch.Tensor, noise: Bombs):
    """One agent step = FRAME_SKIP substeps; auto-restarts on done.
    Returns (state, obs uint8 [B, 84, 84], reward float32 [B], done bool
    [B])."""
    move = torch.where(
        (action == 2) | (action == 4), 1.0,
        torch.where((action == 3) | (action == 5), -1.0, 0.0),
    )
    fire = (action == 1) | (action == 4) | (action == 5)
    reward = torch.zeros_like(state.player_x)
    for k in range(FRAME_SKIP):
        state, r = _substep(state, move, fire, noise.col[:, k], noise.drop_u[:, k])
        reward = reward + r
    state = state._replace(t=state.t + 1)

    done = (state.lives <= 0) | (state.t >= MAX_T)
    state = auto_reset(done, reset(no_draws(done.shape[0], done.device)), state)
    return state, render(state), reward, done


def render(state: State) -> torch.Tensor:
    Y, X = pixel_grid(obs_shape, state.player_x.device)
    ys, xs = Y[0, :, 0], X[0, 0]

    cx, cy = _alien_centers(state.origin)
    # the fleet raster is separable: in_alien = rowhit @ aliens @ colhit^T
    rowhit = torch.abs(ys[None, :, None] - cy[:, None, :]) <= ALIEN_H   # [B, h, ROWS]
    colhit = torch.abs(xs[None, :, None] - cx[:, None, :]) <= ALIEN_W   # [B, w, COLS]
    m = torch.bmm(rowhit.to(torch.float32), state.aliens.to(torch.float32))
    in_alien = torch.bmm(m, colhit.to(torch.float32).transpose(1, 2)) > 0.0  # [B, h, w]

    def col(v):  # [B] -> [B, 1, 1]
        return v[:, None, None]

    player = (torch.abs(X - col(state.player_x)) <= PLAYER_W) & (
        torch.abs(Y - PLAYER_Y) <= 0.02
    )
    shot = (
        col(state.shot_live)
        & (torch.abs(X - col(state.shot[:, 0])) <= 0.006)
        & (torch.abs(Y - col(state.shot[:, 1])) <= 0.015)
    )
    bombs = torch.zeros_like(player)
    for i in range(N_BOMBS):
        bombs = bombs | (
            col(state.bombs_live[:, i])
            & (torch.abs(X - col(state.bombs[:, i, 0])) <= 0.006)
            & (torch.abs(Y - col(state.bombs[:, i, 1])) <= 0.015)
        )
    frame = (player | shot).to(torch.uint8) * 255
    frame = torch.maximum(frame, in_alien.to(torch.uint8) * 180)
    return torch.maximum(frame, bombs.to(torch.uint8) * 120)

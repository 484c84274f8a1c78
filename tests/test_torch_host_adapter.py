"""The port's host player for the on-device games
(distributed_ba3c_tpu_torch/envs/jaxenv/host_adapter.py) held against the
JAX package's (distributed_ba3c_tpu/envs/jaxenv/host_adapter.py).

The JAX adapter keeps one key: ``reset(PRNGKey(idx))`` at start, then
``key, k = split(key)`` before every step and every restart. The port's
player takes its draws from a draw source (a seeded CPU generator by
default); here :class:`AdapterReplay` makes them from the JAX adapter's
key chain (``jax_step_noise``/``jax_reset_noise`` of
tests/test_torch_games.py), so both players roll one trajectory: the
stacked frames, rewards and dones must be equal at every step.

A spawned simulator child builds and steps a player on the CPU and never
initializes CUDA; the module imports no torch until a player is built.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from distributed_ba3c_tpu.envs.jaxenv.host_adapter import build_jax_player as jax_build_jax_player
from distributed_ba3c_tpu_torch import cli
from distributed_ba3c_tpu_torch.envs import jaxenv
from distributed_ba3c_tpu_torch.envs.jaxenv.host_adapter import build_jax_player
from test_torch_games import jax_reset_noise, jax_step_noise

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class AdapterReplay:
    """The JAX adapter's draws for player ``idx``: its first reset takes
    ``PRNGKey(idx)`` itself, every later step or restart a fresh split."""

    def __init__(self, game: str, idx: int):
        self.game = game
        self.key = jax.random.PRNGKey(idx)
        self.started = False

    def _next(self):
        self.key, k = jax.random.split(self.key)
        return k

    def reset_noise(self, n, device):
        k = self._next() if self.started else self.key
        self.started = True
        return jax_reset_noise(self.game, k[None])

    def env_noise(self, n, device):
        return jax_step_noise(self.game, self._next()[None])


@pytest.mark.parametrize("game", jaxenv.GAMES)
def test_player_matches_the_jax_adapter(game):
    idx = 3
    ref = jax_build_jax_player(idx, game, 4)
    got = build_jax_player(idx, game, 4, draws=AdapterReplay(game, idx))
    assert got.get_action_space_size() == ref.get_action_space_size()
    rng = np.random.default_rng(0)
    for t in range(40):
        s_ref, s_got = ref.current_state(), got.current_state()
        assert s_got.dtype == np.uint8 and s_got.shape == (84, 84, 4)
        np.testing.assert_array_equal(s_got, s_ref, err_msg=f"{game} step {t}")
        a = int(rng.integers(0, got.get_action_space_size()))
        assert got.action(a) == ref.action(a), (game, t)
        if t == 20:  # a restart mid-episode takes the next split on both
            ref.restart_episode()
            got.restart_episode()
    np.testing.assert_array_equal(got.current_state(), ref.current_state())


def test_default_player_is_seeded_by_its_index():
    a, b, c = (build_jax_player(i, "coinrun") for i in (5, 5, 6))
    for _ in range(10):
        assert a.action(4) == b.action(4)
        c.action(4)
    assert np.array_equal(a.current_state(), b.current_state())
    # another index generates another level
    assert not np.array_equal(a.player.state.heights.numpy(), c.player.state.heights.numpy())


def test_player_reports_finished_episodes():
    player = build_jax_player(0, "qbert")
    for _ in range(40):  # up-right from the top hops off: 3 lives, 3 hops
        _, over = player.action(1)
        if over:
            break
    assert over
    assert player.stats["score"], player.stats


def _child(conn, game):
    import torch

    from distributed_ba3c_tpu_torch.envs.jaxenv.host_adapter import build_jax_player

    player = build_jax_player(1, game)
    for _ in range(5):
        player.action(1)
    conn.send((player.current_state().shape, torch.cuda.is_initialized(),
               torch.get_num_threads()))
    conn.close()


def test_spawned_child_steps_a_player_and_leaves_cuda_uninitialized():
    ctx = mp.get_context("spawn")
    parent, child = ctx.Pipe()
    p = ctx.Process(target=_child, args=(child, "breakout"))
    p.start()
    assert parent.poll(120), "the child sent nothing"
    shape, cuda_initialized, threads = parent.recv()
    p.join(30)
    assert not p.is_alive() and p.exitcode == 0
    assert shape == (84, 84, 4)
    assert cuda_initialized is False
    assert threads == 1  # a fleet of children shares the host's cores


def test_module_imports_no_torch():
    code = ("import sys; import distributed_ba3c_tpu_torch.envs.jaxenv.host_adapter; "
            "print('torch' in sys.modules)")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=60, cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "False"


@pytest.mark.parametrize("task", ["eval", "play"])
def test_eval_and_play_run_a_jax_game(task, capsys):
    assert cli.main(["--task", task, "--env", "jax:breakout", "--fc_units", "16",
                     "--nr_eval", "2", "--max_steps", "30", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert ("mean_score=" in out) if task == "eval" else ("episode 1 finished" in out)

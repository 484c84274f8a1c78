"""The port's on-device game set (distributed_ba3c_tpu_torch/envs/jaxenv/)
held against the JAX package's games (distributed_ba3c_tpu/envs/jaxenv/).

JAX's random streams are not reproduced in torch, so the draws are made
here from the JAX keys, with the same ``split`` structure as each JAX
game's ``step``/``reset``, and handed to the port (``jax_step_noise``,
``jax_reset_noise``): a Bernoulli draw as the uniform JAX compares with p
(``bernoulli(k, p, s) == uniform(k, s) < p``, guarded below), a
``randint`` draw as JAX's own integer. :class:`GameReplay` replays a whole
fused rollout step the same way.

Rendered frames, rewards, dones and every discrete state field must be
equal; float state fields agree within ``FLOAT_TOL``. They are not
bit-equal: XLA contracts a product and a sum into one fused multiply-add
(``origin + arange * GRID_DX``, ``BRICK_TOP + row * BRICK_H``), which the
port's separate float32 operations round once more, and breakout's launch
takes the cos and sin of float64 (XLA's float32 ones are an ulp off on
some arguments). Over these horizons no comparison flips.
"""

from __future__ import annotations

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_ba3c_tpu.envs import jaxenv as jenvs
from distributed_ba3c_tpu_torch.envs import jaxenv

FLOAT_TOL = 1e-5
NEW_GAMES = ("breakout", "coinrun", "seaquest", "qbert", "space_invaders",
             "boxing", "assault")


def _split_substeps(key, fn, n_substeps):
    """``fn`` over the first ``n_substeps`` of ``split(key, n + 1)``,
    stacked on axis 0 (a scan over the substep keys)."""
    keys = jax.random.split(key, n_substeps + 1)
    return jax.vmap(fn)(keys[:n_substeps])


# -- each game's draws from one key, as its step / reset make them ----------

def _breakout_step(key):
    return (_split_substeps(key, lambda k: jax.random.uniform(
        k, (), minval=0.25 * jnp.pi, maxval=0.75 * jnp.pi), 4),)


def _coinrun_level(key):
    k1, k2, k3, k4, k5 = jax.random.split(key, 5)
    L = jenvs.coinrun.LEVEL_LEN
    return (
        jax.random.randint(k4, (), 6, L - 1),
        jax.random.uniform(k5, (), minval=0.0, maxval=1.0),
        jax.random.randint(k1, (L,), -1, 2),
        jax.random.uniform(k2, (L,)),
        jax.random.uniform(k3, (L,)),
    )


def _seaquest_reset(key):
    k1, k2 = jax.random.split(key)
    n = jenvs.seaquest.N_LANES
    return jax.random.uniform(k1, (n,)), jax.random.uniform(k2, (n,))


def _seaquest_step(key):
    return _seaquest_reset(jax.random.split(key, jenvs.seaquest.FRAME_SKIP + 1)[-1])


def _qbert_step(key):
    k_ball, _ = jax.random.split(key)
    return (jax.random.uniform(k_ball, ()),)


def _space_invaders_sub(k):
    k_bomb, k_col = jax.random.split(k)
    return (jax.random.randint(k_bomb, (), 0, jenvs.space_invaders.COLS),
            jax.random.uniform(k_col))


def _boxing_sub(k):
    k_side, k_punch = jax.random.split(k)
    return jax.random.uniform(k_side, (2,)), jax.random.uniform(k_punch)


def _assault_sub(k):
    k_spawn, k_lane, k_bomb = jax.random.split(k, 3)
    return (jax.random.uniform(k_spawn),
            jax.random.randint(k_lane, (), 0, jenvs.assault.N_LANES),
            jax.random.uniform(k_bomb))


def _pong_serve(key):
    k1, k2 = jax.random.split(key)
    return jnp.stack([jax.random.uniform(k1, (), minval=-0.7, maxval=0.7),
                      jax.random.uniform(k2, (), minval=-0.1, maxval=0.1)])


def _none(key):
    return ()


#: game -> (step draws of one key, reset draws of one key, the port's
#: NamedTuple of them, if it has one)
_DRAWS = {
    "pong": (lambda k: (jax.vmap(_pong_serve)(jax.random.split(k, 5)),),
             lambda k: (_pong_serve(k),), None),
    "breakout": (_breakout_step, _none, None),
    "coinrun": (_coinrun_level, _coinrun_level, "Level"),
    "seaquest": (_seaquest_step, _seaquest_reset, "Spawn"),
    "qbert": (_qbert_step, _none, None),
    "space_invaders": (lambda k: _split_substeps(k, _space_invaders_sub, 4), _none, "Bombs"),
    "boxing": (lambda k: _split_substeps(k, _boxing_sub, 4), _none, "Jabs"),
    "assault": (lambda k: _split_substeps(k, _assault_sub, 4), _none, "Raid"),
}

_jitted = {}


def _to_port(game: str, arrays, n: int):
    port = jaxenv.get_env(game)
    ts = [torch.from_numpy(np.array(a)) for a in arrays]
    cls = _DRAWS[game][2]
    if not ts:  # draws nothing
        return torch.zeros((n, 0), dtype=torch.float32)
    return ts[0] if cls is None else getattr(port, cls)(*ts)


def jax_step_noise(game: str, keys):
    """[B] keys -> the port's draws of one ``step`` of B envs, as JAX's
    ``vmap(game.step)(state, action, keys)`` draws them."""
    fn = _jitted.setdefault(("step", game), jax.jit(jax.vmap(_DRAWS[game][0])))
    return _to_port(game, fn(keys), keys.shape[0])


def jax_reset_noise(game: str, keys):
    """[B] keys -> the port's draws of ``reset`` of B envs."""
    fn = _jitted.setdefault(("reset", game), jax.jit(jax.vmap(_DRAWS[game][1])))
    return _to_port(game, fn(keys), keys.shape[0])


def to_torch(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def state_to_torch(game: str, js):
    port = jaxenv.get_env(game)
    return port.State(*(to_torch(getattr(js, f)) for f in port.State._fields))


class GameReplay:
    """A draw source that replays a JAX rollout's key tree for ``game``:
    each rollout step splits ``key`` into (key, k_act, k_env) as JAX's
    ``make_rollout_body`` does; Gumbel noise comes from ``k_act`` and the
    env's draws from ``split(k_env, B)``."""

    def __init__(self, key, game: str):
        self.key = key
        self.game = game

    def action_noise(self, shape, device):
        self.key, k_act, self.k_env = jax.random.split(self.key, 3)
        return to_torch(jax.random.gumbel(k_act, tuple(shape))).to(device)

    def env_noise(self, n, device):
        return jax_step_noise(self.game, jax.random.split(self.k_env, n))

    def reset_noise(self, n, device):
        raise AssertionError("a replayed rollout resets inside env.step only")


def assert_states_close(game, js, ts, where):
    port = jaxenv.get_env(game)
    for f in port.State._fields:
        a, b = np.asarray(getattr(js, f)), getattr(ts, f).numpy()
        assert a.dtype == b.dtype, (where, f, a.dtype, b.dtype)
        assert a.shape == b.shape, (where, f, a.shape, b.shape)
        if np.issubdtype(a.dtype, np.floating):
            np.testing.assert_allclose(b, a, rtol=0, atol=FLOAT_TOL, err_msg=f"{where}: {f}")
        else:
            np.testing.assert_array_equal(b, a, err_msg=f"{where}: {f}")


def _jax_step(game):
    return _jitted.setdefault(("env", game), jax.jit(jax.vmap(jenvs.get_env(game).step)))


def reset_both(game, key, B):
    jgame, port = jenvs.get_env(game), jaxenv.get_env(game)
    keys = jax.random.split(key, B)
    js = jax.jit(jax.vmap(jgame.reset))(keys)
    ts = port.reset(jax_reset_noise(game, keys))
    assert_states_close(game, js, ts, "reset")
    np.testing.assert_array_equal(
        port.render(ts).numpy(), np.asarray(jax.jit(jax.vmap(jgame.render))(js))
    )
    return js, ts


def run_both(game, js, ts, key, n_steps, seed, actions=None):
    """Step both with the same numpy-random actions and the same draws;
    frames, rewards and dones must be equal at every step."""
    port = jaxenv.get_env(game)
    rng = np.random.default_rng(seed)
    jstep = _jax_step(game)
    B = js.t.shape[0]
    resets, total = 0, 0.0
    for t in range(n_steps):
        a = (rng.integers(0, port.num_actions, B) if actions is None
             else np.full(B, actions)).astype(np.int32)
        key, k = jax.random.split(key)
        keys = jax.random.split(k, B)
        js, jobs, jr, jd = jstep(js, jnp.asarray(a), keys)
        ts, tobs, tr, td = port.step(ts, torch.from_numpy(a), jax_step_noise(game, keys))
        where = f"{game} step {t}"
        assert tobs.dtype == torch.uint8 and tobs.shape == (B, 84, 84)
        assert tr.dtype == torch.float32 and td.dtype == torch.bool
        np.testing.assert_array_equal(tobs.numpy(), np.asarray(jobs), err_msg=where)
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr), err_msg=where)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd), err_msg=where)
        assert_states_close(game, js, ts, where)
        resets += int(td.sum())
        total += float(tr.sum())
    return js, ts, resets, total


# -- the draw replay's guards ------------------------------------------------

@pytest.mark.parametrize("p", [0.5, 0.06, 0.25])
def test_jax_bernoulli_is_a_uniform_below_p(p):
    """The guard on the replay: a Bernoulli draw is the uniform of the same
    key compared with p, for a Python p and an array p (CoinRun's
    ``GAP_P * diff``)."""
    for k in jax.random.split(jax.random.PRNGKey(11), 4):
        u = jax.random.uniform(k, (64,))
        np.testing.assert_array_equal(jax.random.bernoulli(k, p, (64,)), u < p)
        pa = jnp.float32(0.12) * jax.random.uniform(jax.random.PRNGKey(3))
        np.testing.assert_array_equal(jax.random.bernoulli(k, pa, (64,)), u < pa)
    k = jax.random.PRNGKey(5)
    assert bool(jax.random.bernoulli(k, 0.5)) == bool(jax.random.uniform(k) < 0.5)


# -- per game ---------------------------------------------------------------

def _constants(mod):
    return {k: v for k, v in vars(mod).items()
            if k.isupper() and not k.startswith("_")
            and isinstance(v, (int, float, tuple, jax.Array))}


@pytest.mark.parametrize("game", NEW_GAMES)
def test_constants_and_fields_match_the_jax_module(game):
    jgame, port = jenvs.get_env(game), jaxenv.get_env(game)
    assert port.num_actions == jgame.num_actions
    assert port.obs_shape == jgame.obs_shape
    for name, ref in _constants(jgame).items():
        got = getattr(port, name)
        if isinstance(ref, jax.Array):  # a float32 table: the port's, rounded alike
            np.testing.assert_array_equal(np.asarray(got, ref.dtype), np.asarray(ref), err_msg=name)
        else:
            assert got == ref, name
    assert port.State._fields == jgame.State._fields


@pytest.mark.parametrize("game", NEW_GAMES)
def test_sixty_steps_of_eight_envs_match_jax(game):
    js, ts = reset_both(game, jax.random.PRNGKey(0), 8)
    run_both(game, js, ts, jax.random.PRNGKey(1), 60, seed=0)


@pytest.mark.parametrize("game", NEW_GAMES)
def test_auto_reset_matches_jax(game):
    """Env b starts ``3 + b % 4`` steps short of ``MAX_T``, so every env's
    episode ends inside the run and the auto-reset replays the step's own
    draws (a fresh CoinRun level, Seaquest's fish)."""
    jgame = jenvs.get_env(game)
    js, ts = reset_both(game, jax.random.PRNGKey(2), 8)
    t0 = (jgame.MAX_T - 3 - np.arange(8) % 4).astype(np.int32)
    js = js._replace(t=jnp.asarray(t0))
    ts = ts._replace(t=torch.from_numpy(t0))
    js, ts, resets, _ = run_both(game, js, ts, jax.random.PRNGKey(3), 12, seed=1)
    assert resets >= 8
    assert int(ts.t.max()) < 12


@pytest.mark.parametrize("game", NEW_GAMES)
def test_draws_have_the_documented_shapes_and_ranges(game):
    port = jaxenv.get_env(game)
    for fn, key in ((port.step_noise, jax.random.PRNGKey(4)),
                    (port.reset_noise, jax.random.PRNGKey(5))):
        got = fn(16, torch.Generator().manual_seed(0), "cpu")
        ref = (jax_step_noise if fn is port.step_noise else jax_reset_noise)(
            game, jax.random.split(key, 16))
        got_t = got if isinstance(got, tuple) else (got,)
        ref_t = ref if isinstance(ref, tuple) else (ref,)
        assert type(got) is type(ref)
        for a, b in zip(got_t, ref_t):
            assert a.shape == b.shape and a.dtype == b.dtype
            if a.is_floating_point() and a.numel():
                assert 0.0 <= float(a.min()) and float(a.max()) < 4.0
        again = fn(16, torch.Generator().manual_seed(0), "cpu")
        for a, b in zip(got_t, again if isinstance(again, tuple) else (again,)):
            assert torch.equal(a, b)


def test_get_env_serves_all_eight_games():
    for name in jaxenv.GAMES:
        mod = jaxenv.get_env(name)
        assert mod is importlib.import_module(f"distributed_ba3c_tpu_torch.envs.jaxenv.{name}")
        assert mod.num_actions == jenvs.get_env(name).num_actions
        assert mod.obs_shape == (84, 84)
    assert set(jaxenv.GAMES) == {"pong", *NEW_GAMES}
    with pytest.raises(ValueError, match="unknown"):
        jaxenv.get_env("tetris")


def test_pong_draws_are_the_parents_stream():
    """Pong's draw functions wrap ``sample_noise`` in the order the fused
    loop drew before: a seeded generator gives the same numbers."""
    pong = jaxenv.get_env("pong")
    g1, g2 = torch.Generator().manual_seed(7), torch.Generator().manual_seed(7)
    for _ in range(3):
        assert torch.equal(pong.reset_noise(5, g1, "cpu"), pong.sample_noise(5, 1, g2, "cpu")[:, 0])
        assert torch.equal(pong.step_noise(5, g1, "cpu"),
                           pong.sample_noise(5, pong.FRAME_SKIP + 1, g2, "cpu"))


# -- the JAX tests' properties, on the port ---------------------------------

def _one(game, noise_seed=0):
    port = jaxenv.get_env(game)
    g = torch.Generator().manual_seed(noise_seed)
    return port, g, port.reset(port.reset_noise(1, g, "cpu"))


def _act(port, g, st, a):
    return port.step(st, torch.tensor([a], dtype=torch.int32), port.step_noise(1, g, "cpu"))


class TestBreakout:
    def test_serve_rides_paddle_until_fire(self):
        port, g, st = _one("breakout")
        st, _, _, _ = _act(port, g, st, 2)  # move right, no fire
        assert not bool(st.in_play[0])
        assert abs(float(st.ball_xy[0, 0]) - float(st.paddle_x[0])) < 1e-5
        st, _, _, _ = _act(port, g, st, 1)  # fire
        assert bool(st.in_play[0])

    def test_bricks_and_reward(self):
        """Fire, then track the ball: bricks break and the reward sums
        the row points of the broken bricks."""
        port, g, st = _one("breakout", 1)
        st, _, _, _ = _act(port, g, st, 1)
        total = 0.0
        for _ in range(400):
            bx, px = float(st.ball_xy[0, 0]), float(st.paddle_x[0])
            a = 2 if bx > px + 0.02 else (3 if bx < px - 0.02 else 1)
            st, _, r, _ = _act(port, g, st, a)
            total += float(r[0])
        broken = 108 - int(st.bricks.sum())
        assert broken > 0 and total > 0
        assert int(st.lives[0]) >= 1

    def test_lives_deplete_and_done(self):
        port, g, st = _one("breakout")
        for _ in range(3000):
            st, _, _, d = _act(port, g, st, 1)
            if bool(d[0]):
                break
        assert bool(d[0]), "episode never ended"
        assert int(st.lives[0]) == port.LIVES  # auto-restarted


class TestSeaquest:
    def test_oxygen_depletes_and_kills(self):
        port, g, st = _one("seaquest")
        lives0 = int(st.lives[0])
        for _ in range(60):
            st, _, _, d = _act(port, g, st, 0)
            if int(st.lives[0]) < lives0:
                break
        assert int(st.lives[0]) < lives0 or bool(d[0])

    def test_surfacing_refills_oxygen(self):
        port, g, st = _one("seaquest")
        for _ in range(10):
            st, _, _, _ = _act(port, g, st, 0)
        low = float(st.oxygen[0])
        for _ in range(30):
            st, _, _, _ = _act(port, g, st, 2)
        assert float(st.oxygen[0]) > low

    def test_torpedo_scores(self):
        port, g, st = _one("seaquest", 3)
        rng = np.random.default_rng(0)
        total = 0.0
        for _ in range(300):
            st, _, r, _ = _act(port, g, st, int(rng.choice([1, 1, 2, 3, 4, 5])))
            total += float(r[0])
        assert total > 0.0


class TestQbert:
    def test_hop_flips_cube_and_scores(self):
        port, g, st = _one("qbert")
        st2, _, r, _ = _act(port, g, st, 2)  # down-right
        assert float(r[0]) >= port.CUBE_POINTS
        assert int(st2.flipped.sum()) == int(st.flipped.sum()) + 1

    def test_hop_off_pyramid_costs_life(self):
        port, g, st = _one("qbert")
        st2, _, _, _ = _act(port, g, st, 1)  # up-right off the top
        assert int(st2.lives[0]) == port.LIVES - 1

    def test_noop_is_safe_hop_free(self):
        port, g, st = _one("qbert")
        st2, _, r, _ = _act(port, g, st, 0)
        assert float(r[0]) == 0.0
        assert torch.equal(st2.pos, st.pos)


class TestCoinRun:
    def test_levels_are_procedural(self):
        port = jaxenv.get_env("coinrun")
        st = port.reset(port.reset_noise(2, torch.Generator().manual_seed(0), "cpu"))
        assert not torch.equal(st.heights[0], st.heights[1])

    def test_spawn_platform_protected(self):
        port = jaxenv.get_env("coinrun")
        st = port.reset(port.reset_noise(64, torch.Generator().manual_seed(1), "cpu"))
        assert (st.heights[:, :4] > 0).all() and (st.heights[:, -4:] > 0).all()
        assert not st.spikes[:, :4].any() and not st.spikes[:, -4:].any()

    def test_right_jump_clears_some_levels(self):
        port = jaxenv.get_env("coinrun")
        g = torch.Generator().manual_seed(2)
        st = port.reset(port.reset_noise(8, g, "cpu"))
        finished = torch.zeros(8, dtype=torch.bool)
        wins = 0
        for _ in range(600):
            st, _, r, d = port.step(st, torch.full((8,), 4, dtype=torch.int32),
                                    port.step_noise(8, g, "cpu"))
            wins += int(((r > 0) & ~finished).sum())
            finished |= d
            if finished.all():
                break
        assert wins >= 1

    def test_render_scrolls_with_agent(self):
        port, g, st = _one("coinrun")
        f0 = port.render(st)
        for _ in range(10):
            st, obs, _, _ = _act(port, g, st, 2)
        assert not torch.equal(f0, obs)


def _invariants(game, n_steps=50, seed=0):
    port, g, st = _one(game, seed)
    rng = np.random.default_rng(seed)
    for _ in range(n_steps):
        st, obs, r, _ = _act(port, g, st, int(rng.integers(0, port.num_actions)))
        assert obs.shape == (1, 84, 84) and obs.dtype == torch.uint8
        assert bool(torch.isfinite(r).all())
    return st


class TestSpaceInvaders:
    def test_invariants(self):
        _invariants("space_invaders")

    def test_shooting_scores(self):
        port, g, st = _one("space_invaders")
        rng = np.random.default_rng(1)
        total = 0.0
        for _ in range(300):
            st, _, r, _ = _act(port, g, st, int(rng.choice([1, 1, 4, 5, 2, 3])))
            total += float(r[0])
        assert total > 0.0

    def test_points_are_row_scaled(self):
        pts = np.asarray(jaxenv.get_env("space_invaders").ROW_POINTS)
        assert pts[0] == 30.0 and pts[-1] == 5.0
        assert (np.diff(pts) < 0).all()

    def test_fleet_marches_and_descends(self):
        port, g, st = _one("space_invaders")
        y0 = float(st.origin[0, 1])
        for _ in range(200):
            st, _, _, d = _act(port, g, st, 0)
            if bool(d[0]):
                break
        assert float(st.origin[0, 1]) > y0 or bool(d[0])


class TestBoxing:
    def test_invariants(self):
        _invariants("boxing")

    def test_punching_in_range_scores_plus_one(self):
        port, g, st = _one("boxing")
        st = st._replace(opp=st.me + torch.tensor([[0.05, 0.0]]))
        st2, _, r, _ = _act(port, g, st, 1)
        assert int(st2.my_score[0]) >= 1
        assert float(r[0]) >= 1.0 - 4.0  # the opponent can land some in 4 substeps

    def test_opponent_pursues(self):
        port, g, st = _one("boxing")
        d0 = float(torch.linalg.norm(st.me - st.opp))
        for _ in range(10):
            st, _, _, _ = _act(port, g, st, 0)
        assert float(torch.linalg.norm(st.me - st.opp)) < d0

    def test_ko_ends_episode(self):
        port, g, st = _one("boxing")
        st = st._replace(my_score=torch.tensor([port.KO], dtype=torch.int32))
        _, _, _, d = _act(port, g, st, 0)
        assert bool(d[0])


class TestAssault:
    def test_invariants(self):
        _invariants("assault")

    def test_random_fire_scores_21_point_quanta(self):
        port, g, st = _one("assault")
        rng = np.random.default_rng(2)
        total = 0.0
        for _ in range(400):
            st, _, r, _ = _act(port, g, st, int(rng.choice([1, 1, 3, 4, 5, 6, 2])))
            total += float(r[0])
        assert total > 0.0
        assert total % 21.0 == 0.0

    def test_sustained_fire_overheats(self):
        port, g, st = _one("assault")
        jammed = False
        for _ in range(30):
            st, _, _, _ = _act(port, g, st, 1)
            jammed = jammed or bool(st.jammed[0])
        assert jammed

    def test_venting_clears_jam(self):
        port, g, st = _one("assault")
        st = st._replace(heat=torch.tensor([1.0]), jammed=torch.tensor([True]))
        for _ in range(6):
            st, _, _, _ = _act(port, g, st, 2)
        assert not bool(st.jammed[0])

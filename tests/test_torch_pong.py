"""The port's on-device Pong (distributed_ba3c_tpu_torch/envs/jaxenv/pong.py)
held against the JAX package's (distributed_ba3c_tpu/envs/jaxenv/pong.py).

JAX's random streams are not reproduced in torch, so the draws are made
here from the JAX keys and handed to the port, the draw-replay pattern of
the port's parity tests: ``pong.step``'s ``split(key, 5)``, then for each
serve ``split`` and ``uniform(minval, maxval)`` -- exactly the calls JAX's
``_serve`` makes. :class:`JaxReplay` replays a whole fused rollout step the
same way (``tests/test_torch_fused.py`` uses it).

Rendered frames, rewards and dones must be equal; float state fields agree
to 1e-6. They are not bit-equal: XLA's float32 ``sin``/``cos`` and
PyTorch's differ by one ulp on a few percent of arguments, and a paddle
bounce carries that on. Over these horizons no comparison flips.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_ba3c_tpu.envs.jaxenv import pong as jpong
from distributed_ba3c_tpu_torch.envs import jaxenv
from distributed_ba3c_tpu_torch.envs.jaxenv import pong

FLOAT_TOL = 1e-6


def _serve_draws(key):
    """(angle, jitter) as JAX's ``_serve(key, ...)`` draws them."""
    k1, k2 = jax.random.split(key)
    return jnp.stack([
        jax.random.uniform(k1, (), minval=-0.7, maxval=0.7),
        jax.random.uniform(k2, (), minval=-0.1, maxval=0.1),
    ])


@jax.jit
def reset_noise(keys):
    """[B] keys -> [B, 2]: the draws of ``vmap(pong.reset)(keys)``."""
    return jax.vmap(_serve_draws)(keys)


@jax.jit
def step_noise(keys):
    """[B] keys -> [B, FRAME_SKIP + 1, 2]: the draws of
    ``vmap(pong.step)(state, action, keys)``."""
    return jax.vmap(
        lambda k: jax.vmap(_serve_draws)(
            jax.random.split(k, jpong.FRAME_SKIP + 1)
        )
    )(keys)


def to_torch(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def state_to_torch(js) -> pong.State:
    return pong.State(*(to_torch(getattr(js, f)) for f in pong.State._fields))


class JaxReplay:
    """A draw source that replays a JAX rollout's key tree: each rollout
    step splits ``key`` into (key, k_act, k_env) as ``make_rollout_body``
    does, Gumbel noise comes from ``k_act`` and the env's draws from
    ``split(k_env, B)``."""

    def __init__(self, key):
        self.key = key
        self.k_env = None

    def action_noise(self, shape, device):
        self.key, k_act, self.k_env = jax.random.split(self.key, 3)
        self.last_k_act = k_act
        return to_torch(jax.random.gumbel(k_act, tuple(shape))).to(device)

    def env_noise(self, n, device):
        return to_torch(step_noise(jax.random.split(self.k_env, n))).to(device)

    def reset_noise(self, n, device):
        raise AssertionError("a replayed rollout resets inside env.step only")


def _assert_states_close(js, ts, where):
    for f in pong.State._fields:
        a, b = np.asarray(getattr(js, f)), getattr(ts, f).numpy()
        assert a.dtype == b.dtype, (where, f)
        if np.issubdtype(a.dtype, np.floating):
            np.testing.assert_allclose(b, a, rtol=0, atol=FLOAT_TOL, err_msg=f"{where}: {f}")
        else:
            np.testing.assert_array_equal(b, a, err_msg=f"{where}: {f}")


def _run(js, ts, key, n_steps, seed):
    """Step both envs with the same numpy-random actions and the same
    draws; discrete outputs must be equal at every step."""
    rng = np.random.default_rng(seed)
    jstep = jax.jit(jax.vmap(jpong.step))
    B = ts.agent_y.shape[0]
    resets = 0
    for t in range(n_steps):
        a = rng.integers(0, pong.num_actions, B).astype(np.int32)
        key, k = jax.random.split(key)
        keys = jax.random.split(k, B)
        js, jobs, jr, jd = jstep(js, jnp.asarray(a), keys)
        ts, tobs, tr, td = pong.step(ts, torch.from_numpy(a), to_torch(step_noise(keys)))
        where = f"step {t}"
        assert tobs.dtype == torch.uint8 and tobs.shape == (B, 84, 84)
        np.testing.assert_array_equal(tobs.numpy(), np.asarray(jobs), err_msg=where)
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr), err_msg=where)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd), err_msg=where)
        _assert_states_close(js, ts, where)
        resets += int(td.sum())
    return js, ts, resets


def _reset_both(key, B):
    keys = jax.random.split(key, B)
    js = jax.vmap(jpong.reset)(keys)
    ts = pong.reset(to_torch(reset_noise(keys)))
    _assert_states_close(js, ts, "reset")
    np.testing.assert_array_equal(
        pong.render(ts).numpy(), np.asarray(jax.vmap(jpong.render)(js))
    )
    return js, ts


def test_constants_and_fields_match_the_jax_module():
    for name in ("num_actions", "obs_shape", "PADDLE_H", "PADDLE_W", "AGENT_X",
                 "OPP_X", "BALL_R", "PADDLE_SPEED", "OPP_SPEED", "BALL_SPEED",
                 "WIN_SCORE", "FRAME_SKIP"):
        assert getattr(pong, name) == getattr(jpong, name), name
    assert pong.State._fields == jpong.State._fields


def test_sixty_steps_of_eight_envs_match_jax():
    js, ts = _reset_both(jax.random.PRNGKey(0), 8)
    js, ts, _ = _run(js, ts, jax.random.PRNGKey(1), 60, seed=0)
    # points were scored, so serves after a point were replayed too
    assert int(ts.agent_score.sum() + ts.opp_score.sum()) > 0


def test_auto_reset_at_21_matches_jax():
    """Every env starts at 20 points on one side, so the next point ends
    its match and the auto-reset (the fifth serve's draws) runs."""
    js, ts = _reset_both(jax.random.PRNGKey(2), 8)
    side = np.arange(8) % 2 == 0
    js = js._replace(
        agent_score=jnp.where(side, 20, 0).astype(jnp.int32),
        opp_score=jnp.where(side, 0, 20).astype(jnp.int32),
    )
    ts = ts._replace(
        agent_score=torch.from_numpy(np.where(side, 20, 0).astype(np.int32)),
        opp_score=torch.from_numpy(np.where(side, 0, 20).astype(np.int32)),
    )
    js, ts, resets = _run(js, ts, jax.random.PRNGKey(3), 60, seed=1)
    assert resets > 0
    assert int(ts.t.min()) < 60  # some match restarted its step count


def test_sample_noise_ranges_and_generator():
    g = torch.Generator().manual_seed(0)
    n = pong.sample_noise(4096, 5, g, "cpu")
    assert n.shape == (4096, 5, 2) and n.dtype == torch.float32
    for i, (lo, hi) in enumerate(pong.NOISE_RANGES):
        assert float(n[..., i].min()) >= lo and float(n[..., i].max()) < hi
        assert float(n[..., i].min()) < lo + 0.01 and float(n[..., i].max()) > hi - 0.01
    again = pong.sample_noise(4096, 5, torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(n, again)


def test_get_env_serves_pong_and_names_the_queue_item_for_others():
    """Every game of the set is ported now (tests/test_torch_games.py):
    ``get_env`` serves pong and the others, and names them for an
    unknown game."""
    assert jaxenv.get_env("pong") is pong
    assert jaxenv.get_env("breakout").num_actions == 4
    with pytest.raises(ValueError, match="unknown jax env 'tetris'.*'breakout'"):
        jaxenv.get_env("tetris")

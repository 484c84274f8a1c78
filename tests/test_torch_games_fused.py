"""The fused trainer (distributed_ba3c_tpu_torch/fused/) on the game set:
breakout (FRAME_SKIP 4, a launch angle a substep) and coinrun (FRAME_SKIP
1, a whole level of draws a step) held against the JAX package's
``make_fused_step``, and lag-0 ``--overlap`` on coinrun against the port's
fused step.

The JAX side is ``make_fused_step(BA3CNet(conv_features=(8, 8, 16, 16),
fc_units=16), ...)`` over 4 envs x T=3, as ``tests/test_torch_fused.py``
runs it on Pong (at those widths JAX's pallas and xla models are one
function). Envs 0 and 1 start two steps short of the game's ``MAX_T``, so
their episodes end inside the first rollout and the auto-reset replays the
step's draws. The port starts from the JAX initial state, converted, and
replays the JAX draws (``GameReplay`` from tests/test_torch_games.py).

Bounds, as the Pong test's: with learning rate 0 the trajectory (frame
stacks, discrete env state, episode counters) is equal after two steps,
float env state within ``FLOAT_TOL``, and every metric within 2e-2
relative; one live update agrees to rel-L2 < 5e-2 per leaf, but for the
leaves whose gradients JAX sums in bf16 (the conv biases and the PReLU
slope), held at ``tests/test_torch_model.py``'s conv-bias bound of 0.1,
the cause it was set for (breakout's Conv_1 bias reads 0.064). Lag 0
with frozen params is bit-exact with the fused step.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_ba3c_tpu.config import BA3CConfig as JaxConfig
from distributed_ba3c_tpu.envs import jaxenv as jenvs
from distributed_ba3c_tpu.fused import loop as jloop
from distributed_ba3c_tpu.models.a3c import BA3CNet as JaxNet
from distributed_ba3c_tpu.ops.gradproc import make_optimizer as jax_make_optimizer
from distributed_ba3c_tpu.parallel.mesh import make_mesh
from distributed_ba3c_tpu_torch.config import BA3CConfig
from distributed_ba3c_tpu_torch.envs import jaxenv
from distributed_ba3c_tpu_torch.fused.loop import (
    CUMULATIVE_METRICS,
    FusedState,
    create_fused_state,
    make_fused_step,
)
from distributed_ba3c_tpu_torch.fused.overlap import make_overlap_step
from distributed_ba3c_tpu_torch.models import BA3CNet, from_flax, to_flax
from distributed_ba3c_tpu_torch.parallel.train_step import create_train_state
from test_torch_fused import FEATS, METRIC_REL, METRICS, N_ENVS, T, UPDATE_REL_L2, _np_tree, _update_rel_l2
from test_torch_games import FLOAT_TOL, GameReplay, state_to_torch, to_torch
from test_torch_model import CONV_BIAS_REL_L2
from test_torch_vtrace import bf16_sum_leaf

GAMES = ("breakout", "coinrun")


def _near_the_end(js, game):
    """Envs 0 and 1 two steps short of MAX_T."""
    t = np.array(js.env_state.t)
    t[:2] = jenvs.get_env(game).MAX_T - 2
    return js.replace(env_state=js.env_state._replace(t=t))


@pytest.fixture(scope="module", params=GAMES)
def jax_run(request):
    """The JAX fused step on ``game`` (one compile), its initial state on
    the host and its results: two steps at learning rate 0, one at 1e-3."""
    game = request.param
    env = jenvs.get_env(game)
    cfg = JaxConfig(fc_units=16, num_actions=env.num_actions)
    model = JaxNet(num_actions=env.num_actions, fc_units=16, conv_features=FEATS)
    opt = jax_make_optimizer(cfg.learning_rate, cfg.adam_epsilon, cfg.grad_clip_norm)
    step = jloop.make_fused_step(
        model, opt, cfg, make_mesh(num_data=1, devices=jax.devices()[:1]), env,
        rollout_len=T,
    )
    s0 = jloop.create_fused_state(
        jax.random.PRNGKey(0), model, cfg, opt, env, N_ENVS, n_shards=1
    )
    host0 = _near_the_end(_np_tree(s0), game)
    states, metrics = [], []
    s = step.put(jax.tree_util.tree_map(jnp.asarray, host0))
    for _ in range(2):
        s, m = step(s, 0.01, 0.0)
        states.append(_np_tree(s))
        metrics.append({k: float(v) for k, v in m.items()})
    s_live, _ = step(step.put(jax.tree_util.tree_map(jnp.asarray, host0)), 0.01, 1e-3)
    return {"game": game, "init": host0, "states": states, "metrics": metrics,
            "live": _np_tree(s_live)}


def _port_state(game, host0) -> FusedState:
    cfg = BA3CConfig(fc_units=16)
    net = BA3CNet(jaxenv.get_env(game).num_actions, fc_units=16, conv_features=FEATS,
                  device="cpu")
    net.load_state_dict(from_flax(host0.train.params))
    return FusedState(
        train=create_train_state(net, cfg),
        env_state=state_to_torch(game, host0.env_state),
        obs_stack=to_torch(host0.obs_stack),
        draws=GameReplay(jnp.asarray(host0.key)[0], game),
        ep_return=to_torch(host0.ep_return),
        ep_count=to_torch(host0.ep_count),
        ep_return_sum=to_torch(host0.ep_return_sum),
    )


def _port_step(game, state):
    return make_fused_step(state.train.model, state.train.optimizer,
                           BA3CConfig(fc_units=16), jaxenv.get_env(game), rollout_len=T)


def test_two_steps_at_lr0_replay_the_jax_trajectory(jax_run):
    game = jax_run["game"]
    state = _port_state(game, jax_run["init"])
    step = _port_step(game, state)
    for i, (ref, ref_m) in enumerate(zip(jax_run["states"], jax_run["metrics"])):
        state, m = step(state, 0.01, 0.0)
        where = f"{game} after step {i + 1}"
        np.testing.assert_array_equal(state.obs_stack.numpy(), ref.obs_stack, err_msg=where)
        for f in jaxenv.get_env(game).State._fields:
            a, b = getattr(state.env_state, f).numpy(), getattr(ref.env_state, f)
            if np.issubdtype(b.dtype, np.floating):
                np.testing.assert_allclose(a, b, rtol=0, atol=FLOAT_TOL, err_msg=f"{where}: {f}")
            else:
                np.testing.assert_array_equal(a, b, err_msg=f"{where}: {f}")
        np.testing.assert_array_equal(state.ep_count.numpy(), ref.ep_count, err_msg=where)
        np.testing.assert_allclose(state.ep_return.numpy(), ref.ep_return, atol=1e-6)
        np.testing.assert_allclose(state.ep_return_sum.numpy(), ref.ep_return_sum, atol=1e-6)
        for k in METRICS:
            got, r = float(m[k]), ref_m[k]
            assert abs(got - r) <= METRIC_REL * max(abs(r), 1e-6), (where, k, got, r)
        for k in CUMULATIVE_METRICS:
            assert float(m[k]) == pytest.approx(ref_m[k], abs=1e-6), (where, k)
    # the two envs started near MAX_T finished an episode
    assert int(state.ep_count[:2].min()) >= 1


def test_one_live_update_matches_jax(jax_run):
    game = jax_run["game"]
    state = _port_state(game, jax_run["init"])
    old = to_flax(state.train.model.state_dict())
    state, m = _port_step(game, state)(state, 0.01, 1e-3)
    new = to_flax(state.train.model.state_dict())
    errs = _update_rel_l2(new, old, jax_run["live"].train.params, jax_run["init"].train.params)
    for leaf, err in errs.items():
        assert err < (CONV_BIAS_REL_L2 if bf16_sum_leaf(leaf) else UPDATE_REL_L2), (leaf, errs)
    assert all(np.isfinite(float(v)) for v in m.values())


def test_coinrun_lag0_overlap_is_bitexact_with_the_fused_step():
    """Lag 0 with frozen params consumes the level draws in the fused
    step's order: four windows leave equal stacks, env states (levels
    included) and episode counters."""
    coinrun = jaxenv.get_env("coinrun")
    runs = []
    for kind in ("fused", "overlap"):
        cfg = BA3CConfig(fc_units=16)
        net = BA3CNet(coinrun.num_actions, fc_units=16, conv_features=FEATS, device="cpu",
                      generator=torch.Generator().manual_seed(1))
        state = create_fused_state(5, net, cfg, coinrun, N_ENVS)
        if kind == "fused":
            step = make_fused_step(net, state.train.optimizer, cfg, coinrun, T)
        else:
            step = make_overlap_step(net, state.train.optimizer, cfg, coinrun, T, lag=0)
            state = step.put(state)
        # episodes end inside the windows: two envs near MAX_T
        env_state = state.env_state if kind == "fused" else state.actor.env_state
        env_state.t[:2] = coinrun.MAX_T - 4
        metrics = None
        for _ in range(4):
            state, metrics = step(state, 0.01, 0.0)
        runs.append((state if kind == "fused" else state.actor, metrics))
    (f, mf), (o, mo) = runs
    assert torch.equal(f.obs_stack, o.obs_stack)
    for a, b in zip(f.env_state, o.env_state):
        assert torch.equal(a, b)
    for name in ("ep_count", "ep_return", "ep_return_sum"):
        assert torch.equal(getattr(f, name), getattr(o, name)), name
    assert int(f.ep_count[:2].min()) >= 1
    for k in (*CUMULATIVE_METRICS, "reward_per_step"):
        assert torch.equal(mf[k], mo[k]), k

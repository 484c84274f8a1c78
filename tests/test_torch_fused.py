"""The port's fused trainer step (distributed_ba3c_tpu_torch/fused/loop.py)
held against the JAX package's ``make_fused_step`` on one device.

The JAX side is ``make_fused_step(BA3CNet(conv_features=(8, 8, 16, 16),
fc_units=16), make_optimizer(...), cfg, make_mesh(num_data=1), pong,
rollout_len=3)`` over 4 envs. At those widths no conv block is
``supported``, so JAX's pallas and xla models are one function (flax's
layers in every block). The port starts from the JAX initial state,
converted (params through ``from_flax``), and replays the JAX draws
(``JaxReplay`` from tests/test_torch_pong.py): the rollout's keys give the
Gumbel noise of the actions and the env's serve draws.

Bounds: with learning rate 0 the trajectory (frame stacks, env state,
episode counters) is equal after two steps (env floats to 1e-6, one ulp of
sin/cos apart) and every metric agrees within 2e-2 relative; one live
update agrees to rel-L2 < 5e-2 per leaf (a bf16 torso on both sides, Adam
normalising each entry).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_ba3c_tpu.config import BA3CConfig as JaxConfig
from distributed_ba3c_tpu.envs.jaxenv import pong as jpong
from distributed_ba3c_tpu.fused import loop as jloop
from distributed_ba3c_tpu.models.a3c import BA3CNet as JaxNet
from distributed_ba3c_tpu.ops.gradproc import make_optimizer as jax_make_optimizer
from distributed_ba3c_tpu.parallel.mesh import make_mesh
from distributed_ba3c_tpu_torch.config import BA3CConfig
from distributed_ba3c_tpu_torch.envs.jaxenv import pong
from distributed_ba3c_tpu_torch.fused.loop import (
    CUMULATIVE_METRICS,
    FusedState,
    create_fused_state,
    make_fused_step,
    make_greedy_eval,
)
from distributed_ba3c_tpu_torch.models import BA3CNet, from_flax, to_flax
from distributed_ba3c_tpu_torch.parallel.train_step import create_train_state, n_grad_chunks
from test_torch_pong import FLOAT_TOL, JaxReplay, state_to_torch, to_torch

FEATS = (8, 8, 16, 16)
N_ENVS, T = 4, 3
METRIC_REL = 2e-2
UPDATE_REL_L2 = 5e-2
METRICS = ("loss", "policy_loss", "value_loss", "entropy", "pred_value",
           "grad_norm", "grad_max_abs", "reward_per_step")


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), jax.device_get(tree))


@pytest.fixture(scope="module")
def jax_run():
    """The JAX fused step (one compile), its initial state on the host, and
    its results: two steps at learning rate 0, one at 1e-3."""
    cfg = JaxConfig(fc_units=16)
    model = JaxNet(num_actions=6, fc_units=16, conv_features=FEATS)
    opt = jax_make_optimizer(cfg.learning_rate, cfg.adam_epsilon, cfg.grad_clip_norm)
    step = jloop.make_fused_step(
        model, opt, cfg, make_mesh(num_data=1, devices=jax.devices()[:1]), jpong,
        rollout_len=T,
    )
    s0 = jloop.create_fused_state(
        jax.random.PRNGKey(0), model, cfg, opt, jpong, N_ENVS, n_shards=1
    )
    host0 = _np_tree(s0)
    states, metrics = [], []
    s = step.put(s0)
    for _ in range(2):
        s, m = step(s, 0.01, 0.0)
        states.append(_np_tree(s))
        metrics.append({k: float(v) for k, v in m.items()})
    s_live, _ = step(step.put(jax.tree_util.tree_map(jnp.asarray, host0)), 0.01, 1e-3)
    return {
        "init": host0, "states": states, "metrics": metrics,
        "live": _np_tree(s_live),
    }


def _port_state(host0, feats=FEATS) -> FusedState:
    cfg = BA3CConfig(fc_units=16)
    net = BA3CNet(6, fc_units=16, conv_features=feats, device="cpu")
    net.load_state_dict(from_flax(host0.train.params))
    return FusedState(
        train=create_train_state(net, cfg),
        env_state=state_to_torch(host0.env_state),
        obs_stack=to_torch(host0.obs_stack),
        draws=JaxReplay(jnp.asarray(host0.key)[0]),
        ep_return=to_torch(host0.ep_return),
        ep_count=to_torch(host0.ep_count),
        ep_return_sum=to_torch(host0.ep_return_sum),
    )


def _port_step(state: FusedState, **kw):
    return make_fused_step(
        state.train.model, state.train.optimizer, BA3CConfig(fc_units=16),
        pong, rollout_len=T, **kw,
    )


def _update_rel_l2(new, old, ref_new, ref_old) -> dict:
    out = {}
    for path, r_new in jax.tree_util.tree_leaves_with_path(ref_new):
        get = lambda tree: np.asarray(_leaf(tree, path), np.float64)  # noqa: E731
        d_ref = np.asarray(r_new, np.float64) - get(ref_old)
        d_got = get(new) - get(old)
        out[jax.tree_util.keystr(path)] = float(
            np.linalg.norm(d_got - d_ref) / max(np.linalg.norm(d_ref), 1e-30)
        )
    return out


def _leaf(tree, path):
    for p in path:
        tree = tree[p.key]
    return tree


def test_jax_categorical_is_argmax_of_logits_plus_gumbel():
    """The guard on the replay: JAX's categorical sampling is exactly
    argmax(logits + gumbel(k_act)), the form the port takes."""
    key = jax.random.PRNGKey(7)
    logits = jax.random.normal(jax.random.PRNGKey(8), (64, 6))
    for k in jax.random.split(key, 5):
        got = jnp.argmax(logits + jax.random.gumbel(k, logits.shape), axis=-1)
        np.testing.assert_array_equal(got, jax.random.categorical(k, logits, axis=-1))


def test_two_steps_at_lr0_replay_the_jax_trajectory(jax_run):
    state = _port_state(jax_run["init"])
    params0 = {k: v.clone() for k, v in state.train.model.state_dict().items()}
    step = _port_step(state)
    for i, (ref_state, ref_m) in enumerate(zip(jax_run["states"], jax_run["metrics"])):
        state, m = step(state, 0.01, 0.0)
        where = f"after step {i + 1}"
        np.testing.assert_array_equal(state.obs_stack.numpy(), ref_state.obs_stack, err_msg=where)
        for f in pong.State._fields:
            a, b = getattr(state.env_state, f).numpy(), getattr(ref_state.env_state, f)
            np.testing.assert_allclose(a, b, rtol=0, atol=FLOAT_TOL, err_msg=f"{where}: {f}")
        np.testing.assert_array_equal(state.ep_count.numpy(), ref_state.ep_count, err_msg=where)
        np.testing.assert_allclose(state.ep_return.numpy(), ref_state.ep_return, atol=1e-6)
        np.testing.assert_allclose(state.ep_return_sum.numpy(), ref_state.ep_return_sum, atol=1e-6)
        assert state.train.step == int(ref_state.train.step) == i + 1
        assert set(m) == set(ref_m) and set(CUMULATIVE_METRICS) <= set(m)
        for k in METRICS:
            got, ref = float(m[k]), ref_m[k]
            assert abs(got - ref) <= METRIC_REL * max(abs(ref), 1e-6), (where, k, got, ref)
        for k in CUMULATIVE_METRICS:
            assert float(m[k]) == pytest.approx(ref_m[k], abs=1e-6), (where, k)
    # learning rate 0 leaves the params exactly where they were
    for k, v in state.train.model.state_dict().items():
        assert torch.equal(v, params0[k]), k


def test_one_live_update_matches_jax(jax_run):
    state = _port_state(jax_run["init"])
    old = to_flax(state.train.model.state_dict())
    state, m = _port_step(state)(state, 0.01, 1e-3)
    new = to_flax(state.train.model.state_dict())
    errs = _update_rel_l2(new, old, jax_run["live"].train.params, jax_run["init"].train.params)
    assert max(errs.values()) < UPDATE_REL_L2, errs
    assert all(np.isfinite(float(v)) for v in m.values())


@pytest.fixture(scope="module")
def jax_full_width_run():
    """The JAX fused step on its default (xla) model at full conv widths,
    fc_units=16, 2 envs x T=2: the initial state and one update at 1e-3."""
    cfg = JaxConfig(fc_units=16)
    model = JaxNet(num_actions=6, fc_units=16)
    opt = jax_make_optimizer(cfg.learning_rate, cfg.adam_epsilon, cfg.grad_clip_norm)
    step = jloop.make_fused_step(
        model, opt, cfg, make_mesh(num_data=1, devices=jax.devices()[:1]), jpong,
        rollout_len=2,
    )
    s0 = jloop.create_fused_state(jax.random.PRNGKey(1), model, cfg, opt, jpong, 2, n_shards=1)
    host0 = _np_tree(s0)
    s1, m = step(step.put(s0), 0.01, 1e-3)
    return {"init": host0, "live": _np_tree(s1), "metrics": {k: float(v) for k, v in m.items()}}


def test_full_width_update_matches_jax_default_model(jax_full_width_run):
    """At full width the port's default model takes the JAX CLI's gradient
    rules (flax's in every block): one update on the JAX trajectory agrees
    per leaf within the live-update bound, and so do the metrics."""
    run = jax_full_width_run
    state = _port_state(run["init"], feats=(32, 32, 64, 64))
    assert state.train.model.block_rules == "xla"
    old = to_flax(state.train.model.state_dict())
    step = make_fused_step(state.train.model, state.train.optimizer, BA3CConfig(fc_units=16),
                           pong, rollout_len=2)
    state, m = step(state, 0.01, 1e-3)
    np.testing.assert_array_equal(state.obs_stack.numpy(), run["live"].obs_stack)
    new = to_flax(state.train.model.state_dict())
    errs = _update_rel_l2(new, old, run["live"].train.params, run["init"].train.params)
    assert max(errs.values()) < UPDATE_REL_L2, errs
    for k in METRICS:
        got, ref = float(m[k]), run["metrics"][k]
        assert abs(got - ref) <= METRIC_REL * max(abs(ref), 1e-6), (k, got, ref)


def test_three_grad_chunks_give_the_one_chunk_update():
    """T*B = 12 samples in 3 chunks of 4: the mean of the chunk gradients
    is the full-batch gradient, so the update is the one-chunk update."""
    assert n_grad_chunks(T * N_ENVS, 4) == 3 and n_grad_chunks(T * N_ENVS, 4096) == 1
    assert n_grad_chunks(12, 5) == 3  # rounded up until the chunks divide
    updates = []
    for chunk in (4096, 4):
        cfg = BA3CConfig(fc_units=16)
        net = BA3CNet(6, fc_units=16, conv_features=FEATS, device="cpu",
                      generator=torch.Generator().manual_seed(1))
        state = create_fused_state(5, net, cfg, pong, N_ENVS)
        old = {k: v.clone() for k, v in net.state_dict().items()}
        step = make_fused_step(net, state.train.optimizer, cfg, pong, T,
                               grad_chunk_samples=chunk)
        state, _ = step(state, 0.01, 1e-3)
        updates.append({k: v - old[k] for k, v in net.state_dict().items()})
    for k in updates[0]:
        d = float((updates[1][k] - updates[0][k]).norm())
        assert d <= UPDATE_REL_L2 * max(float(updates[0][k].norm()), 1e-30), k


def test_steps_per_dispatch_runs_k_updates_and_reduces_metrics():
    cfg = BA3CConfig(fc_units=16)
    net = BA3CNet(6, fc_units=16, conv_features=FEATS, device="cpu")
    state = create_fused_state(0, net, cfg, pong, 2)
    step = make_fused_step(net, state.train.optimizer, cfg, pong, 2, steps_per_dispatch=3)
    state, m = step(state, 0.01, 0.0)
    assert state.train.step == 3
    assert m["loss"].dim() == 0 and m["episodes"].dtype == torch.int64
    state = step.reset_episode_stats(state)
    assert int(state.ep_count.sum()) == 0 and float(state.ep_return_sum.sum()) == 0.0


class CountdownEnv:
    """A stub env for the greedy eval: env b's episodes last
    ``LENGTHS[b]`` steps and pay 1 a step, plus ``b`` at the end."""

    LENGTHS = (2, 3, 5, 50)
    num_actions = 3
    obs_shape = (16, 16)
    FRAME_SKIP = 1

    @classmethod
    def reset(cls, noise):
        return torch.zeros(noise.shape[0], dtype=torch.int32)

    @classmethod
    def step(cls, t, action, noise):
        t = t + 1
        lengths = torch.tensor(cls.LENGTHS[: t.shape[0]], dtype=torch.int32)
        done = t >= lengths
        reward = 1.0 + done.float() * torch.arange(t.shape[0]).float()
        t = torch.where(done, torch.zeros_like(t), t)
        return t, cls.render(t), reward, done

    @staticmethod
    def render(t):
        return (t[:, None, None] * 10).to(torch.uint8).expand(-1, 16, 16).contiguous()

    @staticmethod
    def step_noise(n, generator, device):
        return torch.rand((n, 1), generator=generator, device=device)

    reset_noise = step_noise


def test_greedy_eval_counts_each_envs_first_finished_episode():
    cfg = BA3CConfig(fc_units=16, image_size=(16, 16))
    net = BA3CNet(3, fc_units=16, image_size=(16, 16), device="cpu")
    # 12 steps: envs 0-2 finish episodes (several for the short ones), env 3
    # finishes none; first-episode returns are 2+0, 3+1, 5+2
    evaluate = make_greedy_eval(net, cfg, CountdownEnv, n_envs=4, max_steps=12)
    mean, mx, n = evaluate(0)
    assert (mean, mx, n) == (pytest.approx((2 + 4 + 7) / 3), 7.0, 3)
    assert make_greedy_eval(net, cfg, CountdownEnv, 4, max_steps=1)(0) == (0.0, float("-inf"), 0)


def test_draws_are_seeded_and_on_the_models_device():
    cfg = BA3CConfig(fc_units=16)
    net = BA3CNet(6, fc_units=16, conv_features=FEATS, device="cpu")
    a = create_fused_state(3, net, cfg, pong, 2)
    b = create_fused_state(3, net, cfg, pong, 2)
    assert torch.equal(a.obs_stack, b.obs_stack)
    assert torch.equal(a.draws.action_noise((2, 6), "cpu"), b.draws.action_noise((2, 6), "cpu"))
    assert a.obs_stack.shape == (2, 84, 84, 4) and a.obs_stack.dtype == torch.uint8

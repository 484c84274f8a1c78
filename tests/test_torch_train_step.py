"""The port's sync learner step (``parallel/train_step.py::make_train_step``)
held against the JAX package's ``make_train_step`` on a one-device CPU mesh.

Both sides run the JAX CLI's model (``BA3CNet`` with the default ``xla``
conv backend; the port's default ``block_rules="xla"``) at full conv width
(84x84x4 frames, convs 32/32/64/64) with ``fc_units=16`` for CPU time, on
one batch of B=8 JAX Pong frame stacks with seeded actions and returns,
from the JAX initial params (converted through ``from_flax``) and a fresh
Adam on either side. The bounds are those of
``tests/test_torch_fused.py::test_full_width_update_matches_jax_default_model``:
per leaf, the update's rel-L2 against JAX's update from the same state
below ``UPDATE_REL_L2`` (the first update and the second, Adam's history
in play), and every metric of two steps in a row within ``METRIC_REL``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_ba3c_tpu.config import BA3CConfig as JaxConfig
from distributed_ba3c_tpu.models.a3c import BA3CNet as JaxNet
from distributed_ba3c_tpu.ops.gradproc import make_optimizer as jax_make_optimizer
from distributed_ba3c_tpu.parallel import train_step as jstep
from distributed_ba3c_tpu.parallel.mesh import make_mesh
from distributed_ba3c_tpu_torch.config import BA3CConfig
from distributed_ba3c_tpu_torch.models import BA3CNet, from_flax, to_flax
from distributed_ba3c_tpu_torch.parallel.train_step import (
    create_train_state,
    make_train_step,
)
from test_torch_fused import METRIC_REL, UPDATE_REL_L2, _np_tree, _update_rel_l2
from test_torch_model import pong_frames

B = 8
LRS = (1e-3, 1e-3)  # two live steps
METRICS = ("loss", "policy_loss", "value_loss", "entropy", "advantage",
           "pred_value", "grad_norm", "grad_max_abs")


def _batches(n: int):
    rng = np.random.default_rng(0)
    frames = pong_frames(B * n, seed=3)
    return [{
        "state": frames[i * B:(i + 1) * B],
        "action": rng.integers(0, 6, B).astype(np.int32),
        "return": rng.normal(size=B).astype(np.float32),
    } for i in range(n)]


@pytest.fixture(scope="module")
def jax_run():
    """The JAX sync step (one compile): the initial state, its state after
    each of two steps at 1e-3, and one step at 2e-3 and at 0 from the
    initial state."""
    cfg = JaxConfig(fc_units=16)
    model = JaxNet(num_actions=6, fc_units=16)
    opt = jax_make_optimizer(cfg.learning_rate, cfg.adam_epsilon, cfg.grad_clip_norm)
    step = jstep.make_train_step(model, opt, cfg, make_mesh(num_data=1, devices=jax.devices()[:1]))
    s0 = jstep.create_train_state(jax.random.PRNGKey(2), model, cfg, opt)
    host0 = _np_tree(s0)
    batches = _batches(2)

    def fresh():
        return jax.device_put(jax.tree_util.tree_map(jnp.asarray, host0), step.state_sharding)

    def put(b):
        return {k: jax.device_put(v, step.batch_sharding) for k, v in b.items()}

    s, states, metrics = fresh(), [], []
    for b, lr in zip(batches, LRS):
        s, m = step(s, put(b), 0.01, lr)
        states.append(_np_tree(s))
        metrics.append({k: float(v) for k, v in m.items()})
    s2, _ = step(fresh(), put(batches[0]), 0.01, 2e-3)
    s0_, _ = step(fresh(), put(batches[0]), 0.01, 0.0)
    return {"init": host0, "states": states, "metrics": metrics, "batches": batches,
            "lr2": _np_tree(s2), "lr0": _np_tree(s0_)}


def _port(host0):
    cfg = BA3CConfig(fc_units=16)
    net = BA3CNet(6, fc_units=16, device="cpu")
    assert net.block_rules == "xla"
    net.load_state_dict(from_flax(host0.params))
    state = create_train_state(net, cfg)
    return state, make_train_step(net, state.optimizer, cfg)


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _port_at(host):
    """A port state at a JAX TrainState: its params and its Adam state
    (count, moments, learning rate) through the Adam bridge."""
    state, step = _port(host)
    inject = host.opt_state[1]
    adam = inject.inner_state[0]
    state.optimizer.load_state_dict({
        "count": np.asarray(adam.count), "mu": adam.mu, "nu": adam.nu,
        "learning_rate": np.asarray(inject.hyperparams["learning_rate"]),
    })
    state.step = int(host.step)
    return state, step


def test_two_updates_match_jax(jax_run):
    """Two steps of the port's step function in a row: every metric of each
    within the bound of JAX's. Each update is held against JAX's update
    from the same state: the first from the initial params, the second
    from JAX's state after the first (params and Adam's moments), so the
    second compares the update rule with Adam's history in play rather
    than the first step's rounding carried forward."""
    state, step = _port(jax_run["init"])
    old = to_flax(state.model.state_dict())
    for i, (b, lr) in enumerate(zip(jax_run["batches"], LRS)):
        state, m = step(state, _t(b), 0.01, lr)
        assert state.step == int(jax_run["states"][i].step) == i + 1
        ref = jax_run["metrics"][i]
        assert set(m) == set(ref)
        for k in METRICS:
            got = float(m[k])
            assert abs(got - ref[k]) <= METRIC_REL * max(abs(ref[k]), 1e-6), (i, k, got, ref[k])
        if i == 0:
            errs = _update_rel_l2(to_flax(state.model.state_dict()), old,
                                  jax_run["states"][0].params, jax_run["init"].params)
            assert max(errs.values()) < UPDATE_REL_L2, (i, errs)
    state, step = _port_at(jax_run["states"][0])
    assert int(state.optimizer.state_dict()["count"]) == 1
    old = to_flax(state.model.state_dict())
    state, _ = step(state, _t(jax_run["batches"][1]), 0.01, LRS[1])
    assert state.step == 2 and int(state.optimizer.state_dict()["count"]) == 2
    errs = _update_rel_l2(to_flax(state.model.state_dict()), old,
                          jax_run["states"][1].params, jax_run["states"][0].params)
    assert max(errs.values()) < UPDATE_REL_L2, errs


def test_learning_rate_zero_freezes_the_params(jax_run):
    state, step = _port(jax_run["init"])
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    state, m = step(state, _t(jax_run["batches"][0]), 0.01, 0.0)
    assert state.step == 1 and all(np.isfinite(float(v)) for v in m.values())
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    # and JAX's step at 0 leaves its params where they were too
    for a, b in zip(jax.tree_util.tree_leaves(jax_run["lr0"].params),
                    jax.tree_util.tree_leaves(jax_run["init"].params)):
        np.testing.assert_array_equal(a, b)


def test_injected_learning_rate_scales_the_update(jax_run):
    """Adam's first step is lr * m/(sqrt(v)+eps): twice the learning rate,
    twice the update, on both sides."""
    deltas = {}
    for lr in (1e-3, 2e-3):
        state, step = _port(jax_run["init"])
        old = {k: v.clone() for k, v in state.model.state_dict().items()}
        state, _ = step(state, _t(jax_run["batches"][0]), 0.01, lr)
        deltas[lr] = {k: v - old[k] for k, v in state.model.state_dict().items()}
        assert state.optimizer.learning_rate == pytest.approx(lr)
    for k, p in old.items():
        # a delta is the difference of two float32 params: a few of their
        # ulps of rounding on top of the exact update
        ulp = float(p.abs().max()) * 2.0 ** -23
        torch.testing.assert_close(deltas[2e-3][k], 2 * deltas[1e-3][k], rtol=1e-4, atol=4 * ulp)
    state, step = _port(jax_run["init"])
    old = to_flax(state.model.state_dict())
    state, _ = step(state, _t(jax_run["batches"][0]), 0.01, 2e-3)
    errs = _update_rel_l2(to_flax(state.model.state_dict()), old,
                          jax_run["lr2"].params, jax_run["init"].params)
    assert max(errs.values()) < UPDATE_REL_L2, errs

"""The port's returns, loss and gradient processing held against the JAX
package's (ops/returns.py, ops/loss.py, ops/gradproc.py, optax), and its
anneal schedule and stat writer against their originals.

Everything here is float32 arithmetic in the same op order on both sides,
so the bound is 1e-6 relative; the Adam step is held to 1e-5 (optax and
torch.optim.Adam fold the bias corrections in different places).
"""

from __future__ import annotations

import json

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_ba3c_tpu.ops import gradproc as jgradproc
from distributed_ba3c_tpu.ops.loss import a3c_loss as j_a3c_loss
from distributed_ba3c_tpu.ops.returns import n_step_returns as j_n_step_returns
from distributed_ba3c_tpu.ops.symbolic import huber_loss as j_huber
from distributed_ba3c_tpu.train.callbacks import anneal_interp as j_anneal
from distributed_ba3c_tpu.utils.stats import StatCounter as JStatCounter
from distributed_ba3c_tpu_torch.ops.gradproc import (
    global_norm_clip,
    grad_summaries,
    make_optimizer,
)
from distributed_ba3c_tpu_torch.ops.loss import A3CLossOut, a3c_loss
from distributed_ba3c_tpu_torch.ops.returns import n_step_returns
from distributed_ba3c_tpu_torch.ops.symbolic import huber_loss
from distributed_ba3c_tpu_torch.train.callbacks import anneal_interp
from distributed_ba3c_tpu_torch.utils.stats import StatCounter, StatHolder

REL = 1e-6


def _close(got, ref, rel=REL):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    scale = max(float(np.max(np.abs(ref))), 1e-30)
    assert float(np.max(np.abs(got - ref))) <= rel * scale, (got, ref)


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def test_n_step_returns_with_dones_match_jax():
    rng = np.random.default_rng(0)
    T, B = 7, 5
    r = rng.normal(0, 1, (T, B)).astype(np.float32)
    d = (rng.random((T, B)) < 0.25).astype(np.float32)
    v = rng.normal(0, 1, B).astype(np.float32)
    ref = j_n_step_returns(jnp.asarray(r), jnp.asarray(d), jnp.asarray(v), 0.99)
    got = n_step_returns(_t(r), _t(d), _t(v), 0.99)
    assert got.dtype == torch.float32
    _close(got.numpy(), ref)
    # a done step's return is its reward alone: no credit across episodes
    t, b = np.argwhere(d == 1)[0]
    assert float(got[t, b]) == pytest.approx(float(r[t, b]))


@pytest.mark.parametrize("huber_delta", [None, 1.0])
def test_a3c_loss_matches_jax(huber_delta):
    rng = np.random.default_rng(1)
    n, A = 32, 6
    logits = rng.normal(0, 2, (n, A)).astype(np.float32)
    values = rng.normal(0, 2, n).astype(np.float32)
    actions = rng.integers(0, A, n).astype(np.int32)
    returns = rng.normal(0, 2, n).astype(np.float32)
    ref = j_a3c_loss(
        jnp.asarray(logits), jnp.asarray(values), jnp.asarray(actions),
        jnp.asarray(returns), entropy_beta=0.01, value_loss_coef=0.5,
        huber_delta=huber_delta,
    )
    got = a3c_loss(
        _t(logits), _t(values), _t(actions), _t(returns), entropy_beta=0.01,
        value_loss_coef=0.5, huber_delta=huber_delta,
    )
    assert isinstance(got, A3CLossOut) and got._fields == type(ref)._fields
    for f in got._fields:
        _close(getattr(got, f).numpy(), getattr(ref, f))


def test_a3c_loss_gradient_matches_jax():
    import jax

    rng = np.random.default_rng(2)
    logits = rng.normal(0, 1, (16, 4)).astype(np.float32)
    values = rng.normal(0, 1, 16).astype(np.float32)
    actions = rng.integers(0, 4, 16).astype(np.int32)
    returns = rng.normal(0, 1, 16).astype(np.float32)
    gl, gv = jax.grad(
        lambda l, v: j_a3c_loss(l, v, jnp.asarray(actions), jnp.asarray(returns)).total,
        argnums=(0, 1),
    )(jnp.asarray(logits), jnp.asarray(values))
    tl, tv = _t(logits).requires_grad_(), _t(values).requires_grad_()
    a3c_loss(tl, tv, _t(actions), _t(returns)).total.backward()
    _close(tl.grad.numpy(), gl, rel=1e-5)
    _close(tv.grad.numpy(), gv, rel=1e-5)


def test_huber_matches_jax():
    x = np.linspace(-3, 3, 41).astype(np.float32)
    _close(huber_loss(_t(x), 1.5).numpy(), j_huber(jnp.asarray(x), 1.5))


def _grads(seed, scale):
    rng = np.random.default_rng(seed)
    shapes = [(3, 4), (4,), (5, 2, 2), ()]
    return [(rng.normal(0, scale, s)).astype(np.float32) for s in shapes]


def test_grad_summaries_match_jax():
    g = _grads(3, 1.0)
    ref = jgradproc.grad_summaries({f"l{i}": jnp.asarray(x) for i, x in enumerate(g)})
    got = grad_summaries([_t(x) for x in g])
    assert sorted(got) == sorted(ref)
    for k in ref:
        _close(got[k].numpy(), ref[k])


@pytest.mark.parametrize("scale", [0.01, 10.0], ids=["below_max_norm", "above_max_norm"])
def test_global_norm_clip_matches_optax(scale):
    g = _grads(4, scale)
    clip = optax.clip_by_global_norm(0.5)
    tree = {f"l{i}": jnp.asarray(x) for i, x in enumerate(g)}
    ref, _ = clip.update(tree, clip.init(tree))
    got = global_norm_clip([_t(x) for x in g], 0.5)
    for i, x in enumerate(got):
        _close(x.numpy(), ref[f"l{i}"])
    norm = float(np.sqrt(sum(float(np.sum(x.astype(np.float64) ** 2)) for x in g)))
    if scale < 1:
        assert norm < 0.5 and all(np.array_equal(a.numpy(), b) for a, b in zip(got, g))
    else:
        assert norm > 0.5
        assert float(np.sqrt(sum(float((x.double() ** 2).sum()) for x in got))) == pytest.approx(0.5, rel=1e-5)


def test_clip_adam_steps_match_optax_with_runtime_learning_rate():
    """Three updates, the learning rate changed between them, against
    make_optimizer's optax chain with the injected learning rate."""
    rng = np.random.default_rng(5)
    p0 = [rng.normal(0, 1, s).astype(np.float32) for s in [(3, 4), (4,)]]
    tparams = [torch.nn.Parameter(_t(x)) for x in p0]
    opt = make_optimizer(zip("ab", tparams), 1e-3, adam_epsilon=1e-3, grad_clip_norm=0.5)
    jopt = jgradproc.make_optimizer(1e-3, adam_epsilon=1e-3, grad_clip_norm=0.5)
    jparams = {"a": jnp.asarray(p0[0]), "b": jnp.asarray(p0[1])}
    jstate = jopt.init(jparams)
    for k, lr in enumerate([1e-3, 5e-4, 0.0]):
        g = [rng.normal(0, 0.3 * (k + 1), x.shape).astype(np.float32) for x in p0]
        before = [p.detach().clone() for p in tparams]
        opt.set_learning_rate(lr)
        opt.step([_t(x) for x in g])
        jstate = jgradproc.inject_learning_rate(jstate, lr)
        upd, jstate = jopt.update({"a": jnp.asarray(g[0]), "b": jnp.asarray(g[1])}, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        for p, name in zip(tparams, "ab"):
            _close(p.detach().numpy(), jparams[name], rel=1e-5)
    # the last step ran at learning rate 0: the params did not move
    assert all(torch.equal(p.detach(), b) for p, b in zip(tparams, before))
    assert all(p.grad is None for p in tparams)


@pytest.mark.parametrize("mode", ["linear", "exp"])
def test_anneal_interp_matches_jax(mode):
    for f in (-0.5, 0.0, 0.3, 1.0, 2.0):
        assert anneal_interp(1e-3, 1e-5, f, mode) == j_anneal(1e-3, 1e-5, f, mode)
    if mode == "exp":
        with pytest.raises(ValueError):
            anneal_interp(0.0, 1.0, 0.5, mode)


def test_stat_counter_and_holder(tmp_path):
    c, jc = StatCounter(), JStatCounter()
    for v in (1.0, 4.0, 2.5):
        c.feed(v)
        jc.feed(v)
    assert (c.count, c.average, c.sum, c.max) == (jc.count, jc.average, jc.sum, jc.max)
    h = StatHolder(str(tmp_path))
    h.add_stat("epoch", 1)
    h.add_stats({"loss": 0.5})
    assert h.finalize() == {"epoch": 1.0, "loss": 0.5}
    h.add_stat("epoch", 2)
    h.finalize()
    assert json.loads((tmp_path / "stat.json").read_text()) == [
        {"epoch": 1.0, "loss": 0.5}, {"epoch": 2.0}
    ]
    # a new holder on the same dir continues the history
    assert len(StatHolder(str(tmp_path)).stat_history) == 2

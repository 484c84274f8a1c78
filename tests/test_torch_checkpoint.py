"""The port's checkpoints (distributed_ba3c_tpu_torch/train/checkpoint.py)
and the Adam bridge (models/convert.py, ops/gradproc.py::ClipAdam) held
against the JAX package's CheckpointManager rules and optax's Adam state.

The manager's rules mirror tests/test_callbacks.py's checks of the JAX
manager. The parity test trains a narrow JAX TrainState for two updates,
saves it with the JAX manager (orbax), carries it across with ``from_flax``
and the Adam bridge, saves and restores it with the port's manager, and
then takes one update on each side on the same batch: the update agrees to
rel-L2 < 5e-2 per leaf (the fused-step tests' bound) and the Adam counts
are equal.
"""

from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_ba3c_tpu.config import BA3CConfig as JaxConfig
from distributed_ba3c_tpu.models.a3c import BA3CNet as JaxNet
from distributed_ba3c_tpu.ops.gradproc import make_optimizer as jax_make_optimizer
from distributed_ba3c_tpu.parallel.mesh import make_mesh
from distributed_ba3c_tpu.parallel.train_step import create_train_state as jax_train_state
from distributed_ba3c_tpu.parallel.train_step import make_train_step
from distributed_ba3c_tpu.train.checkpoint import CheckpointManager as JaxManager
from distributed_ba3c_tpu_torch.config import BA3CConfig
from distributed_ba3c_tpu_torch.parallel.train_step import learner_grads
from distributed_ba3c_tpu_torch.models import BA3CNet, to_flax
from distributed_ba3c_tpu_torch.models.convert import adam_from_optax, adam_to_optax
from distributed_ba3c_tpu_torch.parallel.train_step import create_train_state
from distributed_ba3c_tpu_torch.train.checkpoint import (
    CheckpointManager,
    load_params,
    restore_train_state,
    train_state_payload,
)
from test_torch_fused import FEATS, UPDATE_REL_L2, _update_rel_l2

SIZE = 16


# -- the manager's rules, each scenario through both managers -----------------
#
# The JAX manager (orbax) saves a numpy payload, the port's a tensor payload;
# each scenario makes the same calls on both, and the two must leave the same
# checkpoint.json, the same ckpt-* directories, the same all_steps,
# latest_step and best_step, and restore the same values.


def _payload(side, v):
    if side == "jax":
        return {"w": np.full(3, float(v), np.float32)}
    return {"w": torch.full((3,), float(v))}


def _manager(side, root, max_to_keep=3):
    return (JaxManager if side == "jax" else CheckpointManager)(str(root), max_to_keep=max_to_keep)


def _restore(side, root, step=None):
    mgr = _manager(side, root)
    if side == "jax":
        return np.asarray(mgr.restore({"w": np.zeros(3, np.float32)}, step)["w"])
    return mgr.restore(step)["w"].numpy()


def _drive(side, root, max_to_keep, calls):
    """Make ``calls`` on a ``side`` manager; returns what mark_best said
    and the manager's view after the last call."""
    mgr = _manager(side, root, max_to_keep)
    said = []
    for call in calls:
        if call[0] == "save":
            mgr.save(_payload(side, call[1]), call[1])
        else:
            said.append(mgr.mark_best(call[1], call[2]))
    return said, (mgr.all_steps, mgr.latest_step, mgr.best_step)


def _on_disk(root):
    meta = json.loads((root / "checkpoint.json").read_text())
    dirs = sorted(int(d.split("-")[1]) for d in os.listdir(root) if d.startswith("ckpt-"))
    return meta, dirs


_SAVES = lambda steps: [("save", s) for s in steps]  # noqa: E731

SCENARIOS = {
    # keep-best survives pruning beyond max_to_keep; a worse score is refused
    "round_trip_and_best": (2, [("save", 1), ("best", 1, 10.0), ("save", 2),
                                ("best", 2, 5.0), ("save", 3)]),
    # with max_to_keep=1 and a protected best, the step just saved survives
    "max_to_keep_one_never_deletes_latest": (1, [("save", 1), ("best", 1, 10.0), ("save", 2)]),
    # a score equal to the best is no improvement; a higher one is
    "best_only_on_improvement": (3, [("save", 1), ("best", 1, 5.0), ("save", 2),
                                     ("best", 2, 5.0), ("save", 3), ("best", 3, 7.0)]),
    "keep_all": (64, _SAVES(range(1, 11))),
    "keep_the_newest": (3, _SAVES(range(1, 11))),
    # a re-save of a step (a killed run re-driven over its logdir)
    "resave_is_not_duplicated": (5, _SAVES((1, 2, 2, 3, 3))),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_manager_rules_match_the_jax_manager(tmp_path, name):
    max_to_keep, calls = SCENARIOS[name]
    got = {side: _drive(side, tmp_path / side, max_to_keep, calls) for side in ("jax", "port")}
    assert got["port"] == got["jax"]
    assert _on_disk(tmp_path / "port") == _on_disk(tmp_path / "jax")
    steps = got["port"][1][0]
    assert steps  # every scenario keeps something to restore
    for step in [None, *steps]:
        np.testing.assert_array_equal(_restore("port", tmp_path / "port", step),
                                      _restore("jax", tmp_path / "jax", step))


def test_run_meta_matches_the_jax_manager(tmp_path):
    fields = {"steps_per_epoch": 3200, "batch_size": 640, "rollout_len": 20}
    for side in ("jax", "port"):
        assert _manager(side, tmp_path / side).read_run_meta() == {}
        _manager(side, tmp_path / side).write_run_meta(**fields)
    assert (_manager("port", tmp_path / "port").read_run_meta()
            == _manager("jax", tmp_path / "jax").read_run_meta() == fields)
    assert ((tmp_path / "port" / "run_meta.json").read_text()
            == (tmp_path / "jax" / "run_meta.json").read_text())
    for side in ("jax", "port"):
        assert not any(f.endswith(".tmp") for f in os.listdir(tmp_path / side))


def test_all_steps_dedups_metadata_written_with_repeats(tmp_path):
    """metadata from a manager that appended a re-saved step twice: both
    managers enumerate each step once, ascending"""
    meta = {"all": [3, 1, 3, 2], "latest": 3, "best": None, "best_score": None}
    views = []
    for side in ("jax", "port"):
        (tmp_path / side).mkdir()
        (tmp_path / side / "checkpoint.json").write_text(json.dumps(meta))
        mgr = _manager(side, tmp_path / side)
        views.append((mgr.all_steps, mgr.latest_step, mgr.best_step))
    assert views[0] == views[1]


def test_restore_without_a_checkpoint_raises(tmp_path):
    with pytest.raises(AssertionError, match="no checkpoint"):
        _manager("jax", tmp_path / "jax").restore({"w": np.zeros(3)})
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        _manager("port", tmp_path / "port").restore()


# -- the Adam bridge -----------------------------------------------------------


def _net(seed=0):
    return BA3CNet(4, fc_units=16, conv_features=FEATS, image_size=(SIZE, SIZE),
                   device="cpu", generator=torch.Generator().manual_seed(seed))


def _batch(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, SIZE, SIZE, 4), dtype=np.uint8),
            rng.integers(0, 4, n).astype(np.int32),
            rng.normal(0, 1, n).astype(np.float32))


def _port_update(train, cfg, batch, beta, lr):
    s, a, r = (torch.from_numpy(x) for x in batch)
    grads, _ = learner_grads(train.model, cfg, s, a.long(), r, beta)
    train.optimizer.set_learning_rate(lr)
    train.optimizer.step(grads)


def test_adam_bridge_round_trips_exactly():
    rng = np.random.default_rng(0)
    sd = _net().state_dict()
    tree = lambda: to_flax({k: torch.from_numpy(rng.normal(0, 1, v.shape).astype(np.float32))  # noqa: E731
                            for k, v in sd.items()})
    mu, nu = tree(), tree()
    per_param = adam_from_optax(np.int32(5), mu, nu)
    assert per_param.keys() == sd.keys()
    for k, st in per_param.items():
        assert st["step"].dtype == torch.float32 and float(st["step"]) == 5.0
        assert st["exp_avg"].shape == sd[k].shape
    count, mu2, nu2 = adam_to_optax(per_param)
    assert count.dtype == np.int32 and int(count) == 5
    for a, b in ((mu, mu2), (nu, nu2)):
        for (pa, la), (pb, lb) in zip(jax.tree_util.tree_leaves_with_path(a),
                                      jax.tree_util.tree_leaves_with_path(b)):
            assert pa == pb
            np.testing.assert_array_equal(la, lb)
    per_param["fc.bias"]["step"] = torch.tensor(4.0)
    with pytest.raises(ValueError, match="different Adam steps"):
        adam_to_optax(per_param)


def test_clip_adam_state_dict_round_trips_and_starts_as_optax_init():
    cfg = BA3CConfig(fc_units=16, image_size=(SIZE, SIZE), num_actions=4)
    train = create_train_state(_net(), cfg)
    fresh = train.optimizer.state_dict()
    # optax's init of make_optimizer's chain on the same params
    jopt = jax_make_optimizer(cfg.learning_rate, cfg.adam_epsilon, cfg.grad_clip_norm)
    inject = jopt.init(to_flax(train.model.state_dict()))[1]
    adam = inject.inner_state[0]
    assert fresh["count"].numpy().dtype == np.asarray(adam.count).dtype
    assert int(fresh["count"]) == int(adam.count) == 0
    for name in ("mu", "nu"):
        for k, v in getattr(adam, name).items():
            for leaf, a in v.items():
                np.testing.assert_array_equal(fresh[name][k][leaf].numpy(), np.asarray(a))
    assert fresh["learning_rate"].numpy() == np.asarray(inject.hyperparams["learning_rate"])
    _port_update(train, cfg, _batch(8, 0), 0.01, 1e-3)
    _port_update(train, cfg, _batch(8, 1), 0.01, 5e-4)
    sd = train.optimizer.state_dict()
    assert int(sd["count"]) == 2 and float(sd["learning_rate"]) == pytest.approx(5e-4)

    other = create_train_state(_net(seed=1), cfg)
    other.optimizer.load_state_dict(sd)
    back = other.optimizer.state_dict()
    assert int(back["count"]) == 2 and float(back["learning_rate"]) == float(sd["learning_rate"])
    for name in ("mu", "nu"):
        for k, v in sd[name].items():
            for leaf, t in v.items():
                assert torch.equal(back[name][k][leaf], t), (name, k, leaf)


def test_train_state_payload_round_trips_through_the_manager(tmp_path):
    cfg = BA3CConfig(fc_units=16, image_size=(SIZE, SIZE), num_actions=4)
    train = create_train_state(_net(), cfg)
    _port_update(train, cfg, _batch(8, 2), 0.01, 1e-3)
    train.step = 1
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(train_state_payload(train), 1)
    restored = restore_train_state(create_train_state(_net(seed=3), cfg), mgr)
    assert restored.step == 1
    for k, v in train.model.state_dict().items():
        assert torch.equal(restored.model.state_dict()[k], v), k
    a, b = train.optimizer.state_dict(), restored.optimizer.state_dict()
    assert int(a["count"]) == int(b["count"]) == 1
    for name in ("mu", "nu"):
        for k in a[name]:
            for leaf in a[name][k]:
                assert torch.equal(a[name][k][leaf], b[name][k][leaf])
    payload = torch.load(os.path.join(mgr._dir(1), "state.pt"), weights_only=True)
    assert set(payload) == {"step", "params", "opt"}
    assert set(payload["opt"]) == {"count", "mu", "nu", "learning_rate"}
    assert set(payload["params"]) == set(to_flax(train.model.state_dict()))
    net = _net(seed=4)
    load_params(net, payload["params"])
    assert all(torch.equal(net.state_dict()[k], v) for k, v in train.model.state_dict().items())


# -- an orbax checkpoint of the JAX package carried into the port --------------


def test_orbax_checkpoint_resumes_in_the_port_to_the_same_update(tmp_path):
    jcfg = JaxConfig(fc_units=16, image_size=(SIZE, SIZE), num_actions=4)
    model = JaxNet(num_actions=4, fc_units=16, conv_features=FEATS)
    opt = jax_make_optimizer(jcfg.learning_rate, jcfg.adam_epsilon, jcfg.grad_clip_norm)
    step = make_train_step(model, opt, jcfg, make_mesh(num_data=1, devices=jax.devices()[:1]))
    state = jax_train_state(jax.random.PRNGKey(0), model, jcfg, opt)
    as_jax = lambda b: {"state": jnp.asarray(b[0]), "action": jnp.asarray(b[1]),  # noqa: E731
                        "return": jnp.asarray(b[2])}
    for i, lr in enumerate((1e-3, 5e-4)):
        state, _ = step(state, as_jax(_batch(8, 10 + i)), 0.01, lr)
    host = jax.device_get(state)
    JaxManager(str(tmp_path / "orbax")).save(host, 2)
    restored = JaxManager(str(tmp_path / "orbax")).restore(host)
    inject = restored.opt_state[1]
    adam = inject.inner_state[0]
    assert int(adam.count) == 2

    # the port takes it over and keeps it in its own format
    cfg = BA3CConfig(fc_units=16, image_size=(SIZE, SIZE), num_actions=4)
    train = create_train_state(_net(seed=9), cfg)
    load_params(train.model, restored.params)
    train.optimizer.load_state_dict({
        "count": np.asarray(adam.count), "mu": adam.mu, "nu": adam.nu,
        "learning_rate": np.asarray(inject.hyperparams["learning_rate"]),
    })
    train.step = int(restored.step)
    mgr = CheckpointManager(str(tmp_path / "port"))
    mgr.save(train_state_payload(train), train.step)
    train = restore_train_state(create_train_state(_net(seed=10), cfg), mgr)
    assert train.step == 2
    assert float(train.optimizer.state_dict()["learning_rate"]) == pytest.approx(5e-4)

    # one more update on each side, on the same batch
    batch = _batch(8, 20)
    old = to_flax(train.model.state_dict())
    _port_update(train, cfg, batch, 0.01, 1e-3)
    jstate, _ = step(jax.tree_util.tree_map(jnp.asarray, restored), as_jax(batch), 0.01, 1e-3)
    jstate = jax.device_get(jstate)
    errs = _update_rel_l2(to_flax(train.model.state_dict()), old, jstate.params, restored.params)
    assert max(errs.values()) < UPDATE_REL_L2, errs
    assert int(train.optimizer.state_dict()["count"]) == int(jstate.opt_state[1].inner_state[0].count) == 3

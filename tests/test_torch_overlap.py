"""The port's overlapped actor/learner step (``fused/overlap.py``) held
against the JAX package's ``fused/overlap.py`` and the port's fused step.

Every JAX side runs ``BA3CNet(conv_features=(8, 8, 16, 16), fc_units=16)``
(at those widths JAX's pallas and xla models are one function, as in
``tests/test_torch_fused.py``) on JAX Pong frames or JAX Pong rollouts;
the port starts from the JAX params (converted) and replays the JAX draws
(``JaxReplay``). The bounds:

- ``make_block_grads`` on one seeded ``TrajBlock``, one chunk and three
  env-column chunks, with the Huber value loss and without: per-leaf
  gradient rel-L2 within the larger of ``tests/test_torch_model.py``'s
  bounds (2e-2; 0.1 on the leaves whose gradients JAX sums in bf16, the
  conv biases and the PReLU slope) and JAX's own spread between its
  one-chunk and three-chunk gradients (``test_torch_vtrace.assert_grads_match``),
  and every aux metric within 2e-2 relative.
- Lag 0 with frozen params is BIT-EXACT with the port's fused step over 4
  windows (frame stacks, env states, episode counters, the cumulative
  metrics): the contract of ``tests/test_overlap.py:87``. One live lag-0
  update lands on the fused update within ``tests/test_overlap.py:135``'s
  ``rtol=2e-4, atol=2e-5``, ``mean_rho`` within 1e-5 of 1 and the loss
  terms within 5e-4.
- Lag 1 against JAX's lag-1 overlap step, two updates from a common
  state: the block in flight after the first (rolled under the initial
  params) has equal states and actions and behaviour log-probs within
  1e-5; each update's per-leaf rel-L2 is within the fused test's 5e-2,
  but for the second update's bf16-sum leaves (the PReLU slope reads
  0.195: Adam's second step amplifies JAX's bf16 sum where the two
  gradients cancel), held instead at the gradient against JAX's
  ``make_block_grads`` on that block, as ``make_block_grads`` above.
- The CLI: ``--trainer tpu_fused_ba3c --overlap --env jax:pong`` trains,
  writes ``mean_rho`` and ``value_lag_mae`` to stat.json and resumes with
  ``--load``; ``--overlap`` needs the fused trainer.
"""

from __future__ import annotations

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_ba3c_tpu.config import BA3CConfig as JaxConfig
from distributed_ba3c_tpu.envs.jaxenv import pong as jpong
from distributed_ba3c_tpu.fused import loop as jloop
from distributed_ba3c_tpu.fused import overlap as joverlap
from distributed_ba3c_tpu.models.a3c import BA3CNet as JaxNet
from distributed_ba3c_tpu.ops.gradproc import make_optimizer as jax_make_optimizer
from distributed_ba3c_tpu.parallel.mesh import make_mesh
from distributed_ba3c_tpu_torch import cli, telemetry
from distributed_ba3c_tpu_torch.config import BA3CConfig
from distributed_ba3c_tpu_torch.envs.jaxenv import pong
from distributed_ba3c_tpu_torch.fused.loop import CUMULATIVE_METRICS, create_fused_state, make_fused_step
from distributed_ba3c_tpu_torch.fused.overlap import (
    TrajBlock,
    make_block_grads,
    make_overlap_step,
    n_env_chunks,
)
from distributed_ba3c_tpu_torch.models import BA3CNet, from_flax, to_flax
from test_torch_fused import (
    FEATS,
    METRIC_REL,
    N_ENVS,
    T,
    UPDATE_REL_L2,
    _np_tree,
    _port_state,
    _update_rel_l2,
)
from test_torch_model import pong_frames
from test_torch_vtrace import assert_grads_match, bf16_sum_leaf

AUX = ("loss", "policy_loss", "value_loss", "entropy", "mean_rho", "pred_value",
       "value_lag_mae")


def _jax_parts(cfg=None):
    cfg = cfg or JaxConfig(fc_units=16)
    model = JaxNet(num_actions=6, fc_units=16, conv_features=FEATS)
    opt = jax_make_optimizer(cfg.learning_rate, cfg.adam_epsilon, cfg.grad_clip_norm)
    return cfg, model, opt, make_mesh(num_data=1, devices=jax.devices()[:1])


# -- make_block_grads ----------------------------------------------------------

BT, BB = 4, 3  # the block: 4 steps x 3 env columns


def _block_arrays(seed=0):
    rng = np.random.default_rng(seed)
    frames = pong_frames((BT + 1) * BB, seed=seed + 1)
    return {
        "states": frames[:BT * BB].reshape(BT, BB, 84, 84, 4),
        "actions": rng.integers(0, 6, (BT, BB)).astype(np.int32),
        "rewards": rng.choice([-1.0, 0.0, 0.0, 1.0], (BT, BB)).astype(np.float32),
        "dones": (rng.random((BT, BB)) < 0.25).astype(np.float32),
        "behavior_log_probs": (np.log(1 / 6) + rng.normal(scale=0.05, size=(BT, BB))
                               ).astype(np.float32),
        "behavior_values": rng.normal(scale=0.5, size=(BT, BB)).astype(np.float32),
        "bootstrap_state": frames[BT * BB:],
    }


def _jax_block_grads(params, arrays, gcs, huber=None):
    """JAX's ``make_block_grads(model, cfg, gcs)(params, block, 0.01)``."""
    jcfg, model, _, _ = _jax_parts(JaxConfig(fc_units=16, value_huber_delta=huber))
    jblock = joverlap.TrajBlock(**{k: jnp.asarray(v) for k, v in arrays.items()})
    fn = jax.jit(joverlap.make_block_grads(model, jcfg, gcs))
    return _np_tree(fn(jax.tree_util.tree_map(jnp.asarray, params), jblock, jnp.float32(0.01)))


@pytest.fixture(scope="module")
def jax_block_grads():
    """The init params, and JAX's gradients and aux of one block at one
    chunk and at three, with and without the Huber value loss."""
    _, model, _, _ = _jax_parts()
    params = _np_tree(model.init(jax.random.PRNGKey(3), jnp.zeros((1, 84, 84, 4), jnp.uint8))
                      ["params"])
    arrays = _block_arrays()
    return params, arrays, {(gcs, huber): _jax_block_grads(params, arrays, gcs, huber)
                            for gcs in (4096, 4) for huber in (None, 1.0)}


@pytest.mark.parametrize("huber", [None, 1.0], ids=["mse", "huber"])
@pytest.mark.parametrize("gcs", [4096, 4], ids=["one_chunk", "three_chunks"])
def test_block_grads_match_jax(gcs, huber, jax_block_grads):
    assert n_env_chunks(BT, BB, gcs) == (1 if gcs == 4096 else 3)
    params, arrays, ref = jax_block_grads
    jgrads, jaux = ref[(gcs, huber)]
    other = ref[(4 if gcs == 4096 else 4096, huber)][0]

    cfg = BA3CConfig(fc_units=16, value_huber_delta=huber)
    net = BA3CNet(6, fc_units=16, conv_features=FEATS, device="cpu")
    net.load_state_dict(from_flax(params))
    block = TrajBlock(**{k: torch.from_numpy(v) for k, v in arrays.items()})
    grads, aux = make_block_grads(net, cfg, gcs)(block, 0.01)
    got = to_flax({k: g for (k, _), g in zip(net.named_parameters(), grads)})
    assert_grads_match(got, jgrads, other)
    assert set(aux) == set(jaux) == set(AUX)
    for k in AUX:
        g, r = float(aux[k]), float(jaux[k])
        assert abs(g - r) <= METRIC_REL * max(abs(r), 1e-6), (k, g, r)
    assert 0.9 < float(aux["mean_rho"]) < 1.0  # the clip engaged


def test_env_column_chunks_clamp_and_give_the_one_chunk_update():
    """A chunk of fewer samples than one column (T) clamps to one column a
    chunk (JAX's rounding loop would never end above B); the mean of the
    column chunks is the one-chunk gradient, so one lag-0 update lands on
    the one-chunk update (``tests/test_overlap.py:190``'s bounds)."""
    assert n_env_chunks(BT, BB, 2) == BB and n_env_chunks(3, 4, 5) == 4
    assert n_env_chunks(20, 128, 4096) == 1  # the CLI's shape: one chunk
    runs = []
    for gcs in (4096, 2):
        (_, _, _), (net, o, step) = _port_pair(lag=0, grad_chunk_samples=gcs)
        o, m = step(o, 0.01, 1e-3)
        runs.append((net.state_dict(), m))
    (p1, m1), (p3, m3) = runs
    for k in p1:
        torch.testing.assert_close(p3[k], p1[k], rtol=2e-4, atol=2e-5, msg=k)
    assert abs(float(m1["loss"]) - float(m3["loss"])) < 5e-4


# -- lag 0 against the port's fused step ---------------------------------------

def _port_pair(lag, **kw):
    """The port's fused step and overlap step over two fresh copies of one
    seeded state."""
    out = []
    for kind in ("fused", "overlap"):
        cfg = BA3CConfig(fc_units=16)
        net = BA3CNet(6, fc_units=16, conv_features=FEATS, device="cpu",
                      generator=torch.Generator().manual_seed(1))
        state = create_fused_state(5, net, cfg, pong, N_ENVS)
        if kind == "fused":
            step = make_fused_step(net, state.train.optimizer, cfg, pong, T)
        else:
            step = make_overlap_step(net, state.train.optimizer, cfg, pong, T, lag=lag, **kw)
            state = step.put(state)
        out.append((net, state, step))
    return out


def test_lag0_frozen_is_bitexact_with_the_fused_step():
    (fnet, f, fstep), (onet, o, ostep) = _port_pair(lag=0)
    p0 = {k: v.clone() for k, v in onet.state_dict().items()}
    for _ in range(4):
        f, mf = fstep(f, 0.01, 0.0)
        o, mo = ostep(o, 0.01, 0.0)
    assert f.train.step == o.train.step == 4 and o.block is None
    assert torch.equal(f.obs_stack, o.actor.obs_stack)
    for a, b in zip(f.env_state, o.actor.env_state):
        assert torch.equal(a, b)
    for name in ("ep_count", "ep_return", "ep_return_sum"):
        assert torch.equal(getattr(f, name), getattr(o.actor, name)), name
    for k in (*CUMULATIVE_METRICS, "reward_per_step"):
        assert torch.equal(mf[k], mo[k]), k
    for k, v in onet.state_dict().items():
        assert torch.equal(v, p0[k]), k


def test_lag0_live_update_matches_the_fused_update():
    (fnet, f, fstep), (onet, o, ostep) = _port_pair(lag=0)
    f, mf = fstep(f, 0.01, 1e-3)
    o, mo = ostep(o, 0.01, 1e-3)
    assert abs(float(mo["mean_rho"]) - 1.0) < 1e-5
    for (k, a), b in zip(fnet.state_dict().items(), onet.state_dict().values()):
        torch.testing.assert_close(b, a, rtol=2e-4, atol=2e-5, msg=k)
    for k in ("loss", "policy_loss", "value_loss", "entropy"):
        assert abs(float(mf[k]) - float(mo[k])) < 5e-4, k


# -- lag 1 against JAX's overlap step -------------------------------------------

@pytest.fixture(scope="module")
def jax_lag1_run():
    """JAX's lag-1 overlap step: its initial state, and after each of two
    calls at 1e-3 the train state and the block in flight."""
    cfg, model, opt, mesh = _jax_parts()
    step = joverlap.make_overlap_step(model, opt, cfg, mesh, jpong, rollout_len=T)
    s0 = jloop.create_fused_state(jax.random.PRNGKey(0), model, cfg, opt, jpong, N_ENVS,
                                  n_shards=1)
    host0 = _np_tree(s0)
    s = step.put(s0)
    out = []
    for _ in range(2):
        s, m = step(s, 0.01, 1e-3)
        out.append({"train": _np_tree(s.train), "block": _np_tree(s.block),
                    "metrics": {k: float(v) for k, v in m.items()}})
    # the second update's gradients: the state after the first, its block
    b1 = out[0]["block"]
    block = {f.name: getattr(b1, f.name) for f in dataclasses.fields(b1)}
    grads = [_jax_block_grads(out[0]["train"].params, block, gcs)[0] for gcs in (4096, T)]
    return {"init": host0, "calls": out, "grads2": grads}


def test_lag1_matches_jax_overlap_step(jax_lag1_run):
    run = jax_lag1_run
    fused = _port_state(run["init"])
    net = fused.train.model
    step = make_overlap_step(net, fused.train.optimizer, BA3CConfig(fc_units=16), pong, T)
    state = step.put(fused)
    old = to_flax(net.state_dict())
    state, m = step(state, 0.01, 1e-3)
    ref = run["calls"][0]
    # the block in flight: window 2, rolled under the initial params
    np.testing.assert_array_equal(state.block.states.numpy(), ref["block"].states)
    np.testing.assert_array_equal(state.block.actions.numpy(), ref["block"].actions)
    np.testing.assert_allclose(state.block.behavior_log_probs.numpy(),
                               ref["block"].behavior_log_probs, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(state.block.bootstrap_state.numpy(),
                                  ref["block"].bootstrap_state)
    errs = _update_rel_l2(to_flax(net.state_dict()), old, ref["train"].params,
                          run["init"].train.params)
    assert max(errs.values()) < UPDATE_REL_L2, errs
    assert set(m) == set(ref["metrics"])
    for k in ("loss", "entropy", "mean_rho", "pred_value", "grad_norm"):
        r = ref["metrics"][k]
        assert abs(float(m[k]) - r) <= METRIC_REL * max(abs(r), 1e-6), (k, float(m[k]), r)
    # the second update, from JAX's state after the first (params and
    # Adam's moments) on the port's own block in flight, equal to JAX's
    net.load_state_dict(from_flax(ref["train"].params))
    inject = ref["train"].opt_state[1]
    adam = inject.inner_state[0]
    state.train.optimizer.load_state_dict({
        "count": np.asarray(adam.count), "mu": adam.mu, "nu": adam.nu,
        "learning_rate": np.asarray(inject.hyperparams["learning_rate"])})
    old = to_flax(net.state_dict())
    grads, _ = make_block_grads(net, BA3CConfig(fc_units=16))(state.block, 0.01)
    assert_grads_match(to_flax({k: g for (k, _), g in zip(net.named_parameters(), grads)}),
                       *run["grads2"])
    state, m = step(state, 0.01, 1e-3)
    assert state.train.step == 2
    errs = _update_rel_l2(to_flax(net.state_dict()), old, run["calls"][1]["train"].params,
                          ref["train"].params)
    errs = {k: v for k, v in errs.items() if not bf16_sum_leaf(k)}
    assert max(errs.values()) < UPDATE_REL_L2, errs


# -- the step's other contracts -------------------------------------------------

def test_lag1_keeps_a_block_in_flight_and_trains():
    (_, _, _), (net, o, step) = _port_pair(lag=1)
    p0 = {k: v.clone() for k, v in net.state_dict().items()}
    o, m = step(o, 0.01, 0.0)
    assert o.block is not None and o.block.states.shape == (T, N_ENVS, 84, 84, 4)
    assert all(torch.equal(v, p0[k]) for k, v in net.state_dict().items())
    o, m = step(o, 0.01, 1e-3)
    assert o.train.step == 2
    assert not all(torch.equal(v, p0[k]) for k, v in net.state_dict().items())
    assert set(AUX) <= set(m) and all(np.isfinite(float(v)) for v in m.values())
    # the actor's snapshot is a net of its own, not the learner's tensors
    assert all(a.data_ptr() != b.data_ptr()
               for a, b in zip(step.actor_net.parameters(), net.parameters()))


def test_steps_per_dispatch_runs_k_pairs_and_reduces_metrics():
    (_, _, _), (_, o, step) = _port_pair(lag=1, steps_per_dispatch=3)
    o, m = step(o, 0.01, 1e-3)
    assert o.train.step == 3
    assert all(v.dim() == 0 and np.isfinite(float(v)) for v in m.values())


def test_reset_episode_stats_keeps_the_running_return():
    (_, _, _), (_, o, step) = _port_pair(lag=1)
    for _ in range(4):
        o, m = step(o, 0.01, 1e-3)
    running = o.actor.ep_return.clone()
    o = step.reset_episode_stats(o)
    assert int(o.actor.ep_count.sum()) == 0 and float(o.actor.ep_return_sum.sum()) == 0.0
    assert torch.equal(o.actor.ep_return, running)


def test_probe_overlap_reports_and_advances():
    (_, _, _), (_, o, step) = _port_pair(lag=1)
    o, _ = step(o, 0.01, 1e-3)
    o, probe = step.probe_overlap(o, 0.01, reps=2)
    assert o.train.step == 1 + 2 * 2  # a solo learner and a pair a rep
    for k in ("actor_ms", "learner_ms", "pair_ms", "overlap_efficiency"):
        assert np.isfinite(probe[k]), k
    assert probe["actor_ms"] > 0 and probe["learner_ms"] > 0
    scalars = telemetry.registry("learner").scalars()
    for series in ("actor_program_ms", "learner_program_ms", "overlap_pair_ms",
                   "overlap_efficiency"):
        assert series in scalars, series


def test_bf16_snapshot_actor_runs_and_the_learner_trains():
    (_, _, _), (net, o, step) = _port_pair(lag=1, rollout_dtype="bfloat16")
    assert all(p.dtype == torch.bfloat16 for p in step.actor_net.parameters())
    p0 = {k: v.clone() for k, v in net.state_dict().items()}
    o, m = step(o, 0.01, 1e-3)
    assert o.block.behavior_log_probs.dtype == torch.float32
    assert torch.isfinite(o.block.behavior_log_probs).all()
    assert all(np.isfinite(float(v)) for v in m.values())
    assert not all(torch.equal(v, p0[k]) for k, v in net.state_dict().items())


@pytest.mark.parametrize("kw,err", [
    (dict(rollout_dtype="int8"), ValueError),  # int8 without a quant_spec
    (dict(macro_fleets=2), NotImplementedError),
    (dict(lag=2), ValueError),
    (dict(rollout_dtype="float16"), ValueError),
], ids=["int8", "fleet_accum", "lag2", "float16"])
def test_unported_and_invalid_options_raise(kw, err):
    net = BA3CNet(6, fc_units=16, conv_features=FEATS, device="cpu")
    state = create_fused_state(0, net, BA3CConfig(fc_units=16), pong, 2)
    with pytest.raises(err):
        make_overlap_step(net, state.train.optimizer, BA3CConfig(fc_units=16), pong, T, **kw)


# -- the CLI ---------------------------------------------------------------------

OVERLAP = ["--task", "train", "--trainer", "tpu_fused_ba3c", "--overlap", "--env", "jax:pong",
           "--fc_units", "16", "--batch_size", "8", "--rollout_len", "4",
           "--steps_per_epoch", "4", "--eval_every", "5", "--device", "cpu"]


def test_overlap_cli_trains_writes_mean_rho_and_resumes(tmp_path):
    assert cli.main([*OVERLAP, "--max_epoch", "1", "--logdir", str(tmp_path / "a")]) == 0
    stats = json.loads((tmp_path / "a" / "stat.json").read_text())
    assert stats[-1]["global_step"] == 4
    for k in ("loss", "mean_rho", "value_lag_mae"):
        assert np.isfinite(stats[-1][k]), k
    assert 0.0 < stats[-1]["mean_rho"] <= 1.0
    # samples_per_iter is the fused trainer's n_envs x rollout_len
    assert stats[-1]["tele/learner/train_samples_total"] == 4 * 2 * 4
    assert cli.main([*OVERLAP, "--max_epoch", "2", "--logdir", str(tmp_path / "b"),
                     "--load", str(tmp_path / "a" / "checkpoints")]) == 0
    stats = json.loads((tmp_path / "b" / "stat.json").read_text())
    assert [s["global_step"] for s in stats] == [8]
    ckpt = json.loads((tmp_path / "b" / "checkpoints" / "checkpoint.json").read_text())
    assert ckpt["latest"] == 8


@pytest.mark.parametrize("trainer", ["tpu_sync_ba3c", "tpu_vtrace_ba3c"])
def test_overlap_needs_the_fused_trainer(trainer, tmp_path):
    with pytest.raises(SystemExit) as e:
        cli.main(["--overlap", "--trainer", trainer, "--env", "fake", "--device", "cpu",
                  "--logdir", str(tmp_path)])
    assert e.value.code == 2
    assert not (tmp_path / "stat.json").exists()

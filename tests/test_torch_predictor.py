"""The port's BatchedPredictor (distributed_ba3c_tpu_torch/predict/server.py)
on the CPU: mirrors tests/test_predictor.py and the scheduler contracts of
tests/test_serving.py, and holds greedy serving actions against the JAX
package's BatchedPredictor on the same (converted) params and frames.

The scheduler tests run a null device in virtual time (a fake clock that
each fetched call advances), so every deadline decision is deterministic.
"""

from __future__ import annotations

import threading
import time
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from distributed_ba3c_tpu.models.a3c import BA3CNet as JaxNet
from distributed_ba3c_tpu.predict.server import BatchedPredictor as JaxPredictor
from distributed_ba3c_tpu_torch import telemetry
from distributed_ba3c_tpu_torch.models import BA3CNet, from_flax
from distributed_ba3c_tpu_torch.ops.conv_block import conv_block_fwd
from distributed_ba3c_tpu_torch.predict.server import (
    BatchedPredictor,
    ShedReject,
    _next_pow2,
    make_fwd_sample,
)

N_ACTIONS = 4
STATE = (4, 4, 2)
SMALL = (16, 16, 4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    return torch.device("cuda")


# -- the null device in virtual time ----------------------------------------


class _FakeClock:
    def __init__(self):
        self.t = 0.0
        self._lock = threading.Lock()

    def __call__(self):
        return self.t

    def advance(self, dt):
        with self._lock:
            self.t += dt


class _NullPred(BatchedPredictor):
    """Each fetched call advances the fake clock by ``service_s``."""

    service_s = 0.0
    vclock = None

    def _dispatch(self, params, batch):
        k = np.asarray(batch).shape[0]
        acts = (np.arange(k) % N_ACTIONS).astype(np.int32)
        return k, (acts, np.zeros(k, np.float32), np.full(k, -1.0, np.float32), acts)

    def _collect(self, handle):
        if self.vclock is not None and self.service_s:
            self.vclock.advance(self.service_s)
        return handle[1]


def _null_pred(service_s=0.0, **kw):
    telemetry.reset_all()
    clock = _FakeClock()
    kw.setdefault("coalesce_ms", 0.0)
    pred = _NullPred(SimpleNamespace(num_actions=N_ACTIONS), {}, clock=clock,
                     device="cpu", **kw)
    pred.service_s = service_s
    pred.vclock = clock
    return pred, clock


def _drain(resolved, total, timeout=20.0):
    deadline = time.monotonic() + timeout
    while resolved() < total and time.monotonic() < deadline:
        time.sleep(0.005)
    assert resolved() == total, f"only {resolved()}/{total} tasks resolved"


def _pred_scalar(name):
    return telemetry.registry("predictor").scalars().get(name, 0.0)


# -- a real small model -----------------------------------------------------


def _model(seed=0):
    return BA3CNet(N_ACTIONS, fc_units=16, image_size=SMALL[:2], device="cpu",
                   generator=torch.Generator().manual_seed(seed))


def _pred(seed=0, **kw):
    telemetry.reset_all()
    m = _model(seed)
    kw.setdefault("batch_size", 8)
    return m, BatchedPredictor(m, m.state_dict(), device="cpu", **kw)


def _states(n, seed=0):
    return np.random.default_rng(seed).integers(0, 255, (n, *SMALL), dtype=np.uint8)


def test_next_pow2():
    assert [_next_pow2(n) for n in (1, 2, 3, 5, 8, 9)] == [1, 2, 4, 8, 8, 16]


def test_sync_predict_shapes_and_padding():
    _, pred = _pred()
    actions, values, greedy = pred.predict_batch(np.zeros((5, *SMALL), np.uint8))
    assert actions.shape == values.shape == greedy.shape == (5,)
    assert ((actions >= 0) & (actions < N_ACTIONS)).all()
    assert ((greedy >= 0) & (greedy < N_ACTIONS)).all()


@pytest.mark.parametrize("greedy,rows", [(False, 4), (True, 3)])
def test_fwd_sample_packed_shapes(greedy, rows):
    m = _model()
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        packed = make_fwd_sample(m, m.state_dict(), torch.from_numpy(_states(5)), g, greedy)
    assert packed.shape == (rows, 5) and packed.dtype == torch.float32
    out = m(torch.from_numpy(_states(5)))
    argmax = out.logits.argmax(-1).float()
    assert torch.equal(packed[rows - 1 if not greedy else 0], argmax)
    # row 2 is log mu(action|state) of row 0's action
    logp = torch.log_softmax(out.logits, -1).gather(1, packed[0].long()[:, None])[:, 0]
    torch.testing.assert_close(packed[2], logp.detach())
    torch.testing.assert_close(packed[1], out.value.detach())


def test_sampling_follows_the_generator_and_the_policy():
    """Gumbel-argmax draws: the same generator seed gives the same actions,
    and the empirical action frequencies follow softmax(logits)."""
    m = _model()
    params = {k: v * 0 for k, v in m.state_dict().items()}
    params["policy.bias"] = torch.tensor([0.0, 1.0, 2.0, -1.0])
    x = torch.from_numpy(_states(1)).expand(4096, *SMALL).contiguous()
    with torch.no_grad():
        a1 = make_fwd_sample(m, params, x, torch.Generator().manual_seed(5))[0]
        a2 = make_fwd_sample(m, params, x, torch.Generator().manual_seed(5))[0]
        a3 = make_fwd_sample(m, params, x, torch.Generator().manual_seed(6))[0]
    assert torch.equal(a1, a2) and not torch.equal(a1, a3)
    freq = np.bincount(a1.long().numpy(), minlength=4) / 4096
    np.testing.assert_allclose(freq, torch.softmax(params["policy.bias"], 0).numpy(), atol=0.03)


def test_greedy_actions_match_the_jax_predictor():
    """Same flax params (converted) and frames: the port's greedy serving
    actions equal the JAX BatchedPredictor's wherever the top-2 logit
    margin exceeds the bf16 band; values within the band."""
    jm = JaxNet(num_actions=N_ACTIONS, fc_units=16)
    params = jax.device_get(
        jm.init(jax.random.PRNGKey(3), np.zeros((1, *SMALL), np.uint8))["params"]
    )
    states = _states(16, seed=4)
    jpred = JaxPredictor(jm, params, batch_size=16, greedy=True)
    j_actions, j_values, _ = jpred.predict_batch(states)
    jpred.stop()
    telemetry.reset_all()
    m = BA3CNet(N_ACTIONS, fc_units=16, image_size=SMALL[:2], device="cpu")
    pred = BatchedPredictor(m, from_flax(params), batch_size=16, greedy=True, device="cpu")
    actions, values, greedy = pred.predict_batch(states)
    np.testing.assert_array_equal(actions, greedy)
    logits = np.asarray(jm.apply({"params": params}, states).logits, np.float32)
    top2 = np.sort(logits, axis=-1)[:, -2:]
    band = 2e-2 * np.max(np.abs(logits))
    clear = (top2[:, 1] - top2[:, 0]) > band
    assert clear.sum() >= 8
    np.testing.assert_array_equal(actions[clear], np.asarray(j_actions)[clear])
    assert np.max(np.abs(values - j_values)) <= 2e-2 * np.max(np.abs(j_values)) + 1e-6


def test_async_callbacks_all_fire():
    _, pred = _pred()
    pred.start()
    try:
        n, results, lock, done = 60, {}, threading.Lock(), threading.Event()
        states = _states(n, seed=1)

        def make_cb(i):
            def cb(action, value, logp):
                with lock:
                    results[i] = (action, value, logp)
                    if len(results) == n:
                        done.set()
            return cb

        for i in range(n):
            pred.put_task(states[i], make_cb(i))
        assert done.wait(timeout=60), f"only {len(results)}/{n} callbacks fired"
        for a, v, lp in results.values():
            assert 0 <= a < N_ACTIONS and np.isfinite(v) and lp <= 0.0
    finally:
        pred.stop()
        pred.join(timeout=5)


def test_block_tasks_served_as_units_with_staging():
    _, pred = _pred(batch_size=16, greedy=True)
    states = _states(12, seed=2)
    ref, _, _ = pred.predict_batch(states)
    got, evt = [], threading.Event()
    for blk in (states[:5], states[5:]):
        pred.put_block_task(blk, lambda a, v, lp: (got.append(a), len(got) == 2 and evt.set()))
    pred.start()
    try:
        assert evt.wait(30)
        np.testing.assert_array_equal(np.concatenate(got), ref)
        assert _pred_scalar("stage_copies_total") >= 1
        with pytest.raises(ValueError, match="exceeds the serving bucket"):
            pred.put_block_task(_states(17), lambda *a: None)
    finally:
        pred.stop()
        pred.join(timeout=5)


def test_chunked_predict_batch_equals_one_call():
    _, pred = _pred(batch_size=4, greedy=True)
    states = _states(11, seed=5)
    actions, values, _ = pred.predict_batch(states)
    parts = [pred.predict_batch(states[i:i + 4]) for i in range(0, 11, 4)]
    np.testing.assert_array_equal(actions, np.concatenate([p[0] for p in parts]))
    np.testing.assert_allclose(values, np.concatenate([p[1] for p in parts]))
    assert _pred_scalar("chunked_calls_total") == 1


def test_update_params_changes_output():
    _, pred = _pred(greedy=True)
    states = np.full((2, *SMALL), 128, np.uint8)
    _, before, _ = pred.predict_batch(states)
    pred.update_params(_model(seed=7).state_dict())
    _, after, _ = pred.predict_batch(states)
    assert not np.allclose(before, after)
    assert _pred_scalar("param_publishes_total") == 1


def test_bfloat16_rollout_casts_params_and_stays_close():
    m, f32 = _pred(greedy=True)
    bf = BatchedPredictor(m, m.state_dict(), batch_size=8, greedy=True,
                          rollout_dtype="bfloat16", device="cpu")
    assert all(v.dtype == torch.bfloat16 for v in bf._params.values())
    assert all(v.dtype == torch.float32 for v in f32._params.values())
    states = _states(8, seed=6)
    _, v32, _ = f32.predict_batch(states)
    _, v16, _ = bf.predict_batch(states)
    assert np.max(np.abs(v32 - v16)) <= 5e-2 * np.max(np.abs(v32)) + 1e-3


def test_rollout_dtype_validation(monkeypatch):
    from distributed_ba3c_tpu_torch.quantize import QuantSpec, quant_layer_names

    m = _model()
    spec = QuantSpec(act_scales={n: 1.0 for n in quant_layer_names(m)})
    # JAX's three ValueErrors: int8 with no source, int8 with both, a
    # quant source off int8
    with pytest.raises(ValueError, match="exactly ONE calibration source"):
        BatchedPredictor(m, m.state_dict(), rollout_dtype="int8", device="cpu")
    with pytest.raises(ValueError, match="exactly ONE calibration source"):
        BatchedPredictor(m, m.state_dict(), rollout_dtype="int8", quant_spec=spec,
                         quant_calibrate=4, device="cpu")
    with pytest.raises(ValueError, match="do not apply"):
        BatchedPredictor(m, m.state_dict(), rollout_dtype="bfloat16", quant_spec=spec,
                         device="cpu")
    with pytest.raises(ValueError, match="rollout_dtype"):
        BatchedPredictor(m, m.state_dict(), rollout_dtype="fp8", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        BatchedPredictor(m, m.state_dict())  # cuda by default: raises here


# -- deadline semantics (null device, virtual time) --------------------------


def test_expired_task_is_shed_with_typed_reject():
    pred, clock = _null_pred(batch_size=8, queue_depth=16)
    served, sheds, evt = [], [], threading.Event()
    pred.put_block_task(
        np.zeros((4, *STATE), np.uint8), lambda a, v, lp: served.append(a),
        deadline=clock() + 0.05,
        shed_callback=lambda r: (sheds.append(r), evt.set()),
    )
    clock.advance(0.1)
    pred.start()
    try:
        assert evt.wait(10)
        assert served == []
        assert isinstance(sheds[0], ShedReject) and sheds[0].reason == "deadline"
        assert _pred_scalar("sheds_deadline_total") == 4
    finally:
        pred.stop()
        pred.join(timeout=5)


def test_full_admission_queue_rejects_fast():
    pred, _ = _null_pred(batch_size=8, queue_depth=4, slo_ms=1000.0)
    rejects, admitted = [], 0
    try:
        for _ in range(10):
            admitted += pred.put_block_task(
                np.zeros((2, *STATE), np.uint8), lambda a, v, lp: None,
                shed_callback=lambda r: rejects.append(r),
            )
        assert admitted == 4 and len(rejects) == 6
        assert all(r.reason == "queue_full" for r in rejects)
        assert _pred_scalar("sheds_queue_full_total") == 12
    finally:
        pred.stop()


def test_overload_sheds_but_admitted_p99_stays_bounded():
    slo_s, service_s = 0.05, 0.01
    pred, clock = _null_pred(service_s=service_s, batch_size=8, queue_depth=64,
                             slo_ms=1000 * slo_s)
    per_round = 2 * int(slo_s / service_s)
    lats, sheds = [], []
    pred.start()
    try:
        for _ in range(3):
            t0 = clock()

            def cb(a, v, lp, t0=t0):
                lats.append(clock() - t0)

            before = len(lats) + len(sheds)
            for _ in range(per_round):
                pred.put_block_task(np.zeros((8, *STATE), np.uint8), cb,
                                    shed_callback=lambda r: sheds.append(r))
            _drain(lambda: len(lats) + len(sheds), before + per_round)
    finally:
        pred.stop()
        pred.join(timeout=5)
    assert sheds and all(r.reason in ("deadline", "queue_full") for r in sheds)
    assert max(lats) <= slo_s + 1e-9
    assert _pred_scalar("deadline_misses_total") == 0
    assert len(lats) >= 3


def test_no_deadline_means_backpressure_and_fifo_service():
    pred, _ = _null_pred(batch_size=4, queue_depth=256)
    got, done, n = [], threading.Event(), 50

    def cb(i):
        def _cb(a, v, lp):
            got.append(i)
            if len(got) == n:
                done.set()
        return _cb

    for i in range(n):
        pred.put_task(np.zeros(STATE, np.uint8), cb(i))
    pred.start()
    try:
        assert done.wait(20)
        assert got == list(range(n)) and _pred_scalar("sheds_total") == 0
    finally:
        pred.stop()
        pred.join(timeout=5)


def test_estimator_recovers_after_transient_stall():
    pred, _ = _null_pred(service_s=0.2, batch_size=8, queue_depth=64, slo_ms=50.0)
    served, sheds = [], []
    pred.start()
    try:
        pred.put_block_task(np.zeros((8, *STATE), np.uint8),
                            lambda a, v, lp: served.append(1),
                            shed_callback=lambda r: sheds.append(r))
        _drain(lambda: len(served) + len(sheds), 1)
        assert served == [1]
        pred.service_s = 0.01
        for i in range(2, 42):
            pred.put_block_task(np.zeros((8, *STATE), np.uint8),
                                lambda a, v, lp: served.append(1),
                                shed_callback=lambda r: sheds.append(r))
            _drain(lambda: len(served) + len(sheds), i)
            if len(served) >= 3:
                break
    finally:
        pred.stop()
        pred.join(timeout=5)
    assert sheds and len(served) >= 3


# -- multi-policy serving ----------------------------------------------------


def test_canary_routing_is_deterministic_fraction():
    pred, _ = _null_pred(batch_size=4, queue_depth=256)
    pred.add_policy("canary", {})
    pred.set_canary("canary", 0.25)
    n, done, served = 16, threading.Event(), []

    def cb(a, v, lp):
        served.append(a)
        if len(served) == n:
            done.set()

    for _ in range(n):
        pred.put_task(np.zeros(STATE, np.uint8), cb)
    pred.start()
    try:
        assert done.wait(20)
        assert _pred_scalar("policy_canary_rows_total") == 4
        assert _pred_scalar("policy_default_rows_total") == 12
    finally:
        pred.stop()
        pred.join(timeout=5)


def test_policy_table_validation():
    pred, _ = _null_pred(batch_size=4)
    try:
        with pytest.raises(ValueError, match="policy id"):
            pred.add_policy("Not-Valid!", {})
        with pytest.raises(KeyError, match="unknown policy"):
            pred.set_canary("ghost", 0.5)
        with pytest.raises(KeyError, match="unknown policy"):
            pred.set_shadow("ghost")
        with pytest.raises(KeyError, match="unknown policy"):
            pred.update_params({}, policy="ghost")
        with pytest.raises(KeyError, match="unknown policy"):
            pred.put_task(np.zeros(STATE, np.uint8), lambda *a: None, policy="ghost")
        pred.add_policy("ok_2", {})
        with pytest.raises(ValueError, match="fraction"):
            pred.set_canary("ok_2", 1.5)
        pred.set_canary("ok_2", 0.5)
        pred.set_canary("ok_2", 0)
        assert pred._canary is None
    finally:
        pred.stop()


def test_raising_callback_does_not_kill_the_scheduler():
    pred, _ = _null_pred(batch_size=4, queue_depth=64)
    served, done = [], threading.Event()
    pred.start()
    try:
        pred.put_task(np.zeros(STATE, np.uint8),
                      lambda a, v, lp: (_ for _ in ()).throw(RuntimeError("bad cb")))
        pred.put_task(np.zeros(STATE, np.uint8),
                      lambda a, v, lp: (served.append(a), done.set()))
        assert done.wait(20), "scheduler died on the raising callback"
        assert served and pred.threads[0].is_alive()
        assert _pred_scalar("callback_errors_total") == 1
        assert telemetry.recorded("predictor_callback_error")[-1]["error"] == "bad cb"
    finally:
        pred.stop()
        pred.join(timeout=5)


def test_stop_delivers_shutdown_reject_to_queued_tasks():
    pred, _ = _null_pred(batch_size=4, queue_depth=16, slo_ms=1000.0)
    sheds, served = [], []
    for _ in range(3):
        pred.put_block_task(np.zeros((2, *STATE), np.uint8),
                            lambda a, v, lp: served.append(a),
                            shed_callback=lambda r: sheds.append(r))
    pred.stop()
    pred.threads[0].start()  # runs straight into the teardown drain
    pred.join(timeout=10)
    assert served == [] and len(sheds) == 3
    assert all(r.reason == "shutdown" for r in sheds)
    # after stop, a new task is rejected at once
    assert not pred.put_task(np.zeros(STATE, np.uint8), lambda *a: None,
                             shed_callback=lambda r: sheds.append(r))
    assert sheds[-1].reason == "shutdown"


def test_shadow_sees_identical_states_and_never_reaches_callers():
    m0, pred = _pred(seed=0, greedy=True)
    m1 = _model(seed=7)
    pred.add_policy("shadow_p", m1.state_dict())
    pred.set_shadow("shadow_p")
    taps = []
    pred.shadow_tap = lambda states, actions, pid: taps.append((states, actions, pid))
    states = _states(5, seed=3)
    got, evt = [], threading.Event()
    pred.put_block_task(states, lambda a, v, lp: (got.append(a), evt.set()))
    pred.start()
    try:
        assert evt.wait(60)
        deadline = time.monotonic() + 30
        while not taps and time.monotonic() < deadline:
            time.sleep(0.01)
        assert taps, "shadow mirror never fetched through the tap"

        def greedy_actions(m):
            with torch.no_grad():
                return m(torch.from_numpy(states)).logits.argmax(-1).numpy()

        np.testing.assert_array_equal(got[0], greedy_actions(m0))
        tap_states, tap_actions, pid = taps[0]
        assert pid == "shadow_p"
        np.testing.assert_array_equal(tap_states, states)
        np.testing.assert_array_equal(tap_actions, greedy_actions(m1))
        assert _pred_scalar("shadow_rows_total") == 5
    finally:
        pred.stop()
        pred.join(timeout=5)


@pytest.mark.cuda
def test_serving_on_the_card_goes_through_the_kernel(cuda):
    """On a CUDA device the served forward launches the conv-block kernel
    four times per call (one per block), and actions match the CPU's
    wherever the margin is clear."""
    m = BA3CNet(6, device=cuda, generator=torch.Generator().manual_seed(0))
    pred = BatchedPredictor(m, m.state_dict(), batch_size=64, greedy=True, device=cuda)
    states = np.random.default_rng(0).integers(0, 255, (64, 84, 84, 4), dtype=np.uint8)
    before = conv_block_fwd.launches
    actions, values, _ = pred.predict_batch(states)
    assert conv_block_fwd.launches == before + 4
    assert ((actions >= 0) & (actions < 6)).all() and np.isfinite(values).all()

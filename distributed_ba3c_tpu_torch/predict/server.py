"""SLO-aware serving plane: continuous batching, deadline admission, N policies.

Port of ``distributed_ba3c_tpu/predict/server.py``. What it keeps:

- ONE forward + sampling function per served batch (:func:`make_fwd_sample`):
  the BA3C forward and the action draw run on the device, and the host
  fetches one packed ``[4, B]`` (``[3, B]`` greedy) float32 tensor per call.
  Batches are padded to pow-2 buckets, which :meth:`BatchedPredictor.warmup`
  runs once each before traffic.
- **Continuous batching**: one scheduler thread keeps up to
  ``dispatch_depth`` device calls in flight. A call's work is launched on the
  predictor's own CUDA stream, its result copied into pinned host memory on
  that stream behind an event, and fetched only after the next call is
  dispatched, so the host never syncs between dispatches.
- **Deadline admission + load shedding**: tasks carry deadlines (defaulted
  from ``slo_ms``); the scheduler sheds tasks that cannot make theirs BEFORE
  spending device time on them, and a bounded admission queue turns
  overload into a fast typed :class:`ShedReject`.
- **Multi-policy serving**: ``add_policy``, a deterministic canary split
  (``set_canary``) and a shadow mirror (``set_shadow``) whose results never
  reach a caller.

Params are a BA3CNet ``state_dict`` (name -> tensor); each policy's copy
lives on the device, cast to ``rollout_dtype``. ``update_params`` swaps a
policy's table entry atomically.

A task of a sampled trace (``trace=``, telemetry/tracing.py) records two
spans under the predictor's role when its call is fetched:
``predict_dispatch`` (admission to the call's issue on the stream, host
time) and ``predict_fetch`` (issue to results on the host: on the card,
the wait on the call's CUDA event, i.e. the device's time plus the
device-to-host copy, and the pipeline's wait for the fetch). The
untraced path reads no clock for them.

**The int8 rung** (``rollout_dtype="int8"``, quantize/): with a frozen
``quant_spec`` every publish quantizes the f32 params into the int8 table
(``quantize_params``, on the predictor's stream) and the forward is the
quantized module (``make_quant_apply``; its arm is logged). With
``quant_calibrate=N`` instead the table serves f32 while the shadow mirror
feeds every served batch to a ``CalibrationTap``; after N batches the
spec freezes and ``_switch_to_int8`` quantizes every hot policy and swaps
forward and table together, in place. ``serving_dtype`` says which
precision serves now.
"""

from __future__ import annotations

import collections
import contextlib
import queue
import re
import threading
import time
import weakref
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call

from distributed_ba3c_tpu_torch import telemetry
from distributed_ba3c_tpu_torch.telemetry import tracing
from distributed_ba3c_tpu_torch.utils import logger
from distributed_ba3c_tpu_torch.utils.concurrency import (
    FastQueue,
    StoppableThread,
    queue_put_stoppable,
)
from distributed_ba3c_tpu_torch.utils.device import resolve_device

#: metric-name grammar for policy ids: they are embedded in Prometheus
#: series names (``policy_<id>_rows_total``)
_POLICY_ID_RE = re.compile(r"^[a-z0-9_]{1,32}$")


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


#: serving forward precisions: the PARAMS precision of the serving table
#: (models/a3c.py keeps the policy/value heads f32 either way)
ROLLOUT_DTYPES = ("float32", "bfloat16", "int8")


class _StagePool:
    """Reused per-shape serving staging buffers with a ready fence.

    ``_launch`` materializes each group ONCE into a pooled buffer instead of
    a fresh ``np.asarray`` + pad ``np.concatenate`` per dispatch. A buffer
    goes back to its free list when the dispatches that read it are fetched;
    an UNFETCHED release (the no-tap shadow mirror, which must never add a
    host sync) parks on the pending list until its handle reports ready."""

    __slots__ = ("_free", "_pending", "_c_alloc", "_c_copies")

    def __init__(self, tele):
        self._free: dict = {}     # (shape, dtype str) -> [ndarray, ...]
        self._pending: list = []  # (handle, key, ndarray) awaiting ready
        self._c_alloc = tele.counter("stage_alloc_total")
        self._c_copies = tele.counter("stage_copies_total")

    def _drain(self) -> None:
        still = []
        for handle, key, arr in self._pending:
            if handle.is_ready():
                self._free.setdefault(key, []).append(arr)
            else:
                still.append((handle, key, arr))
        self._pending = still

    def acquire(self, shape: tuple, dtype) -> np.ndarray:
        self._drain()
        key = (tuple(shape), np.dtype(dtype).str)
        free = self._free.get(key)
        if free:
            return free.pop()
        self._c_alloc.inc()
        return np.zeros(shape, dtype)

    def release(self, arr: np.ndarray, handle=None) -> None:
        key = (tuple(arr.shape), arr.dtype.str)
        if handle is None or handle.is_ready():
            self._free.setdefault(key, []).append(arr)
        else:
            self._pending.append((handle, key, arr))

    def count_copy(self) -> None:
        self._c_copies.inc()


class _StageLease:
    """One staged group buffer shared by its primary + shadow dispatches."""

    __slots__ = ("arr", "refs")

    def __init__(self, arr: np.ndarray, refs: int = 1):
        self.arr = arr
        self.refs = refs


class _Pending:
    """One dispatched call's packed result: a host tensor (pinned on CUDA)
    and the event recorded after its device-to-host copy (None on the CPU,
    where the result is ready when dispatch returns)."""

    __slots__ = ("out", "event")

    def __init__(self, out: torch.Tensor, event=None):
        self.out = out
        self.event = event

    def is_ready(self) -> bool:
        return self.event is None or self.event.query()

    def result(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.out.numpy()


class ShedReject:
    """Typed reject delivered to a task's ``shed_callback``.

    ``reason`` is one of:

    - ``"deadline"``: the scheduler proved the task could not be served
      before its deadline (queue wait + estimated device time) and shed it
      WITHOUT spending device time on it;
    - ``"queue_full"``: the bounded admission queue was full — the fast
      overload signal; retry after backing off, or fall back;
    - ``"shutdown"``: the predictor stopped while the task waited.
    """

    __slots__ = ("reason", "deadline", "now")

    def __init__(self, reason: str, deadline: Optional[float] = None,
                 now: Optional[float] = None):
        self.reason = reason
        self.deadline = deadline
        self.now = now

    def __repr__(self) -> str:
        return f"ShedReject(reason={self.reason!r}, deadline={self.deadline})"


class _BlockTask:
    """One whole [B, ...] state block awaiting ONE batched callback."""

    __slots__ = ("states", "callback", "k", "deadline", "policy", "shed_cb",
                 "t_admit", "trace")

    def __init__(self, states, callback, deadline=None, policy=None,
                 shed_cb=None, trace=None):
        self.states = states
        self.callback = callback
        self.k = states.shape[0]
        self.deadline = deadline
        self.policy = policy
        self.shed_cb = shed_cb
        self.t_admit = 0.0
        self.trace = trace  # tracing.TraceRef for a sampled block step


class _RowTask:
    """One single state row; ``k`` is always 1."""

    __slots__ = ("states", "callback", "k", "deadline", "policy", "shed_cb",
                 "t_admit", "trace")

    def __init__(self, state, callback, deadline=None, policy=None,
                 shed_cb=None, trace=None):
        self.states = state
        self.callback = callback
        self.k = 1
        self.deadline = deadline
        self.policy = policy
        self.shed_cb = shed_cb
        self.t_admit = 0.0
        self.trace = trace  # tracing.TraceRef for a sampled row


class _Inflight:
    """One dispatched-not-yet-fetched device call the scheduler tracks."""

    __slots__ = ("tasks", "n", "policy", "handle", "t_dispatch", "t_oldest",
                 "shadow", "states", "t_dispatch_us", "lease")

    def __init__(self, tasks, n, policy, handle, t_dispatch, t_oldest=0.0,
                 shadow=False, states=None, t_dispatch_us=0, lease=None):
        self.tasks = tasks        # ordered singles-then-blocks; None = shadow
        self.n = n
        self.policy = policy
        self.handle = handle      # (k, _Pending)
        self.t_dispatch = t_dispatch
        # admit stamp of the group's FIFO-oldest task (tasks is reordered
        # singles-first to match the batch layout)
        self.t_oldest = t_oldest
        self.shadow = shadow
        self.states = states      # batch kept only for a shadow tap
        # µs stamp of the issue for trace spans (0 when no task of the
        # group is traced: the untraced path reads no clock for it)
        self.t_dispatch_us = t_dispatch_us
        # _StageLease of the pooled staging buffer this call reads (None
        # for pass-through / sync-path batches); released at _complete
        self.lease = lease


def make_fwd_sample(
    model: torch.nn.Module,
    params: Dict[str, torch.Tensor],
    states: torch.Tensor,
    generator: torch.Generator,
    greedy: bool = False,
) -> torch.Tensor:
    """The action server's device program: forward + sampling, packed.

    Runs ``model`` with ``params`` (a state_dict, through
    ``torch.func.functional_call``) on ``states`` and returns ONE float32
    tensor: rows (action, value, log mu(action|state), argmax action)
    ``[4, B]``, or ``[3, B]`` when ``greedy`` (row 0 is then the argmax and
    the duplicate row is dropped). Sampling is Gumbel-argmax with noise
    drawn from ``generator`` (on the states' device), so no host sync.
    """
    out = functional_call(model, params, (states,))
    logits = out.logits
    argmax = torch.argmax(logits, dim=-1)
    if greedy:
        actions = argmax
    else:
        u = torch.rand(
            logits.shape, generator=generator, device=logits.device,
            dtype=logits.dtype,
        )
        actions = torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)
    # log mu(a|s): the behavior policy record V-trace needs
    log_probs = torch.log_softmax(logits, dim=-1)
    logp = torch.gather(log_probs, 1, actions[:, None])[:, 0]
    rows = [actions.float(), out.value, logp]
    if not greedy:
        rows.append(argmax.float())
    return torch.stack(rows)


class BatchedPredictor:
    """Asynchronous batched (action, value) server with an SLO contract.

    Parameters
    ----------
    model: a BA3CNet (or any module whose forward maps states to
        ``PolicyValue``); its structure is used, its weights are not.
    params: the ``default`` policy's state_dict.
    batch_size: micro-batch coalesce target; the hard bucket cap is the
        next power of two.
    seed: seed of the sampling generator.
    slo_ms: default deadline budget applied to every queued task (0 = no
        deadlines — the training plane's backpressure semantics).
    queue_depth: admission-queue bound. With deadlines, a full queue is an
        immediate typed reject; without, a blocking backpressure put.
    dispatch_depth: device calls kept in flight by the scheduler (2: fetch
        call k only after dispatching call k+1).
    clock: monotonic-clock callable (tests inject a fake clock).
    rollout_dtype: ``float32``, ``bfloat16`` or ``int8`` serving table.
    quant_spec: the frozen :class:`~distributed_ba3c_tpu_torch.quantize.spec.QuantSpec`
        of the int8 rung; or ``quant_calibrate`` = N live batches through
        the calibration tap (``quant_method``, ``quant_percentile``).
        ``int8`` takes exactly one of the two, and neither applies to
        another dtype (``ValueError``, as JAX's). The int8 forward's arm
        is ``auto``'s (``quantize/qforward.py``).
    tele_role: telemetry registry role (``predictor``; one per fleet
        when a learner hosts several).
    device: where the policies live and the forward runs; ``cuda`` by
        default, which raises when no card is present.

    ``model`` must not be the learner's own module: the forward swaps the
    served params into it (``functional_call``) from the scheduler thread.
    """

    def __init__(
        self,
        model,
        params,
        batch_size: int = 16,
        seed: int = 0,
        greedy: bool = False,
        coalesce_ms: float = 2.0,
        slo_ms: float = 0.0,
        queue_depth: int = 4096,
        dispatch_depth: int = 2,
        clock: Optional[Callable[[], float]] = None,
        tele_role: str = "predictor",
        rollout_dtype: str = "float32",
        device="cuda",
        quant_spec=None,
        quant_calibrate: int = 0,
        quant_method: str = "absmax",
        quant_percentile: float = 99.9,
    ):
        self._model = model
        # the masters' shed fallback draws uniform actions over this space
        self.num_actions = int(getattr(model, "num_actions", 0) or 0)
        if rollout_dtype not in ROLLOUT_DTYPES:
            raise ValueError(
                f"rollout_dtype must be one of {ROLLOUT_DTYPES}, got "
                f"{rollout_dtype!r}"
            )
        if rollout_dtype == "int8":
            if (quant_spec is None) == (not quant_calibrate):
                raise ValueError(
                    "rollout_dtype='int8' needs exactly ONE calibration "
                    "source: a frozen quant_spec, or quant_calibrate=N "
                    "live batches through the CalibrationTap"
                )
        elif quant_spec is not None or quant_calibrate:
            raise ValueError(
                "quant_spec/quant_calibrate configure the int8 rung — "
                f"they do not apply to rollout_dtype={rollout_dtype!r}"
            )
        self.rollout_dtype = rollout_dtype
        self.device = resolve_device(device)
        #: the ACTIVE QuantSpec (int8 serving); None while f32/bf16 and
        #: during the live-calibration window
        self.quant_spec = None
        self.tele_role = tele_role
        # the forward make_fwd_sample runs and the publish cast (state_dict
        # on the device -> table), swapped together by _switch_to_int8
        # under this lock; the scheduler thread, where the switch runs,
        # never needs it
        self._swap_lock = threading.Lock()
        self._fwd_model = model
        self._cast: Optional[Callable] = None
        if rollout_dtype == "int8" and quant_spec is not None:
            self.quant_spec = quant_spec
            self._fwd_model, self._cast = self._int8_program(quant_spec)
        # the predictor's own stream: every dispatch and every publish runs
        # on it, so one stream orders the params a call reads before it
        self._stream = (
            torch.cuda.Stream(self.device) if self.device.type == "cuda"
            else None
        )
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        # the generator is shared by the scheduler thread and sync callers
        self._gen_lock = threading.Lock()
        self._policies = {"default": self._put_policy(params, self._cast)}
        self._batch_size = batch_size
        self._coalesce_s = coalesce_ms / 1000.0
        self._slo_s = slo_ms / 1000.0
        self._depth = max(1, int(dispatch_depth))
        self._clock = clock or time.monotonic
        self._queue: FastQueue = FastQueue(maxsize=queue_depth)
        self._greedy = greedy
        self._stop_evt = threading.Event()
        # serve-time estimate feeding the deadline gate: a DECAYING MAX of
        # dispatch->fetch wall time (includes pipeline wait). Deliberately
        # conservative: the error mode must be shedding a task that would
        # have made it, never serving one late
        self._est_serve_s = 0.0
        self._inflight_n = 0
        # canary: an atomic (policy, fraction) tuple swap, routed at GROUP
        # granularity by a deficit accumulator (no RNG, no fragmentation)
        self._canary: Optional[Tuple[str, float]] = None
        self._shadow: Optional[str] = None
        self._canary_debt = 0.0  # scheduler-thread only
        self._held = None  # scheduler-local FIFO carry between groups
        #: test/eval tap for shadow results: ``tap(states, actions, policy)``
        #: — when None, shadow results are dropped WITHOUT a host sync
        self.shadow_tap: Optional[Callable] = None

        tele = telemetry.registry(tele_role)
        self.tele_role = tele_role
        self._tele = tele
        self._c_batches = tele.counter("batches_total")
        self._c_rows = tele.counter("rows_total")
        self._c_oversize = tele.counter("blocks_oversize_total")
        self._c_publishes = tele.counter("param_publishes_total")
        self._c_chunked = tele.counter("chunked_calls_total")
        self._c_chunks = tele.counter("chunks_total")
        self._h_occupancy = tele.histogram("batch_rows", unit=1)
        # sheds are counted in ROWS (a shed block is k lost requests);
        # misses are rows served past their deadline (should stay ~0)
        self._c_sheds = tele.counter("sheds_total")
        self._c_shed_deadline = tele.counter("sheds_deadline_total")
        self._c_shed_full = tele.counter("sheds_queue_full_total")
        self._c_deadline_miss = tele.counter("deadline_misses_total")
        self._h_queue_wait = tele.histogram("queue_wait_s", unit=1e-6)
        self._h_serve = tele.histogram("serve_latency_s", unit=1e-6)
        self._c_shadow_batches = tele.counter("shadow_batches_total")
        self._c_shadow_rows = tele.counter("shadow_rows_total")
        self._c_cb_errors = tele.counter("callback_errors_total")
        # batches served by the int8 table (the rest of batches_total
        # served f32/bf16, incl. a calibration window's)
        self._c_int8_batches = tele.counter("int8_batches_total")
        self._c_policy_rows = {
            "default": tele.counter("policy_default_rows_total")
        }

        ref = weakref.ref(self)
        tele.gauge(
            "task_queue_depth",
            fn=lambda: p._queue.qsize() if (p := ref()) else 0,
        )
        tele.gauge(
            "slo_ms", fn=lambda: p._slo_s * 1000.0 if (p := ref()) else 0
        )
        tele.gauge(
            "inflight_dispatches",
            fn=lambda: p._inflight_n if (p := ref()) else 0,
        )

        self._pool = _StagePool(tele)
        # the live-calibration window (int8 without a frozen spec): serve
        # f32 while the shadow mirror feeds every batch to the tap; after
        # N batches it freezes and _switch_to_int8 swaps forward + table
        self._warm_shape = None
        self._warm_dtype = None
        if rollout_dtype == "int8" and self.quant_spec is None:
            from distributed_ba3c_tpu_torch.quantize.calibrate import CalibrationTap

            self.shadow_tap = CalibrationTap(
                model, params, quant_calibrate,
                method=quant_method, percentile=quant_percentile,
                on_freeze=self._switch_to_int8, tele_role=tele_role,
                device=self.device,
            )
            self._shadow = "default"
        self.threads: List[StoppableThread] = [
            StoppableThread(
                target=self._scheduler, daemon=True, name="predictor-sched"
            )
        ]

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        for t in self.threads:
            t.start()

    def warmup(self, state_shape, dtype=np.uint8) -> None:
        """Run every pow-2 bucket up to batch_size once, before traffic:
        the kernels' build and load, the allocator's first blocks and the
        CUDA context all happen here, not under a caller's deadline."""
        # remembered for the int8 calibration switch: the swapped-in
        # forward proves the same buckets before it takes traffic
        self._warm_shape = tuple(state_shape)
        self._warm_dtype = dtype
        b = 1
        while b <= _next_pow2(self._batch_size):
            self._run_device(np.zeros((b, *state_shape), dtype))
            b *= 2

    def stop(self) -> None:
        self._stop_evt.set()
        for t in self.threads:
            t.stop()

    def join(self, timeout: Optional[float] = None) -> None:
        """Wait for the scheduler thread to exit (it polls with 0.5s
        timeout)."""
        for t in self.threads:
            if t.is_alive():
                t.join(timeout)

    # -- the int8 rung -----------------------------------------------------
    @property
    def serving_dtype(self) -> str:
        """The precision the table SERVES now: ``rollout_dtype``, except
        during the int8 live-calibration window (f32 until the tap freezes
        and the switch lands)."""
        if self.rollout_dtype != "int8":
            return self.rollout_dtype
        return "int8" if self.quant_spec is not None else "float32"

    def _int8_program(self, spec):
        """The int8 forward (its arm resolved on this device, and logged)
        and the publish cast for ``spec``."""
        from distributed_ba3c_tpu_torch.quantize.qforward import (
            make_quant_apply,
            quantize_params,
        )

        net = make_quant_apply(self._model, "auto", device=self.device)
        logger.info(
            "predictor %s: int8 forward, arm %s on %s, quant spec %s",
            self.tele_role, net.quant_arm,
            self.device, spec.sha256()[:12],
        )
        return net, lambda table: quantize_params(table, spec)

    def _on_stream(self):
        return (torch.cuda.stream(self._stream) if self._stream is not None
                else contextlib.nullcontext())

    def _switch_to_int8(self, spec) -> None:
        """The CalibrationTap's freeze hook: switch the serving plane to
        int8 IN PLACE -- quantize every hot policy, swap in the int8
        forward, retire the shadow mirror and the tap, and prove the
        warmed buckets through the new forward.

        Runs on the scheduler thread (the tap fires from the shadow fetch),
        so no async dispatch is concurrent with it; ``_swap_lock`` covers
        the sync ``predict_batch`` path."""
        fwd, cast = self._int8_program(spec)
        while True:
            # quantize OUTSIDE the lock, commit only if no publish replaced
            # an entry meanwhile -- else a fresh f32 table would be dropped
            snapshot = dict(self._policies)
            with torch.no_grad(), self._on_stream():
                table = {pid: cast(p) for pid, p in snapshot.items()}
            with self._swap_lock:
                current = self._policies
                if len(current) == len(snapshot) and all(
                    current.get(pid) is p for pid, p in snapshot.items()
                ):
                    self._cast = cast
                    self._policies = table
                    self._fwd_model = fwd
                    self.quant_spec = spec
                    break
        # the tap saw its N batches; from here the mirror would only double
        # the device work
        self._shadow = None
        self.shadow_tap = None
        if self._warm_shape is not None:
            b = 1
            while b <= _next_pow2(self._batch_size):
                self._run_device(np.zeros((b, *self._warm_shape), self._warm_dtype))
                b *= 2
        self._c_publishes.inc()
        logger.info(
            "predictor %s: calibrated over %d batches, serving int8 (spec %s)",
            self.tele_role, spec.calibration_batches, spec.sha256()[:12],
        )

    # -- policy table ------------------------------------------------------
    def _publish_policy(self, policy_id: str, params) -> None:
        """Commit a publish to the table: cast/quantize OUTSIDE the swap
        lock, store only if the serving forward did not change underneath
        (a publish racing ``_switch_to_int8`` lands through the NEW cast,
        never as an f32 table behind the int8 forward)."""
        while True:
            cast = self._cast
            p = self._put_policy(params, cast)
            with self._swap_lock:
                if self._cast is cast:
                    self._policies[policy_id] = p
                    return

    def _put_policy(self, params, cast=None) -> Dict[str, torch.Tensor]:
        """Params -> the serving table's storage: a device copy, float32
        entries cast to the rollout dtype, then ``cast`` (the int8 rung's
        quantize-on-publish) -- ONE place, so every publish path (ctor,
        add_policy, update_params) serves the same precision.

        On CUDA the copy runs on the predictor's stream, after the caller's
        pending work on its current stream, so the dispatches that read
        the table are ordered after it without a host sync; and the
        caller's stream then waits for the copy, so the caller's next work
        (the learner's in-place Adam update) cannot overwrite the source
        tensors while the copy still reads them."""
        dt = torch.bfloat16 if self.rollout_dtype == "bfloat16" else None

        def put(v: torch.Tensor) -> torch.Tensor:
            v = torch.as_tensor(v)
            cast = dt if (dt is not None and v.dtype == torch.float32) else v.dtype
            return v.detach().to(device=self.device, dtype=cast, copy=True)

        def build():
            table = {k: put(v) for k, v in params.items()}
            return table if cast is None else cast(table)

        if self._stream is None:
            return build()
        caller = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(caller)
        with torch.cuda.stream(self._stream):
            table = build()
        caller.wait_stream(self._stream)
        return table

    def add_policy(self, policy_id: str, params) -> None:
        """Make a second checkpoint hot behind the same scheduler.

        ``policy_id`` must match ``[a-z0-9_]{1,32}`` — it is embedded in
        the per-policy telemetry series names."""
        if not _POLICY_ID_RE.match(policy_id):
            raise ValueError(
                f"policy id {policy_id!r} must match {_POLICY_ID_RE.pattern} "
                "(it names Prometheus series)"
            )
        self._publish_policy(policy_id, params)
        self._c_policy_rows.setdefault(
            policy_id, self._tele.counter(f"policy_{policy_id}_rows_total")
        )

    def set_canary(self, policy_id: str, fraction: float) -> None:
        """Route ``fraction`` of un-pinned traffic to ``policy_id``.

        Deterministic deficit-accumulator split at GROUP granularity (no
        RNG, full batch occupancy preserved). 0 clears the canary. Callers
        that pin ``policy=`` on their tasks bypass routing."""
        if fraction <= 0:
            self._canary = None
            return
        if not 0 < fraction <= 1:
            raise ValueError(f"canary fraction {fraction} not in (0, 1]")
        if policy_id not in self._policies:
            raise KeyError(f"unknown policy {policy_id!r} — add_policy first")
        self._canary = (policy_id, float(fraction))

    def set_shadow(self, policy_id: Optional[str]) -> None:
        """Mirror EVERY served batch through ``policy_id``; its results never
        reach any caller (dropped without a host sync unless a
        ``shadow_tap`` is installed). ``None`` clears."""
        if policy_id is not None and policy_id not in self._policies:
            raise KeyError(f"unknown policy {policy_id!r} — add_policy first")
        self._shadow = policy_id

    def update_params(self, params, policy: str = "default") -> None:
        """Publish fresh weights (atomic ref swap; next batch uses them).

        Only EXISTING policies can be republished — a typo'd id must fail
        loudly, not create a dead entry."""
        if policy not in self._policies:
            raise KeyError(f"unknown policy {policy!r} — add_policy first")
        self._publish_policy(policy, params)
        self._c_publishes.inc()

    # -- API ---------------------------------------------------------------
    def put_task(
        self,
        state: np.ndarray,
        callback: Callable[[int, float, float], None],
        *,
        deadline: Optional[float] = None,
        policy: Optional[str] = None,
        shed_callback: Optional[Callable[[ShedReject], None]] = None,
        trace=None,
    ) -> bool:
        """Queue one state; ``callback(action, value, logp)`` fires when
        served — logp is log mu(action|state) under the sampling policy.

        ``deadline`` is an absolute clock() time (defaulted from ``slo_ms``
        when set); a task that cannot make it is shed with a typed
        :class:`ShedReject` to ``shed_callback`` instead of served late.
        ``trace`` is a sampled ``tracing.TraceRef``: the scheduler records
        its dispatch and fetch spans under this predictor's role.
        Returns True if admitted."""
        return self._admit(
            _RowTask(state, callback, deadline, policy, shed_callback, trace)
        )

    def put_block_task(
        self,
        states: np.ndarray,
        callback: Callable[[np.ndarray, np.ndarray, np.ndarray], None],
        *,
        deadline: Optional[float] = None,
        policy: Optional[str] = None,
        shed_callback: Optional[Callable[[ShedReject], None]] = None,
        trace=None,
    ) -> bool:
        """Queue one [B, ...] state block; ``callback(actions[B], values[B],
        logps[B])`` fires ONCE when the block is served. The block lands in
        a pow-2 bucket as a unit; queued neighbors coalesce into one device
        call up to the bucket cap. Same deadline/shed semantics as
        :meth:`put_task`; ``trace`` as there."""
        cap = _next_pow2(max(self._batch_size, 1))
        if states.shape[0] > cap:
            self._c_oversize.inc()
            raise ValueError(
                f"block of {states.shape[0]} states exceeds the serving "
                f"bucket ({cap}) — raise predict_batch_size to at least "
                "the env-server block size"
            )
        return self._admit(
            _BlockTask(states, callback, deadline, policy, shed_callback,
                       trace)
        )

    def predict_batch(
        self, states: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Synchronous batched predict: (actions, values, greedy_actions).

        ``actions`` follow the serving policy (sampled, or argmax when
        ``greedy=True``); ``greedy_actions`` are always the argmax. Always
        the ``default`` policy; never queued, never shed."""
        actions, values, _, greedy_actions = self._run_rows(
            np.asarray(states)
        )
        return actions, values, greedy_actions

    # -- admission ---------------------------------------------------------
    def _admit(self, task) -> bool:
        now = self._clock()
        task.t_admit = now
        if task.deadline is None and self._slo_s > 0:
            task.deadline = now + self._slo_s
        if task.policy is not None and task.policy not in self._policies:
            # validated HERE, in the caller's thread: an unknown id reaching
            # the scheduler would kill the one thread the plane runs on
            raise KeyError(
                f"unknown policy {task.policy!r} — add_policy first"
            )
        if self._stop_evt.is_set():
            self._shed(task, "shutdown")
            return False
        if task.deadline is not None:
            # serving contract: a full bounded queue is an IMMEDIATE typed
            # reject, never unbounded queue latency
            try:
                self._queue.put_nowait(task)
            except queue.Full:
                self._shed(task, "queue_full")
                return False
        else:
            # training contract (no deadline): backpressure pauses the
            # caller, but stays shutdown-responsive
            if not queue_put_stoppable(self._queue, task, self._stop_evt):
                self._shed(task, "shutdown")
                return False
        if self._stop_evt.is_set():
            # the put may have raced PAST the scheduler's final teardown
            # drain — resolve the queue from this thread
            self._drain_shutdown()
        return True

    def _route_group(self, weight: int) -> str:
        """Resolve an un-pinned group's policy (scheduler thread only).

        Deficit accumulator: each routed group adds ``fraction * weight``
        of canary debt; a group dispatches to the canary when the debt
        covers it. Over time exactly ``fraction`` of routed ROWS serve
        the canary."""
        c = self._canary
        if c is None:
            return "default"
        pid, frac = c
        self._canary_debt += frac * weight
        if self._canary_debt >= weight:
            self._canary_debt -= weight
            return pid
        return "default"

    def _shed(self, task, reason: str) -> None:
        self._c_sheds.inc(task.k)
        if reason == "deadline":
            self._c_shed_deadline.inc(task.k)
            # transient-stall recovery: a FRESH task (>80% of its budget
            # left — the estimator, not queue wait, shed it) decays the
            # estimate 10%, so after a stall the scheduler probes its way
            # back to serving instead of shedding forever
            if task.deadline is not None:
                budget = task.deadline - task.t_admit
                if budget > 0 and (
                    task.deadline - self._clock() > 0.8 * budget
                ):
                    self._est_serve_s *= 0.9
        elif reason == "queue_full":
            self._c_shed_full.inc(task.k)
        cb = task.shed_cb
        if cb is not None:
            self._fire(cb, ShedReject(reason, task.deadline, self._clock()))

    def _fire(self, fn, *args) -> None:
        """Run one user callback; an exception must not kill the ONE
        thread the whole serving plane runs on. Counted, recorded and
        logged, never silent."""
        try:
            fn(*args)
        except Exception as e:
            self._c_cb_errors.inc()
            telemetry.record("predictor_callback_error", error=str(e)[:200])
            logger.error("predictor callback raised %r", e)

    # -- internals ---------------------------------------------------------
    def _dispatch(self, params, batch: np.ndarray, fwd=None):
        """Pad to the pow-2 bucket and launch forward + sampling; NO host
        fetch — the scheduler fetches via :meth:`_collect` only after the
        next group is dispatched. Returns ``(k, _Pending)``.

        ``params`` is passed explicitly so a multi-chunk caller serves ONE
        parameter version even if a publish lands mid-batch; ``fwd`` (the
        forward module) likewise, as the int8 switch swaps it."""
        model = self._fwd_model if fwd is None else fwd
        batch = np.asarray(batch)
        k = batch.shape[0]
        padded = _next_pow2(max(k, 1))
        if padded != k:
            pad = np.zeros((padded - k, *batch.shape[1:]), batch.dtype)
            batch = np.concatenate([batch, pad], axis=0)
        host = torch.from_numpy(batch)
        with torch.inference_mode(), self._gen_lock:
            if self._stream is None:
                out = make_fwd_sample(
                    model, params, host, self._gen, self._greedy
                )
                return k, _Pending(out)
            with torch.cuda.stream(self._stream):
                states = host.to(self.device, non_blocking=True)
                packed = make_fwd_sample(
                    model, params, states, self._gen, self._greedy
                )
                out = torch.empty(packed.shape, dtype=packed.dtype,
                                  pin_memory=True)
                out.copy_(packed, non_blocking=True)
                event = torch.cuda.Event()
                event.record(self._stream)
        return k, _Pending(out, event)

    def _collect(self, handle):
        """ONE device->host fetch of a dispatched call (see fwd_sample)."""
        k, pending = handle
        return self._unpack(pending.result(), k)

    def _unpack(self, packed: np.ndarray, k: int):
        actions = packed[0, :k].astype(np.int32)
        if packed.shape[0] == 3:
            # greedy server: row 0 IS the argmax channel (make_fwd_sample)
            return actions, packed[1, :k], packed[2, :k], actions
        return actions, packed[1, :k], packed[2, :k], packed[3, :k].astype(
            np.int32
        )

    def _run_device(self, batch: np.ndarray):
        return self._collect(self._dispatch(self._params, batch))

    @property
    def _params(self):
        return self._policies["default"]

    def _run_rows(self, states: np.ndarray):
        """Serve N rows synchronously: (actions, values, logps, greedy).

        Inputs larger than the serving bucket are chunked to it, and every
        chunk is dispatched before any is fetched. Params are snapshotted
        once per call: a publish mid-call must not split one logical batch
        across two policies, nor pair one forward with another's table."""
        cap = _next_pow2(max(self._batch_size, 1))
        with self._swap_lock:
            fwd, params = self._fwd_model, self._params
        if states.shape[0] <= cap:
            return self._collect(self._dispatch(params, states, fwd))
        pending = [
            self._dispatch(params, states[i:i + cap], fwd)
            for i in range(0, states.shape[0], cap)
        ]
        self._c_chunked.inc()
        self._c_chunks.inc(len(pending))
        parts = [self._collect(h) for h in pending]
        return tuple(np.concatenate(p) for p in zip(*parts))

    # -- the continuous-batching scheduler ---------------------------------
    def _viable(self, task, now: float) -> bool:
        """Can this task still make its deadline if dispatched NOW?

        The decaying-max serve-time estimate already includes pipeline
        wait; the extra 25% headroom absorbs scheduler jitter. The error
        mode is shedding a task that would have made it, never serving one
        late."""
        return (
            task.deadline is None
            or now + self._est_serve_s * 1.25 <= task.deadline
        )

    def _next_task(self, t: StoppableThread, wait: bool):
        """Pop the next VIABLE task (shedding hopeless ones on the way).

        ``wait``: block stoppably (device idle) vs return None immediately
        (a dispatch is in flight)."""
        while True:
            if self._held is not None:
                task, self._held = self._held, None
            elif wait:
                task = t.queue_get_stoppable(self._queue)
                if task is None:
                    return None  # stopping
            else:
                try:
                    task = self._queue.get_nowait()
                except queue.Empty:
                    return None
            if self._viable(task, self._clock()):
                return task
            self._shed(task, "deadline")

    def _assemble(self, t: StoppableThread, idle: bool):
        """Build one ≤-bucket, single-policy group of tasks.

        When the device is idle, waits for a first task and then up to
        ``coalesce_ms`` to multiply the batch. When a dispatch is already
        in flight, takes only what is queued NOW: the in-flight call is
        the coalesce window (continuous batching)."""
        first = self._next_task(t, wait=idle)
        if first is None:
            return None
        cap = _next_pow2(max(self._batch_size, 1))
        tasks, weight = [first], first.k
        deadline = time.perf_counter() + (self._coalesce_s if idle else 0.0)
        while weight < self._batch_size:
            if self._held is not None:
                tk, self._held = self._held, None
            else:
                remaining = deadline - time.perf_counter()
                try:
                    if remaining > 0:
                        tk = self._queue.get(timeout=remaining)
                    else:
                        tk = self._queue.get_nowait()
                except queue.Empty:
                    break
            if not self._viable(tk, self._clock()):
                self._shed(tk, "deadline")
                continue
            if tk.policy != first.policy or weight + tk.k > cap:
                # one device call serves ONE policy and ONE bucket; the
                # misfit leads the next group (never reordered past FIFO)
                self._held = tk
                break
            tasks.append(tk)
            weight += tk.k
        return tasks, weight, first.policy

    def _stage_group(self, singles, blocks, weight):
        """The group's ONE materialization: rows interleave straight into a
        pooled, bucket-padded staging buffer. Returns ``(batch, lease)``;
        lease None = zero-copy pass-through (a lone already-bucket-shaped
        ndarray block). Pad rows keep stale bytes: only rows :weight reach
        any callback."""
        padded = _next_pow2(max(weight, 1))
        if not singles and len(blocks) == 1:
            b0 = blocks[0].states
            if isinstance(b0, np.ndarray) and b0.shape[0] == padded:
                return b0, None
        if singles:
            first = singles[0].states
            tail = tuple(np.shape(first))  # one row's shape
        else:
            first = blocks[0].states
            tail = tuple(np.shape(first))[1:]  # strip the block axis
        dtype = getattr(first, "dtype", np.uint8)
        buf = self._pool.acquire((padded, *tail), dtype)
        off = 0
        for tk in singles:
            buf[off] = tk.states
            off += 1
        for tk in blocks:
            buf[off : off + tk.k] = tk.states
            off += tk.k
        self._pool.count_copy()
        return buf, _StageLease(buf)

    def _release_lease(self, inf: _Inflight, synced: bool) -> None:
        """One dispatch done with its staging buffer; the buffer frees when
        every sharer (primary + shadow) released. ``synced=False`` (the
        unfetched shadow) parks on the ready fence instead."""
        lease = inf.lease
        if lease is None:
            return
        lease.refs -= 1
        if lease.refs == 0:
            self._pool.release(
                lease.arr, None if synced else inf.handle[1]
            )

    def _launch(self, group) -> List[_Inflight]:
        """Dispatch one group (plus its shadow mirror) — no host fetch."""
        tasks, weight, policy = group
        if policy is None:
            policy = self._route_group(weight)  # un-pinned: routed here
        singles = [tk for tk in tasks if isinstance(tk, _RowTask)]
        blocks = [tk for tk in tasks if isinstance(tk, _BlockTask)]
        batch, lease = self._stage_group(singles, blocks, weight)
        now = self._clock()
        # counted at LAUNCH (not fetch) so the series lead the latency
        # histograms by exactly the in-flight window
        self._c_batches.inc()
        self._c_rows.inc(weight)
        self._h_occupancy.observe(weight)
        self._policy_counter(policy).inc(weight)
        if self.quant_spec is not None:
            self._c_int8_batches.inc()
        # tasks[0] is the group's oldest admit (FIFO pop order) — captured
        # BEFORE the singles-first reorder below
        t_oldest = tasks[0].t_admit
        self._h_queue_wait.observe(max(0.0, now - t_oldest))
        ordered = singles + blocks  # callback offsets follow batch layout
        handle = self._dispatch(self._policies[policy], batch)
        # µs stamp only when a sampled trace rides this group: the untraced
        # path pays one attribute scan, never a clock read
        t_us = (
            tracing.now_us()
            if any(tk.trace is not None for tk in ordered) else 0
        )
        out = [_Inflight(
            ordered, weight, policy, handle, now,
            t_oldest=t_oldest, t_dispatch_us=t_us, lease=lease,
        )]
        shadow = self._shadow
        if shadow is not None:
            self._c_shadow_batches.inc()
            self._c_shadow_rows.inc(weight)
            if lease is not None:
                lease.refs += 1  # the mirror reads the same staged bytes
            out.append(_Inflight(
                None, weight, shadow,
                self._dispatch(self._policies[shadow], batch), now,
                shadow=True,
                states=batch if self.shadow_tap is not None else None,
                lease=lease,
            ))
        return out

    def _policy_counter(self, policy: str):
        c = self._c_policy_rows.get(policy)
        if c is None:
            self._c_policy_rows[policy] = c = self._tele.counter(
                f"policy_{policy}_rows_total"
            )
        return c

    def _complete(self, inf: _Inflight) -> None:
        """Fetch one in-flight call and fire its callbacks."""
        if inf.shadow:
            tap = self.shadow_tap
            # inf.states is captured at LAUNCH only when a tap was already
            # installed — a tap that appears mid-flight skips this call
            if tap is not None and inf.states is not None:
                actions, _, _, _ = self._collect(inf.handle)
                states = np.asarray(inf.states)[: inf.n]
                if inf.lease is not None:
                    # the tap's states must outlive the staging buffer's
                    # reuse
                    states = states.copy()
                # the calibration tap's statistics run on this stream
                with self._on_stream():
                    self._fire(tap, states, actions[: inf.n], inf.policy)
                self._release_lease(inf, synced=True)
            else:
                # no tap: DROP without a host sync; the staging buffer
                # parks on the ready fence instead
                self._release_lease(inf, synced=False)
            return
        actions, values, logps, _ = self._collect(inf.handle)
        self._release_lease(inf, synced=True)
        now = self._clock()
        if inf.t_dispatch_us:
            # sampled spans, after the fetch returned (on the card: after
            # the wait on the call's event): admission -> issue, then
            # issue -> results on the host, under THIS predictor's role
            for tk in inf.tasks:
                if tk.trace is not None:
                    tk.trace.hop(
                        "predict_dispatch", self.tele_role,
                        t_end_us=inf.t_dispatch_us,
                    ).hop("predict_fetch", self.tele_role)
                    tk.trace = None  # one attribution per task
        # decaying-max serve-time estimate for the deadline gate: tracks
        # the worst recent dispatch->fetch (incl. pipeline wait) and decays
        # 10% per call so a one-off stall doesn't shed forever
        self._est_serve_s = max(
            self._est_serve_s * 0.9, now - inf.t_dispatch
        )
        self._h_serve.observe(max(0.0, now - inf.t_oldest))
        late = sum(
            tk.k for tk in inf.tasks
            if tk.deadline is not None and now > tk.deadline
        )
        if late:
            # served PAST deadline: the estimator was wrong
            self._c_deadline_miss.inc(late)
        off = 0
        for tk in inf.tasks:
            if isinstance(tk, _RowTask):
                self._fire(
                    tk.callback,
                    int(actions[off]), float(values[off]), float(logps[off]),
                )
                off += 1
            else:
                self._fire(
                    tk.callback,
                    actions[off:off + tk.k],
                    values[off:off + tk.k],
                    logps[off:off + tk.k],
                )
                off += tk.k

    def _scheduler(self) -> None:
        """The serving loop: dispatch-depth-pipelined continuous batching.

        Invariant: the fetch of call k happens AFTER the dispatch of call
        k+1 whenever there is queued work — the host never syncs between
        dispatches, so the device never idles between micro-batches."""
        t = threading.current_thread()
        assert isinstance(t, StoppableThread)
        inflight: collections.deque = collections.deque()
        while not t.stopped():
            group = self._assemble(t, idle=not inflight)
            if group is not None:
                inflight.extend(self._launch(group))
            self._inflight_n = len(inflight)
            # fetch the oldest call(s) once the pipeline is full — or when
            # there is nothing new to dispatch (drain toward idle); a drain
            # completion re-checks the queue before fetching the next
            # handle, so work that arrived DURING the fetch is dispatched
            # before the host blocks again
            while inflight and (len(inflight) >= self._depth
                                or group is None):
                self._complete(inflight.popleft())
                self._inflight_n = len(inflight)
                if group is None:
                    break
        # teardown: complete what was dispatched (callers may be waiting),
        # then deliver the promised "shutdown" reject to everything queued
        while inflight:
            self._complete(inflight.popleft())
        self._inflight_n = 0
        if self._held is not None:
            held, self._held = self._held, None
            self._shed(held, "shutdown")
        self._drain_shutdown()

    def _drain_shutdown(self) -> None:
        """Shed everything still queued with the promised "shutdown"
        reject (scheduler teardown, and ``_admit`` when its put raced past
        that final drain)."""
        while True:
            try:
                task = self._queue.get_nowait()
            except queue.Empty:
                return
            self._shed(task, "shutdown")

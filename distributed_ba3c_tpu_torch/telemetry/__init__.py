"""Fleet telemetry plane of the port: copies of the JAX package's
``distributed_ba3c_tpu/telemetry`` modules, with the same names and layout.

1. **Metrics core** (:mod:`.metrics`): per-thread-sharded Counter, Gauge
   and log2 Histogram, one :class:`Registry` per role (master, predictor,
   learner, simulator, fleet); no lock on the write side.
2. **Flight recorder** (:mod:`.recorder`): a ring of structured events,
   dumped as ``flight-<pid>.json`` on SIGTERM, an actor prune or a client
   drop.
3. **Fleet aggregation** (:mod:`.wire`): env servers piggyback counter
   deltas on the wire headers the plane already has.
4. **Exporters** (:mod:`.exporters`): the ``--telemetry_port`` scrape
   endpoint (``/metrics``, ``/json``, ``/flight``, ``/trace``) and the
   stat.json/TensorBoard bridge.
5. **Trace plane** (:mod:`.tracing`): sampled causal block-lifetime spans
   (``--trace_sample``) folded into ``hop_<name>_s`` histograms.

None of these modules imports torch: spawned env-server children import
them.

    from distributed_ba3c_tpu_torch import telemetry
    telemetry.registry("predictor").counter("rows_total").inc(B)
    telemetry.record("predictor_callback_error", error="...")
"""

from __future__ import annotations

from distributed_ba3c_tpu_torch.telemetry.metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    Registry,
    all_registries,
    all_snapshots,
    enabled,
    fleet_role,
    registry,
    reset_all,
    set_enabled,
)
from distributed_ba3c_tpu_torch.telemetry.recorder import (  # noqa: F401
    FlightRecorder,
    configure,
    dump,
    flight_recorder,
    install_signal_dump,
    record,
)
from distributed_ba3c_tpu_torch.telemetry.exporters import (  # noqa: F401
    TelemetryServer,
    export_scalars,
    prometheus_text,
)
from distributed_ba3c_tpu_torch.telemetry.wire import (  # noqa: F401
    PIGGYBACK_EVERY,
    DeltaTracker,
    apply_fleet_deltas,
)
from distributed_ba3c_tpu_torch.telemetry import tracing  # noqa: F401


def recorded(kind=None) -> list:
    """The flight ring's events as ``{"t_monotonic", "kind", **fields}``
    dicts, oldest first; ``kind`` filters to one event kind."""
    return [
        ev for ev in flight_recorder().snapshot()
        if kind is None or ev["kind"] == kind
    ]

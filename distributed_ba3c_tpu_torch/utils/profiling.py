"""Timing and profiling hooks, on ``torch.profiler`` and NVTX.

Port of ``distributed_ba3c_tpu/utils/profiling.py``:

- :func:`timed_operation`: the reference's host-side timer.
- :func:`step_annotation`: a named region around one train step, both a
  ``torch.profiler.record_function`` range and, on a CUDA machine, an NVTX
  range. The name carries the trace plane's ids (telemetry/tracing.py), so
  a capture lines up with the ``/trace`` spans by id.
- :func:`capture_trace`: runs a function under ``torch.profiler.profile``
  (CPU and CUDA activities) and writes the Chrome trace-event JSON.

The JAX package's ``start_server`` (a ``jax.profiler`` gRPC server a
TensorBoard attaches to) has no torch counterpart; the CLI's
``--profiler_port`` says so and names :func:`capture_trace`.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

from distributed_ba3c_tpu_torch.utils import logger

#: the Chrome trace-event file :func:`capture_trace` writes in its log dir
TRACE_FILE = "torch_trace.json"


@contextlib.contextmanager
def timed_operation(msg: str, log_start: bool = False):
    """Log the wall-clock duration of a block (reference ``timed_operation``)."""
    if log_start:
        logger.info("start %s ...", msg)
    t0 = time.monotonic()
    try:
        yield
    finally:
        logger.info("%s finished, time:%.4f sec.", msg, time.monotonic() - t0)


def annotation_name(
    name: str, step: int, trace_id: Optional[int] = None,
    span_id: Optional[int] = None,
) -> str:
    """``"<name> step=<step>[ trace_id=<id>][ span_id=<id>]"``: the range
    name :func:`step_annotation` gives a capture."""
    label = f"{name} step={int(step)}"
    if trace_id is not None:
        label += f" trace_id={int(trace_id)}"
    if span_id is not None:
        label += f" span_id={int(span_id)}"
    return label


@contextlib.contextmanager
def step_annotation(
    name: str,
    step: int,
    trace_id: Optional[int] = None,
    span_id: Optional[int] = None,
):
    """Named region for one step: a ``record_function`` range (it shows up
    in a ``torch.profiler`` capture, with the kernels launched inside it)
    and an NVTX range where CUDA is available. Pass the active block
    trace's ids (a TraceRef's ``trace_id`` and ``parent_id``) to line the
    capture up with the host spans by id. Costs one string format and,
    without a profiler attached, a no-op range."""
    import torch

    label = annotation_name(name, step, trace_id, span_id)
    nvtx = torch.cuda.is_available()
    with torch.profiler.record_function(label):
        if nvtx:
            torch.cuda.nvtx.range_push(label)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


def capture_trace(log_dir: str, seconds: float, fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` under a ``torch.profiler`` capture of the
    CPU and, where available, CUDA activities. Synchronizes the device
    before the capture closes, so the kernels ``fn`` queued are in it, and
    writes the Chrome trace-event JSON to ``<log_dir>/torch_trace.json``.
    Returns ``fn``'s output. ``seconds`` is the JAX function's argument;
    as there, the capture spans the one call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        out = fn(*args, **kwargs)
        if cuda:
            torch.cuda.synchronize()
    path = os.path.join(log_dir, TRACE_FILE)
    prof.export_chrome_trace(path)
    logger.info("trace written to %s", path)
    return out

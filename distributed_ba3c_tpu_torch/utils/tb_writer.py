"""TensorBoard scalar event plane.

A copy of ``distributed_ba3c_tpu/utils/tb_writer.py``: standard tfevents
files written through the ``tensorboard`` package's event writer (no
TensorFlow), under the metric names of ``stat.json``. The package is
imported lazily; where it is missing, the writer warns once and does
nothing, so a headless machine still trains (``stat.json`` and
``channels.jsonl`` are still written).
"""

from __future__ import annotations

import time
from typing import Optional


class TBScalarWriter:
    """Minimal scalar-only event-file writer (``logdir/events.out.tfevents*``)."""

    def __init__(self, log_dir: str):
        self._writer = None
        try:
            from tensorboard.compat.proto.event_pb2 import Event  # noqa: F401
            from tensorboard.summary.writer.event_file_writer import (
                EventFileWriter,
            )

            self._writer = EventFileWriter(log_dir)
        except Exception:  # noqa: BLE001 - observability must never kill training
            from distributed_ba3c_tpu_torch.utils import logger

            logger.warn(
                "tensorboard unavailable — scalar event plane disabled "
                "(stat.json/channels.jsonl still written)"
            )

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        if self._writer is None:
            return
        from tensorboard.compat.proto.event_pb2 import Event
        from tensorboard.compat.proto.summary_pb2 import Summary

        event = Event(
            wall_time=time.time(),
            step=int(step),
            summary=Summary(
                value=[Summary.Value(tag=tag, simple_value=float(value))]
            ),
        )
        self._writer.add_event(event)

    def add_scalars(self, record: dict, step: Optional[int] = None) -> None:
        """Emit one epoch record (the stat.json dict) as scalar events."""
        if self._writer is None:
            return
        if step is None:
            step = int(record.get("global_step", 0))
        for k, v in record.items():
            if k == "global_step":
                continue
            self.add_scalar(k, v, step)

    def flush(self) -> None:
        if self._writer is not None:
            self._writer.flush()

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
            self._writer = None

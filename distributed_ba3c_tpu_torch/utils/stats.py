"""Stat aggregation: per-step counters -> per-epoch records -> stat.json.

A copy of ``distributed_ba3c_tpu/utils/stats.py``: each epoch's record goes
to ``stat.json`` and, as TensorBoard scalar events under the same names, to
the log dir (``utils/tb_writer.py``).

Reference equivalent: ``utils/stats.py`` ``StatCounter`` +
``callbacks/stats.py`` ``StatHolder`` (SURVEY.md §2.7 #22).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np


class StatCounter:
    """Accumulates scalars; exposes average/sum/max/count."""

    def __init__(self):
        self._values: List[float] = []

    def feed(self, v: float) -> None:
        self._values.append(float(v))

    def reset(self) -> None:
        self._values = []

    @property
    def count(self) -> int:
        return len(self._values)

    @property
    def average(self) -> float:
        assert self._values
        return float(np.mean(self._values))

    @property
    def sum(self) -> float:
        assert self._values
        return float(np.sum(self._values))

    @property
    def max(self) -> float:
        assert self._values
        return float(np.max(self._values))


class StatHolder:
    """Holds the current epoch's scalar stats; finalizes to stat.json.

    ``stat.json`` is a JSON list of per-epoch dicts, the format tensorpack
    tooling reads. With a log dir (and ``tensorboard``), each record is also
    written as scalar events at its ``global_step``.
    """

    def __init__(self, log_dir: Optional[str] = None):
        self.log_dir = log_dir
        self.stat_now: Dict[str, float] = {}
        self.stat_history: List[Dict[str, float]] = []
        self._tb = None
        if log_dir is not None:
            from distributed_ba3c_tpu_torch.utils.tb_writer import TBScalarWriter

            self._tb = TBScalarWriter(log_dir)
        if log_dir is not None:
            os.makedirs(log_dir, exist_ok=True)
            self._path = os.path.join(log_dir, "stat.json")
            if os.path.isfile(self._path):
                try:
                    with open(self._path) as f:
                        self.stat_history = json.load(f)
                except json.JSONDecodeError:
                    self.stat_history = []
        else:
            self._path = None

    def add_stat(self, name: str, value: float) -> None:
        self.stat_now[name] = float(value)

    def add_stats(self, values: Dict[str, float]) -> None:
        """Bulk :meth:`add_stat` (the telemetry bridge's entry point)."""
        for name, v in values.items():
            self.stat_now[name] = float(v)

    def finalize(self) -> Dict[str, float]:
        """Close the epoch: append the record, rewrite stat.json and write
        the TensorBoard events."""
        record = dict(self.stat_now)
        self.stat_history.append(record)
        if self._path is not None:
            tmp = self._path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(self.stat_history, f)
            os.replace(tmp, self._path)
        if self._tb is not None:
            step = int(record.get("global_step", record.get("epoch", 0)))
            self._tb.add_scalars(record, step)
            self._tb.flush()
        self.stat_now = {}
        return record

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()

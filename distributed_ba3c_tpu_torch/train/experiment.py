"""Experiment-tracking channels (Neptune-equivalent surface).

A copy of ``distributed_ba3c_tpu/train/experiment.py``: the reference's
Neptune channels (score, cost, fps; SURVEY.md §2.7 #24) as a
dependency-free JSONL writer, ``<logdir>/channels.jsonl``, one line per
point ``{channel, x, y, ts}``, that any dashboard can tail. The ZMQ
trainers add :class:`ExperimentLogger` to their callbacks; the fused loop
writes through :class:`ChannelWriter` itself.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

from distributed_ba3c_tpu_torch.train.callbacks import Callback


class ChannelWriter:
    """Append-only JSONL: one line per point {channel, x, y, ts}."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a", buffering=1)

    def send(self, channel: str, x: float, y: float) -> None:
        self._f.write(
            json.dumps(
                {"channel": channel, "x": x, "y": y, "ts": time.time()}
            )
            + "\n"
        )

    def close(self) -> None:
        self._f.close()


#: the channels a run streams, where its epoch record has them
CHANNELS = ("mean_score", "max_score", "fps", "loss")


class ExperimentLogger(Callback):
    """Streams the stat_holder's per-epoch record to channels.jsonl."""

    def __init__(self, channels=CHANNELS):
        self.channels = channels
        self._writer: Optional[ChannelWriter] = None

    def before_train(self):
        log_dir = self.trainer.config.log_dir
        if log_dir:
            self._writer = ChannelWriter(os.path.join(log_dir, "channels.jsonl"))

    def trigger_epoch(self):
        if self._writer is None:
            return
        # read the just-finalized record (StatPrinter runs before this
        # callback in the standard ordering; see cli.py callback order note)
        if self.trainer.stat_holder.stat_history:
            rec = self.trainer.stat_holder.stat_history[-1]
            x = rec.get("global_step", self.trainer.global_step)
            for ch in self.channels:
                if ch in rec:
                    self._writer.send(ch, x, rec[ch])

    def after_train(self):
        if self._writer is not None:
            self._writer.close()

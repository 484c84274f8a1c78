"""The trainer: the epochs x steps main loop of the sync learner.

Port of ``distributed_ba3c_tpu/train/trainer.py:36-281`` (Tensorpack's
``Trainer.train() -> main_loop()``, SURVEY.md §2.5) on one device:

- ``run_step`` takes the next device batch (``data/staging.py``
  ``DeviceIngest``: its H2D copy was issued behind the previous step), runs
  the step of ``parallel/train_step.py`` and issues the next batch's copy;
- every ``publish_every`` steps the params go to the ``BatchedPredictor``
  (a device copy on the predictor's stream, ordered after the step and
  before the next one: Adam updates the params in place);
- callbacks (``train/callbacks.py``) fire per step and per epoch;
- feed starvation (the actor plane died) raises ``RuntimeError``;
- a batch of a sampled trace (telemetry/tracing.py) runs its step under
  ``utils/profiling.py::step_annotation`` (the range's name carries the
  trace and span ids, so a ``torch.profiler`` capture lines up with
  ``/trace``), and records ``ingest`` (unstaged feeds) and
  ``learner_step``: the host-side dispatch of the update, as in JAX; the
  card's side of the step is the annotated range of a capture.

Left out: the multi-host ``LockstepWatchdog`` (a no-op on one process,
ROADMAP queue A item 8).
"""

from __future__ import annotations

import dataclasses
import queue
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from distributed_ba3c_tpu_torch import telemetry
from distributed_ba3c_tpu_torch.config import BA3CConfig
from distributed_ba3c_tpu_torch.train.callbacks import Callback, Callbacks
from distributed_ba3c_tpu_torch.utils import logger
from distributed_ba3c_tpu_torch.utils.stats import StatCounter, StatHolder


@dataclasses.dataclass
class TrainLoopConfig:
    """Loop shape and wiring (the reference's ``TrainConfig``)."""

    steps_per_epoch: int = 1000
    max_epoch: int = 100
    log_dir: Optional[str] = None
    publish_every: int = 1  # params -> predictor every N steps
    feed_timeout: float = 120.0


class Trainer:
    """Owns the TrainState, the step function and the callback lifecycle."""

    def __init__(
        self,
        config: TrainLoopConfig,
        cfg: BA3CConfig,
        step_fn: Callable,  # from make_train_step
        state,  # TrainState
        feed,  # TrainFeed-like or DeviceIngest: next_batch(timeout)
        callbacks: List[Callback],
        predictor=None,  # BatchedPredictor to publish params to
        score_queue: Optional[queue.Queue] = None,
        samples_per_step: Optional[int] = None,
    ):
        self.config = config
        self.cfg = cfg
        self.step_fn = step_fn
        self.state = state
        self.device = next(state.model.parameters()).device
        self.feed = feed
        self.predictor = predictor
        self.score_queue = score_queue

        self.hyperparams: Dict[str, float] = {
            "learning_rate": cfg.learning_rate,
            "entropy_beta": cfg.entropy_beta,
        }
        self.global_step = 0
        self.epoch_num = 0
        self.batch_size = samples_per_step or cfg.batch_size
        self.stat_holder = StatHolder(config.log_dir)
        self.score_counter: Optional[StatCounter] = StatCounter()
        self.last_mean_score: Optional[float] = None
        self.ckpt_manager = None  # set by ModelSaver
        self.metrics = None
        self._pending_trace = None  # sampled trace between stage and step
        self._callbacks = Callbacks(callbacks)

        # the learner registry is the one account of training progress
        tele = telemetry.registry("learner")
        self._c_steps = tele.counter("train_steps_total")
        self._c_samples = tele.counter("train_samples_total")
        self._h_step = tele.histogram("step_s", unit=1e-6)
        # the part of step_s spent waiting for (and claiming) the batch
        self._h_feed_wait = tele.histogram("feed_wait_s", unit=1e-6)

    # -- predictor glue ----------------------------------------------------
    def predictor_fn(self) -> Callable[[np.ndarray], np.ndarray]:
        """Greedy batched predict on the CURRENT params (the Evaluator's)."""
        assert self.predictor is not None

        def predict(states: np.ndarray) -> np.ndarray:
            _, _, greedy_actions = self.predictor.predict_batch(states)
            return greedy_actions

        return predict

    def _publish_params(self):
        if self.predictor is not None:
            # the predictor copies the tensors on its own stream, after this
            # thread's pending work and before its next (the in-place Adam)
            self.predictor.update_params(self.state.model.state_dict())

    def _drain_scores(self):
        if self.score_queue is None:
            return
        while True:
            try:
                self.score_counter.feed(self.score_queue.get_nowait())
            except queue.Empty:
                return

    # -- loop --------------------------------------------------------------
    def _next_device_batch(self) -> Dict[str, torch.Tensor]:
        batch = self.feed.next_batch(timeout=self.config.feed_timeout)
        # a sampled trace rode the batch (claimed before the copy: the
        # step must never meet the ref)
        trace = batch.pop("_trace", None)
        if getattr(self.feed, "is_device_ingest", False):
            # staged: already device tensors, stream-ordered; the pipeline
            # recorded h2d_copy and ingest
            self._pending_trace = trace
            return batch
        out = {
            k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
            for k, v in batch.items()
        }
        if trace is not None:
            # feed handoff -> copies issued (host-side ingest hop)
            self._pending_trace = trace.hop("ingest", "learner")
        return out

    def _step(self, batch) -> None:
        self.state, self.metrics = self.step_fn(
            self.state,
            batch,
            self.hyperparams["entropy_beta"],
            self.hyperparams["learning_rate"],
        )

    def run_step(self) -> None:
        t0 = time.monotonic()
        batch = self._next_device_batch()
        self._h_feed_wait.observe(time.monotonic() - t0)
        if self._pending_trace is not None:
            from distributed_ba3c_tpu_torch.utils.profiling import (
                step_annotation,
            )

            with step_annotation(
                "train_step", self.global_step,
                trace_id=self._pending_trace.trace_id,
                span_id=self._pending_trace.parent_id,
            ):
                self._step(batch)
        else:
            self._step(batch)
        self.global_step += 1
        prefetch = getattr(self.feed, "prefetch", None)
        if prefetch is not None:
            # issue the NEXT batch's H2D behind this step (non-blocking)
            prefetch()
        if self._pending_trace is not None:
            # the host-side dispatch of the update; the card runs behind
            self._pending_trace.hop(
                "learner_step", "learner", tags={"step": self.global_step}
            )
            self._pending_trace = None
        # host-side time: feed wait + the step's dispatch (the card runs
        # behind; StatPrinter's sampled metric fetches sync it)
        self._h_step.observe(time.monotonic() - t0)
        self._c_steps.inc()
        self._c_samples.inc(self.batch_size)
        if self.global_step % self.config.publish_every == 0:
            self._publish_params()
        self._drain_scores()
        self._callbacks.trigger_step(self.metrics)

    def train(self) -> None:
        self._callbacks.setup(self)
        if self.config.log_dir:
            logger.set_logger_dir(self.config.log_dir)
        self._callbacks.before_train()
        self._publish_params()
        try:
            for self.epoch_num in range(1, self.config.max_epoch + 1):
                for _ in range(self.config.steps_per_epoch):
                    self.run_step()
                self._callbacks.trigger_epoch()
        except KeyboardInterrupt:
            logger.warn("training interrupted")
        except queue.Empty:
            # feed starvation is a FAILURE (dead actor plane), not a clean
            # shutdown: launchers and CI must see a nonzero exit
            logger.error(
                "train feed starved for %.0fs — actor plane dead?",
                self.config.feed_timeout,
            )
            raise RuntimeError("train feed starved; actor plane dead") from None
        finally:
            self._callbacks.after_train()
            # the TensorBoard writer's thread must not outlive the run
            self.stat_holder.close()

    # -- resume ------------------------------------------------------------
    def restore(self, ckpt_dir: str, step: Optional[int] = None) -> None:
        """Resume params, Adam's state and the step from a checkpoint
        directory (``--load``)."""
        from distributed_ba3c_tpu_torch.train.checkpoint import (
            CheckpointManager,
            restore_train_state,
        )

        self.state = restore_train_state(
            self.state, CheckpointManager(ckpt_dir), step
        )
        self.global_step = int(self.state.step)
        self._publish_params()
        logger.info("restored checkpoint at step %d", self.global_step)

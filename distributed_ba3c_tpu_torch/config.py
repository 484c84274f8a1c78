"""Hyperparameter configuration for BA3C training.

A copy of ``distributed_ba3c_tpu/config.py`` (the port imports nothing of
the JAX package).

Defaults follow SURVEY.md §2.9 (recalled Tensorpack/BA3C defaults, confidence
[M]/[L] — the reference mount was empty so they could not be re-read from
``src/train.py``; every one of them is overridable from the JAX package's
CLI, and the port's CLI (cli.py) overrides the serving subset).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass
class BA3CConfig:
    """All hyperparameters of the BA3C algorithm and its runtime.

    Reference equivalents: module-level constants + argparse defaults in
    ``src/train.py`` (SURVEY.md §2.9) and ``TrainConfig`` fields
    (``tensorpack/train/config.py``, SURVEY.md §2.5 #13).
    """

    # --- environment / observation ---------------------------------------
    image_size: Tuple[int, int] = (84, 84)   # IMAGE_SIZE
    frame_history: int = 4                   # FRAME_HISTORY (stacked as channels)
    frame_skip: int = 4                      # ALE frameskip
    channels: int = 1                        # grayscale channels per frame
    episode_length_cap: int = 40000          # LimitLengthPlayer cap [L]

    # --- algorithm --------------------------------------------------------
    gamma: float = 0.99                      # GAMMA
    local_time_max: int = 5                  # LOCAL_TIME_MAX (n-step truncation)
    reward_clip: float = 0.0                 # clip rewards to [-c, c] (0 = off);
                                             # standard A3C stabilizer for games
                                             # with multi-scale scores
    entropy_beta: float = 0.01               # entropy bonus coefficient
    value_loss_coef: float = 0.5             # weight on the L2 value loss
    value_huber_delta: float | None = None   # Huber value loss if set (robust)
    grad_clip_norm: float = 0.5              # global-norm clip [M]

    # --- optimizer --------------------------------------------------------
    learning_rate: float = 1e-3              # Adam LR (scheduled down during run)
    adam_epsilon: float = 1e-3               # reference tweaked Adam eps [L]
    batch_size: int = 128                    # learner batch per step (per host)

    # --- actor system -----------------------------------------------------
    simulator_procs: int = 50                # SIMULATOR_PROC per worker
    predict_batch_size: int = 16             # PREDICT_BATCH_SIZE
    predictor_threads: int = 2               # no effect: the predictor runs one scheduler thread

    # --- model ------------------------------------------------------------
    num_actions: int = 6                     # set from the env at build time
    fc_units: int = 512

    def __post_init__(self):
        assert self.reward_clip >= 0, (
            f"reward_clip must be >= 0, got {self.reward_clip}"
        )

    @property
    def state_shape(self) -> Tuple[int, int, int]:
        """(H, W, C) of the stacked observation fed to the network."""
        h, w = self.image_size
        return (h, w, self.frame_history * self.channels)

    def replace(self, **kw) -> "BA3CConfig":
        return dataclasses.replace(self, **kw)

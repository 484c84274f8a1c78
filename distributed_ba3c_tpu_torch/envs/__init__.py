"""Environments and the player protocol (copies of the JAX package's
numpy-only env modules, plus the ctypes binding of the C++ core); the
device-batched envs of the fused trainer are in ``jaxenv/``."""

from distributed_ba3c_tpu_torch.envs.base import ProxyPlayer, RLEnvironment
from distributed_ba3c_tpu_torch.envs.fake import FakeEnv, build_fake_player
from distributed_ba3c_tpu_torch.envs.wrappers import (
    HistoryFramePlayer,
    LimitLengthPlayer,
    MapPlayerState,
    PreventStuckPlayer,
)

__all__ = [
    "RLEnvironment",
    "ProxyPlayer",
    "FakeEnv",
    "build_fake_player",
    "HistoryFramePlayer",
    "LimitLengthPlayer",
    "MapPlayerState",
    "PreventStuckPlayer",
]

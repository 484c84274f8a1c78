"""The on-device games as host players, one env stepped on CPU tensors.

Port of ``distributed_ba3c_tpu/envs/jaxenv/host_adapter.py``: it lets the
games of ``envs/jaxenv/`` serve the host actor plane too -- a
``SimulatorProcess`` child of the sync and V-trace trainers, or the
Evaluator and ``--task eval|play`` in the trainer process -- through the
player protocol of ``envs/base.py``, wrapped in ``HistoryFramePlayer``.

The player runs the game at B=1 on the CPU, as the JAX adapter pins its
env to a CPU device: one env step is host-scale work, and a spawned child
must never create a CUDA context (64 children would make 64). Nothing
here touches CUDA. torch is imported inside :func:`build_jax_player`, so
this module stays torch-free at import, as the plane's modules must
(a child unpickles its player factory before it builds a player). A child
runs torch on one thread: a fleet of them shares the host's cores.
"""

from __future__ import annotations

import multiprocessing


def build_jax_player(idx: int, name: str = "pong", frame_history: int = 4, draws=None):
    """Player ``idx`` of ``jax:<name>``: its draws come from a CPU
    ``torch.Generator`` seeded ``idx`` (``draws``, a source with
    ``env_noise(n, device)`` and ``reset_noise(n, device)`` as
    ``fused/loop.py::GeneratorDraws``, replaces it in a test)."""
    import torch

    from distributed_ba3c_tpu_torch.envs.base import RLEnvironment
    from distributed_ba3c_tpu_torch.envs.jaxenv import get_env
    from distributed_ba3c_tpu_torch.envs.wrappers import HistoryFramePlayer

    if multiprocessing.parent_process() is not None:
        torch.set_num_threads(1)
    env = get_env(name)
    if draws is None:
        from distributed_ba3c_tpu_torch.fused.loop import GeneratorDraws

        draws = GeneratorDraws(env, torch.Generator().manual_seed(idx))

    class _GamePlayer(RLEnvironment):
        def __init__(self):
            self._new_episode()
            super().__init__()

        def _new_episode(self):
            self.state = env.reset(draws.reset_noise(1, "cpu"))
            self.obs = env.render(self.state)[0].numpy()
            self.score = 0.0

        def current_state(self):
            return self.obs

        def get_action_space_size(self):
            return env.num_actions

        def action(self, act):
            a = torch.tensor([act], dtype=torch.int32)
            self.state, obs, r, d = env.step(self.state, a, draws.env_noise(1, "cpu"))
            self.obs = obs[0].numpy()
            r, d = float(r[0]), bool(d[0])
            self.score += r
            if d:
                self.finish_episode(self.score)
                self.score = 0.0
            return r, d

        def restart_episode(self):
            self._new_episode()

    return HistoryFramePlayer(_GamePlayer(), frame_history)

"""distributed_ba3c_tpu_torch -- the PyTorch/CUDA port of distributed_ba3c_tpu.

It runs on one NVIDIA H100. The JAX package beside it is the reference each
ported module is tested against; this package imports none of it (and no
JAX): what it needs from there it keeps as its own copy. Every TPU kernel
on a ported path is a hand-written Hopper kernel (``csrc/``, built at first
use into ``build/kernels/``), each with a plain PyTorch version that the
CPU path and the tests use.

Ported so far: the serving path -- ``BA3CNet`` (models/a3c.py) through the
fused conv-block kernel (ops/conv_block.py), ``BatchedPredictor``
(predict/server.py), and ``python -m distributed_ba3c_tpu_torch --task
play|eval`` (cli.py); and the training path -- the fused trainer
(fused/loop.py, ``--task train --trainer tpu_fused_ba3c --env
jax:<game>``) on the on-device game set (envs/jaxenv/: pong, breakout,
seaquest, qbert, coinrun, space_invaders, boxing, assault), with the conv
block's custom VJP
(``ops/conv_block.py::conv_block``), the loss, returns and optimizer
(ops/); and the sync trainer with its ZMQ actor plane (``--task train
--trainer tpu_sync_ba3c``, the default): env-server processes
(envs/native.py, actors/simulator.py), the n-step master
(actors/master.py), the train feed and pinned staging (data/), the
learner step (parallel/train_step.py) and the trainer with its callbacks
(train/); the V-trace learner (parallel/vtrace_step.py, ``--trainer
tpu_vtrace_ba3c``, and the fused trainer's ``--overlap``); the games
as host players of the plane and of eval/play
(envs/jaxenv/host_adapter.py); the telemetry plane (telemetry/); and the
int8 rung of the rollout precision ladder (quantize/: ``--rollout_dtype
int8`` on the predictor and the overlap's actor) with the single serving
plane's SLO, canary and shadow flags.
"""

"""Numeric ops and the hand-written kernels behind them.

``conv_block`` is the port of ``distributed_ba3c_tpu/ops/pallas_conv.py``
(the kernel forward and the custom VJP); ``_build`` compiles and loads the
CUDA sources in ``csrc/``; ``returns``, ``vtrace``, ``loss``, ``gradproc``
and ``symbolic`` are the learners' ops.
"""

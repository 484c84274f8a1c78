"""The learner's input pipeline: the train-queue batcher (``dataflow``) and
the pinned staging ring with its H2D pipeline (``staging``); a port of
``distributed_ba3c_tpu/data``."""

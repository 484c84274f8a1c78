"""The ZMQ actor plane: simulator processes, the master's receive loop,
and the BA3C master (port of ``distributed_ba3c_tpu/actors``). No module
here imports torch: spawned children import them."""

"""The learners' steps on one device: the train state and the sync
(n-step A3C) step in ``train_step.py``, the V-trace step in
``vtrace_step.py``."""

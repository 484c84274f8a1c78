"""Eval/play loops (``eval.py``) and hyperparameter schedules
(``callbacks.py``); the fused trainer itself is ``fused/loop.py``."""

"""The learner's train state (``train_step.py``); the sync and V-trace
steps wait for ROADMAP queue A item 6."""

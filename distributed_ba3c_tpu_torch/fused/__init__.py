"""The fused trainer (``loop.py``): rollout on the device env, n-step
returns, the A3C loss and Adam, one update per step."""

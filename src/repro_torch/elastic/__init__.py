"""Elastic recovery, ported from the JAX package's ``elastic`` package.

Only the serving policy is ported so far (ROADMAP.md queue 1):
  ServingDrainReadmit   (recovery.py)
"""
from repro_torch.elastic.recovery import ServingDrainReadmit

__all__ = ["ServingDrainReadmit"]

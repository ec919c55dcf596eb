"""Continuous-batching serving engine (slot-level admission scheduling),
ported from the JAX package's ``serving`` package.

Public API:
  Request / FinishedRequest             (request.py)
  FifoScheduler / SlotPool / PagePool   (scheduler.py)
  ServeEngine / ServeProgram            (engine.py)
  MigratedKV / DrainedRequest           (engine.py)
  LookupDraft / ModelDraft / SpecDecodeEngine   (speculative.py)
  ThroughputRouter                      (router.py)
  ServeFleet / Replica                  (fleet.py)
"""
from repro_torch.serving.engine import (DrainedRequest, MigratedKV,
                                        ServeEngine, ServeProgram)
from repro_torch.serving.fleet import Replica, ServeFleet
from repro_torch.serving.request import FinishedRequest, Request
from repro_torch.serving.router import ThroughputRouter
from repro_torch.serving.scheduler import FifoScheduler, PagePool, SlotPool
from repro_torch.serving.speculative import (LookupDraft, ModelDraft,
                                             SpecDecodeEngine)

__all__ = ["Request", "FinishedRequest", "FifoScheduler", "SlotPool",
           "PagePool", "ServeEngine", "ServeProgram", "MigratedKV",
           "DrainedRequest", "LookupDraft", "ModelDraft",
           "SpecDecodeEngine", "ThroughputRouter", "ServeFleet", "Replica"]

"""Fault-tolerant training runtime: failure injector, straggler watchdog,
elastic mesh re-planning, metrics trackers, the trainer and config-driven
runs (``RunSpec``).

Counterpart of the reference's ``repro/ft``.
"""
from .failures import FailureInjector, FailureModel
from .watchdog import StepTimeWatchdog, WatchdogConfig
from .elastic import ElasticPlan, plan_reshard, build_mesh, reshard_tree
from .trainer import FaultTolerantTrainer, TrainerConfig
from .tracker import (Tracker, NullTracker, MemoryTracker, StdoutTracker,
                      JsonlTracker, CompositeTracker)
from .run import RunSpec, execute as execute_run

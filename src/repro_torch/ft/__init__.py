"""Fault-tolerant training runtime: failure injector, straggler watchdog,
metrics trackers, the trainer and config-driven runs (``RunSpec``).

Counterpart of the reference's ``repro/ft``; its ``elastic`` (mesh
re-planning) waits for the port's device meshes (ROADMAP A11).
"""
from .failures import FailureInjector, FailureModel
from .watchdog import StepTimeWatchdog, WatchdogConfig
from .trainer import FaultTolerantTrainer, TrainerConfig
from .tracker import (Tracker, NullTracker, MemoryTracker, StdoutTracker,
                      JsonlTracker, CompositeTracker)
from .run import RunSpec, execute as execute_run

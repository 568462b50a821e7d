"""Checkpoint runtime: sharded compressed store and policy-driven manager."""
from .store import (ShardedStore, StoreConfig, FaultPlan, FlushAborted,
                    TransientIOError, FAULT_POINTS)
from .manager import (CheckpointManager, ManagerConfig, BuddyReplica,
                      FlushController)

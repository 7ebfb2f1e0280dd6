"""Fault-tolerant training runtime (the counterpart of
``repro.resilience``; see docs/resilience.md).

Three layers over the existing training stack:

* health monitoring — ``make_resilient_train_step`` (loss, grad norm
  and finite flag read in one copy from the card, an EMA loss-spike
  score on the host, the update applied only to a healthy step) and
  ``HealthMonitor`` (host-side ``ok|skip|rollback|abort`` classifier
  with a JSONL ``EventLog``);
* atomic resumable checkpointing — ``CheckpointManager``
  (write-to-temp-then-rename, per-shard crc32, retention, one manifest
  bundling params + optimizer + EMA state + data cursor + free-form
  meta, ``latest()`` discovery, one checkpoint written by the ranks of
  a process group together);
* rollback-and-retry — ``ResilientTrainer`` + ``RetryPolicy`` +
  ``CursorStream``, with the deterministic fault-injection harness
  (``FaultPlan``/``FaultInjector``) that makes crash/rollback paths
  assertable in tier-1 tests.
"""
from repro_torch.resilience.faults import (FAULT_KINDS, CrashInjected,
                                           DeviceLossInjected, Fault,
                                           FaultInjector, FaultPlan,
                                           corrupt_shard)
from repro_torch.resilience.manager import CheckpointManager
from repro_torch.resilience.monitor import (ABORT, BUNDLE_KEYS, OK,
                                            ROLLBACK, SKIP, VERDICTS,
                                            EventLog, HealthMonitor,
                                            MonitorConfig, bundle_dict,
                                            default_controls, init_health,
                                            make_resilient_train_step)
from repro_torch.resilience.trainer import (CursorStream, ResilientTrainer,
                                            RetryPolicy, TrainingAborted)

__all__ = [
    "ABORT", "BUNDLE_KEYS", "FAULT_KINDS", "OK", "ROLLBACK", "SKIP",
    "VERDICTS", "CheckpointManager", "CrashInjected", "CursorStream",
    "DeviceLossInjected", "EventLog", "Fault", "FaultInjector",
    "FaultPlan", "HealthMonitor", "MonitorConfig", "ResilientTrainer",
    "RetryPolicy", "TrainingAborted", "bundle_dict", "corrupt_shard",
    "default_controls", "init_health", "make_resilient_train_step",
]

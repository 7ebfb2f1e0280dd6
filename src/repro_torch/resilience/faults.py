"""Deterministic fault injection (a copy of ``repro.resilience.faults``,
which is jax-free) for the resilience tests and the chip smoke run.

A :class:`FaultPlan` is a declarative list of faults pinned to step
indices — the whole point is *reproducibility*: the same plan against
the same seed produces the same failure at the same step, every run,
so crash-safety and rollback behaviour are assertable in tier-1 tests
instead of hoped-for in production.

Fault kinds (``Fault.kind``):

* ``nan_grads``      — at step k, the guarded train step's
  ``inject_nan`` switch multiplies every gradient by NaN (indistin-
  guishable downstream from a real overflow).
* ``crash``          — at step k, raise :class:`CrashInjected` before
  the step runs: simulated process death. Nothing is saved; recovery
  is a fresh process resuming from the last checkpoint.
* ``crash_in_save``  — kill the checkpoint write after ``arg`` shards
  have hit the temp dir (via ``checkpoint.save``'s ``on_entry`` hook).
  Because saves are write-to-temp-then-rename, the previous
  checkpoint must stay intact and loadable — the atomicity test.
* ``corrupt_shard``  — flip bytes in shard ``arg`` of a finished
  checkpoint dir (bit rot / torn disk write). ``checkpoint.load``
  must catch it by crc32, never silently train on it.
* ``device_loss``    — at step k, raise :class:`DeviceLossInjected`
  (``arg`` = devices lost). The trainer's recovery path re-plans over
  the shrunken cluster and resumes from the last checkpoint —
  graceful degradation of the parallelization plan.

Every fault fires **once** (the injector tracks spent faults), so a
rollback that replays step k does not re-trip the same fault forever.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional, Sequence, Tuple

FAULT_KINDS = ("nan_grads", "crash", "crash_in_save", "corrupt_shard",
               "device_loss")


class CrashInjected(RuntimeError):
    """Simulated process death (``crash`` / ``crash_in_save``)."""


class DeviceLossInjected(RuntimeError):
    """Simulated loss of ``lost`` devices at one step."""

    def __init__(self, step: int, lost: int):
        super().__init__(f"device loss injected at step {step} "
                         f"({lost} device(s) lost)")
        self.step = step
        self.lost = lost


@dataclasses.dataclass(frozen=True)
class Fault:
    kind: str
    step: int
    arg: int = 0      # shard index (crash_in_save/corrupt_shard) or
    #                   device count (device_loss); unused otherwise

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; pick "
                             f"from {FAULT_KINDS}")
        if self.step < 0:
            raise ValueError(f"fault step must be >= 0, got {self.step}")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """An immutable, JSON round-trippable list of faults."""
    faults: Tuple[Fault, ...] = ()

    @classmethod
    def make(cls, faults: Sequence[Fault]) -> "FaultPlan":
        return cls(tuple(sorted(faults, key=lambda f: (f.step, f.kind))))

    def to_json(self) -> str:
        return json.dumps([dataclasses.asdict(f) for f in self.faults],
                          indent=1)

    @classmethod
    def from_json(cls, s: str) -> "FaultPlan":
        return cls.make([Fault(**d) for d in json.loads(s)])

    def save(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            f.write(self.to_json() + "\n")

    @classmethod
    def load(cls, path: str) -> "FaultPlan":
        with open(path, encoding="utf-8") as f:
            return cls.from_json(f.read())


class FaultInjector:
    """Consumes a :class:`FaultPlan` during a training run. Each fault
    fires at most once; ``fired`` records what went off (for test
    assertions)."""

    def __init__(self, plan: Optional[FaultPlan] = None):
        self.plan = plan or FaultPlan()
        self._pending: List[Fault] = list(self.plan.faults)
        self.fired: List[Fault] = []

    def take(self, kind: str, step: int) -> Optional[Fault]:
        """Pop the first unfired fault of ``kind`` scheduled at
        ``step`` (None if there is none)."""
        for f in self._pending:
            if f.kind == kind and f.step == step:
                self._pending.remove(f)
                self.fired.append(f)
                return f
        return None

    # -- per-kind conveniences ---------------------------------------------

    def nan_at(self, step: int) -> bool:
        return self.take("nan_grads", step) is not None

    def check_crash(self, step: int) -> None:
        if self.take("crash", step) is not None:
            raise CrashInjected(f"crash injected at step {step}")

    def check_device_loss(self, step: int) -> Optional[DeviceLossInjected]:
        f = self.take("device_loss", step)
        if f is not None:
            return DeviceLossInjected(step, max(f.arg, 1))
        return None

    def save_hook(self, step: int):
        """``on_entry`` callback for ``checkpoint.save`` that kills the
        save after the plan's ``arg``-th shard — or None when no
        ``crash_in_save`` fault is scheduled at this step."""
        f = self.take("crash_in_save", step)
        if f is None:
            return None

        def on_entry(i: int, path: str) -> None:
            if i >= f.arg:
                raise CrashInjected(
                    f"crash injected mid-save at step {step} after "
                    f"shard {i} ({path!r})")
        return on_entry


def corrupt_shard(ckpt_dir: str, shard_index: int) -> str:
    """Flip the last byte of ``arr_<shard_index>.npy`` in a finished
    checkpoint dir (deterministic bit rot). Returns the file path.
    ``checkpoint.load`` must detect the damage via crc32."""
    path = os.path.join(ckpt_dir, f"arr_{shard_index}.npy")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no shard {shard_index} at {ckpt_dir!r}")
    with open(path, "r+b") as f:
        f.seek(-1, os.SEEK_END)
        b = f.read(1)
        f.seek(-1, os.SEEK_END)
        f.write(bytes([b[0] ^ 0xFF]))
    return path

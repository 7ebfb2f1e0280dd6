"""Rollback-and-retry training runtime (the counterpart of
``repro.resilience.trainer``).

:class:`ResilientTrainer` owns the guarded step (see ``monitor``), a
:class:`CursorStream` over the data, a :class:`HealthMonitor`, an
optional :class:`CheckpointManager`, and an optional
:class:`FaultInjector`, and runs the loop that every verdict maps
onto:

* ``ok``       — commit the step (the gate already applied it),
  record the loss, checkpoint on the cadence.
* ``skip``     — the gate withheld the update; params/optimizer
  /EMA are bit-identical to before the step. The batch is consumed and
  the step index advances (the poisoned batch is *dropped*).
* ``rollback`` — restore the last good checkpoint (params + optimizer
  + EMA + data cursor, all from one manifest), fast-forward the stream
  to the restored cursor, shrink the retry ``clip_scale``
  (escalating grad clip), and re-run from there. Attempts are bounded
  by :class:`RetryPolicy`; exceeding them aborts.
* ``abort``    — raise :class:`TrainingAborted` (state is left at the
  last good values; the caller decides what to do with the corpse).

Injected faults ride the same paths: a ``crash`` raises out of the
loop exactly like a SIGKILL would; a new trainer constructed with
``resume=True`` over the same checkpoint root continues bit-exactly
(the resume-equivalence test in ``tests/test_torch_resilience.py``
asserts the loss trajectory matches an uninterrupted run). A
``device_loss`` triggers the ``on_device_loss`` hook — ``launch/train``
re-runs ``parallelize()`` over the shrunken ``ClusterSpec`` there —
then resumes from the last checkpoint (device state is gone by
definition).

The state is the port's: ``params`` a module or a stage list,
``opt_state`` AdamW's dict, ``health`` the monitor's numpy scalars. A
checkpoint holds them in the reference's layout
(``bridge.state_tree``), and a restore writes the saved values into the
live parameters and moments in place.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterable, Optional

import numpy as np

from repro_torch import bridge
from repro_torch.resilience.faults import FaultInjector
from repro_torch.resilience.manager import CheckpointManager
from repro_torch.resilience.monitor import (ABORT, OK, ROLLBACK, SKIP,
                                            HealthMonitor, bundle_dict,
                                            default_controls, init_health)


class TrainingAborted(RuntimeError):
    """The monitor escalated to ``abort`` (or retries ran out)."""


class CursorStream:
    """A replayable, position-aware stream over a deterministic batch
    factory. ``factory()`` must return a fresh iterator that replays
    the same batch sequence every time (our synthetic datasets are
    seeded generators, so this is free); ``seek(n)`` fast-forwards a
    fresh iterator — how rollback and resume land on the exact batch
    the restored step would have seen."""

    def __init__(self, factory: Callable[[], Iterable]):
        self.factory = factory
        self._it = iter(factory())
        self.cursor = 0

    def next(self):
        batch = next(self._it)
        self.cursor += 1
        return batch

    def seek(self, cursor: int) -> None:
        if cursor < 0:
            raise ValueError(f"cursor must be >= 0, got {cursor}")
        self._it = iter(self.factory())
        for _ in range(cursor):
            next(self._it)
        self.cursor = cursor


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Rollback retry bounds + escalating grad clip.

    max_attempts: rollbacks allowed without an intervening successful
        checkpoint before the trainer aborts.
    clip_decay: each rollback multiplies the retry ``clip_scale`` by
        this (grads shrink, the retried step is gentler).
    recover_steps: consecutive ok steps after which ``clip_scale``
        resets to 1.0 and the attempt counter clears.
    """
    max_attempts: int = 3
    clip_decay: float = 0.5
    recover_steps: int = 25


class ResilientTrainer:
    """See module docstring. ``step_fn`` is a guarded step from
    :func:`monitor.make_resilient_train_step`."""

    def __init__(self, step_fn, params, opt_state, stream: CursorStream,
                 *, monitor: Optional[HealthMonitor] = None,
                 manager: Optional[CheckpointManager] = None,
                 injector: Optional[FaultInjector] = None,
                 policy: Optional[RetryPolicy] = None,
                 ckpt_every: int = 0, resume: bool = False,
                 meta: Optional[Dict[str, Any]] = None,
                 on_device_loss: Optional[Callable[[int], None]] = None,
                 log_every: int = 0):
        self.step_fn = step_fn
        self.params = params
        self.opt_state = opt_state
        self.health = init_health()
        self.stream = stream
        self.monitor = monitor or HealthMonitor()
        self.manager = manager
        self.injector = injector or FaultInjector()
        self.policy = policy or RetryPolicy()
        self.ckpt_every = ckpt_every
        self.meta = dict(meta or {})
        self.on_device_loss = on_device_loss
        self.log_every = log_every
        self.step = 0
        self.losses: Dict[int, float] = {}
        self.clip_scale = 1.0
        self._attempts = 0
        self._ok_streak = 0
        if resume:
            if manager is None:
                raise ValueError("resume=True needs a CheckpointManager")
            if manager.latest() is None:
                self.monitor.log.emit("resume-empty", 0, root=manager.root)
            else:
                self._restore("resume")

    # -- checkpoint plumbing -----------------------------------------------

    def _state_tree(self):
        return bridge.state_tree(self.params, self.opt_state, self.health)

    def save_checkpoint(self, on_entry=None) -> Optional[str]:
        if self.manager is None:
            return None
        meta = {**self.meta, "step": self.step,
                "cursor": self.stream.cursor,
                "clip_scale": self.clip_scale}
        path = self.manager.save(self.step, self._state_tree(),
                                 meta=meta, on_entry=on_entry)
        self.monitor.log.emit("checkpoint", self.step, dir=path,
                              cursor=self.stream.cursor)
        return path

    def adopt_state(self, params, opt_state, health=None, *,
                    step: int, cursor: Optional[int] = None) -> None:
        """Install externally-restored training state (cross-mode
        resume: the launcher loaded a checkpoint written under a
        DIFFERENT param layout — e.g. a replay-mode tree resumed into
        an SPMD run — converted it, and hands the result here instead
        of ``resume=True``'s like-tree restore). Seeks the stream and
        logs the adoption so the event trail shows where the state
        came from."""
        self.params = params
        self.opt_state = opt_state
        self.health = health if health is not None else init_health()
        self.step = int(step)
        self.stream.seek(int(cursor if cursor is not None else step))
        self.monitor.log.emit("adopt", self.step,
                              cursor=self.stream.cursor)

    def _restore(self, why: str) -> None:
        # params and moments are restored in place; the scalars come back
        tree, step, meta = self.manager.restore(self._state_tree())
        self.opt_state = {**self.opt_state,
                          "step": int(tree["opt"]["step"])}
        h = tree["health"]
        self.health = {"ema": np.float32(h["ema"]),
                       "var": np.float32(h["var"]),
                       "count": np.int32(h["count"])}
        self.step = int(meta.get("step", step))
        self.stream.seek(int(meta.get("cursor", self.step)))
        self.monitor.log.emit("restore", self.step, why=why,
                              cursor=self.stream.cursor)

    # -- the loop ----------------------------------------------------------

    def _controls(self, inject_nan: bool):
        c = default_controls()
        c["max_grad_norm"] = np.float32(self.monitor.cfg.max_grad_norm)
        c["clip_scale"] = np.float32(self.clip_scale)
        c["inject_nan"] = np.float32(1.0 if inject_nan else 0.0)
        return c

    def _rollback(self, step: int, reason: str) -> None:
        self._attempts += 1
        if self.manager is None or self.manager.latest() is None:
            raise TrainingAborted(
                f"rollback requested at step {step} ({reason}) but no "
                f"checkpoint exists to roll back to — configure a "
                f"CheckpointManager and ckpt_every for rollback "
                f"coverage")
        if self._attempts > self.policy.max_attempts:
            raise TrainingAborted(
                f"rollback at step {step} ({reason}) exceeded "
                f"{self.policy.max_attempts} retry attempts")
        self.clip_scale *= self.policy.clip_decay
        self._ok_streak = 0
        self._restore(f"rollback:{reason}")
        self.monitor.log.emit("retry", self.step, reason=reason,
                              attempt=self._attempts,
                              clip_scale=self.clip_scale)

    def run(self, num_steps: int) -> Dict[str, Any]:
        """Train until ``self.step == num_steps``; returns a summary
        (losses by step, verdict counters, fired faults)."""
        while self.step < num_steps:
            step = self.step
            self.injector.check_crash(step)
            loss_ev = self.injector.check_device_loss(step)
            if loss_ev is not None:
                self.monitor.log.emit("device-loss", step,
                                      lost=loss_ev.lost)
                if self.on_device_loss is not None:
                    self.on_device_loss(loss_ev.lost)
                if self.manager is not None and \
                        self.manager.latest() is not None:
                    self._restore("device-loss")
                continue

            batch = self.stream.next()
            self.params, self.opt_state, self.health, bundle = \
                self.step_fn(self.params, self.opt_state, self.health,
                             batch, self._controls(
                                 self.injector.nan_at(step)))
            b = bundle_dict(bundle)
            verdict = self.monitor.classify(step, b)

            if verdict == ABORT:
                raise TrainingAborted(
                    f"monitor aborted training at step {step}: {b}")
            if verdict == ROLLBACK:
                self._rollback(step, "verdict")
                continue
            # ok | skip: the gate already did the right thing
            self.step += 1
            if verdict == OK:
                self.losses[step] = b["loss"]
                self._ok_streak += 1
                if self._ok_streak >= self.policy.recover_steps and \
                        self.clip_scale != 1.0:
                    self.clip_scale = 1.0
                    self._attempts = 0
                    self.monitor.log.emit("recovered", step)
                if self.log_every and step % self.log_every == 0:
                    print(f"step {step:5d} loss {b['loss']:.4f} "
                          f"gnorm {b['grad_norm']:.3f}", flush=True)
            if self.ckpt_every and verdict == OK and \
                    self.step % self.ckpt_every == 0:
                # a crash_in_save fault at this step kills the write
                # mid-shard; CrashInjected propagates like a SIGKILL
                self.save_checkpoint(
                    on_entry=self.injector.save_hook(step))
        return self.summary()

    def summary(self) -> Dict[str, Any]:
        ev = self.monitor.log
        return {
            "last_step": self.step,
            "losses": dict(self.losses),
            "rollbacks": self.monitor.rollbacks,
            "skipped": len([e for e in ev.of_kind("verdict")
                            if e.get("verdict") == SKIP]),
            "fired_faults": [dataclasses.asdict(f)
                             for f in self.injector.fired],
            "clip_scale": self.clip_scale,
        }

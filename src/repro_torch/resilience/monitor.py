"""Step-health monitoring (the counterpart of
``repro.resilience.monitor``): the guarded train step and the host-side
classifier.

* :func:`make_resilient_train_step` builds the **guarded** train step.
  On the card it computes the loss and gradients (with the deterministic
  NaN poison of a ``nan_grads`` fault applied), the global gradient norm
  and the finite flag, and reads them to the host in **one**
  device-to-host copy: the read the plain loop pays anyway for its loss.
  The host scores the loss against an EMA baseline (numpy f32) and
  decides whether the step is healthy. The JAX step applies AdamW to
  zeroed gradients and selects the old or the new state; the port's
  AdamW updates the parameters in place, so the guarded step calls it
  only on a healthy step, with the gradients scaled by ``clip_scale``.
  A non-finite or over-norm step changes nothing: parameters, moments,
  AdamW's ``step`` and the EMA state stay exactly as they were. The
  health bundle (``BUNDLE_KEYS``) is a numpy f32 vector with the JAX
  step's lanes and values.

* :class:`HealthMonitor` maps a bundle to an ``ok | skip | rollback |
  abort`` verdict under a :class:`MonitorConfig` policy and writes every
  decision to a JSONL :class:`EventLog`, as the reference does.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.optim import optimizer as opt

#: verdicts, in escalation order
OK, SKIP, ROLLBACK, ABORT = "ok", "skip", "rollback", "abort"
VERDICTS = (OK, SKIP, ROLLBACK, ABORT)

#: lanes of the health bundle the guarded step returns, in order:
#:   loss       — this step's loss (may be nan/inf)
#:   grad_norm  — global grad norm (pre-clip; may be nan/inf)
#:   spike      — |loss - EMA| / sqrt(EMA-variance) z-score (0 during
#:                EMA warmup; the host applies its own warmup gate too)
#:   nonfinite  — 1.0 iff loss or grad norm is NaN/Inf
#:   applied    — 1.0 iff the update was applied
BUNDLE_KEYS = ("loss", "grad_norm", "spike", "nonfinite", "applied")


def init_health() -> Dict[str, Any]:
    """The EMA state threaded through the guarded step (and bundled into
    every checkpoint, so resumes keep the spike baseline): numpy
    f32/f32/int32 scalars."""
    return {"ema": np.float32(0.0), "var": np.float32(0.0),
            "count": np.int32(0)}


def default_controls() -> Dict[str, Any]:
    """Per-step policy scalars: ``max_grad_norm`` skip ceiling,
    ``clip_scale`` retry grad shrink (<1 after a rollback),
    ``inject_nan`` deterministic NaN-grad fault switch."""
    return {"max_grad_norm": np.float32(np.inf),
            "clip_scale": np.float32(1.0),
            "inject_nan": np.float32(0.0)}


def make_resilient_train_step(loss_fn, ocfg: opt.AdamWConfig,
                              frozen_mask=None, *,
                              ema_decay: float = 0.98,
                              value_and_grad_fn=None,
                              global_norm_fn: Optional[Callable] = None,
                              named_parameters: Optional[Callable] = None):
    """``step(params, opt_state, health, batch, controls) -> (params,
    opt_state, health, bundle)``: the plain train step with the health
    bundle and the gate (module docstring).

    ``loss_fn(params, batch) -> (loss, aux)`` is the callable the plain
    step builders use (``steps.make_loss_fn`` on a model, or
    ``make_mllm_train_step``'s second return); gradients are taken for
    the parameters that require grad. ``value_and_grad_fn(params, batch)
    -> ((loss, aux), grads)`` replaces that (``loss_fn`` may then be
    None): how the SPMD schedule runner, whose backward is the schedule's
    B/W items, plugs into the same gate. Its ``global_norm_fn(grads)``
    all-reduces the norm over the ranks, and ``named_parameters(params)``
    gives the {name: tensor} that AdamW updates (keys of ``grads``,
    ``opt_state`` and ``frozen_mask``; default
    ``dict(params.named_parameters())``). Every rank then reads the same
    bundle and takes the same verdict."""
    if value_and_grad_fn is None:
        from repro_torch.training.steps import _grads

        def value_and_grad_fn(params, batch):
            loss, aux = loss_fn(params, batch)
            return (loss, aux), _grads(loss, dict(params.named_parameters()))
    norm_fn = global_norm_fn or opt.global_norm
    named_of = named_parameters or (lambda p: dict(p.named_parameters()))
    decay = np.float32(ema_decay)
    fold = np.float32(1 - ema_decay)

    def step(params, opt_state, health, batch, controls):
        (loss, _aux), grads = value_and_grad_fn(params, batch)
        if controls["inject_nan"] > 0:
            # what a real overflow looks like downstream, deterministically
            grads = {n: None if g is None else g * float("nan")
                     for n, g in grads.items()}
        gnorm = norm_fn(grads)
        loss_d = loss.detach().float()
        gnorm_d = gnorm.float().to(loss_d.device)
        finite = torch.isfinite(loss_d) & torch.isfinite(gnorm_d)
        ok_d = finite & (gnorm_d <= float(controls["max_grad_norm"]))
        # the step's one device-to-host copy
        lanes = torch.stack([loss_d, gnorm_d, finite.float(),
                             ok_d.float()]).cpu().numpy()
        loss_h, gnorm_h = np.float32(lanes[0]), np.float32(lanes[1])
        fin, ok = bool(lanes[2] > 0.5), bool(lanes[3] > 0.5)

        # EMA loss-spike score, computed BEFORE this step's loss is folded
        # in (a spike must not dilute its own baseline)
        warm = health["count"] > 0
        mean = health["ema"] if warm else loss_h
        dev = np.float32(loss_h - mean)
        spike = np.float32(np.abs(dev) / np.sqrt(
            health["var"] + np.float32(1e-8))) if warm and fin \
            else np.float32(0.0)

        if ok:
            scale = float(controls["clip_scale"])
            if scale != 1.0:
                grads = {n: None if g is None else
                         (g.float() * scale).to(g.dtype)
                         for n, g in grads.items()}
                # AdamW clips by the norm of the gradients it is given
                gnorm = norm_fn(grads)
            _, opt_state, _ = opt.update(ocfg, grads, opt_state,
                                         named_of(params), frozen_mask,
                                         grad_norm=gnorm)
            # the EMA tracks only applied steps
            health = {"ema": np.float32(decay * mean + fold * loss_h),
                      "var": np.float32(decay * health["var"]
                                        + fold * dev * dev),
                      "count": np.int32(health["count"] + 1)}
        bundle = np.array([loss_h, gnorm_h, spike, 0.0 if fin else 1.0,
                           1.0 if ok else 0.0], np.float32)
        return params, opt_state, health, bundle

    return step


def bundle_dict(bundle) -> Dict[str, float]:
    """Bundle vector -> {key: float}."""
    vals = np.asarray(bundle, np.float32)
    return {k: float(v) for k, v in zip(BUNDLE_KEYS, vals)}


# ---------------------------------------------------------------------------
# Host side: event log + verdict classifier
# ---------------------------------------------------------------------------

class EventLog:
    """Structured JSONL event sink. Every event is one json object per
    line with at least ``{"step", "kind"}``; ``path=None`` keeps the
    log in memory only (tests). Appends are flushed per event so a
    crash cannot lose the decision trail."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.events: List[dict] = []
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)),
                        exist_ok=True)

    def emit(self, kind: str, step: int, **fields) -> dict:
        ev = {"kind": kind, "step": int(step), **fields}
        self.events.append(ev)
        if self.path:
            with open(self.path, "a", encoding="utf-8") as f:
                f.write(json.dumps(ev) + "\n")
                f.flush()
        return ev

    def of_kind(self, kind: str) -> List[dict]:
        return [e for e in self.events if e["kind"] == kind]


@dataclasses.dataclass(frozen=True)
class MonitorConfig:
    """Host-side verdict policy.

    spike_sigma: EMA z-score above which a finite loss is a spike.
    spike_warmup: applied steps before the z-score is trusted (the EMA
        variance estimate is garbage early).
    max_grad_norm: grad-norm ceiling; above it a step is skipped (the
        same value should be passed as the ``max_grad_norm`` control so
        the gate withholds the update).
    skip_limit: consecutive skips tolerated before escalating to
        rollback (0 = first bad step rolls back immediately).
    max_rollbacks: total rollbacks tolerated before abort.
    """
    spike_sigma: float = 8.0
    spike_warmup: int = 20
    max_grad_norm: float = math.inf
    skip_limit: int = 2
    max_rollbacks: int = 3


class HealthMonitor:
    """Maps health bundles to verdicts and logs every decision."""

    def __init__(self, cfg: Optional[MonitorConfig] = None,
                 log: Optional[EventLog] = None):
        self.cfg = cfg or MonitorConfig()
        self.log = log if log is not None else EventLog()
        self.consecutive_skips = 0
        self.rollbacks = 0
        self.applied_steps = 0

    def classify(self, step: int, bundle: Dict[str, float]) -> str:
        """One verdict per step. Escalation is stateful: skips in a row
        beyond ``skip_limit`` become a rollback; rollbacks beyond
        ``max_rollbacks`` become an abort."""
        cfg = self.cfg
        verdict, reason = OK, None
        if bundle["nonfinite"] >= 0.5:
            verdict, reason = SKIP, "nonfinite"
        elif bundle["grad_norm"] > cfg.max_grad_norm:
            verdict, reason = SKIP, "grad-norm"
        elif (self.applied_steps >= cfg.spike_warmup
              and bundle["spike"] > cfg.spike_sigma):
            verdict, reason = ROLLBACK, "loss-spike"

        if verdict == SKIP:
            self.consecutive_skips += 1
            if self.consecutive_skips > cfg.skip_limit:
                verdict = ROLLBACK
        else:
            self.consecutive_skips = 0
        if verdict == ROLLBACK:
            self.rollbacks += 1
            self.consecutive_skips = 0
            if self.rollbacks > cfg.max_rollbacks:
                verdict = ABORT
        if verdict == OK:
            self.applied_steps += 1
        if verdict != OK:
            self.log.emit("verdict", step, verdict=verdict, reason=reason,
                          **{k: bundle[k] for k in BUNDLE_KEYS})
        return verdict

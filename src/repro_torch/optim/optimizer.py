"""AdamW with frozen-parameter masking and LR schedules, computed as the
counterpart ``repro.optim.optimizer.update`` computes it:

- the clip scale from the global norm over all gradients (a frozen
  leaf's missing gradient counts as zero);
- the learning rate at ``lr_at(step + 1)``, in f32 as the JAX function;
- bias-corrected moments;
- decoupled decay as ``lr · (m̂ / (√v̂ + eps) + wd · p)``;
- the update in f32, cast back to the parameter's dtype.

Frozen leaves hold no optimizer state (``None``) and are never written.
Unlike the JAX function, ``update`` writes the new values into the
parameters in place (no second copy of the weights); the parameters and
state are dicts keyed by parameter name, as ``named_parameters`` gives.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"    # cosine | constant


def lr_at(cfg: AdamWConfig, step) -> np.float32:
    """Warmup then cosine (or constant), in f32 like the JAX function."""
    f32 = np.float32
    step = f32(step)
    warm = np.minimum(step / f32(max(cfg.warmup_steps, 1)), f32(1.0))
    if cfg.schedule == "constant":
        return f32(cfg.lr) * warm
    frac = np.clip((step - f32(cfg.warmup_steps))
                   / f32(max(cfg.total_steps - cfg.warmup_steps, 1)),
                   f32(0.0), f32(1.0))
    return (f32(cfg.lr) * warm * f32(0.5)
            * (f32(1.0) + np.cos(f32(np.pi) * frac)))


def global_norm(grads: Mapping[str, Optional[torch.Tensor]]) -> torch.Tensor:
    """sqrt of the sum of squares over every gradient, in f32 (a 0-dim
    tensor on the gradients' device); ``None`` counts as zero."""
    sq = [torch.sum(torch.square(g.float())) for g in grads.values()
          if g is not None]
    if not sq:
        return torch.zeros(())
    return torch.sqrt(torch.stack(sq).sum())


def init(cfg: AdamWConfig, params: Mapping[str, torch.Tensor],
         frozen_mask: Optional[Mapping[str, bool]] = None) -> dict:
    """{"step": 0, "m": {name: f32 zeros or None}, "v": ...}; frozen
    leaves get ``None`` (no optimizer memory)."""
    frozen_mask = frozen_mask or {}

    def zeros(name, p):
        return None if frozen_mask.get(name, False) else \
            torch.zeros_like(p, dtype=torch.float32)
    return {"step": 0,
            "m": {n: zeros(n, p) for n, p in params.items()},
            "v": {n: zeros(n, p) for n, p in params.items()}}


@torch.no_grad()
def update(cfg: AdamWConfig, grads: Mapping[str, Optional[torch.Tensor]],
           state: dict, params: Mapping[str, torch.Tensor],
           frozen_mask: Optional[Mapping[str, bool]] = None):
    """Returns (params, new_state, metrics {"grad_norm", "lr"}); params
    are updated in place. A trainable leaf with no gradient (``None``)
    is updated as if its gradient were zero, as the JAX function sees
    the zeros ``stop_gradient`` gives."""
    frozen_mask = frozen_mask or {}
    gnorm = global_norm(grads)
    clip = (torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0) if cfg.grad_clip else 1.0)
    step = state["step"] + 1
    lr = float(lr_at(cfg, step))
    bc1 = float(np.float32(1.0) - np.float32(cfg.b1) ** np.float32(step))
    bc2 = float(np.float32(1.0) - np.float32(cfg.b2) ** np.float32(step))
    new_m: Dict[str, Optional[torch.Tensor]] = {}
    new_v: Dict[str, Optional[torch.Tensor]] = {}
    for name, p in params.items():
        m, v = state["m"][name], state["v"][name]
        if frozen_mask.get(name, False):
            new_m[name], new_v[name] = m, v
            continue
        g = grads.get(name)
        g = torch.zeros_like(p, dtype=torch.float32) if g is None \
            else g.float() * clip
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g * g
        pf = p.float()
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) \
            + cfg.weight_decay * pf
        p.copy_((pf - lr * delta).to(p.dtype))
        new_m[name], new_v[name] = m, v
    return params, {"step": step, "m": new_m, "v": new_v}, \
        {"grad_norm": gnorm, "lr": lr}

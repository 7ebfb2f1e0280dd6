"""Uniform model API — dispatch on ``cfg.family`` (port of
``repro.models.api``). The port has the dense family only; the others
are ROADMAP.md queue 1 item 20 ("Other backbones").

    init(cfg, device=, generator=)   -> model
    forward(model, cfg, batch)       -> (logits, aux)
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer

_FAMILIES = {"dense": transformer}


def module_for(cfg: ModelConfig):
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(
            f"model family {cfg.family!r} ({cfg.name}) is not ported yet: "
            f"ROADMAP.md queue 1 item 20 (other backbones)")
    return _FAMILIES[cfg.family]


def init(cfg: ModelConfig, *, device="cuda", generator=None):
    return module_for(cfg).init(cfg, device=device, generator=generator)


def forward(model, cfg: ModelConfig, batch):
    return module_for(cfg).forward(model, cfg, batch)

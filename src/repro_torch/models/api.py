"""Uniform model API — dispatch on ``cfg.family`` (port of
``repro.models.api``): dense, vlm, moe, hybrid (zamba2), ssm (xLSTM) and
audio (Whisper).

    init(cfg, device=, generator=)                     -> model
    forward(model, cfg, batch)                         -> (logits, aux)
    init_cache(cfg, batch_size, max_len, dtype, device=) -> cache
    decode_step(model, cfg, cache, batch)              -> (logits, cache)
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models import (mamba2, moe, transformer, vlm, whisper,
                                xlstm)

_FAMILIES = {"dense": transformer, "moe": moe, "ssm": xlstm,
             "hybrid": mamba2, "audio": whisper, "vlm": vlm}


def module_for(cfg: ModelConfig):
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(
            f"unknown model family {cfg.family!r} ({cfg.name}); the port "
            f"has {sorted(_FAMILIES)}")
    return _FAMILIES[cfg.family]


def init(cfg: ModelConfig, *, device="cuda", generator=None):
    return module_for(cfg).init(cfg, device=device, generator=generator)


def forward(model, cfg: ModelConfig, batch):
    return module_for(cfg).forward(model, cfg, batch)


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int, dtype=None,
               *, device="cuda"):
    return module_for(cfg).init_cache(cfg, batch_size, max_len, dtype,
                                      device=device)


def decode_step(model, cfg: ModelConfig, cache, batch):
    return module_for(cfg).decode_step(model, cfg, cache, batch)

"""Concrete MLLM model code (the counterpart of ``repro.models.mllm``):
the bidirectional encoder backbone over stubbed frame/patch embeddings
(the EVA-CLIP / Whisper-encoder stand-ins of the paper's Table 1), and
``build_paper_mllm``, which assembles the paper's VLM / ALM / VALM
evaluation models through ``core.modality.MultimodalModule``.

The encoder's parameter tree mirrors the JAX package's (``layers.<i>``
unstacked, ``final_ln``), so the weight bridge is a copy.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.paper_mllm import (audio_encoder_config, llm_config,
                                            vision_encoder_config)
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.transformer import torch_dtype

VISION_TOKENS = 576     # ~(1280x720 -> 24x24 patches), paper setup
AUDIO_TOKENS = 750      # 30 s clip at Whisper 25 fps after conv stride


class EncoderBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device, generator):
        super().__init__()
        self.ln1 = L.Norm(cfg, cfg.d_model, dtype, device)
        self.attn = L.Attention(cfg, dtype, device, generator)
        self.ln2 = L.Norm(cfg, cfg.d_model, dtype, device)
        self.mlp = L.MLP(cfg.d_model, cfg.d_ff, dtype, device, generator,
                         gated=False)


class Encoder(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device="cuda", generator=None):
        super().__init__()
        dev = resolve_device(device)
        dtype = torch_dtype(cfg)
        self.layers = nn.ModuleList(EncoderBlock(cfg, dtype, dev, generator)
                                    for _ in range(cfg.num_layers))
        self.final_ln = L.Norm(cfg, cfg.d_model, dtype, dev)


def encoder_init(cfg: ModelConfig, *, device="cuda",
                 generator=None) -> Encoder:
    return Encoder(cfg, device=device, generator=generator)


def encoder_forward(model: Encoder, cfg: ModelConfig, embeds):
    """embeds: [B, T_m, d_m] precomputed frontend output. Every token
    attends every token (no RoPE, an all-true mask). The embeds are cast
    to the encoder's dtype first; the JAX function lets f32 embeds
    promote bf16 weights to f32 instead (the same at f32)."""
    B, Tm, _ = embeds.shape
    x = embeds.to(torch_dtype(cfg))
    pos = torch.arange(Tm, dtype=torch.int32,
                       device=x.device)[None].expand(B, Tm)
    full = torch.ones((1, 1, 1, 1), dtype=torch.bool, device=x.device)
    for lp in model.layers:
        h = L.apply_norm(cfg, lp.ln1, x)
        a, _ = L.run_attention(lp.attn, cfg, h, q_pos=pos,
                               mask_fn=lambda: full, rope=False)
        x = x + a
        h = L.apply_norm(cfg, lp.ln2, x)
        x = x + L.run_mlp(lp.mlp, h, "gelu")
    return L.apply_norm(cfg, model.final_ln, x)


def build_paper_mllm(kind: str = "valm", llm_size: str = "M",
                     vision_size: str = "S", audio_size: str = "S",
                     reduced: bool = False, text_len: int = 1024):
    """kind: vlm | alm | valm. Frozen encoders + frozen LLM + trainable
    projectors, the paper's §6 configuration. ``text_len`` is kept for
    the JAX signature; the batch decides the text length."""
    from repro_torch.core.modality import ModalityModule, MultimodalModule
    if kind not in ("vlm", "alm", "valm"):
        raise ValueError(f"kind={kind!r}; want vlm, alm or valm")
    encoders: Dict[str, ModalityModule] = {}
    n_vis = 16 if reduced else VISION_TOKENS
    n_aud = 16 if reduced else AUDIO_TOKENS
    if kind in ("vlm", "valm"):
        encoders["vision"] = ModalityModule(
            "vision", vision_encoder_config(vision_size, reduced),
            modality_id=1, projector="linear", num_tokens=n_vis)
    if kind in ("alm", "valm"):
        encoders["audio"] = ModalityModule(
            "audio", audio_encoder_config(audio_size, reduced),
            modality_id=2, projector="linear", num_tokens=n_aud)
    mllm = MultimodalModule(
        encoders=encoders, llm_cfg=llm_config(llm_size, reduced),
        frozen_llm=True)
    for name in encoders:
        mllm.freeze(name, module=True, projector=False)
    return mllm

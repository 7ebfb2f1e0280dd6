"""Paged prefill and decode steps for the dense transformer family (port
of ``repro.serving.model``).

* ``paged_prefill`` runs the prompt forward, keeping every layer's
  projected, roped K/V (``transformer._block``), and writes the prompt's
  K/V and slot bits/pos into the page pool.
* ``paged_decode_step`` decodes one token for every batch row at ragged
  per-row offsets: each row writes its new K/V into its own (page, slot),
  then attends over its resident pages through the dense-gather
  reference (``attn="xla"``) or K4 (``attn="kernel"``).

Both update the cache dict's tensors in place (JAX returns a new cache;
in place saves a copy of the pool per step) and also return it.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import bam
from repro_torch.kernels.paged_decode import (decode_steps,
                                              paged_decode_attention,
                                              paged_decode_ref)
from repro_torch.models import api
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

ATTN_PATHS = ("xla", "kernel")


def check_serving_cfg(cfg: ModelConfig) -> None:
    """The paged path covers the dense transformer family."""
    if api.module_for(cfg) is not T:
        raise ValueError(
            f"paged serving supports the dense transformer family; "
            f"{cfg.name!r} decodes through {api.module_for(cfg).__name__}")
    if cfg.mm is not None and cfg.mm.mrope_sections:
        raise ValueError(
            f"{cfg.name!r} uses M-RoPE (pos3) — not wired through the "
            f"paged decode path")


# the JAX package keeps a python-int twin of its traced per-layer window;
# the port's window is a python int already
static_layer_window = T.layer_window


def grid_window(cfg: ModelConfig) -> int:
    """Sliding window the decode grid may prune pages with: only when
    every layer shares it."""
    return 0 if cfg.local_global_pattern else cfg.sliding_window


def _replicate_kv(cfg: ModelConfig, k, v):
    """Widen K/V heads (axis 2) to ``decode_kv_replicate``."""
    rep = cfg.decode_kv_replicate
    if rep > k.shape[2]:
        k = bam.repeat_kv(k, rep // k.shape[2])
        v = bam.repeat_kv(v, rep // v.shape[2])
    return k, v


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------

def prefill_forward(model, cfg: ModelConfig, batch):
    """Forward over the prompt that keeps each layer's K/V. Returns
    (logits [B,T,V], k [L,B,T,Hkv,hd], v [L,B,T,Hkv,hd])."""
    x = T.embed_tokens(model, cfg, batch)
    ks, vs = [], []
    for i, lp in enumerate(model.layers):
        x, _, (k, v) = T._block(cfg, lp, x, batch, i)
        ks.append(k)
        vs.append(v)
    h = L.apply_norm(cfg, model.final_ln, x)
    return T.unembed(model, cfg, h), torch.stack(ks), torch.stack(vs)


def paged_prefill(model, cfg: ModelConfig, cache, batch, page, slot):
    """One request's prompt forward, writing its K/V and slot metadata
    into the pool. batch: tokens/positions/bits [1, T]; page/slot [T]
    physical coordinates. Returns (logits [1,T,V], cache)."""
    if batch.get("bits") is None:
        raise ValueError(
            "paged_prefill needs batch['bits'] — the page pool's mask "
            "metadata is the bitfield; use bam.causal_bits for text")
    logits, k, v = prefill_forward(model, cfg, batch)
    k, v = _replicate_kv(cfg, k[:, 0], v[:, 0])     # [L, T, Hkv, hd]
    page, slot = page.long(), slot.long()
    cache["k"][:, page, slot] = k.to(cache["k"].dtype)
    cache["v"][:, page, slot] = v.to(cache["v"].dtype)
    cache["bits"][page, slot] = batch["bits"][0]
    cache["pos"][page, slot] = batch["positions"][0]
    return logits, cache


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def paged_decode_step(model, cfg: ModelConfig, cache, batch, *,
                      attn: str = "xla"):
    """One decode token for every batch row against the page pool.

    batch: tokens/positions/bits [B, 1]; page/slot [B] insert
    coordinates (empty rows point at the null page); page_tables
    [B, max_pages] (attn="xla"); steps — the decode grid's step arrays
    (attn="kernel"). The new token's K/V and bits/pos go into the pool
    before attention, so each query attends itself. Returns
    (logits [B, 1, V], cache)."""
    if attn not in ATTN_PATHS:
        raise ValueError(f"attn={attn!r}; pick from {ATTN_PATHS} "
                         f"(interpret is a JAX-only mode)")
    B = batch["tokens"].shape[0]
    page, slot = batch["page"].long(), batch["slot"].long()
    pos = batch["positions"]                            # [B, 1]
    q_bits = batch.get("bits")
    if q_bits is None:
        q_bits = torch.full((B, 1), bam.text_token(), dtype=torch.int32,
                            device=pos.device)

    x = T.embed_tokens(model, cfg, batch)               # [B, 1, d]
    cache["bits"][page, slot] = q_bits[:, 0]
    cache["pos"][page, slot] = pos[:, 0]
    steps = decode_steps(batch["steps"], B, pos.device,
                         kv_heads=cache["k"].shape[3],
                         page_size=cache["k"].shape[2]) \
        if attn == "kernel" else None

    for i, lp in enumerate(model.layers):
        window = static_layer_window(cfg, i)
        h = L.apply_norm(cfg, lp.ln1, x)
        q, k, v = L.attn_project_qkv(lp.attn, cfg, h, h)
        q = L.apply_rope(q, pos, cfg.rope_theta)
        k = L.apply_rope(k, pos, cfg.rope_theta)
        k, v = _replicate_kv(cfg, k, v)
        ks, vs = cache["k"][i], cache["v"][i]
        ks[page, slot] = k[:, 0].to(ks.dtype)
        vs[page, slot] = v[:, 0].to(vs.dtype)
        if attn == "xla":
            out = paged_decode_ref(
                q[:, 0], ks, vs, q_bits, pos, cache["bits"], cache["pos"],
                batch["page_tables"], softcap=cfg.attn_softcap,
                window=window)
        else:
            out = paged_decode_attention(
                q[:, 0].contiguous(), ks, vs, q_bits, pos, cache["bits"],
                cache["pos"], steps, softcap=cfg.attn_softcap,
                window=window)
        attn_out = out.reshape(B, 1, cfg.q_dim) @ lp.attn.wo
        if cfg.post_block_norm:
            attn_out = L.apply_norm(cfg, lp.post_ln1, attn_out)
        x = x + attn_out
        h = L.apply_norm(cfg, lp.ln2, x)
        mlp_out, _ = T._default_ffn(lp, h, cfg)
        if cfg.post_block_norm:
            mlp_out = L.apply_norm(cfg, lp.post_ln2, mlp_out)
        x = x + mlp_out

    h = L.apply_norm(cfg, model.final_ln, x)
    return T.unembed(model, cfg, h), cache

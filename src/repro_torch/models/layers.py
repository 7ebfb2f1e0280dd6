"""Shared layer library (port of ``repro.models.layers``).

Parameters live in small ``nn.Module``s whose attribute names are the
JAX parameter tree's keys (``wq``, ``w_up``, ``w``, ...), in the JAX
layout: ``x @ W`` with W [d_in, d_out], so the weight bridge is a copy.
The apply functions take those modules and plain tensors.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.bam import repeat_kv
from repro_torch.core.context_parallel import cp_attention
from repro_torch.kernels import ops

ATTN_IMPLS = ("xla", "bam_kernel")


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------

def normal_param(shape, dtype, device, generator, scale: float = 0.02):
    """N(0, 1) * scale drawn in f32 (as the JAX init), cast to dtype.
    Parameters start frozen; a trainer turns on what it trains with
    ``requires_grad_`` (``core.modality.MultimodalModule.apply_freeze``)."""
    x = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32) * scale
    return nn.Parameter(x.to(dtype), requires_grad=False)


def const_param(shape, value: float, dtype, device):
    return nn.Parameter(torch.full(shape, value, dtype=dtype, device=device),
                        requires_grad=False)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm(x, w, eps: float = 1e-6):
    """Computed in f32; scales by (1 + w), w initialised to 0."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + w.float())).to(x.dtype)


def layernorm(x, w, b, eps: float = 1e-5):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * w.float() + b.float()).to(x.dtype)


class Norm(nn.Module):
    def __init__(self, cfg: ModelConfig, d: int, dtype, device):
        super().__init__()
        self.rms = cfg.norm == "rmsnorm"
        self.w = const_param((d,), 0.0 if self.rms else 1.0, dtype, device)
        if not self.rms:
            self.b = const_param((d,), 0.0, dtype, device)


def apply_norm(cfg: ModelConfig, p: Norm, x):
    if cfg.norm == "rmsnorm":
        return rmsnorm(x, p.w)
    return layernorm(x, p.w, p.b)


# ---------------------------------------------------------------------------
# RoPE (split-half form) and M-RoPE (qwen2-vl)
# ---------------------------------------------------------------------------

def rope_angles(pos, head_dim: int, theta: float):
    """pos: [..., T] int -> cos/sin [..., T, head_dim//2] f32."""
    half = head_dim // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=pos.device) / half))
    ang = pos.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, pos, theta: float):
    """x: [B, T, H, hd]; pos: [B, T] -> rotated x, computed in f32."""
    cos, sin = rope_angles(pos, x.shape[-1], theta)
    cos, sin = cos[..., None, :], sin[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x, pos3, sections, theta: float):
    """Multimodal RoPE (qwen2-vl, arXiv:2409.12191). x: [B,T,H,hd];
    pos3: [3,B,T] (temporal, height, width) position ids. ``sections``
    partitions the half-dim into (t, h, w) bands; each band rotates by its
    own position stream. For text tokens the three ids are equal, which
    reduces to ``apply_rope``."""
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"mrope sections {tuple(sections)} must sum to "
                         f"head_dim // 2 = {half}")
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    sec_ids = torch.repeat_interleave(
        torch.arange(len(sections), device=x.device),
        torch.tensor(sections, device=x.device))              # [half]
    pos_sel = pos3.float()[sec_ids]                           # [half,B,T]
    ang = pos_sel.movedim(0, -1) * freqs                      # [B,T,half]
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Masked scaled-dot-product attention (the plain "xla" path)
# ---------------------------------------------------------------------------

def sdpa(q, k, v, mask, *, softcap: float = 0.0):
    """q: [B,Tq,H,hd]; k/v: [B,Tk,H,hd]; mask broadcastable to
    [B,H,Tq,Tk] bool. Rows with no allowed key give 0, not NaN."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1)
    any_ok = mask.any(dim=-1, keepdim=True)
    probs = torch.where(any_ok, probs, torch.zeros_like(probs)).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def sdpa_q_chunked(q, k, v, mask_fn, chunk: int, *, softcap: float = 0.0):
    """``sdpa`` over blocks of ``chunk`` queries: each block's mask comes
    from ``mask_fn(start, size)``, so neither the [Tq,Tk] logits nor the
    [Tq,Tk] mask ever exist at once (the prefill memory lever). Under
    autograd each block is rematerialised (non-reentrant
    ``torch.utils.checkpoint``), as ``jax.checkpoint`` per block in the
    JAX package. q/k/v: [B,T,H,hd], k/v already GQA-expanded."""
    tq = q.shape[1]
    if tq % chunk:
        raise ValueError(f"Tq={tq} is not a multiple of chunk={chunk}")

    def block(qs, k, v, mask):
        return sdpa(qs, k, v, mask, softcap=softcap)

    outs = []
    for start in range(0, tq, chunk):
        qs = q[:, start:start + chunk]
        mask = mask_fn(start, chunk)
        if torch.is_grad_enabled():
            outs.append(checkpoint(block, qs, k, v, mask,
                                   use_reentrant=False))
        else:
            outs.append(block(qs, k, v, mask))
    return torch.cat(outs, dim=1)


def causal_mask(q_pos, kv_pos, window: int = 0):
    """q_pos: [B,Tq], kv_pos: [B,Tk] -> [B,1,Tq,Tk] bool."""
    m = kv_pos[:, None, :] <= q_pos[:, :, None]
    if window:
        m &= (q_pos[:, :, None] - kv_pos[:, None, :]) < window
    return m[:, None]


# ---------------------------------------------------------------------------
# GQA attention block
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device, generator):
        super().__init__()
        d = cfg.d_model
        self.wq = normal_param((d, cfg.q_dim), dtype, device, generator)
        self.wk = normal_param((d, cfg.kv_dim), dtype, device, generator)
        self.wv = normal_param((d, cfg.kv_dim), dtype, device, generator)
        self.wo = normal_param((cfg.q_dim, d), dtype, device, generator)
        if cfg.qkv_bias:
            self.bq = const_param((cfg.q_dim,), 0.0, dtype, device)
            self.bk = const_param((cfg.kv_dim,), 0.0, dtype, device)
            self.bv = const_param((cfg.kv_dim,), 0.0, dtype, device)
        if cfg.use_qk_norm:
            self.qnorm = const_param((cfg.head_dim,), 0.0, dtype, device)
            self.knorm = const_param((cfg.head_dim,), 0.0, dtype, device)


def attn_project_qkv(p: Attention, cfg: ModelConfig, x_q, x_kv):
    b, tq, _ = x_q.shape
    tk = x_kv.shape[1]
    q = x_q @ p.wq
    k = x_kv @ p.wk
    v = x_kv @ p.wv
    if cfg.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q = q.reshape(b, tq, cfg.num_heads, cfg.head_dim)
    k = k.reshape(b, tk, cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(b, tk, cfg.num_kv_heads, cfg.head_dim)
    if cfg.use_qk_norm:
        q = rmsnorm(q, p.qnorm)
        k = rmsnorm(k, p.knorm)
    return q, k, v


def run_attention(p: Attention, cfg: ModelConfig, x, *, q_pos, mask=None,
                  mask_fn=None, kv_pos=None, pos3=None, window: int = 0,
                  bits=None, rope: bool = True, kv_override=None,
                  x_kv=None):
    """Attention block over x [B,T,d]: self-attention, or cross-attention
    to ``x_kv`` [B,Tk,d] when it is given (Whisper's decoder; plain path
    only, with ``mask`` and ``kv_pos``). Returns (out [B,T,d], (k, v))
    with k/v the projected (and, with ``rope``, roped) [B,T,Hkv,hd] the
    serving prefill keeps, or the layer's cache after ``kv_override``.

    Fresh K rotates by the query positions, pads included: by M-RoPE
    over ``pos3`` [3,B,T] when it is given and ``cfg.mm`` has sections,
    else by RoPE over ``q_pos``. Cached keys were roped when inserted;
    ``kv_pos`` only masks them. ``kv_override(k, v)`` (the decode path)
    returns the keys and values to attend instead: the cache with the
    fresh ones written in.

    With ``bits`` given and ``cfg.cp_mesh`` set, attention is context
    parallel (``core.context_parallel.cp_attention`` over the process
    group ``cfg.cp_mesh``, method ``cfg.cp_method``, per-chunk math
    ``cfg.attn_impl``): x is then this rank's slice of a sequence in
    plan layout, with its positions and bits. Else, with ``bits`` and
    ``cfg.attn_impl == "bam_kernel"``, attention runs through the BAM op
    (K1 forward, K2/K3 backward). ``window`` is the static sliding window
    of both and of the causal mask built when neither ``mask`` nor
    ``mask_fn`` is given. Otherwise the plain masked ``sdpa``, over
    blocks of ``cfg.attn_q_chunk`` queries when ``mask_fn(start, size)``
    is given and the chunk divides and is shorter than T, else with
    ``mask`` or ``mask_fn(0, T)``, broadcastable to [B,1,T,Tk]."""
    if cfg.attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl={cfg.attn_impl!r}; the port has "
                         f"{ATTN_IMPLS} (bam_interpret is JAX-only)")
    b, tq, _ = x.shape
    q, k, v = attn_project_qkv(p, cfg, x, x if x_kv is None else x_kv)
    if rope:
        if pos3 is not None and cfg.mm is not None and cfg.mm.mrope_sections:
            q = apply_mrope(q, pos3, cfg.mm.mrope_sections, cfg.rope_theta)
            k = apply_mrope(k, pos3, cfg.mm.mrope_sections, cfg.rope_theta)
        else:
            q = apply_rope(q, q_pos, cfg.rope_theta)
            k = apply_rope(k, q_pos, cfg.rope_theta)
    if kv_override is not None:
        k, v = kv_override(k, v)
    elif cfg.cp_mesh is not None and bits is not None:
        out = cp_attention(
            cfg.cp_mesh, q, k, v, bits, bits, q_pos, q_pos,
            method=cfg.cp_method, softcap=cfg.attn_softcap, window=window,
            impl=cfg.attn_impl)
        return out.reshape(b, tq, cfg.q_dim) @ p.wo, (k, v)
    elif cfg.attn_impl == "bam_kernel" and bits is not None:
        out = ops.bam_attention(
            q, k, v, bits, bits, q_pos, q_pos, softcap=cfg.attn_softcap,
            window=window, impl="bam_kernel")
        return out.reshape(b, tq, cfg.q_dim) @ p.wo, (k, v)
    # n_rep from the actual tensor: a decode cache may hold replicated KV
    # heads (cfg.decode_kv_replicate)
    n_rep = cfg.num_heads // k.shape[2]
    kf, vf = repeat_kv(k, n_rep), repeat_kv(v, n_rep)
    chunk = cfg.attn_q_chunk
    if mask_fn is not None and chunk and tq % chunk == 0 and tq > chunk:
        out = sdpa_q_chunked(q, kf, vf, mask_fn, chunk,
                             softcap=cfg.attn_softcap)
    else:
        if mask is None and mask_fn is not None:
            mask = mask_fn(0, tq)
        if mask is None:
            mask = causal_mask(q_pos, q_pos if kv_pos is None else kv_pos,
                               window)
        out = sdpa(q, kf, vf, mask, softcap=cfg.attn_softcap)
    return out.reshape(b, tq, cfg.q_dim) @ p.wo, (k, v)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    def __init__(self, d: int, d_ff: int, dtype, device, generator,
                 gated: bool):
        super().__init__()
        self.w_up = normal_param((d, d_ff), dtype, device, generator)
        self.w_down = normal_param((d_ff, d), dtype, device, generator)
        self.w_gate = normal_param((d, d_ff), dtype, device, generator) \
            if gated else None


def _act(x, act: str):
    return F.silu(x) if act == "silu" else F.gelu(x, approximate="tanh")


def run_mlp(p: MLP, x, act: str):
    up = x @ p.w_up
    if p.w_gate is not None:
        h = _act(x @ p.w_gate, act) * up
    else:
        h = _act(up, act)
    return h @ p.w_down


# ---------------------------------------------------------------------------
# KV strip cache (one [B, Tmax] strip per layer)
# ---------------------------------------------------------------------------

def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, dtype, device,
                  num_layers: Optional[int] = None):
    """{k, v: zeros [L, B, Tmax, Hkv, hd]} on ``device``."""
    L = cfg.num_layers if num_layers is None else num_layers
    shape = (L, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def cache_update(cache_k, cache_v, k_new, v_new, index: int):
    """Write [B, Tnew, Hkv, hd] at position ``index`` of one layer's
    [B, Tmax, Hkv, hd] strips, in place; returns them."""
    t = k_new.shape[1]
    cache_k[:, index:index + t] = k_new.to(cache_k.dtype)
    cache_v[:, index:index + t] = v_new.to(cache_v.dtype)
    return cache_k, cache_v


def cache_update_ragged(cache_k, cache_v, k_new, v_new, index):
    """Per-row insert for continuous batching: ``index`` is [B] (each
    request sits at its own ragged cache offset), ``k_new``/``v_new``
    are one-token [B, 1, Hkv, hd]. In place; returns the strips."""
    rows = torch.arange(cache_k.shape[0], device=cache_k.device)
    index = index.long()
    cache_k[rows, index] = k_new[:, 0].to(cache_k.dtype)
    cache_v[rows, index] = v_new[:, 0].to(cache_v.dtype)
    return cache_k, cache_v

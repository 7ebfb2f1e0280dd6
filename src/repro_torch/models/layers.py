"""Shared layer library (port of ``repro.models.layers``).

Parameters live in small ``nn.Module``s whose attribute names are the
JAX parameter tree's keys (``wq``, ``w_up``, ``w``, ...), in the JAX
layout: ``x @ W`` with W [d_in, d_out], so the weight bridge is a copy.
The apply functions take those modules and plain tensors.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.bam import repeat_kv
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
# RoPE (split-half form)
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


def run_attention(p: Attention, cfg: ModelConfig, x, *, q_pos, mask_fn,
                  window: int = 0, bits=None, rope: bool = True):
    """Self-attention block over x [B,T,d]. Returns (out [B,T,d], (k, v))
    with k/v the projected (and, with ``rope``, roped) [B,T,Hkv,hd] the
    serving prefill keeps.

    With ``bits`` given and ``cfg.attn_impl == "bam_kernel"``, attention
    runs through the BAM op (K1 forward, K2/K3 backward) with ``window``
    as the static sliding window; otherwise the plain masked ``sdpa``
    with ``mask_fn()``'s mask, broadcastable to [B,1,T,T] (built only on
    that path; the encoders pass an all-true one). Fresh K rotates by
    the query positions, pads included."""
    if cfg.attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl={cfg.attn_impl!r}; the port has "
                         f"{ATTN_IMPLS} (bam_interpret is JAX-only)")
    if cfg.cp_mesh is not None:
        raise NotImplementedError(
            "context parallelism (cp_mesh) is a later slice of the port "
            "(ROADMAP.md queue 1, slice B)")
    if cfg.mm is not None and cfg.mm.mrope_sections:
        raise NotImplementedError("M-RoPE is not ported yet (ROADMAP.md)")
    if cfg.attn_q_chunk:
        raise NotImplementedError(
            "attn_q_chunk (q-chunked plain attention) is not ported yet")
    b, tq, _ = x.shape
    q, k, v = attn_project_qkv(p, cfg, x, x)
    if rope:
        q = apply_rope(q, q_pos, cfg.rope_theta)
        k = apply_rope(k, q_pos, cfg.rope_theta)
    if cfg.attn_impl == "bam_kernel" and bits is not None:
        out = ops.bam_attention(
            q, k, v, bits, bits, q_pos, q_pos, softcap=cfg.attn_softcap,
            window=window, impl="bam_kernel")
    else:
        n_rep = cfg.num_heads // k.shape[2]
        out = sdpa(q, repeat_kv(k, n_rep), repeat_kv(v, n_rep), mask_fn(),
                   softcap=cfg.attn_softcap)
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

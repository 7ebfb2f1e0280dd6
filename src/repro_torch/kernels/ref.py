"""Dense oracle for BAM attention (port of ``repro.kernels.ref``).

Independent of the kernels: it materialises the full boolean mask with
``core.bam.allowed_mask`` and runs a numerically stable masked softmax.
``masked_attention`` is that softmax with the kernels' conventions; the
plain versions of K1 and K4 are built on it. ``masked_stats`` stops
before the normalisation, for K1's stats mode and context parallelism.
"""
from __future__ import annotations

import torch

from repro_torch.core import bam

NEG_INF = -1e30     # the kernels' masked-score sentinel and empty-row lse


def masked_attention(q, k, v, q_bits, kv_bits, q_pos, kv_pos, *,
                     softcap: float = 0.0, window: int = 0, p_dtype=None,
                     tiles=None):
    """q: [B,Tq,H,hd]; k/v: [B,Tk,Hkv,hd] (H % Hkv == 0); bits int32
    [B,T*]; pos int32 [B,T*]. Scores and softmax in f32; the normalised
    probabilities are rounded to ``p_dtype`` (if given) before the
    product with V. ``tiles`` (bool [Tq, Tk], a block map's
    ``core.bam.tile_mask``) further restricts the mask. Returns (out
    [B,Tq,H,hd] in q's dtype, lse [B,H,Tq] f32); rows with no allowed
    key give out = 0 and lse = -1e30."""
    hd = q.shape[-1]
    n_rep = q.shape[2] // k.shape[2]
    k = bam.repeat_kv(k, n_rep)
    v = bam.repeat_kv(v, n_rep)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    logits = logits * (hd ** -0.5)
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    mask = bam.allowed_mask(q_bits, kv_bits, q_pos, kv_pos, window)
    if tiles is not None:
        mask = mask & tiles
    mask = mask[:, None]
    logits = logits.masked_fill(~mask, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m).masked_fill(~mask, 0.0)
    denom = p.sum(dim=-1, keepdim=True)
    p = torch.where(denom > 0, p / denom.clamp_min(1e-30),
                    torch.zeros_like(p))
    if p_dtype is not None:
        p = p.to(p_dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", p.float(), v.float())
    lse = torch.where(denom > 0, m + torch.log(denom.clamp_min(1e-30)),
                      torch.full_like(denom, NEG_INF))
    return out.to(q.dtype), lse[..., 0]


def masked_stats(q, k, v, mask, *, softcap: float = 0.0, p_dtype=None):
    """Unnormalised softmax partials (acc [B,H,Tq,hd] f32 = Σ exp(s - m)·V,
    m [B,H,Tq], l [B,H,Tq]) over ``mask`` (broadcastable to [B,H,Tq,Tk]),
    scores in f32; p is rounded to ``p_dtype`` (if given) before the
    product with V. A row with no allowed key gives exactly m = -1e30,
    l = 0, acc = 0: p is selected, never multiplied by the mask."""
    n_rep = q.shape[2] // k.shape[2]
    kf = bam.repeat_kv(k, n_rep).float()
    vf = bam.repeat_kv(v, n_rep).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * q.shape[-1] ** -0.5
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)
    p = torch.where(mask, torch.exp(s - m[..., None]), torch.zeros_like(s))
    l = p.sum(dim=-1)
    if p_dtype is not None:
        p = p.to(p_dtype).float()
    return torch.einsum("bhqk,bkhd->bhqd", p, vf), m, l


def bam_attention_ref(q, k, v, q_bits, kv_bits, q_pos, kv_pos, *,
                      softcap: float = 0.0, window: int = 0, tiles=None):
    """The JAX oracle's output: as ``masked_attention``, with the
    probabilities rounded to V's dtype (as ``repro.kernels.ref`` does).
    Returns [B,Tq,H,hd] in q's dtype; rows with no allowed key are 0."""
    return masked_attention(q, k, v, q_bits, kv_bits, q_pos, kv_pos,
                            softcap=softcap, window=window,
                            p_dtype=v.dtype, tiles=tiles)[0]

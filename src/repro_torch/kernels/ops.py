"""Public BAM attention op (the counterpart of ``repro.kernels.ops``).

Dispatch on ``impl``:
  "xla"        — the dense PyTorch oracle (``kernels.ref``); plain
                 autograd gives its gradient;
  "bam_kernel" — a ``torch.autograd.Function``: K1 in residual mode
                 forward, saving (q, k, v, bits, pos, out, lse); the
                 backward (``bam_attention_chunk_bwd``) runs K2 (dQ) and
                 K3 (dK/dV). CUDA kernels on a CUDA tensor, their plain
                 versions on a CPU tensor.

The kernels take any Tq, Tk and mask their own ragged edge, so unlike
the JAX op nothing is padded to block multiples and there is no block
size to choose.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.bam_attention import (bam_flash_attention,
                                               bam_flash_attention_bwd)
from repro_torch.kernels.ref import bam_attention_ref

IMPLS = ("xla", "bam_kernel")


def _default_pos(B, T, device):
    return torch.arange(T, dtype=torch.int32,
                        device=device)[None].expand(B, T).contiguous()


def bam_attention_chunk_bwd(q, k, v, out, g, lse, q_bits, kv_bits, q_pos,
                            kv_pos, *, softcap: float = 0.0,
                            window: int = 0):
    """Flash backward from (out, lse) residuals: (dq, dk, dv) with dk/dv
    folded over GQA to [B,Tk,Hkv,hd]. As in the JAX package, (out, lse)
    may be a cross-chunk combined output and log-sum-exp; the result is
    then this chunk's exact share of the global-softmax gradients."""
    return bam_flash_attention_bwd(
        q, k, v, out, g.contiguous(), lse, q_bits, kv_bits, q_pos, kv_pos,
        softcap=softcap, window=window)


class BamAttention(torch.autograd.Function):
    """K1 forward in residual mode; K2 and K3 backward. Saves no tensor
    of Tq·Tk elements."""

    @staticmethod
    def forward(ctx, q, k, v, q_bits, kv_bits, q_pos, kv_pos, softcap,
                window):
        out, lse = bam_flash_attention(
            q, k, v, q_bits, kv_bits, q_pos, kv_pos, softcap=softcap,
            window=window, return_mode="residual")
        ctx.save_for_backward(q, k, v, q_bits, kv_bits, q_pos, kv_pos, out,
                              lse)
        ctx.softcap, ctx.window = softcap, window
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, q_bits, kv_bits, q_pos, kv_pos, out, lse = ctx.saved_tensors
        dq, dk, dv = bam_attention_chunk_bwd(
            q, k, v, out, g, lse, q_bits, kv_bits, q_pos, kv_pos,
            softcap=ctx.softcap, window=ctx.window)
        return dq, dk, dv, None, None, None, None, None, None


def bam_attention(q, k, v, q_bits, kv_bits, q_pos=None, kv_pos=None, *,
                  softcap: float = 0.0, window: int = 0,
                  impl: str = "xla"):
    """q: [B,Tq,H,hd]; k/v: [B,Tk,Hkv,hd]; bits int32 [B,T*]; positions
    default to iota. Returns [B,Tq,H,hd], differentiable in q, k, v."""
    if impl not in IMPLS:
        raise ValueError(f"impl={impl!r}; the port has {IMPLS} "
                         f"(bam_interpret is a JAX-only mode)")
    B, Tq = q.shape[:2]
    Tk = k.shape[1]
    if q_pos is None:
        q_pos = _default_pos(B, Tq, q.device)
    if kv_pos is None:
        kv_pos = _default_pos(B, Tk, q.device)
    if impl == "xla":
        return bam_attention_ref(q, k, v, q_bits, kv_bits, q_pos, kv_pos,
                                 softcap=softcap, window=window)
    return BamAttention.apply(
        q.contiguous(), k.contiguous(), v.contiguous(), q_bits.contiguous(),
        kv_bits.contiguous(), q_pos.contiguous(), kv_pos.contiguous(),
        float(softcap), int(window))

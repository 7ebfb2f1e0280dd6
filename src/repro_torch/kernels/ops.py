"""Public BAM attention op (forward only; port of ``repro.kernels.ops``).

Dispatch on ``impl``:
  "xla"        — the dense PyTorch oracle (``kernels.ref``);
  "bam_kernel" — K1 (``kernels.bam_attention``), CUDA on a CUDA tensor,
                 its plain version on a CPU tensor.

K1 takes any Tq, Tk and masks its own ragged edge, so unlike the JAX op
nothing is padded to block multiples and there is no block size to
choose. Serving needs no gradient: the backward kernels (K2, K3) and
the ``autograd.Function`` come with the train-step slice, so asking for
a gradient through this op raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.bam_attention import bam_flash_attention
from repro_torch.kernels.ref import bam_attention_ref

IMPLS = ("xla", "bam_kernel")


def _default_pos(B, T, device):
    return torch.arange(T, dtype=torch.int32,
                        device=device)[None].expand(B, T).contiguous()


def bam_attention(q, k, v, q_bits, kv_bits, q_pos=None, kv_pos=None, *,
                  softcap: float = 0.0, window: int = 0,
                  impl: str = "xla"):
    """q: [B,Tq,H,hd]; k/v: [B,Tk,Hkv,hd]; bits int32 [B,T*]; positions
    default to iota. Returns [B,Tq,H,hd]."""
    if impl not in IMPLS:
        raise ValueError(f"impl={impl!r}; the port has {IMPLS} "
                         f"(bam_interpret is a JAX-only mode)")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "bam_attention has no backward in the port yet: K2/K3 and the "
            "autograd.Function come with the train-step slice (ROADMAP.md)")
    B, Tq = q.shape[:2]
    Tk = k.shape[1]
    if q_pos is None:
        q_pos = _default_pos(B, Tq, q.device)
    if kv_pos is None:
        kv_pos = _default_pos(B, Tk, q.device)
    if impl == "xla":
        return bam_attention_ref(q, k, v, q_bits, kv_bits, q_pos, kv_pos,
                                 softcap=softcap, window=window)
    out, _lse = bam_flash_attention(
        q.contiguous(), k.contiguous(), v.contiguous(),
        q_bits.contiguous(), kv_bits.contiguous(), q_pos.contiguous(),
        kv_pos.contiguous(), softcap=softcap, window=window,
        return_mode="residual")
    return out

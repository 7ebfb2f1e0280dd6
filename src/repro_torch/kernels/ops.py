"""Public BAM attention op (the counterpart of ``repro.kernels.ops``).

Dispatch on ``impl``:
  "xla"        — the dense PyTorch oracle (``kernels.ref``); plain
                 autograd gives its gradient;
  "bam_kernel" — a ``torch.autograd.Function``: K1 in residual mode
                 forward, saving (q, k, v, bits, pos, out, lse); the
                 backward (``bam_attention_chunk_bwd``) runs K2 (dQ) and
                 K3 (dK/dV). CUDA kernels on a CUDA tensor, their plain
                 versions on a CPU tensor.

``bam_attention_stats`` gives K1's unnormalised stats-mode partials for
context parallelism (``core.context_parallel``), which combines them
across chunks of keys and owns their gradient.

Each entry point takes ``block_map=`` (a ``core.bam.BlockMask`` built at
the kernels' tile, ``build_block_map(..., BLOCK_Q, BLOCK_K, window)``):
the kernels then run on the compacted grid, and ``BamAttention`` carries
the map to its backward, so K2 and K3 run compacted too. Pairs outside
the map's tiles count as masked on every path, ``impl="xla"`` included.

The kernels take any Tq, Tk and mask their own ragged edge, so unlike
the JAX op nothing is padded to block multiples and there is no block
size to choose.
"""
from __future__ import annotations

import torch

from repro_torch.core import bam
from repro_torch.kernels.bam_attention import (bam_flash_attention,
                                               bam_flash_attention_bwd,
                                               check_block_map)
from repro_torch.kernels.ref import bam_attention_ref

IMPLS = ("xla", "bam_kernel")


def _default_pos(B, T, device):
    return torch.arange(T, dtype=torch.int32,
                        device=device)[None].expand(B, T).contiguous()


def bam_attention_chunk_bwd(q, k, v, out, g, lse, q_bits, kv_bits, q_pos,
                            kv_pos, *, softcap: float = 0.0,
                            window: int = 0, block_map=None):
    """Flash backward from (out, lse) residuals: (dq, dk, dv) with dk/dv
    folded over GQA to [B,Tk,Hkv,hd]. As in the JAX package, (out, lse)
    may be a cross-chunk combined output and log-sum-exp; the result is
    then this chunk's exact share of the global-softmax gradients."""
    return bam_flash_attention_bwd(
        q, k, v, out, g.contiguous(), lse, q_bits, kv_bits, q_pos, kv_pos,
        softcap=softcap, window=window, block_map=block_map)


class BamAttention(torch.autograd.Function):
    """K1 forward in residual mode; K2 and K3 backward, on the block
    map's compacted grid when the forward had one. Saves no tensor of
    Tq·Tk elements."""

    @staticmethod
    def forward(ctx, q, k, v, q_bits, kv_bits, q_pos, kv_pos, softcap,
                window, block_map):
        out, lse = bam_flash_attention(
            q, k, v, q_bits, kv_bits, q_pos, kv_pos, softcap=softcap,
            window=window, return_mode="residual", block_map=block_map)
        ctx.save_for_backward(q, k, v, q_bits, kv_bits, q_pos, kv_pos, out,
                              lse)
        ctx.softcap, ctx.window, ctx.block_map = softcap, window, block_map
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, q_bits, kv_bits, q_pos, kv_pos, out, lse = ctx.saved_tensors
        dq, dk, dv = bam_attention_chunk_bwd(
            q, k, v, out, g, lse, q_bits, kv_bits, q_pos, kv_pos,
            softcap=ctx.softcap, window=ctx.window, block_map=ctx.block_map)
        return dq, dk, dv, None, None, None, None, None, None, None


@torch.no_grad()
def bam_attention_stats(q, k, v, q_bits, kv_bits, q_pos=None, kv_pos=None,
                        *, softcap: float = 0.0, window: int = 0,
                        impl: str = "bam_kernel", block_map=None):
    """Unnormalised flash-attention partials for cross-chunk combination:
    (acc [B,H,Tq,hd] f32 = Σ p·V, m [B,H,Tq], l [B,H,Tq]) from K1's stats
    mode, the mask evaluated inside the kernel (no [B,H,Tq,Tk] tensor on
    the card). A forward building block with no gradient of its own, as
    in the JAX package: differentiate through
    ``core.context_parallel.cp_attention``."""
    if impl != "bam_kernel":
        raise ValueError(f"impl={impl!r}; the stats op has only "
                         f"'bam_kernel' in the port")
    B, Tq = q.shape[:2]
    Tk = k.shape[1]
    if q_pos is None:
        q_pos = _default_pos(B, Tq, q.device)
    if kv_pos is None:
        kv_pos = _default_pos(B, Tk, q.device)
    return bam_flash_attention(
        q.contiguous(), k.contiguous(), v.contiguous(), q_bits.contiguous(),
        kv_bits.contiguous(), q_pos.contiguous(), kv_pos.contiguous(),
        softcap=softcap, window=window, return_mode="stats",
        block_map=block_map)


def bam_attention(q, k, v, q_bits, kv_bits, q_pos=None, kv_pos=None, *,
                  softcap: float = 0.0, window: int = 0,
                  impl: str = "xla", block_map=None):
    """q: [B,Tq,H,hd]; k/v: [B,Tk,Hkv,hd]; bits int32 [B,T*]; positions
    default to iota. Returns [B,Tq,H,hd], differentiable in q, k, v.
    ``block_map``: an optional host-precomputed ``core.bam.BlockMask``
    (grid compaction: active tiles only)."""
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
        tiles = None
        if block_map is not None:
            check_block_map(block_map, Tq, Tk, window)
            tiles = bam.tile_mask(block_map, Tq, Tk, q.device)
        return bam_attention_ref(q, k, v, q_bits, kv_bits, q_pos, kv_pos,
                                 softcap=softcap, window=window, tiles=tiles)
    return BamAttention.apply(
        q.contiguous(), k.contiguous(), v.contiguous(), q_bits.contiguous(),
        kv_bits.contiguous(), q_pos.contiguous(), kv_pos.contiguous(),
        float(softcap), int(window), block_map)

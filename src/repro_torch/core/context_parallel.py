"""Multimodality-aware context parallelism (Cornstarch §4.3, §5.3): the
port's counterpart of ``repro.core.context_parallel``.

A distribution plan (``core.distribution``) assigns token blocks to CP
ranks; ``plan_permutation`` lays the sequence out so that each rank's
tokens are one contiguous run, and positions and bitfields travel with
their tokens, so RoPE and the BAM mask stay exact. Two attention bodies:

* ``allgather`` (paper §5.3, the default): every rank gathers K/V and
  their bits and positions, and computes the rows of its own queries
  only; the per-rank work is the row workload the LPT plan balances.
  Its backward gathers again and reduce-scatters dK/dV to their owners.
* ``ring``: K/V chunks pass around the ring, each rank combining the
  unnormalised online-softmax statistics of every chunk; the backward
  is the reverse ring, each chunk's f32 dK/dV travelling with it.

Unlike the JAX package, where ``shard_map`` splits global arrays, ranks
are processes: ``cp_attention`` takes this rank's slice and the bodies,
``torch.autograd.Function``s, call ``torch.distributed`` themselves
(``all_gather_into_tensor``, ``reduce_scatter_tensor``,
``batch_isend_irecv``) on the ``ProcessGroup`` they are given.
``cp_reference`` is the collective-free oracle on global tensors.

Per-chunk math (``impl``): ``"xla"`` is the dense PyTorch body, which
builds the [B,H,Tq,Tk] logits; ``"bam_kernel"`` runs K1 in stats mode
forward and K2/K3 backward (``kernels.ops``), which evaluate the mask
inside the kernel. Either way each Function saves only O(Tq·H·hd)
tensors: the local inputs and the combined (out, lse).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import bam
from repro_torch.core.distribution import Plan
from repro_torch.kernels import ops
from repro_torch.kernels.bam_attention import bam_flash_attention_bwd_torch
from repro_torch.kernels.ref import NEG_INF, masked_stats

IMPLS = ("xla", "bam_kernel")


# ---------------------------------------------------------------------------
# Plan application (host side)
# ---------------------------------------------------------------------------

def plan_permutation(plan: Plan, seq_len: int) -> np.ndarray:
    """perm[i] = source index of the i-th token in CP layout, a true
    permutation of ``arange(seq_len)``. Plans balance workloads, so the
    ranks' token counts may differ; they are evened out to differ by at
    most one (ranks ``0..seq_len % G - 1`` get the extra token) by moving
    the trailing tokens of over-full ranks to under-full ones, in rank
    order. Raises ``ValueError`` if the plan's blocks do not cover
    ``seq_len`` tokens."""
    slices = [s[s < seq_len] for s in plan.rank_token_slices()]
    total = sum(len(s) for s in slices)
    if total != seq_len:
        raise ValueError(
            f"plan covers {total} tokens "
            f"({len(plan.assignment)} blocks x {plan.block_size}) "
            f"but seq_len={seq_len}")
    if len({len(s) for s in slices}) != 1:
        base, rem = divmod(seq_len, plan.num_ranks)
        targets = [base + (1 if g < rem else 0)
                   for g in range(plan.num_ranks)]
        extra: list = []
        for g, s in enumerate(slices):
            if len(s) > targets[g]:
                extra.extend(s[targets[g]:])
                slices[g] = s[:targets[g]]
        for g, s in enumerate(slices):
            need = targets[g] - len(s)
            if need > 0:
                slices[g] = np.concatenate(
                    [s, np.asarray(extra[:need], dtype=np.int64)])
                extra = extra[need:]
        # targets sum to seq_len, so excess and deficit match exactly
        if extra:
            raise RuntimeError("rebalance left unassigned tokens")
    return np.concatenate(slices).astype(np.int64)


def apply_plan(tensors, perm: np.ndarray, axis: int = 1):
    """Gather ``axis`` (the token axis) of every tensor of a tensor, a
    dict or a list/tuple of tensors by perm."""
    if isinstance(tensors, dict):
        return {k: apply_plan(t, perm, axis) for k, t in tensors.items()}
    if isinstance(tensors, (list, tuple)):
        return type(tensors)(apply_plan(t, perm, axis) for t in tensors)
    return torch.index_select(
        tensors, axis, torch.as_tensor(perm, device=tensors.device))


def invert_perm(perm: np.ndarray) -> np.ndarray:
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    return inv


# ---------------------------------------------------------------------------
# Per-chunk attention statistics and their combination
# ---------------------------------------------------------------------------

def _masked_attn_stats(q, k, v, mask, softcap: float = 0.0):
    """(acc [B,H,Tq,hd] f32 = Σ exp(s - m)·V, m [B,H,Tq], l [B,H,Tq]) on
    the dense [B,H,Tq,Tk] logits, scale hd**-0.5; p is rounded to V's
    dtype before the product, as in the JAX body."""
    return masked_stats(q, k, v, mask, softcap=softcap, p_dtype=v.dtype)


def _attn_stats(q, k, v, q_bits, kv_bits, q_pos, kv_pos, softcap: float,
                window: int, impl: str):
    """One chunk's stats: the dense body for ``"xla"``, K1's stats mode
    for ``"bam_kernel"`` (its plain version on a CPU tensor)."""
    if impl == "xla":
        mask = bam.allowed_mask(q_bits, kv_bits, q_pos, kv_pos,
                                window)[:, None]
        return _masked_attn_stats(q, k, v, mask, softcap)
    return ops.bam_attention_stats(q, k, v, q_bits, kv_bits, q_pos, kv_pos,
                                   softcap=softcap, window=window,
                                   impl=impl)


def _combine_stats(acc1, m1, l1, acc2, m2, l2):
    m = torch.maximum(m1, m2)
    a1 = torch.exp(m1 - m)
    a2 = torch.exp(m2 - m)
    return acc1 * a1[..., None] + acc2 * a2[..., None], m, l1 * a1 + l2 * a2


def _finish(acc, m, l, dtype):
    """Normalised output [B,Tq,H,hd] in ``dtype``; rows with l = 0 are 0."""
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = torch.where((l > 0)[..., None], out, torch.zeros_like(out))
    return out.permute(0, 2, 1, 3).to(dtype).contiguous()


def _lse_from_stats(m, l):
    """Combined (m, l) -> per-row log-sum-exp [B,H,Tq], -1e30 on rows
    with no allowed key (the kernels' own convention)."""
    return torch.where(l > 0, m + torch.log(torch.clamp(l, min=1e-30)),
                       torch.full_like(m, NEG_INF))


# ---------------------------------------------------------------------------
# Per-chunk flash backward from the combined residuals
# ---------------------------------------------------------------------------

def _dense_chunk_bwd(q, k, v, out, g, lse, q_bits, kv_bits, q_pos, kv_pos,
                     softcap: float, window: int):
    """Dense body of one chunk's backward, dS = P·(dP − Δ) with P from the
    combined lse, on [B,H,Tq,Tk] tensors: the plain versions of K2 and K3
    (``bam_flash_attention_bwd_torch``). Returns (dq_contrib, dk, dv),
    dk/dv folded over GQA to the K/V head count."""
    return bam_flash_attention_bwd_torch(
        q, k, v, out, g, lse, q_bits, kv_bits, q_pos, kv_pos,
        softcap=softcap, window=window)


def _chunk_bwd(q, k, v, out, g, lse, q_bits, kv_bits, q_pos, kv_pos,
               softcap: float, window: int, impl: str):
    """One K/V chunk's backward against the combined (out, lse):
    (dq_contrib, dk, dv). dq contributions sum over chunks; dk/dv are
    complete for the chunk. ``"bam_kernel"`` runs K2 and K3."""
    if impl == "xla":
        return _dense_chunk_bwd(q, k, v, out, g, lse, q_bits, kv_bits,
                                q_pos, kv_pos, softcap, window)
    return ops.bam_attention_chunk_bwd(
        q, k, v, out, g, lse, q_bits, kv_bits, q_pos, kv_pos,
        softcap=softcap, window=window)


# ---------------------------------------------------------------------------
# Collectives along the token axis (dim 1); torch.distributed works on dim 0
# ---------------------------------------------------------------------------

def _gather_tokens(group, x):
    """[B, Tl, ...] on each rank -> [B, G·Tl, ...], ranks in order."""
    G = dist.get_world_size(group)
    x = x.contiguous()
    buf = x.new_empty((G * x.shape[0],) + x.shape[1:])
    dist.all_gather_into_tensor(buf, x, group=group)
    out = buf.reshape((G,) + x.shape).movedim(0, 1)
    return out.reshape((x.shape[0], G * x.shape[1]) + x.shape[2:]).contiguous()


def _scatter_tokens(group, x):
    """[B, G·Tl, ...] on each rank -> this rank's [B, Tl, ...] of the sum
    over ranks (reduce-scatter from a rank-major copy)."""
    G = dist.get_world_size(group)
    B, T = x.shape[:2]
    rest = x.shape[2:]
    src = x.reshape((B, G, T // G) + rest).movedim(1, 0).contiguous()
    out = x.new_empty((B, T // G) + rest)
    dist.reduce_scatter_tensor(out, src.reshape((G * B, T // G) + rest),
                               group=group)
    return out


def _ring_shift(group, tensors: Sequence[torch.Tensor], reverse: bool = False):
    """Send each tensor to the next rank (the previous with ``reverse``)
    and return those received from the other side. Every rank posts the
    same ops in the same order, sends before receives, in one
    ``batch_isend_irecv``. Only for G > 1: a rank never sends to itself."""
    G = dist.get_world_size(group)
    r = dist.get_rank(group)
    step = -1 if reverse else 1
    dst = dist.get_global_rank(group, (r + step) % G)
    src = dist.get_global_rank(group, (r - step) % G)
    sends = [t.contiguous() for t in tensors]
    recvs = [torch.empty_like(t) for t in sends]
    p2p = ([dist.P2POp(dist.isend, t, dst, group, tag=i)
            for i, t in enumerate(sends)]
           + [dist.P2POp(dist.irecv, t, src, group, tag=i)
              for i, t in enumerate(recvs)])
    for req in dist.batch_isend_irecv(p2p):
        req.wait()
    return recvs


# ---------------------------------------------------------------------------
# The CP bodies: autograd Functions whose residuals are the local inputs
# and the (out, lse) of the cross-chunk combined (m, l)
# ---------------------------------------------------------------------------

class AllGatherAttention(torch.autograd.Function):
    """Local queries against the gathered K/V; backward gathers again
    and reduce-scatters dK/dV to their owner ranks."""

    @staticmethod
    def forward(ctx, q, k, v, q_bits, kv_bits, q_pos, kv_pos, group,
                softcap, window, impl):
        k_all, v_all, kb_all, kp_all = (_gather_tokens(group, t)
                                        for t in (k, v, kv_bits, kv_pos))
        acc, m, l = _attn_stats(q, k_all, v_all, q_bits, kb_all, q_pos,
                                kp_all, softcap, window, impl)
        out = _finish(acc, m, l, q.dtype)
        ctx.save_for_backward(q, k, v, q_bits, kv_bits, q_pos, kv_pos, out,
                              _lse_from_stats(m, l))
        ctx.group, ctx.softcap, ctx.window, ctx.impl = (group, softcap,
                                                        window, impl)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, q_bits, kv_bits, q_pos, kv_pos, out, lse = ctx.saved_tensors
        group = ctx.group
        k_all, v_all, kb_all, kp_all = (_gather_tokens(group, t)
                                        for t in (k, v, kv_bits, kv_pos))
        dq, dk_all, dv_all = _chunk_bwd(
            q, k_all, v_all, out, g, lse, q_bits, kb_all, q_pos, kp_all,
            ctx.softcap, ctx.window, ctx.impl)
        # every rank has gradients for all keys: sum them onto the owners
        return (dq, _scatter_tokens(group, dk_all),
                _scatter_tokens(group, dv_all)) + (None,) * 8


class RingAttention(torch.autograd.Function):
    """G steps of stats on the chunk at hand, combined online; backward
    is the reverse ring with each chunk's f32 dK/dV travelling with it,
    so chunk and gradients are home after G steps."""

    @staticmethod
    def forward(ctx, q, k, v, q_bits, kv_bits, q_pos, kv_pos, group,
                softcap, window, impl):
        G = dist.get_world_size(group)
        chunk = (k, v, kv_bits, kv_pos)
        acc, m, l = _attn_stats(q, k, v, q_bits, kv_bits, q_pos, kv_pos,
                                softcap, window, impl)
        for _ in range(G - 1):
            chunk = _ring_shift(group, chunk)
            kc, vc, kb, kp = chunk
            acc, m, l = _combine_stats(
                acc, m, l, *_attn_stats(q, kc, vc, q_bits, kb, q_pos, kp,
                                        softcap, window, impl))
        out = _finish(acc, m, l, q.dtype)
        ctx.save_for_backward(q, k, v, q_bits, kv_bits, q_pos, kv_pos, out,
                              _lse_from_stats(m, l))
        ctx.group, ctx.softcap, ctx.window, ctx.impl = (group, softcap,
                                                        window, impl)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, q_bits, kv_bits, q_pos, kv_pos, out, lse = ctx.saved_tensors
        group = ctx.group
        G = dist.get_world_size(group)
        chunk = [k, v, kv_bits, kv_pos]
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dkc = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dvc = torch.zeros_like(dkc)
        for i in range(G):
            kc, vc, kb, kp = chunk
            dq2, dk2, dv2 = _chunk_bwd(q, kc, vc, out, g, lse, q_bits, kb,
                                       q_pos, kp, ctx.softcap, ctx.window,
                                       ctx.impl)
            dq += dq2.float()
            dkc = dkc + dk2.float()
            dvc = dvc + dv2.float()
            if G == 1:
                break
            # the last shift carries only the gradients home
            moving = chunk + [dkc, dvc] if i < G - 1 else [dkc, dvc]
            moved = _ring_shift(group, moving, reverse=True)
            chunk, (dkc, dvc) = moved[:-2], moved[-2:]
        return (dq.to(q.dtype), dkc.to(k.dtype), dvc.to(v.dtype)) \
            + (None,) * 8


_CP_BODIES = {"allgather": AllGatherAttention, "ring": RingAttention}


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

def cp_attention(group, q, k, v, q_bits, kv_bits, q_pos, kv_pos, *,
                 method: str = "allgather", softcap: float = 0.0,
                 window: int = 0, impl: str = "xla"):
    """Context-parallel BAM attention on this rank's slice of a sequence
    already in plan layout: q [B,Tl,H,hd], k/v [B,Tl,Hkv,hd], bits and
    positions int32 [B,Tl], where rank r of ``group`` (a
    ``torch.distributed.ProcessGroup``) holds tokens [r·Tl, (r+1)·Tl).
    Returns this rank's [B,Tl,H,hd] output. Differentiable in q, k, v on
    either ``impl``; every rank of the group must call it, and its
    backward, together."""
    if method not in _CP_BODIES:
        raise ValueError(f"unknown CP method {method!r}; valid methods: "
                         f"{sorted(_CP_BODIES)}")
    if impl not in IMPLS:
        raise ValueError(f"impl={impl!r}; pick from {IMPLS}")
    if not isinstance(group, dist.ProcessGroup):
        raise TypeError(f"context parallelism needs a torch.distributed "
                        f"ProcessGroup, got {type(group).__name__}")
    if k.shape[1] != q.shape[1]:
        raise ValueError(f"q and k/v slices differ in length: "
                         f"{q.shape[1]} vs {k.shape[1]}")
    return _CP_BODIES[method].apply(
        q, k, v, q_bits.contiguous(), kv_bits.contiguous(),
        q_pos.contiguous(), kv_pos.contiguous(), group, float(softcap),
        int(window), impl)


def cp_reference(q, k, v, q_bits, kv_bits, q_pos, kv_pos, *,
                 softcap: float = 0.0, window: int = 0):
    """Collective-free oracle: the same math on global tensors, and, being
    plain autograd, the gradient oracle of the CP backward."""
    mask = bam.allowed_mask(q_bits, kv_bits, q_pos, kv_pos, window)[:, None]
    acc, m, l = _masked_attn_stats(q, k, v, mask, softcap)
    return _finish(acc, m, l, q.dtype)


def simulate_rank_workloads(plan: Plan, bits: np.ndarray, pos: np.ndarray,
                            window: int = 0) -> np.ndarray:
    """Per-rank attention work (sums of row workloads, in allowed pairs):
    the largest bounds the attention step time under all-gather CP."""
    W = bam.token_workload(bits, pos, window)
    bs = plan.block_size
    nb = len(plan.assignment)
    padded = np.zeros(nb * bs, np.float64)
    n = min(len(W), nb * bs)
    padded[:n] = W[:n]
    loads = np.zeros(plan.num_ranks)
    np.add.at(loads, plan.assignment, padded.reshape(nb, bs).sum(axis=1))
    return loads

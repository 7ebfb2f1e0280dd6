"""The numerical design of K1's bf16 kernel (``csrc/bam_fwd.cu``), held
on the CPU against K1's plain version.

The kernel computes S = Q·K^T on the tensor cores from bf16 Q and K
(exact products, f32 sums), runs the online softmax in f32 per 32-key
tile, and multiplies P by bf16 V on the tensor cores, which take bf16
operands only. P is split as P_hi = bf16(P), P_lo = bf16(P - P_hi) and
both parts are multiplied (f32 accumulate). ``k1_emulated`` repeats that
arithmetic in PyTorch, tile by tile, and is held against
``bam_flash_attention_torch`` (f32 scores, P in f32, as the TPU kernel
computes) in all three modes, before the final bf16 rounding. The rule
is the one the card's run applies, ``chip_smoke.compare`` (|d| <= 2^-7
|plain| + 1e-4, one bf16 ulp of the element) and ``compare_stats`` (acc
and l per row over the plain l), imported from ``chip_smoke.py``: the
split must use at most a quarter of it (its worst |d|/tol <= 0.25, the
final rounding's half ulp then fits), and rounding P once to bf16, as
a plain flash kernel would, must break it (> 1).

Sizes: T 512 causal and vlm-like multimodal (32 text tokens, a
192-token image block, text), and the allgather share of a 4-rank LPT
plan of
``random_multimodal_bits(512, "ee", seed=0)`` (q 128 rows against all
512 keys, stats mode); 4 query and 2 KV heads of 64, 80 (on the layout
padded to 128), 128 and 256; inputs from a numpy seed.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import compare, compare_stats  # noqa: E402
from repro_torch.core import bam  # noqa: E402
from repro_torch.data.synthetic import random_multimodal_bits  # noqa: E402
from repro_torch.kernels.bam_attention import (  # noqa: E402
    BLOCK_K, NEG_INF, bam_flash_attention_torch)
from repro_torch.parallel import plan_context  # noqa: E402

T, H, HKV = 512, 4, 2
SPLIT_MAX, SINGLE_MIN = 0.25, 1.0


def k1_emulated(q, k, v, q_bits, kv_bits, q_pos, kv_pos, *, split: bool,
                return_mode: str):
    """K1's bf16 arithmetic, unrounded: per BLOCK_K-key tile, S in f32
    from bf16 q and k, the running (m, l) and the rescale of the f32
    accumulator, masked pairs selected to p = 0, and P times bf16 V in
    f32 as P_hi·V + P_lo·V (``split``) or bf16(P)·V. hd 80 runs on the
    kernel's layout padded to 128 (zero columns 80-127 of Q, K and V; the
    scale stays 80^-0.5), and the output keeps the first 80 columns.
    Returns f32 (out [B,Tq,H,hd], lse) or (acc [B,H,Tq,hd], m, l)."""
    hd = q.shape[-1]
    scale = hd ** -0.5
    n_rep = q.shape[2] // k.shape[2]
    qf, kf, vf = (padded(x.float()) for x in (
        q, bam.repeat_kv(k, n_rep), bam.repeat_kv(v, n_rep)))
    mask = bam.allowed_mask(q_bits, kv_bits, q_pos, kv_pos)[:, None]
    B, Tq = q.shape[:2]
    m = torch.full((B, H, Tq), NEG_INF)
    l = torch.zeros((B, H, Tq))
    acc = torch.zeros((B, H, Tq, qf.shape[-1]))
    for k0 in range(0, k.shape[1], BLOCK_K):
        ks = slice(k0, k0 + BLOCK_K)
        allowed = mask[..., ks]
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kf[:, ks]) * scale
        s = torch.where(allowed, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(allowed, torch.exp(s - m_new[..., None]),
                        torch.zeros_like(s))
        l = l * alpha + p.sum(-1)
        hi = p.bfloat16().float()
        pv = torch.einsum("bhqk,bkhd->bhqd", hi, vf[:, ks])
        if split:
            lo = (p - hi).bfloat16().float()
            pv = pv + torch.einsum("bhqk,bkhd->bhqd", lo, vf[:, ks])
        acc = acc * alpha[..., None] + pv
        m = m_new
    acc = acc[..., :hd]
    if return_mode == "stats":
        return acc, m, l
    out = torch.where(l[..., None] > 0, acc / l.clamp_min(1e-30)[..., None],
                      torch.zeros_like(acc)).permute(0, 2, 1, 3)
    lse = torch.where(l > 0, m + torch.log(l.clamp_min(1e-30)),
                      torch.full_like(l, NEG_INF))
    return out if return_mode == "out" else (out, lse)


def padded(x):
    """x [..., hd] with hd 80 zero-padded to 128 columns (the kernels'
    shared-memory layout, ``csrc/bam_mma.cuh``); other sizes as they
    are."""
    hd = x.shape[-1]
    return torch.nn.functional.pad(x, (0, 128 - hd)) if hd == 80 else x


def _layout(name: str):
    """(q bits, k bits, q pos, k pos) int32 [1, T*] for a layout."""
    if name == "causal":
        bits, pos = bam.build_sample_bits([("text", 0, T)], T)
        qsel = slice(None)
    elif name == "multimodal":
        bits, pos = bam.build_sample_bits(
            [("text", 0, 32), ("mod", 1, 192), ("text", 0, 288)], T)
        qsel = slice(None)
    else:   # the allgather share of rank 0 in a 4-rank LPT plan
        bits, pos = random_multimodal_bits(T, "ee", seed=0)
        perm = plan_context(bits, pos, 4, block_size=32,
                            method="lpt").apply(T)["perm"]
        bits, pos = bits[perm], pos[perm]
        qsel = slice(0, T // 4)
    b, p = (torch.from_numpy(np.ascontiguousarray(x))[None]
            for x in (bits, pos))
    return b[:, qsel].contiguous(), b, p[:, qsel].contiguous(), p


def _inputs(layout: str, hd: int):
    qb, kb, qp, kp = _layout(layout)
    rng = np.random.default_rng(17 + hd)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).bfloat16() for shape in (
        (1, qb.shape[1], H, hd), (1, T, HKV, hd), (1, T, HKV, hd)))
    return q, k, v, qb, kb, qp, kp


HDS = [64, 128, 80, 256]   # every head size on K1's bf16 wgmma body
CASES = [("causal", "out"), ("causal", "residual"),
         ("multimodal", "out"), ("multimodal", "residual"),
         ("cp", "stats")]


def _worst(layout: str, mode: str, hd: int, split: bool):
    """Worst |d|/tol of the emulation against the plain version (given
    the same bf16 values in f32, so its output is not rounded either),
    and the lse's max |d| (0 where the mode has none)."""
    q, k, v, qb, kb, qp, kp = _inputs(layout, hd)
    got = k1_emulated(q, k, v, qb, kb, qp, kp, split=split,
                      return_mode=mode)
    plain = bam_flash_attention_torch(q.float(), k.float(), v.float(), qb,
                                      kb, qp, kp, return_mode=mode)
    if mode == "stats":
        return compare_stats(got, plain, "bfloat16")[1], 0.0
    if mode == "out":
        return compare(got, plain, "bfloat16")[1], 0.0
    err_lse = float((got[1] - plain[1]).abs().max())
    return compare(got[0], plain[0], "bfloat16")[1], err_lse


@pytest.mark.parametrize("hd", HDS)
@pytest.mark.parametrize("layout,mode", CASES)
def test_split_p_keeps_one_bf16_ulp(layout, mode, hd):
    ratio, err_lse = _worst(layout, mode, hd, split=True)
    assert ratio <= SPLIT_MAX, ratio
    assert err_lse <= 1e-5, err_lse


@pytest.mark.parametrize("hd", HDS)
@pytest.mark.parametrize("layout,mode", CASES)
def test_p_rounded_once_breaks_the_check(layout, mode, hd):
    ratio, _ = _worst(layout, mode, hd, split=False)
    assert ratio > SINGLE_MIN, ratio


def test_empty_rows_stay_exact():
    """A q row with no allowed key in the chunk: stats exactly (-1e30, 0,
    0) through the emulation, as the kernel's select gives."""
    q, k, v, _, kb, _, kp = _inputs("causal", 64)
    qb = torch.zeros((1, T), dtype=torch.int32)      # padding rows
    acc, m, l = k1_emulated(q, k, v, qb, kb, kp, kp, split=True,
                            return_mode="stats")
    assert bool((m == NEG_INF).all() and (l == 0).all() and
                (acc == 0).all())

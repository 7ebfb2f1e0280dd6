"""The numerical design of the bf16 BAM backward kernels, K2 (dQ,
``csrc/bam_bwd_dq.cu``) and K3 (dK/dV, ``csrc/bam_bwd_dkv.cu``), held on
the CPU against their plain versions.

Both kernels recompute S = Q·K^T and dP = dO·V^T on the tensor cores
from bf16 operands (exact products, f32 sums), then P = exp(s·scale -
lse) and dS = P (dP - delta) (times the softcap's chain) in f32 on the
accumulator fragment. The three products after that take P or dS as
their A operand, and the tensor cores take bf16 operands only: dS·K (K2),
P^T·dO and dS^T·Q (K3). Each f32 operand x is either split as hi =
bf16(x), lo = bf16(x - hi), both parts multiplied (f32 accumulate), or
rounded once to bf16. ``k2_emulated`` and ``k3_emulated`` repeat that
arithmetic in PyTorch, tile by tile (32 keys a step for K2, 32 q rows a
step for K3, GQA folded in f32), and are held against
``bam_bwd_dq_torch`` / ``bam_bwd_dkv_torch`` (P and dS in f32, as the
TPU kernel computes) before the final bf16 rounding, with
``chip_smoke.compare``'s rule (|d| <= 2^-7 |plain| + 1e-4, one bf16 ulp
of the element), imported from ``chip_smoke.py``. The design the kernels
use must take at most a quarter of it (worst |d|/tol <= 0.25), and
rounding the operand of each product the kernels split must break it
(> 1).

Worst |d|/tol of each case, over the 8 cases below (4 layouts, hd 64
and 128): the largest when split, the smallest and largest when rounded
once.

| Product | split hi/lo | rounded once |
| --- | --- | --- |
| dS·K (dQ) | 0.028 | 7.8 to 14.3 |
| P^T·dO (dV) | 0.049 | 7.9 to 44.3 |
| dS^T·Q (dK) | 0.039 | 9.9 to 25.6 |

So the kernels split all three: K2 issues 4 products per 32-key tile (S,
dP, dS_hi·K, dS_lo·K), K3 6 per 32-row q tile.

K3 runs its wgmma body also at hd 80 (on the layout padded to 128) and
256 (two warpgroups, each summing every column of its half in one
warpgroup's order), K2 its SIMT body there; over the 4 layouts:

| Product | hd | split hi/lo | rounded once |
| --- | --- | --- | --- |
| P^T·dO (dV) | 80 | 0.070 | 12.6 to 34.2 |
| dS^T·Q (dK) | 80 | 0.039 | 10.1 to 24.1 |
| P^T·dO (dV) | 256 | 0.043 | 9.2 to 29.8 |
| dS^T·Q (dK) | 256 | 0.048 | 12.9 to 36.8 |

Sizes: T 512 causal; vlm-like multimodal (32 text tokens, a 192-token
image block, text); the allgather share of rank 0 in a 4-rank LPT plan of
``random_multimodal_bits(512, "ee", seed=0)`` (q 128 rows against all
512 keys); causal with softcap 30 and window 100. 4 query and 2 KV heads
of 64 and 128 (and 80 and 256 for K3); inputs from a numpy seed.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import compare  # noqa: E402
from repro_torch.core import bam  # noqa: E402
from repro_torch.data.synthetic import random_multimodal_bits  # noqa: E402
from repro_torch.kernels.bam_attention import (  # noqa: E402
    BLOCK_K, bam_bwd_dkv_torch, bam_bwd_dq_torch, bam_flash_attention_torch,
    bwd_delta)
from repro_torch.parallel import plan_context  # noqa: E402

T, H, HKV = 512, 4, 2
BLOCK_Q3 = 32           # K3's q rows per step
SPLIT_MAX, SINGLE_MIN = 0.25, 1.0


def _product(a, b, eq: str, split: bool):
    """a·b on the tensor cores: bf16(a)·b, plus bf16(a - bf16(a))·b when
    split; b holds bf16 values, the sum is f32."""
    hi = a.bfloat16().float()
    out = torch.einsum(eq, hi, b)
    if split:
        out = out + torch.einsum(eq, (a - hi).bfloat16().float(), b)
    return out


def _p_ds(qf, kf, vf, dof, lse, delta, allowed, softcap, scale):
    """P and dS in f32 on one tile, from f32 S and dP of bf16 values;
    masked pairs selected to 0."""
    x = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    chain = 1.0
    if softcap:
        x = torch.tanh(x / softcap) * softcap
        chain = 1.0 - (x / softcap) ** 2
    p = torch.where(allowed, torch.exp(x - lse[..., None]),
                    torch.zeros_like(x))
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    return p, p * (dp - delta[..., None]) * chain


def _expanded(q, k, v, do, qb, kb, qp, kp, window):
    n_rep = q.shape[2] // k.shape[2]
    mask = bam.allowed_mask(qb, kb, qp, kp, window)[:, None]
    return (q.float(), bam.repeat_kv(k, n_rep).float(),
            bam.repeat_kv(v, n_rep).float(), do.float(), mask)


def k2_emulated(q, k, v, do, lse, delta, qb, kb, qp, kp, *, softcap=0.0,
                window=0, split=True):
    """K2's bf16 arithmetic, unrounded: per BLOCK_K-key tile, P and dS in
    f32, dQ += dS·K with dS split or rounded once. f32 [B,Tq,H,hd]."""
    qf, kf, vf, dof, mask = _expanded(q, k, v, do, qb, kb, qp, kp, window)
    B, Tq, _, hd = q.shape
    dq = torch.zeros((B, H, Tq, hd))
    for k0 in range(0, k.shape[1], BLOCK_K):
        ks = slice(k0, k0 + BLOCK_K)
        _, ds = _p_ds(qf, kf[:, ks], vf[:, ks], dof, lse, delta,
                      mask[..., ks], softcap, hd ** -0.5)
        dq += _product(ds, kf[:, ks], "bhqk,bkhd->bhqd", split)
    return (dq * hd ** -0.5).permute(0, 2, 1, 3)


def k3_emulated(q, k, v, do, lse, delta, qb, kb, qp, kp, *, softcap=0.0,
                window=0, split_p=True, split_ds=True):
    """K3's bf16 arithmetic, unrounded: per BLOCK_Q3-row q tile, P and dS
    in f32, dV += P^T·dO and dK += dS^T·Q with each operand split or
    rounded once, then the query heads of each KV head summed in f32.
    hd 80 runs on the kernel's layout padded to 128 (zero columns of Q,
    K, V and dO; the scale stays 80^-0.5; dK and dV keep the first 80
    columns). At 256 the kernel's two warpgroups each compute S^T and
    dP^T whole and own 128 columns of dK and dV: every column's sums run
    in this order. f32 (dK, dV) [B,Tk,Hkv,hd]."""
    qf, kf, vf, dof, mask = _expanded(q, k, v, do, qb, kb, qp, kp, window)
    B, Tq, _, hd = q.shape
    qf, kf, vf, dof = (padded(x) for x in (qf, kf, vf, dof))
    Tk, Hkv, hp = k.shape[1], k.shape[2], qf.shape[-1]
    dk = torch.zeros((B, H, Tk, hp))
    dv = torch.zeros((B, H, Tk, hp))
    for q0 in range(0, Tq, BLOCK_Q3):
        qs = slice(q0, q0 + BLOCK_Q3)
        p, ds = _p_ds(qf[:, qs], kf, vf, dof[:, qs], lse[..., qs],
                      delta[..., qs], mask[:, :, qs], softcap, hd ** -0.5)
        dv += _product(p, dof[:, qs], "bhqk,bqhd->bhkd", split_p)
        dk += _product(ds, qf[:, qs], "bhqk,bqhd->bhkd", split_ds)

    def fold(x):
        x = x[..., :hd]
        return x.reshape(B, Hkv, H // Hkv, Tk, hd).sum(2).permute(0, 2, 1, 3)
    return fold(dk) * hd ** -0.5, fold(dv)


def padded(x):
    """x [..., hd] with hd 80 zero-padded to 128 columns (the kernels'
    shared-memory layout, ``csrc/bam_mma.cuh``); other sizes as they
    are."""
    hd = x.shape[-1]
    return torch.nn.functional.pad(x, (0, 128 - hd)) if hd == 80 else x


def _layout(name: str):
    """(q bits, k bits, q pos, k pos) int32 [1, T*] for a layout."""
    qsel = slice(None)
    if name in ("causal", "capped"):
        bits, pos = bam.build_sample_bits([("text", 0, T)], T)
    elif name == "multimodal":
        bits, pos = bam.build_sample_bits(
            [("text", 0, 32), ("mod", 1, 192), ("text", 0, 288)], T)
    else:   # the allgather share of rank 0 in a 4-rank LPT plan
        bits, pos = random_multimodal_bits(T, "ee", seed=0)
        perm = plan_context(bits, pos, 4, block_size=32,
                            method="lpt").apply(T)["perm"]
        bits, pos = bits[perm], pos[perm]
        qsel = slice(0, T // 4)
    b, p = (torch.from_numpy(np.ascontiguousarray(x))[None]
            for x in (bits, pos))
    return b[:, qsel].contiguous(), b, p[:, qsel].contiguous(), p


LAYOUTS = ("causal", "multimodal", "cp", "capped")


def _kw(layout: str):
    return dict(softcap=30.0, window=100) if layout == "capped" else {}


def _args(layout: str, hd: int):
    """(q, k, v, do, lse, delta, bits and positions): bf16 q/k/v/do from
    a numpy seed, and the plain forward's lse and delta in f32."""
    qb, kb, qp, kp = _layout(layout)
    rng = np.random.default_rng(29 + hd)
    Tq = qb.shape[1]
    q, k, v, do = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).bfloat16() for shape in (
        (1, Tq, H, hd), (1, T, HKV, hd), (1, T, HKV, hd), (1, Tq, H, hd)))
    out, lse = bam_flash_attention_torch(
        q.float(), k.float(), v.float(), qb, kb, qp, kp,
        return_mode="residual", **_kw(layout))
    return q, k, v, do, lse, bwd_delta(out, do), qb, kb, qp, kp


_PLAIN = {}


def _plain(layout: str, hd: int):
    """The plain versions on the same bf16 values in f32 (so their output
    is not rounded either): dQ, dK, dV."""
    key = (layout, hd)
    if key not in _PLAIN:
        args = _args(layout, hd)
        fargs = [t.float() if t.dtype == torch.bfloat16 else t for t in args]
        _PLAIN[key] = (args, bam_bwd_dq_torch(*fargs, **_kw(layout)),
                                *bam_bwd_dkv_torch(*fargs, **_kw(layout)))
    return _PLAIN[key]


def _worst(layout: str, hd: int, product: str, split: bool):
    """Worst |d|/tol of the emulated product's gradient (dq for "dS·K",
    dv for "P^T·dO", dk for "dS^T·Q"), with that product's operand split
    or rounded once and the other products split."""
    args, dq_p, dk_p, dv_p = _plain(layout, hd)
    kw = _kw(layout)
    if product == "dS·K":
        return compare(k2_emulated(*args, split=split, **kw), dq_p,
                       "bfloat16")[1]
    dk, dv = k3_emulated(*args, split_p=split or product != "P^T·dO",
                         split_ds=split or product != "dS^T·Q", **kw)
    if product == "P^T·dO":
        return compare(dv, dv_p, "bfloat16")[1]
    return compare(dk, dk_p, "bfloat16")[1]


PRODUCTS = ("dS·K", "P^T·dO", "dS^T·Q")


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("product", PRODUCTS)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_split_keeps_one_bf16_ulp(layout, product, hd):
    ratio = _worst(layout, hd, product, split=True)
    assert ratio <= SPLIT_MAX, ratio


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("product", PRODUCTS)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_rounded_once_breaks_the_check(layout, product, hd):
    ratio = _worst(layout, hd, product, split=False)
    assert ratio > SINGLE_MIN, ratio


# K3 alone at 80 and 256: K2 runs its SIMT body (f32 FMAs) there
K3_PRODUCTS = ("P^T·dO", "dS^T·Q")


@pytest.mark.parametrize("hd", [80, 256])
@pytest.mark.parametrize("product", K3_PRODUCTS)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_k3_split_keeps_one_bf16_ulp(layout, product, hd):
    ratio = _worst(layout, hd, product, split=True)
    assert ratio <= SPLIT_MAX, ratio


@pytest.mark.parametrize("hd", [80, 256])
@pytest.mark.parametrize("product", K3_PRODUCTS)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_k3_rounded_once_breaks_the_check(layout, product, hd):
    ratio = _worst(layout, hd, product, split=False)
    assert ratio > SINGLE_MIN, ratio


def test_empty_rows_give_exact_zeros():
    """Padding q rows (bits 0, lse -1e30, where exp overflows): dQ of
    those rows exactly 0, and dK/dV exactly 0 where every row is padding,
    through the emulation's select, as the kernels' select gives."""
    args = list(_args("causal", 64))
    qb = torch.zeros_like(args[6])
    args[4] = torch.full_like(args[4], -1e30)
    args[6] = qb
    dq = k2_emulated(*args)
    dk, dv = k3_emulated(*args)
    assert bool((dq == 0).all() and (dk == 0).all() and (dv == 0).all())

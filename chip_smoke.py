#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU. Run from the root of the repository:

    python3 chip_smoke.py                       # every phase
    python3 chip_smoke.py --phases kernels      # phases 1-2 only

Phases (any failure exits non-zero and prints no result line; the result
line is printed only when every phase ran and passed):

1. Print the card's name and power limit; build the four CUDA kernels
   from ``src/repro_torch/kernels/csrc`` with nvcc (in parallel) and print
   the build seconds and ptxas' register/spill report.
2. Hold each kernel against its plain PyTorch version on the card at its
   main path's shapes, printing max abs error beside its tolerance,
   kernel/plain/library ms and the roofline bound:
   - K1 (BAM forward) on q [1,T,32,128], k/v [1,T,8,128], T in {512,
     2000} causal and T = 2000 multimodal, bf16 and f32, plus a
     softcap-50/window-256 case;
   - K2 (dQ) and K3 (dK/dV) at the train path's shapes: q [1,1600,32,128],
     k/v [1,1600,8,128] with the vlm layout's bits (512 text, 576 image,
     512 text), bf16 and f32, a softcap-50/window-256 case and a ragged
     T = 1000; K3 run twice must give the same bits;
   - K4 (paged decode) on a [P,16,8,128] page pool with 4 rows, one empty.
3. Serve 8 requests (6 text, 2 multimodal, 32 new tokens each) through
   ``ServingEngine(attn="kernel")`` at the full width and depth of
   ``llm_config("M")`` (Llama-3.1-8B widths) in bf16, random weights from
   a seeded generator. Launch counts are zeroed just before and read
   just after: K1 must launch once per layer per request, K4 > 0.
   Then a torch.profiler window over 3 decode ticks of 4 rows prints the
   device busy share and the top kernels by device time.
4. Serving parity: at f32 with 2 layers (full width) the kernel engine
   and the plain engine emit identical greedy tokens; at bf16 full depth,
   the two paths' last-row prefill logits are compared.
5. Train: 3 steps of ``make_mllm_train_step`` on
   ``build_paper_mllm("vlm", llm_size="M", vision_size="S")`` (a frozen
   40-layer EVA-CLIP-S-width encoder, a trainable linear projector, the
   frozen 32-layer Llama-3.1-8B-width LLM with attn_impl="bam_kernel"),
   bf16, B = 1, text_len 1024 (merged 1600), over ``MultimodalDataset``
   batches. Launch counts are zeroed just before and read just after:
   K1, K2 and K3 must each launch 32 times per step. Frozen parameters
   must be bit-identical afterwards (torch.equal against a host copy),
   the projector must have moved, every loss must be finite. A
   torch.profiler window over a fourth step prints the device busy share
   and the top kernels.
6. Train parity: the same model at f32 with 2 LLM and 2 encoder layers at
   full width; the kernel path and the plain path (attn_impl="xla"), from
   the same weights and batches, give the same loss (rel 1e-5) and
   grad_norm (rel 1e-4) at each of 3 steps.
7. Print a ``{"kernels": [...]}`` line, the nvidia-smi line, and, last,
   ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import copy
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12                       # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
SEED = 0


def cuda_ms(torch, fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of fn() over ``iters`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: float, nbytes: float, dtype: str):
    """(bound_ms, bound_by): the larger of bytes over HBM rate and
    operations over the dtype's peak rate."""
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


TOL_TEXT = {"float32": "|d| <= 1e-4",
            "bfloat16": "|d| <= 2^-7 |plain| + 1e-4 per element"}


def compare(out, plain, dtype: str):
    """Element-wise check of a kernel's output against its plain version.
    f32: only the summation order differs, so |d| <= 1e-4. bf16: both
    compute in f32 from the same bf16 inputs and round once, so they
    differ by at most one bf16 ulp of the element itself, which is at
    most 2^-7 of its magnitude. Returns (max |d|, worst |d| / tol); the
    check passes when the ratio is <= 1."""
    plain = plain.float()
    d = (out.float() - plain).abs()
    tol = 1e-4 if dtype == "float32" else 2.0 ** -7 * plain.abs() + 1e-4
    return float(d.max()), float((d / tol).max())


class Smoke:
    def __init__(self, torch):
        self.torch = torch
        self.failures = []
        self.kernels = {}
        self.launches = {}

    def check(self, ok: bool, what: str) -> None:
        print(("PASS " if ok else "FAIL ") + what, flush=True)
        if not ok:
            self.failures.append(what)


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def k1_cases(smoke: Smoke):
    torch = smoke.torch
    import torch.nn.functional as F
    from repro_torch.core import bam
    from repro_torch.kernels.bam_attention import (
        bam_flash_attention, bam_flash_attention_torch)

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    H, Hkv, hd = 32, 8, 128

    def layout(kind, T):
        if kind == "causal":
            return np.full(T, bam.text_token(), np.int32), \
                np.arange(T, dtype=np.int32)
        n_text = T - 576
        return bam.build_sample_bits(
            [("text", 0, n_text // 2), ("mod", 1, 576),
             ("text", 0, n_text - n_text // 2)], T)

    cases = [(T, kind, dt, 0.0, 0)
             for T, kind in ((512, "causal"), (2000, "causal"),
                             (2000, "multimodal"))
             for dt in ("bfloat16", "float32")]
    cases += [(300, "causal", dt, 50.0, 256) for dt in ("bfloat16", "float32")]
    headline = (2000, "multimodal", "bfloat16", 0.0, 0)
    for T, kind, dt, softcap, window in cases:
        dtype = getattr(torch, dt)
        q = torch.randn((1, T, H, hd), generator=gen, device="cuda").to(dtype)
        k = torch.randn((1, T, Hkv, hd), generator=gen, device="cuda").to(dtype)
        v = torch.randn((1, T, Hkv, hd), generator=gen, device="cuda").to(dtype)
        bits_np, pos_np = layout(kind, T)
        bits = torch.from_numpy(bits_np).cuda()[None]
        pos = torch.from_numpy(pos_np).cuda()[None]
        args = (q, k, v, bits, bits, pos, pos)
        kw = dict(softcap=softcap, window=window, return_mode="residual")
        out, lse = bam_flash_attention(*args, **kw)
        torch.cuda.synchronize()
        out_p, lse_p = bam_flash_attention_torch(*args, **kw)
        err, ratio = compare(out, out_p, dt)
        err_lse = float((lse - lse_p).abs().max())
        name = f"K1 T={T} {kind} {dt} softcap={softcap} window={window}"
        smoke.check(ratio <= 1.0 and err_lse <= 1e-3,
                    f"{name}: max_abs_err out {err:.3e} (tol {TOL_TEXT[dt]}; "
                    f"worst |d|/tol {ratio:.3f}), lse {err_lse:.3e} "
                    f"(tol 1e-3)")
        if (T, kind, dt, softcap, window) != headline:
            continue
        ms = cuda_ms(torch, lambda: bam_flash_attention(*args, **kw))
        plain_ms = cuda_ms(torch, lambda: bam_flash_attention_torch(*args, **kw),
                           iters=3)
        mask = bam.allowed_mask(bits, bits, pos, pos, window)   # [1,T,T]
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lib_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask[:, None], enable_gqa=True))
        pairs = float(mask.sum())
        flops = 4.0 * hd * H * pairs                    # QK^T and PV
        nbytes = sum(t.numel() * t.element_size()
                     for t in (q, k, v, out, lse, bits, bits, pos, pos))
        b_ms, b_by = bound(flops, nbytes, dt)
        print(f"{name}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
              f"SDPA with bool mask {lib_ms:.3f} ms, bound {b_ms:.4f} ms "
              f"({b_by}); mask density {pairs / T / T:.3f}, "
              f"{flops / ms / 1e9:.1f} TFLOP/s", flush=True)
        smoke.kernels["K1"] = {
            "name": "bam_fwd (K1, BAM flash-attention forward, residual)",
            "route": "cuda", "source": "src/repro_torch/kernels/csrc/bam_fwd.cu",
            "replaces": "src/repro/kernels/bam_attention.py:421",
            "max_abs_err": err, "tolerance": TOL_TEXT[dt],
            "worst_err_over_tol": ratio, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
            "shape": f"q[1,{T},{H},{hd}] kv[1,{T},{Hkv},{hd}] {dt} {kind}"}


def vlm_segments(T: int):
    """The vlm ``default_layout`` at merged length T as build_sample_bits
    segments: text split around the 576-token modality-1 stream."""
    from repro_torch.models.mllm import build_paper_mllm
    mllm = build_paper_mllm("vlm")
    enc = mllm.encoders["vision"]
    return [("text", 0, seg[1]) if seg[0] == "text"
            else ("mod", enc.modality_id, enc.num_tokens)
            for seg in mllm.default_layout(T - enc.num_tokens)]


def bwd_cases(smoke: Smoke):
    """K2 and K3 against their plain versions from the same (out, lse,
    delta) K1 gives, at the train path's shapes."""
    torch = smoke.torch
    import torch.nn.functional as F
    from repro_torch.core import bam
    from repro_torch.kernels.bam_attention import (
        bam_bwd_dkv, bam_bwd_dkv_torch, bam_bwd_dq, bam_bwd_dq_torch,
        bam_flash_attention, bwd_delta)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    H, Hkv, hd = 32, 8, 128
    cases = [(T, dt, cap, win) for T, cap, win in
             ((1600, 0.0, 0), (1600, 50.0, 256), (1000, 0.0, 0))
             for dt in ("bfloat16", "float32")]
    headline = (1600, "bfloat16", 0.0, 0)
    for T, dt, softcap, window in cases:
        dtype = getattr(torch, dt)
        q, do = (torch.randn((1, T, H, hd), generator=gen,
                             device="cuda").to(dtype) for _ in range(2))
        k, v = (torch.randn((1, T, Hkv, hd), generator=gen,
                            device="cuda").to(dtype) for _ in range(2))
        bits_np, pos_np = bam.build_sample_bits(vlm_segments(T), T)
        bits = torch.from_numpy(bits_np).cuda()[None]
        pos = torch.from_numpy(pos_np).cuda()[None]
        kw = dict(softcap=softcap, window=window)
        out, lse = bam_flash_attention(q, k, v, bits, bits, pos, pos,
                                       return_mode="residual", **kw)
        delta = bwd_delta(out, do)
        args = (q, k, v, do, lse, delta, bits, bits, pos, pos)
        dq = bam_bwd_dq(*args, **kw)
        dk, dv = bam_bwd_dkv(*args, **kw)
        dk2, dv2 = bam_bwd_dkv(*args, **kw)
        torch.cuda.synchronize()
        dq_p = bam_bwd_dq_torch(*args, **kw)
        dk_p, dv_p = bam_bwd_dkv_torch(*args, **kw)
        e_dq, r_dq = compare(dq, dq_p, dt)
        e_dk, r_dk = compare(dk, dk_p, dt)
        e_dv, r_dv = compare(dv, dv_p, dt)
        same = bool(torch.equal(dk, dk2) and torch.equal(dv, dv2))
        name = f"T={T} vlm layout {dt} softcap={softcap} window={window}"
        smoke.check(r_dq <= 1.0, f"K2 {name}: max_abs_err dq {e_dq:.3e} "
                    f"(tol {TOL_TEXT[dt]}; worst |d|/tol {r_dq:.3f})")
        smoke.check(r_dk <= 1.0 and r_dv <= 1.0 and same,
                    f"K3 {name}: max_abs_err dk {e_dk:.3e} (worst |d|/tol "
                    f"{r_dk:.3f}), dv {e_dv:.3e} (worst {r_dv:.3f}), tol "
                    f"{TOL_TEXT[dt]}; second run bit-identical: {same}")
        if (T, dt, softcap, window) != headline:
            continue
        ms_dq = cuda_ms(torch, lambda: bam_bwd_dq(*args, **kw))
        ms_dkv = cuda_ms(torch, lambda: bam_bwd_dkv(*args, **kw))
        plain_dq = cuda_ms(torch, lambda: bam_bwd_dq_torch(*args, **kw),
                           iters=3)
        plain_dkv = cuda_ms(torch, lambda: bam_bwd_dkv_torch(*args, **kw),
                            iters=3)
        # yardstick: SDPA's backward with a boolean mask, K/V expanded to
        # the 32 query heads (dK/dV per query head, unfolded)
        mask = bam.allowed_mask(bits, bits, pos, pos, window)   # [1,T,T]
        n_rep = H // Hkv
        qt = q.transpose(1, 2).detach().requires_grad_()
        kt, vt = (t.transpose(1, 2).repeat_interleave(n_rep, dim=1)
                  .detach().requires_grad_() for t in (k, v))
        out_l = F.scaled_dot_product_attention(qt, kt, vt,
                                               attn_mask=mask[:, None])
        g_l = do.transpose(1, 2)
        lib_dq = cuda_ms(torch, lambda: torch.autograd.grad(
            out_l, (qt,), g_l, retain_graph=True))
        lib_dkv = cuda_ms(torch, lambda: torch.autograd.grad(
            out_l, (kt, vt), g_l, retain_graph=True))
        del out_l
        pairs = float(mask.sum())
        tile_flops = 2.0 * hd * H * pairs          # one product per pair
        small = sum(t.numel() * t.element_size()
                    for t in (lse, delta, bits, bits, pos, pos))
        big = sum(t.numel() * t.element_size() for t in (q, k, v, do))
        b_dq, by_dq = bound(3 * tile_flops, big + small
                            + dq.numel() * dq.element_size(), dt)
        b_dkv, by_dkv = bound(4 * tile_flops, big + small
                              + 2 * dk.numel() * dk.element_size(), dt)
        density = pairs / T / T
        for key, label, ms, plain, lib, b_ms, b_by, err, ratio, src, line in (
                ("K2", "bam_bwd_dq (K2, BAM flash-attention backward, dQ)",
                 ms_dq, plain_dq, lib_dq, b_dq, by_dq, e_dq, r_dq,
                 "bam_bwd_dq.cu", 566),
                ("K3", "bam_bwd_dkv (K3, BAM flash-attention backward, "
                 "dK/dV, GQA folded)", ms_dkv, plain_dkv, lib_dkv, b_dkv,
                 by_dkv, max(e_dk, e_dv), max(r_dk, r_dv),
                 "bam_bwd_dkv.cu", 599)):
            flops = (3 if key == "K2" else 4) * tile_flops
            print(f"{key} {name}: kernel {ms:.3f} ms, plain {plain:.3f} ms, "
                  f"SDPA backward with bool mask {lib:.3f} ms, bound "
                  f"{b_ms:.4f} ms ({b_by}); mask density {density:.3f}, "
                  f"{flops / ms / 1e9:.1f} TFLOP/s", flush=True)
            smoke.kernels[key] = {
                "name": label, "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{src}",
                "replaces": f"src/repro/kernels/bam_attention.py:{line}",
                "max_abs_err": err, "tolerance": TOL_TEXT[dt],
                "worst_err_over_tol": ratio, "ms": ms, "plain_ms": plain,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib,
                "shape": f"q[1,{T},{H},{hd}] kv[1,{T},{Hkv},{hd}] {dt} "
                         f"vlm layout"}


def decode_fixture(torch, dtype, page_size=16, Hkv=8, hd=128):
    """A page pool holding the smoke traffic: rows (text 1500, multimodal
    32+576+64 with a query attending modality 1, text 700, empty)."""
    from repro_torch.core import bam
    from repro_torch.serving.paged_cache import PageTable, build_decode_grid
    layouts = [[("text", 0, 1500)],
               [("text", 0, 32), ("mod", 1, 576), ("text", 0, 64)],
               [("text", 0, 700)]]
    P = 1 + sum(-(-sum(s[2] for s in segs) // page_size) + 1
                for segs in layouts)
    table = PageTable(P, page_size)
    q_bits = [bam.text_token(), bam.text_token((1,)), bam.text_token(), 0]
    q_pos = []
    for rid, segs in enumerate(layouts):
        n = sum(s[2] for s in segs)
        bits, pos = bam.build_sample_bits(segs, n)
        table.alloc(rid, n + 1)
        # the query token is in the pool before attention runs
        table.write(rid, np.arange(n + 1), np.append(bits, q_bits[rid]),
                    np.append(pos, n))
        q_pos.append(n)
    q_pos.append(0)
    grid = build_decode_grid(table, [0, 1, 2, None], q_bits, q_pos)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    shape = (P, page_size, Hkv, hd)
    k = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    v = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    return (table, grid, k, v,
            torch.tensor(q_bits, dtype=torch.int32, device="cuda")[:, None],
            torch.tensor(q_pos, dtype=torch.int32, device="cuda")[:, None])


def k4_cases(smoke: Smoke):
    torch = smoke.torch
    import torch.nn.functional as F
    from repro_torch.core import bam
    from repro_torch.kernels.paged_decode import (
        decode_steps, paged_decode_attention, paged_decode_torch)

    H, hd = 32, 128
    for dt in ("bfloat16", "float32"):
        dtype = getattr(torch, dt)
        table, grid, kp, vp, qb, qp = decode_fixture(torch, dtype)
        gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
        q = torch.randn((4, H, hd), generator=gen, device="cuda").to(dtype)
        kvb = torch.from_numpy(table.bits).cuda()
        kvp = torch.from_numpy(table.pos).cuda()
        steps = decode_steps(grid.arrays(), 4, "cuda")
        args = (q, kp, vp, qb, qp, kvb, kvp, steps)
        out = paged_decode_attention(*args)
        torch.cuda.synchronize()
        out_p = paged_decode_torch(*args)
        err, ratio = compare(out, out_p, dt)
        name = f"K4 B=4 (one empty) pool {tuple(kp.shape)} {dt}"
        smoke.check(ratio <= 1.0 and bool((out[3] == 0).all()),
                    f"{name}: max_abs_err {err:.3e} (tol {TOL_TEXT[dt]}; "
                    f"worst |d|/tol {ratio:.3f}), empty row exactly 0: "
                    f"{bool((out[3] == 0).all())}")
        if dt != "bfloat16":
            continue
        ms = cuda_ms(torch, lambda: paged_decode_attention(*args), iters=50)
        plain_ms = cuda_ms(torch, lambda: paged_decode_torch(*args), iters=5)
        # yardstick: SDPA over the rows' pages gathered dense, bool mask
        mp = max(len(table.pages_of(r)) for r in range(3))
        pt = torch.from_numpy(np.stack(
            [table.page_table_row(r, mp) for r in range(3)]
            + [np.zeros(mp, np.int32)])).cuda().long()
        kd = kp[pt].reshape(4, -1, 8, hd).transpose(1, 2)
        vd = vp[pt].reshape(4, -1, 8, hd).transpose(1, 2)
        mask = bam.allowed_mask(qb, kvb[pt].reshape(4, -1), qp,
                                kvp[pt].reshape(4, -1))[:, None]
        mask[3] = True                   # SDPA has no empty-row convention
        qd = q[:, :, None]
        lib_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            qd, kd, vd, attn_mask=mask, enable_gqa=True), iters=50)
        n_pages = int(steps.pages.numel())
        page_bytes = 16 * 8 * hd * kp.element_size()
        keys = float(mask[:3].sum())
        nbytes = (2 * n_pages * page_bytes + 2 * q.numel() * q.element_size()
                  + n_pages * 16 * 8 + steps.row_ptr.numel() * 4)
        b_ms, b_by = bound(4.0 * hd * H * keys, nbytes, dt)
        print(f"{name}: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, SDPA "
              f"on gathered pages {lib_ms:.4f} ms, bound {b_ms:.5f} ms "
              f"({b_by}); {n_pages} active pages, "
              f"{nbytes / ms / 1e6:.1f} GB/s", flush=True)
        smoke.kernels["K4"] = {
            "name": "paged_decode (K4, paged BAM flash decode)",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_decode.cu",
            "replaces": "src/repro/kernels/paged_decode.py:138",
            "max_abs_err": err, "tolerance": TOL_TEXT[dt],
            "worst_err_over_tol": ratio, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
            "shape": f"q[4,{H},{hd}] pages{tuple(kp.shape)} {dt}"}


# ---------------------------------------------------------------------------
# Phases 3 and 4: the serving path
# ---------------------------------------------------------------------------

def traffic(vocab: int):
    """6 text prompts of 128-1500 tokens and 2 multimodal prompts (32
    text, 576 modality-1, 64 text), 32 new tokens each."""
    from repro_torch.core import bam
    rng = np.random.default_rng(SEED)
    reqs = [dict(tokens=rng.integers(1, vocab, size=n), max_new_tokens=32)
            for n in (128, 400, 750, 1000, 1250, 1500)]
    segs = [("text", 0, 32), ("mod", 1, 576), ("text", 0, 64)]
    bits, pos = bam.build_sample_bits(segs, 672)
    for _ in range(2):
        reqs.append(dict(tokens=rng.integers(1, vocab, size=672), bits=bits,
                         positions=pos, gen_bits=bam.text_token((1,)),
                         max_new_tokens=32))
    return reqs


def serve(model, cfg, attn, reqs):
    from repro_torch.serving import ServingEngine
    eng = ServingEngine(model, cfg, num_pages=400, page_size=16,
                        max_batch=4, attn=attn, device="cuda")
    rids = [eng.submit(**r) for r in reqs]
    out = eng.run()
    return [out[r] for r in rids], eng


def serving_phase(smoke: Smoke):
    torch = smoke.torch
    from repro_torch.configs.paper_mllm import llm_config
    from repro_torch.kernels.bam_attention import bam_flash_attention
    from repro_torch.kernels.paged_decode import paged_decode_attention
    from repro_torch.models import api

    cfg = llm_config("M").replace(attn_impl="bam_kernel")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    t0 = time.perf_counter()
    model = api.init(cfg, device="cuda", generator=gen)
    torch.cuda.synchronize()
    print(f"{cfg.name}: {cfg.param_count() / 1e9:.2f} B parameters, bf16, "
          f"init {time.perf_counter() - t0:.1f} s", flush=True)
    reqs = traffic(cfg.vocab_size)

    torch.cuda.reset_peak_memory_stats()
    bam_flash_attention.launches = 0
    paged_decode_attention.launches = 0
    t0 = time.perf_counter()
    tokens, eng = serve(model, cfg, "kernel", reqs)
    wall = time.perf_counter() - t0
    k1, k4 = bam_flash_attention.launches, paged_decode_attention.launches
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n_gen = sum(len(t) for t in tokens)
    prompt_tokens = sum(len(r["tokens"]) for r in reqs)
    print(f"serving {len(reqs)} requests ({prompt_tokens} prompt tokens): "
          f"prefill {eng.prefill_seconds * 1e3:.1f} ms total "
          f"({eng.prefill_seconds * 1e3 / len(reqs):.1f} ms/request), "
          f"decode {eng.decode_seconds * 1e3 / eng.decode_ticks:.2f} ms/tick "
          f"over {eng.decode_ticks} ticks, {n_gen / wall:.1f} generated "
          f"tokens/s, wall {wall:.2f} s, peak memory {peak:.2f} GiB",
          flush=True)
    print(f"launches on the serving path: K1 {k1}, K4 {k4}", flush=True)
    smoke.launches["serving"] = {"K1": k1, "K4": k4}
    want_k1 = cfg.num_layers * len(reqs)
    smoke.check(k1 == want_k1, f"K1 launched {k1} times, once per layer per "
                f"request = {want_k1}")
    smoke.check(k4 > 0 and k4 == cfg.num_layers * eng.decode_ticks,
                f"K4 launched {k4} times = layers x decode ticks")
    smoke.check(all(len(t) == 32 and all(0 <= x < cfg.vocab_size for x in t)
                    for t in tokens), "every request generated 32 in-vocab "
                "tokens")
    smoke.serving = dict(prefill_ms=eng.prefill_seconds * 1e3,
                         decode_ms_per_tick=eng.decode_seconds * 1e3
                         / eng.decode_ticks,
                         tokens_per_s=n_gen / wall, peak_gib=peak)
    return model, cfg, reqs


def decode_profile(smoke: Smoke, model, cfg, reqs):
    """Device busy share and kernel time by name over 3 decode ticks of
    4 rows (torch.profiler), to see where a decode tick's time goes."""
    torch = smoke.torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving import ServingEngine
    eng = ServingEngine(model, cfg, num_pages=400, page_size=16,
                        max_batch=4, attn="kernel", device="cuda")
    for r in reqs[:4]:
        eng.submit(**r)
    eng.step()                       # admit + prefill 4 rows, one tick
    eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            eng.step()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    print(f"decode profile, 3 ticks x 4 rows: wall {wall_us / 3e3:.2f} "
          f"ms/tick, device busy {busy_us / 3e3:.2f} ms/tick "
          f"({100 * busy_us / wall_us:.1f}% busy); top kernels: "
          + "; ".join(f"{e.key[:48]} {e.self_device_time_total / 3e3:.3f} "
                      f"ms/tick x{e.count // 3}" for e in top), flush=True)


def parity_phase(smoke: Smoke, model, cfg, reqs):
    torch = smoke.torch
    from repro_torch.core import bam
    from repro_torch.models import api
    from repro_torch.serving.model import prefill_forward

    # f32, 2 layers at full width: identical greedy tokens
    cfg32 = cfg.replace(num_layers=2, dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    m32 = api.init(cfg32, device="cuda", generator=gen)
    got, _ = serve(m32, cfg32.replace(attn_impl="bam_kernel"), "kernel", reqs)
    ref, _ = serve(m32, cfg32.replace(attn_impl="xla"), "xla", reqs)
    same = sum(a == b for a, b in zip(got, ref))
    smoke.check(same == len(reqs), f"f32 2-layer full width: kernel engine "
                f"== plain engine greedy tokens for {same}/{len(reqs)} "
                f"requests")
    del m32

    # bf16 full depth: last-row prefill logits of the two paths
    diffs, stds, agree, finite = [], [], 0, True
    with torch.inference_mode():
        for r in reqs:
            T = len(r["tokens"])
            bits = r.get("bits")
            batch = {
                "tokens": torch.as_tensor(r["tokens"], device="cuda")[None],
                "positions": torch.as_tensor(
                    r.get("positions", np.arange(T)), dtype=torch.int32,
                    device="cuda")[None],
                "bits": torch.as_tensor(
                    np.full(T, bam.text_token(), np.int32) if bits is None
                    else bits,
                    dtype=torch.int32, device="cuda")[None]}
            lk = prefill_forward(model, cfg, batch)[0][0, -1].float()
            lx = prefill_forward(model, cfg.replace(attn_impl="xla"),
                                 batch)[0][0, -1].float()
            finite &= bool(torch.isfinite(lk).all() and torch.isfinite(lx).all())
            diffs.append(float((lk - lx).abs().max()))
            stds.append(float(lx.std()))
            agree += int(lk.argmax() == lx.argmax())
    print(f"bf16 full depth, last-row prefill logits kernel vs plain: max "
          f"abs diff {max(diffs):.4f} (per request "
          f"{[round(d, 4) for d in diffs]}), logits std "
          f"{float(np.mean(stds)):.4f}; argmax agreement {agree}/{len(reqs)}",
          flush=True)
    # random weights give near-ties, so agreement is printed, not required
    smoke.check(finite, "bf16 full-depth prefill logits are finite")


# ---------------------------------------------------------------------------
# Phases 5 and 6: the train path
# ---------------------------------------------------------------------------

TEXT_LEN = 1024


def mllm_dataset(mllm, seed: int):
    from repro_torch.data.synthetic import MultimodalDataset
    encs = mllm.encoders
    return MultimodalDataset(
        vocab_size=mllm.llm_cfg.vocab_size, text_len=TEXT_LEN, batch_size=1,
        encoder_dims={n: e.cfg.d_model for n, e in encs.items()},
        encoder_tokens={n: e.num_tokens for n, e in encs.items()},
        modality_ids={n: e.modality_id for n, e in encs.items()},
        seed=seed, device="cuda")


def train_phase(smoke: Smoke):
    torch = smoke.torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.bam_attention import (
        bam_bwd_dkv, bam_bwd_dq, bam_flash_attention)
    from repro_torch.kernels.paged_decode import paged_decode_attention
    from repro_torch.models.mllm import build_paper_mllm
    from repro_torch.optim import optimizer as opt
    from repro_torch.training.steps import make_mllm_train_step

    mllm = build_paper_mllm("vlm", llm_size="M", vision_size="S")
    mllm.llm_cfg = mllm.llm_cfg.replace(attn_impl="bam_kernel")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    t0 = time.perf_counter()
    params = mllm.init(device="cuda", generator=gen)
    torch.cuda.synchronize()
    named = dict(params.named_parameters())
    fmask = mllm.frozen_mask(params)
    n_all = sum(p.numel() for p in named.values())
    n_train = sum(p.numel() for n, p in named.items() if not fmask[n])
    enc_cfg = mllm.encoders["vision"].cfg
    print(f"vlm: {enc_cfg.name} ({enc_cfg.num_layers} layers, d "
          f"{enc_cfg.d_model}, {enc_cfg.num_heads} heads of "
          f"{enc_cfg.head_dim}) + linear projector + {mllm.llm_cfg.name} "
          f"({mllm.llm_cfg.num_layers} layers); {n_all / 1e9:.2f} B "
          f"parameters, {n_train / 1e6:.2f} M trainable, bf16, init "
          f"{time.perf_counter() - t0:.1f} s; merged length "
          f"{mllm.merged_length(TEXT_LEN)}", flush=True)
    ocfg = opt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    step, _ = make_mllm_train_step(mllm, ocfg)
    state = opt.init(ocfg, named, fmask)
    frozen_copy = {n: p.detach().cpu() for n, p in named.items() if fmask[n]}
    proj0 = params.encoders["vision"].projector.w1.detach().clone()
    data = iter(mllm_dataset(mllm, SEED))
    batches = [next(data) for _ in range(4)]
    torch.cuda.synchronize()

    kernels = (bam_flash_attention, bam_bwd_dq, bam_bwd_dkv,
               paged_decode_attention)
    for fn in kernels:
        fn.launches = 0
    steps = []
    for i, batch in enumerate(batches[:3]):
        torch.cuda.reset_peak_memory_stats()
        before = [fn.launches for fn in kernels]
        t0 = time.perf_counter()
        params, state, met = step(params, state, batch)
        loss, gnorm = float(met["loss"]), float(met["grad_norm"])
        ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        counts = [fn.launches - b for fn, b in zip(kernels, before)]
        steps.append(dict(loss=loss, grad_norm=gnorm, ms=ms, peak_gib=peak))
        print(f"train step {i}: loss {loss:.6f}, grad_norm {gnorm:.6f}, "
              f"{ms:.1f} ms, peak memory {peak:.2f} GiB; launches K1 "
              f"{counts[0]}, K2 {counts[1]}, K3 {counts[2]}, K4 {counts[3]}",
              flush=True)
    k1, k2, k3, k4 = (fn.launches for fn in kernels)
    print(f"launches on the train path (3 steps): K1 {k1}, K2 {k2}, K3 {k3}, "
          f"K4 {k4}", flush=True)
    smoke.launches["train"] = {"K1": k1, "K2": k2, "K3": k3, "K4": k4}
    want = 3 * mllm.llm_cfg.num_layers
    smoke.check(k1 == k2 == k3 == want and k4 == 0,
                f"K1, K2, K3 launched {k1}, {k2}, {k3} times = "
                f"{mllm.llm_cfg.num_layers} layers x "
                f"3 steps = {want}; K4 {k4} times")
    smoke.check(all(np.isfinite(s["loss"]) and np.isfinite(s["grad_norm"])
                    for s in steps), "every train loss and grad_norm is "
                "finite")
    moved = float((params.encoders["vision"].projector.w1.detach().float()
                   - proj0.float()).abs().max())
    smoke.check(moved > 0, f"the projector moved (max |delta| {moved:.3e})")
    same = [n for n, c in frozen_copy.items()
            if torch.equal(named[n].detach().cpu(), c)]
    smoke.check(len(same) == len(frozen_copy),
                f"{len(same)}/{len(frozen_copy)} frozen parameters "
                f"bit-identical after 3 steps")
    del frozen_copy

    # where a step's device time goes: one more step under the profiler
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, state, met = step(params, state, batches[3])
        float(met["loss"])
        wall_us = (time.perf_counter() - t0) * 1e6
    evs = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in evs)
    top = sorted(evs, key=lambda e: -e.self_device_time_total)[:8]
    print(f"train profile, 1 step: wall {wall_us / 1e3:.1f} ms, device busy "
          f"{busy_us / 1e3:.1f} ms ({100 * busy_us / wall_us:.1f}% busy); top "
          f"kernels: " + "; ".join(
              f"{e.key[:48]} {e.self_device_time_total / 1e3:.2f} ms "
              f"x{e.count}" for e in top), flush=True)
    smoke.train = dict(steps=steps, profile_busy_ms=busy_us / 1e3,
                       profile_wall_ms=wall_us / 1e3)


def train_parity_phase(smoke: Smoke):
    """f32, 2 LLM and 2 encoder layers at full width: kernel path vs plain
    path from the same weights and batches."""
    torch = smoke.torch
    from repro_torch.models.mllm import build_paper_mllm
    from repro_torch.optim import optimizer as opt
    from repro_torch.training.steps import make_mllm_train_step

    def build(impl):
        m = build_paper_mllm("vlm", llm_size="M", vision_size="S")
        m.llm_cfg = m.llm_cfg.replace(num_layers=2, dtype="float32",
                                      attn_impl=impl)
        enc = m.encoders["vision"]
        enc.cfg = enc.cfg.replace(num_layers=2, dtype="float32")
        return m

    ocfg = opt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    data = iter(mllm_dataset(build("xla"), SEED + 6))
    batches = [next(data) for _ in range(3)]
    runs = {}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    params0 = None
    for impl in ("bam_kernel", "xla"):
        mllm = build(impl)
        if params0 is None:
            params0 = mllm.init(device="cuda", generator=gen)
        params = copy.deepcopy(params0)
        step, _ = make_mllm_train_step(mllm, ocfg)
        state = opt.init(ocfg, dict(params.named_parameters()),
                         mllm.frozen_mask(params))
        runs[impl] = []
        for batch in batches:
            params, state, met = step(params, state, batch)
            runs[impl].append((float(met["loss"]), float(met["grad_norm"])))
        del params, state
    for i, ((lk, gk), (lx, gx)) in enumerate(zip(runs["bam_kernel"],
                                                 runs["xla"])):
        rl, rg = abs(lk - lx) / abs(lx), abs(gk - gx) / abs(gx)
        smoke.check(rl <= 1e-5 and rg <= 1e-4,
                    f"f32 2+2 layers full width, step {i}: kernel loss "
                    f"{lk:.7f} vs plain {lx:.7f} (rel {rl:.2e}, tol 1e-5); "
                    f"grad_norm {gk:.7f} vs {gx:.7f} (rel {rg:.2e}, tol "
                    f"1e-4)")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default="kernels,serving,train",
                    help="comma-separated subset of kernels,serving,train; "
                    "the result line needs all three")
    phases = set(ap.parse_args().phases.split(","))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    print(sys.version.split()[0], torch.__version__, torch.version.cuda,
          flush=True)
    t_start = time.perf_counter()
    took = _build.build_all()
    print(f"built {sorted(took)} in {time.perf_counter() - t_start:.1f} s "
          f"({ {k: round(v, 1) for k, v in took.items()} })", flush=True)
    for name in _build.KERNELS:
        for line in _build.ptxas_report(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    smoke = Smoke(torch)
    if "kernels" in phases:
        k1_cases(smoke)
        bwd_cases(smoke)
        k4_cases(smoke)
    if "serving" in phases:
        model, cfg, reqs = serving_phase(smoke)
        decode_profile(smoke, model, cfg, reqs)
        parity_phase(smoke, model, cfg, reqs)
        del model
        gc.collect()
        torch.cuda.empty_cache()
    if "train" in phases:
        train_phase(smoke)
        gc.collect()
        torch.cuda.empty_cache()
        train_parity_phase(smoke)
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s after the "
          f"start of the build", flush=True)

    if smoke.failures:
        print(f"chip_smoke: {len(smoke.failures)} failure(s):",
              *smoke.failures, sep="\n  ", file=sys.stderr)
        return 1
    if phases != {"kernels", "serving", "train"}:
        print(f"chip_smoke: phases {sorted(phases)} passed; no result line "
              f"for a partial run")
        return 0
    # launches: each kernel's count on the paths it is on (serving: K1,
    # K4; train: K1, K2, K3); "launches" is the train path's for K1-K3
    paths = smoke.launches
    for key in ("K1", "K2", "K3", "K4"):
        by_path = {path: counts[key] for path, counts in paths.items()
                   if counts.get(key)}
        smoke.kernels[key]["launches_by_path"] = by_path
        smoke.kernels[key]["launches"] = by_path.get(
            "train", by_path.get("serving", 0))
    print(json.dumps({"kernels": [smoke.kernels[k]
                                  for k in ("K1", "K2", "K3", "K4")]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

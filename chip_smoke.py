#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU. Run from the root of the repository:

    python3 chip_smoke.py                       # every phase
    python3 chip_smoke.py --phases kernels      # phases 1-2 only
    python3 chip_smoke.py --phases compact      # phases 1, 2b only
    python3 chip_smoke.py --phases kernels,cp   # phases 1-2, 7-8

Phases (any failure exits non-zero and prints no result line; the result
line is printed only when every phase ran and passed):

1. Print the card's name and power limit; build the four CUDA kernels
   from ``src/repro_torch/kernels/csrc`` with nvcc (in parallel) and print
   the build seconds and ptxas' register/spill report. Then the proof
   that K1, K2 and K3 run on the tensor cores: ``cuobjdump --dump-sass``
   of the built ``bam_fwd``, ``bam_bwd_dq`` and ``bam_bwd_dkv``
   libraries, ``HGMMA`` instructions counted per kernel instantiation
   and printed beside ptxas' registers and spills; a check per library
   fails unless each of its bf16 instantiations (mangled names holding
   ``__nv_bfloat16``: 8 of K1, 4 of K2, 4 of K3) has HGMMA and no spill.
2. Hold each kernel against its plain PyTorch version on the card at its
   main path's shapes, printing max abs error beside its tolerance,
   kernel/plain/library ms and the roofline bound:
   - K1 (BAM forward) on q [1,T,32,128], k/v [1,T,8,128], T in {512,
     2000} causal and T = 2000 multimodal, bf16 and f32, plus a
     softcap-50/window-256 case and a bf16 head_dim-64 case (T = 2000
     multimodal);
   - K2 (dQ) and K3 (dK/dV) at the train path's shapes: q [1,1600,32,128],
     k/v [1,1600,8,128] with the vlm layout's bits (512 text, 576 image,
     512 text), bf16 and f32, a softcap-50/window-256 case and a ragged
     T = 1000; K3 run twice must give the same bits;
   - bf16 K2 and K3 at head_dim 64 (vlm layout, 32/8 heads) and at batch
     2 (a row of three packed documents, a multimodal row; T = 1000) with
     GQA 1:1 (8/8 heads of 128) and 4:1 (16/4 heads of 64, softcap 30,
     window 100), dense and compacted under the batch's map: each within
     ``compare`` of its plain version, K3 bit-identical on a second run,
     the compacted grid torch.equal to the dense one;
   - K4 (paged decode) on a [P,16,8,128] page pool with 4 rows, one empty;
   - at the most loaded rank's share of a 4-rank LPT plan of
     ``random_multimodal_bits(4096, "ee", seed=0)`` (block 128) with
     qwen3-1.7b's widths (16 query, 8 KV heads of 128), bf16 and f32: K1
     stats on q [1,1024] against all 4096 keys (the allgather share) and
     against one 1024-key ring chunk with rows that see no key there
     (exactly m = -1e30, l = 0, acc = 0); the four chunks' stats combined
     against one K1 residual call; K2 and K3 at Tq 1024, Tk 4096.
2b. ``compact``: the compacted grid (a ``BlockMask`` built at the
   kernels' 64 x 32 tile, walked as CSR rows).
   - At the vlm layout (q [1,1600,32,128], k/v [1,1600,8,128]) in bf16
     and f32, plus softcap 50 / window 256 with a map built for that
     window: K1c in its three modes, K2c and K3c each within ``compare``
     of its plain version under the same map and torch.equal to the dense
     kernel; a pruned map (one active tile with allowed pairs dropped
     from both lists) agrees with its plain version and differs from the
     dense kernels; times, bound and SDPA's time beside the dense ones.
   - At ``random_multimodal_bits(4096, mode, seed=0)`` for ep, ee and mp
     in bf16: active and dense steps, skip fraction, dense and compacted
     times of K1, K2, K3, and torch.equal between the two grids.
   - The path end to end: ``ops.bam_attention(impl="bam_kernel",
     block_map=bm)`` forward and ``torch.autograd.grad`` for q, k, v.
     Launch counts are zeroed just before and read just after: K1c, K2c
     and K3c once each, no dense kernel; output and gradients
     torch.equal to the same call without a map.
3. Serve 8 requests (6 text, 2 multimodal, 32 new tokens each) through
   ``ServingEngine(attn="kernel")`` at the full width and depth of
   ``llm_config("M")`` (Llama-3.1-8B widths) in bf16, random weights from
   a seeded generator. Launch counts are zeroed just before and read
   just after: K1 must launch once per layer per request, K4 > 0.
   Then torch.profiler windows over the step that prefills the longest
   prompt (device time, K1's share) and over 3 decode ticks of 4 rows
   (device busy share, top kernels by device time). One multimodal
   request is served again, prefilled in a 4-rank plan's layout: its
   pages are owned by the 4 ranks, and its agreement with the plan-less
   run is printed.
4. Serving parity: at f32 with 2 layers (full width) the kernel engine
   and the plain engine emit identical greedy tokens, and the request
   prefilled in the plan's layout emits its plan-less tokens; at bf16
   full depth, the two paths' last-row prefill logits are compared.
5. Train: 3 steps of ``make_mllm_train_step`` on
   ``build_paper_mllm("vlm", llm_size="M", vision_size="S")`` (a frozen
   40-layer EVA-CLIP-S-width encoder, a trainable linear projector, the
   frozen 32-layer Llama-3.1-8B-width LLM with attn_impl="bam_kernel"),
   bf16, B = 1, text_len 1024 (merged 1600), over ``MultimodalDataset``
   batches. Launch counts are zeroed just before and read just after:
   K2 and K3 must each launch 32 times per step, K1 once per layer and,
   under the config's ``remat`` (on for ``llm_config("M")``), once more
   in the backward's recompute: 64. Frozen parameters
   must be bit-identical afterwards (torch.equal against a host copy),
   the projector must have moved, every loss must be finite. A
   torch.profiler window over a fourth step prints the device busy share,
   the top kernels and K1's, K2's and K3's device time; a fifth step
   without remat prints its time and peak memory beside the remat
   steps'.
6. Train parity: the same model at f32 with 2 LLM and 2 encoder layers at
   full width; the kernel path and the plain path (attn_impl="xla"), from
   the same weights and batches, give the same loss (rel 1e-5) and
   grad_norm (rel 1e-4) at each of 3 steps.
7. Context parallelism, on a NCCL process group of world size 1 (NCCL
   refuses two ranks on one card) with the 4-rank LPT plan applied to
   the sequence: 3 allgather and 3 ring steps of ``make_cp_train_step``
   on full-width qwen3-1.7b (28 layers, bf16, all 1.72 B parameters
   trainable, B = 1, T = 4096), from the same seeded weights. Launch
   counts are zeroed just before and read just after each step: K2 and
   K3 must launch 28 times per step, K1 stats 28 or, under the config's
   ``remat`` (on for qwen3-1.7b), 56; K1 residual and K4 never. A fourth
   allgather step runs under the profiler (K1 stats', K2's and K3's
   device time beside the top kernels), and a fifth without remat prints
   its time and peak memory. One
   unpermuted non-CP step on the kernel path must agree with step 0 of
   both runs within rel 2e-2 (bf16).
8. CP parity: at f32, full width, 2 layers, the CP step (both methods,
   kernels) and the plain non-CP step (attn_impl="xla") give the same
   loss (rel 1e-5) and grad_norm (rel 1e-4) at each of 3 steps.
9. Print a ``{"kernels": [...]}`` line, the nvidia-smi line, and, last,
   ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import copy
import gc
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

PHASES = ("kernels", "compact", "serving", "train", "cp")
KERNEL_KEYS = ("K1", "K1s", "K1c", "K2", "K2c", "K3", "K3c", "K4")
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
        self.cp_share = {}

    def check(self, ok: bool, what: str) -> None:
        print(("PASS " if ok else "FAIL ") + what, flush=True)
        if not ok:
            self.failures.append(what)


def ptxas_by_function(report: str):
    """{mangled name: (registers, spill store bytes, spill load bytes)}
    from nvcc's -Xptxas -v report."""
    out, fn = {}, None
    for line in report.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$]+)'?", line)
        if m:
            fn = m.group(1)
            out.setdefault(fn, [0, 0, 0])
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and fn:
            out[fn][1:] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out[fn][0] = int(m.group(1))
    return out


# the libraries whose bf16 instantiations run on the tensor cores, and how
# many each has: K1 (3 modes' epilogues x compact x hd), K2, K3 (compact x hd)
SASS_LIBS = {"bam_fwd": ("K1", 8), "bam_bwd_dq": ("K2", 4),
             "bam_bwd_dkv": ("K3", 4)}


def short_name(fn: str) -> str:
    """``kernel<dtype, hd N, flags>`` from a mangled instantiation name."""
    m = re.search(r"\d+(bam_\w*?kernel)I(.*)", fn)
    if not m:
        return fn
    hd = re.search(r"Li(\d+)E", m.group(2))
    flags = re.findall(r"Lb(\d)E", m.group(2))
    dtype = "bf16" if "__nv_bfloat16" in fn else "f32"
    return (f"{m.group(1)}<{dtype}, hd {hd.group(1) if hd else '?'}, "
            f"flags {''.join(flags)}>")


def sass_check(smoke: Smoke, _build) -> None:
    """HGMMA instructions per kernel instantiation of the built bam_fwd,
    bam_bwd_dq and bam_bwd_dkv libraries (cuobjdump --dump-sass), printed
    beside ptxas' registers and spills. Every bf16 instantiation of K1
    (8), K2 (4) and K3 (4) must hold HGMMA and spill nothing."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    for lib, (key, want) in SASS_LIBS.items():
        try:
            sass = subprocess.run([tool, "--dump-sass",
                                   str(_build._lib_path(lib))],
                                  capture_output=True, text=True,
                                  check=True).stdout
        except (OSError, subprocess.CalledProcessError) as err:
            smoke.check(False, f"{key} SASS: cuobjdump failed: {err}")
            continue
        hgmma, fn = {}, None
        for line in sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                fn = m.group(1)
                hgmma[fn] = 0
            elif fn and "HGMMA" in line:
                hgmma[fn] += 1
        ptxas = ptxas_by_function(_build.ptxas_report(lib))
        bf16 = []
        for fn, count in sorted(hgmma.items()):
            regs, st, ld = ptxas.get(fn, (-1, -1, -1))
            print(f"  {lib} SASS {short_name(fn)}: {count} HGMMA, {regs} "
                  f"registers, spill stores {st} B, loads {ld} B",
                  flush=True)
            if "__nv_bfloat16" in fn:
                bf16.append(count > 0 and st == 0 and ld == 0)
        smoke.check(len(bf16) == want and all(bf16),
                    f"{key} SASS: {sum(bf16)} of {len(bf16)} bf16 "
                    f"instantiations (want {want}) hold HGMMA and spill "
                    f"nothing")


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
    H, Hkv = 32, 8

    def layout(kind, T):
        if kind == "causal":
            return np.full(T, bam.text_token(), np.int32), \
                np.arange(T, dtype=np.int32)
        n_text = T - 576
        return bam.build_sample_bits(
            [("text", 0, n_text // 2), ("mod", 1, 576),
             ("text", 0, n_text - n_text // 2)], T)

    cases = [(T, kind, dt, 0.0, 0, 128)
             for T, kind in ((512, "causal"), (2000, "causal"),
                             (2000, "multimodal"))
             for dt in ("bfloat16", "float32")]
    cases += [(300, "causal", dt, 50.0, 256, 128)
              for dt in ("bfloat16", "float32")]
    cases += [(2000, "multimodal", "bfloat16", 0.0, 0, 64)]
    headline = (2000, "multimodal", "bfloat16", 0.0, 0, 128)
    for T, kind, dt, softcap, window, hd in cases:
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
        if hd != 128:
            name += f" hd={hd}"
        smoke.check(ratio <= 1.0 and err_lse <= 1e-3,
                    f"{name}: max_abs_err out {err:.3e} (tol {TOL_TEXT[dt]}; "
                    f"worst |d|/tol {ratio:.3f}), lse {err_lse:.3e} "
                    f"(tol 1e-3)")
        if (T, kind, dt, softcap, window, hd) != headline:
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
def bwd_more_cases(smoke: Smoke):
    """bf16 K2 and K3 beyond the train path's shapes: head_dim 64 at the
    vlm layout (T = 1600, 32/8 heads); batch 2 at T = 1000, one row of
    three packed documents and one multimodal row, with GQA 1:1 (8/8
    heads of 128) and 4:1 (16/4 heads of 64, softcap 30, window 100).
    Each dense and compacted under the batch's block map: within
    ``compare`` of the plain version, K3 bit-identical on a second run,
    the compacted grid torch.equal to the dense one."""
    torch = smoke.torch
    from repro_torch.core import bam
    from repro_torch.kernels.bam_attention import (
        BLOCK_K, BLOCK_Q, bam_bwd_dkv, bam_bwd_dkv_torch, bam_bwd_dq,
        bam_bwd_dq_torch, bam_flash_attention, bwd_delta)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    docs = [("text", 0, 300), ("newdoc", 0, 0), ("text", 0, 400),
            ("newdoc", 0, 0), ("text", 0, 300)]
    mm = [("text", 0, 100), ("mod", 1, 400), ("text", 0, 500)]
    cases = [("vlm layout, 32/8 heads of 64", 1600, [vlm_segments(1600)],
              32, 8, 64, 0.0, 0),
             ("batch 2 (3 documents; multimodal), GQA 1:1, 8/8 heads of "
              "128", 1000, [docs, mm], 8, 8, 128, 0.0, 0),
             ("batch 2 (3 documents; multimodal), GQA 4:1, 16/4 heads of "
              "64, softcap 30, window 100", 1000, [docs, mm], 16, 4, 64,
              30.0, 100)]
    dt = "bfloat16"
    for name, T, rows, H, Hkv, hd, softcap, window in cases:
        pairs = [bam.build_sample_bits(r, T) for r in rows]
        bits_np = np.stack([b for b, _ in pairs])
        pos_np = np.stack([p for _, p in pairs])
        bits, pos = (torch.from_numpy(x).cuda() for x in (bits_np, pos_np))
        B = len(rows)
        q, do = (torch.randn((B, T, H, hd), generator=gen,
                             device="cuda").bfloat16() for _ in range(2))
        k, v = (torch.randn((B, T, Hkv, hd), generator=gen,
                            device="cuda").bfloat16() for _ in range(2))
        kw = dict(softcap=softcap, window=window)
        out, lse = bam_flash_attention(q, k, v, bits, bits, pos, pos,
                                       return_mode="residual", **kw)
        args = (q, k, v, do, lse, bwd_delta(out, do), bits, bits, pos, pos)
        bm = bam.build_block_map(bits_np, bits_np, pos_np, pos_np, BLOCK_Q,
                                 BLOCK_K, window)
        got = {}
        for grid, extra in (("dense", {}), ("compacted", {"block_map": bm})):
            dq = bam_bwd_dq(*args, **kw, **extra)
            dk, dv = bam_bwd_dkv(*args, **kw, **extra)
            dk2, dv2 = bam_bwd_dkv(*args, **kw, **extra)
            torch.cuda.synchronize()
            _, r_dq = compare(dq, bam_bwd_dq_torch(*args, **kw, **extra), dt)
            dk_p, dv_p = bam_bwd_dkv_torch(*args, **kw, **extra)
            _, r_dk = compare(dk, dk_p, dt)
            _, r_dv = compare(dv, dv_p, dt)
            same = bool(torch.equal(dk, dk2) and torch.equal(dv, dv2))
            smoke.check(r_dq <= 1.0 and r_dk <= 1.0 and r_dv <= 1.0 and same,
                        f"K2/K3 {grid} {name} bf16: worst |d|/tol dq "
                        f"{r_dq:.3f}, dk {r_dk:.3f}, dv {r_dv:.3f} (tol "
                        f"{TOL_TEXT[dt]}); K3 second run bit-identical: "
                        f"{same}")
            got[grid] = (dq, dk, dv)
        equal = all(torch.equal(a, b) for a, b in zip(got["dense"],
                                                      got["compacted"]))
        smoke.check(equal, f"K2c/K3c {name} bf16 (skip fraction "
                    f"{bm.skip_fraction:.3f}): torch.equal to the dense "
                    f"K2/K3: {equal}")


# Phase 2, continued: K1's stats mode and K2/K3 at a context-parallel share
# ---------------------------------------------------------------------------

CP_T, CP_RANKS, CP_BLOCK = 4096, 4, 128


def cp_layout():
    """The CP layout: ``random_multimodal_bits(4096, "ee", seed=0)``, its
    4-rank LPT plan (block 128), the plan-layout bits/positions and the
    most loaded rank."""
    from repro_torch.core.context_parallel import simulate_rank_workloads
    from repro_torch.data.synthetic import random_multimodal_bits
    from repro_torch.parallel import plan_context
    bits, pos = random_multimodal_bits(CP_T, "ee", seed=SEED)
    plan = plan_context(bits, pos, CP_RANKS, block_size=CP_BLOCK,
                        method="lpt")
    layout = plan.apply(CP_T)
    loads = simulate_rank_workloads(plan.core_plan(), bits, pos)
    perm = layout["perm"]
    return dict(bits=bits, pos=pos, plan=plan, layout=layout,
                pbits=bits[perm], ppos=pos[perm], loads=loads,
                rank=int(np.argmax(loads)))


def compare_stats(got, plain, dtype: str):
    """K1 stats against its plain version: acc and l divided per row by
    the plain l (their scale; 1 on rows with l = 0), m as it is, then
    ``compare``'s element rule. Returns (max |d| of the raw values, worst
    |d|/tol over the three)."""
    acc, m, l = got
    acc_p, m_p, l_p = plain
    scale = l_p.clamp_min(1.0)
    worst = max(compare(acc / scale[..., None], acc_p / scale[..., None],
                        dtype)[1],
                compare(l / scale, l_p / scale, dtype)[1],
                compare(m, m_p, dtype)[1])
    err = max(float((a - b).abs().max()) for a, b in zip(got, plain))
    return err, worst


def empty_rows_exact(stats):
    """(number of rows with l == 0, whether each has exactly m = -1e30,
    l = 0, acc = 0)."""
    acc, m, l = stats
    empty = l == 0
    ok = bool((m[empty] == -1e30).all() and (acc[empty] == 0).all())
    return int(empty.sum()), ok


def cp_kernel_cases(smoke: Smoke):
    """K1 stats, the combine, and K2/K3 at the most loaded rank's share of
    the 4-rank LPT layout (qwen3-1.7b's widths: 16 query and 8 KV heads
    of 128): allgather share q [1,1024] against all 4096 keys, and one
    ring chunk (1024 keys of another rank, with rows empty in it)."""
    torch = smoke.torch
    import torch.nn.functional as F
    from repro_torch.core import bam
    from repro_torch.core import context_parallel as cp
    from repro_torch.kernels.bam_attention import (
        bam_bwd_dkv, bam_bwd_dkv_torch, bam_bwd_dq, bam_bwd_dq_torch,
        bam_flash_attention, bam_flash_attention_torch, bwd_delta)

    lay = cp_layout()
    H, Hkv, hd = 16, 8, 128
    Tl = CP_T // CP_RANKS
    r = lay["rank"]
    own = slice(r * Tl, (r + 1) * Tl)
    bits = torch.from_numpy(lay["pbits"]).cuda()[None]
    pos = torch.from_numpy(lay["ppos"]).cuda()[None]
    qb, qp = bits[:, own].contiguous(), pos[:, own].contiguous()
    # the ring chunk: another rank's keys, the one leaving most of this
    # rank's rows without a key (but not all)
    empties = []
    for c in range(CP_RANKS):
        ch = slice(c * Tl, (c + 1) * Tl)
        allowed = bam.allowed_mask(qb, bits[:, ch], qp, pos[:, ch]).any(-1)
        n_empty = int((~allowed).sum())
        empties.append(n_empty if 0 < n_empty < Tl else -1)
    chunk = int(np.argmax(empties))
    print(f"CP layout: T {CP_T}, {CP_RANKS}-rank LPT plan (block "
          f"{CP_BLOCK}), rank loads {lay['loads'].tolist()} allowed pairs; "
          f"share of rank {r} (the most loaded); ring chunk of rank {chunk} "
          f"({empties[chunk]} of its rows have no key there)", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    for dt in ("bfloat16", "float32"):
        dtype = getattr(torch, dt)
        q, do = (torch.randn((1, Tl, H, hd), generator=gen,
                             device="cuda").to(dtype) for _ in range(2))
        k, v = (torch.randn((1, CP_T, Hkv, hd), generator=gen,
                            device="cuda").to(dtype) for _ in range(2))
        kw = dict(return_mode="stats")
        # allgather share
        ag = (q, k, v, qb, bits, qp, pos)
        st = bam_flash_attention(*ag, **kw)
        torch.cuda.synchronize()
        st_p = bam_flash_attention_torch(*ag, **kw)
        err, ratio = compare_stats(st, st_p, dt)
        n_empty, exact = empty_rows_exact(st)
        name = f"K1 stats allgather share q[1,{Tl},{H},{hd}] kv[1,{CP_T}," \
               f"{Hkv},{hd}] {dt}"
        smoke.check(ratio <= 1.0 and exact and n_empty == int(
            (st_p[2] == 0).sum()),
                    f"{name}: max_abs_err {err:.3e} (acc and l per row over "
                    f"the plain l, m as is; tol {TOL_TEXT[dt]}; worst "
                    f"|d|/tol {ratio:.3f}); {n_empty} empty rows (every "
                    f"token sees itself), exact: {exact}")
        if dt == "bfloat16":
            headline = dict(args=ag, err=err, ratio=ratio, name=name)
        # one ring chunk, then the four chunks combined against one K1
        # residual call over all keys
        parts = []
        for c in range(CP_RANKS):
            ch = slice(c * Tl, (c + 1) * Tl)
            args = (q, k[:, ch].contiguous(), v[:, ch].contiguous(), qb,
                    bits[:, ch].contiguous(), qp, pos[:, ch].contiguous())
            parts.append(bam_flash_attention(*args, **kw))
            if c != chunk:
                continue
            torch.cuda.synchronize()
            part_p = bam_flash_attention_torch(*args, **kw)
            err_c, ratio_c = compare_stats(parts[-1], part_p, dt)
            n_empty, exact = empty_rows_exact(parts[-1])
            smoke.check(ratio_c <= 1.0 and exact and n_empty > 0
                        and n_empty == int((part_p[2] == 0).sum()),
                        f"K1 stats ring chunk q[1,{Tl}] kv[1,{Tl}] {dt}: "
                        f"max_abs_err {err_c:.3e} (worst |d|/tol "
                        f"{ratio_c:.3f}); {n_empty // H} rows x {H} heads "
                        f"without a key in the chunk give exactly m = -1e30, "
                        f"l = 0, acc = 0: {exact}")
        acc, m, l = parts[0]
        for part in parts[1:]:
            acc, m, l = cp._combine_stats(acc, m, l, *part)
        out_c, lse_c = cp._finish(acc, m, l, dtype), cp._lse_from_stats(m, l)
        out, lse = bam_flash_attention(*ag, return_mode="residual")
        err_o, ratio_o = compare(out_c, out, dt)
        err_l = float((lse_c - lse).abs().max())
        smoke.check(ratio_o <= 1.0 and err_l <= 1e-3,
                    f"combine of 4 ring chunks' stats {dt} vs one K1 residual "
                    f"call over {CP_T} keys: out max_abs_err {err_o:.3e} "
                    f"(tol {TOL_TEXT[dt]}; worst |d|/tol {ratio_o:.3f}), lse "
                    f"{err_l:.3e} (tol 1e-3)")
        # K2 and K3 at the share, from the combined (out, lse)
        delta = bwd_delta(out_c, do)
        bargs = (q, k, v, do, lse_c, delta, qb, bits, qp, pos)
        dq = bam_bwd_dq(*bargs)
        dk, dv = bam_bwd_dkv(*bargs)
        torch.cuda.synchronize()
        e_dq, r_dq = compare(dq, bam_bwd_dq_torch(*bargs), dt)
        dk_p, dv_p = bam_bwd_dkv_torch(*bargs)
        e_dk, r_dk = compare(dk, dk_p, dt)
        e_dv, r_dv = compare(dv, dv_p, dt)
        del dk_p, dv_p
        shape = f"Tq {Tl}, Tk {CP_T} {dt}"
        smoke.check(r_dq <= 1.0, f"K2 CP share {shape}: max_abs_err dq "
                    f"{e_dq:.3e} (tol {TOL_TEXT[dt]}; worst |d|/tol "
                    f"{r_dq:.3f})")
        smoke.check(r_dk <= 1.0 and r_dv <= 1.0,
                    f"K3 CP share {shape}: max_abs_err dk {e_dk:.3e} (worst "
                    f"|d|/tol {r_dk:.3f}), dv {e_dv:.3e} (worst {r_dv:.3f})")
        if dt == "bfloat16":
            headline.update(bargs=bargs, e_dq=e_dq, r_dq=r_dq,
                            e_dkv=max(e_dk, e_dv), r_dkv=max(r_dk, r_dv))

    # times at the bf16 share
    ag, bargs = headline["args"], headline["bargs"]
    q, k, v, qb_, kb_, qp_, kp_ = ag
    mask = bam.allowed_mask(qb_, kb_, qp_, kp_)               # [1,Tl,T]
    pairs = float(mask.sum())
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    ms = cuda_ms(torch, lambda: bam_flash_attention(*ag, return_mode="stats"))
    plain_ms = cuda_ms(torch, lambda: bam_flash_attention_torch(
        *ag, return_mode="stats"), iters=3)
    lib_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask[:, None], enable_gqa=True))
    small = sum(t.numel() * t.element_size() for t in (qb_, kb_, qp_, kp_))
    io = sum(t.numel() * t.element_size() for t in (q, k, v))
    out_bytes = (Tl * H * hd + 2 * Tl * H) * 4                # acc, m, l
    b_ms, b_by = bound(4.0 * hd * H * pairs, io + small + out_bytes,
                       "bfloat16")
    print(f"{headline['name']}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
          f"SDPA with bool mask {lib_ms:.3f} ms, bound {b_ms:.4f} ms "
          f"({b_by}); {pairs:.0f} allowed pairs (density "
          f"{pairs / Tl / CP_T:.3f}), "
          f"{4.0 * hd * H * pairs / ms / 1e9:.1f} TFLOP/s", flush=True)
    smoke.kernels["K1s"] = {
        "name": "bam_fwd stats mode (K1 stats, unnormalised acc/m/l for "
                "context parallelism)",
        "route": "cuda", "source": "src/repro_torch/kernels/csrc/bam_fwd.cu",
        "replaces": "src/repro/kernels/bam_attention.py:474",
        "max_abs_err": headline["err"], "tolerance": TOL_TEXT["bfloat16"]
        + " (acc, l per row over the plain l)",
        "worst_err_over_tol": headline["ratio"], "ms": ms,
        "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": lib_ms,
        "shape": f"q[1,{Tl},{H},{hd}] kv[1,{CP_T},{Hkv},{hd}] bf16, CP "
                 f"share of a 4-rank LPT plan"}
    # K2/K3 at Tq != Tk, beside their train-path numbers; yardstick:
    # SDPA's backward with a boolean mask, K/V expanded to the 16 heads
    qt_l = qt.detach().requires_grad_()
    kt_l, vt_l = (t.repeat_interleave(H // Hkv, dim=1).detach()
                  .requires_grad_() for t in (kt, vt))
    out_l = F.scaled_dot_product_attention(qt_l, kt_l, vt_l,
                                           attn_mask=mask[:, None])
    g_l = bargs[3].transpose(1, 2)
    lib_dq = cuda_ms(torch, lambda: torch.autograd.grad(
        out_l, (qt_l,), g_l, retain_graph=True))
    lib_dkv = cuda_ms(torch, lambda: torch.autograd.grad(
        out_l, (kt_l, vt_l), g_l, retain_graph=True))
    del out_l
    tile_flops = 2.0 * hd * H * pairs
    big = io + bargs[3].numel() * bargs[3].element_size()    # q, k, v, do
    small_b = small + 2 * Tl * H * 4                         # lse, delta
    for key, fn, fn_p, nprod, out_bytes, err, ratio, lib in (
            ("K2", bam_bwd_dq, bam_bwd_dq_torch, 3,
             q.numel() * q.element_size(), headline["e_dq"],
             headline["r_dq"], lib_dq),
            ("K3", bam_bwd_dkv, bam_bwd_dkv_torch, 4,
             2 * k.numel() * k.element_size(), headline["e_dkv"],
             headline["r_dkv"], lib_dkv)):
        t_ms = cuda_ms(torch, lambda: fn(*bargs))
        t_plain = cuda_ms(torch, lambda: fn_p(*bargs), iters=3)
        b_ms, b_by = bound(nprod * tile_flops, big + small_b + out_bytes,
                           "bfloat16")
        print(f"{key} CP share Tq {Tl}, Tk {CP_T} bf16: kernel {t_ms:.3f} ms, "
              f"plain {t_plain:.3f} ms, SDPA backward with bool mask "
              f"{lib:.3f} ms, bound {b_ms:.4f} ms ({b_by}), "
              f"{nprod * tile_flops / t_ms / 1e9:.1f} TFLOP/s", flush=True)
        smoke.cp_share[key] = {"ms": t_ms, "plain_ms": t_plain,
                               "bound_ms": b_ms, "bound_by": b_by,
                               "library_ms": lib, "max_abs_err": err,
                               "worst_err_over_tol": ratio,
                               "shape": f"q[1,{Tl},{H},{hd}] kv[1,{CP_T},"
                                        f"{Hkv},{hd}] bf16"}


# ---------------------------------------------------------------------------
# Phase compact: the compacted-grid kernels and the op's block_map= path
# ---------------------------------------------------------------------------

COMPACT_T, COMPACT_LAYOUTS = 4096, ("ep", "ee", "mp")


def kernel_counts():
    """Every launch counter of the port's kernels, by kernel key."""
    from repro_torch.kernels.bam_attention import (
        bam_bwd_dkv, bam_bwd_dq, bam_flash_attention)
    from repro_torch.kernels.paged_decode import paged_decode_attention
    return {"K1": bam_flash_attention.launches,
            "K1s": bam_flash_attention.stats_launches,
            "K1c": bam_flash_attention.compact_launches,
            "K2": bam_bwd_dq.launches, "K2c": bam_bwd_dq.compact_launches,
            "K3": bam_bwd_dkv.launches, "K3c": bam_bwd_dkv.compact_launches,
            "K4": paged_decode_attention.launches}


def zero_counts() -> None:
    from repro_torch.kernels.bam_attention import (
        bam_bwd_dkv, bam_bwd_dq, bam_flash_attention)
    from repro_torch.kernels.paged_decode import paged_decode_attention
    for fn in (bam_flash_attention, bam_bwd_dq, bam_bwd_dkv,
               paged_decode_attention):
        fn.launches = 0
    bam_flash_attention.stats_launches = 0
    for fn in (bam_flash_attention, bam_bwd_dq, bam_bwd_dkv):
        fn.compact_launches = 0


def as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def pruned_map(bm, mask):
    """``bm`` without one active tile that holds allowed pairs (``mask``
    [Tq, Tk] bool): the first such k tile of the middle q block."""
    from repro_torch.core import bam
    active = bm.active_tiles()
    iq = bm.nq // 2
    rows = mask[iq * bm.block_q:(iq + 1) * bm.block_q]
    ik = next(j for j in np.flatnonzero(active[iq])
              if bool(rows[:, j * bm.block_k:(j + 1) * bm.block_k].any()))
    active[iq, ik] = False
    return bam.block_map_from_tiles(active, bm.block_q, bm.block_k,
                                    bm.window), (iq, int(ik))


def compact_kernel_cases(smoke: Smoke):
    """K1 (three modes), K2 and K3 on the compacted grid at the vlm layout
    (q [1,1600,32,128], k/v [1,1600,8,128]), bf16 and f32, plus softcap
    50 / window 256 with a map built for that window: each within
    ``compare`` of its plain version under the same map and equal
    (torch.equal) to the dense kernel; a pruned map (one active tile with
    allowed pairs dropped from both lists) agrees with its plain version
    and differs from the dense kernel."""
    torch = smoke.torch
    from repro_torch.core import bam
    from repro_torch.kernels.bam_attention import (
        BLOCK_K, BLOCK_Q, RETURN_MODES, bam_bwd_dkv, bam_bwd_dkv_torch,
        bam_bwd_dq, bam_bwd_dq_torch, bam_flash_attention,
        bam_flash_attention_torch, bwd_delta)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    H, Hkv, hd, T = 32, 8, 128, 1600
    bits_np, pos_np = bam.build_sample_bits(vlm_segments(T), T)
    bits = torch.from_numpy(bits_np).cuda()[None]
    pos = torch.from_numpy(pos_np).cuda()[None]
    cases = [(dt, cap, win) for cap, win in ((0.0, 0), (50.0, 256))
             for dt in ("bfloat16", "float32")]
    headline = ("bfloat16", 0.0, 0)
    for dt, softcap, window in cases:
        dtype = getattr(torch, dt)
        q, do = (torch.randn((1, T, H, hd), generator=gen,
                             device="cuda").to(dtype) for _ in range(2))
        k, v = (torch.randn((1, T, Hkv, hd), generator=gen,
                            device="cuda").to(dtype) for _ in range(2))
        bm = bam.build_block_map(bits_np, bits_np, pos_np, pos_np, BLOCK_Q,
                                 BLOCK_K, window)
        fargs = (q, k, v, bits, bits, pos, pos)
        kw = dict(softcap=softcap, window=window)
        name = (f"T={T} vlm layout {dt} softcap={softcap} window={window} "
                f"({bm.n_steps} of {bm.n_dense_steps} steps)")
        errs = {}
        for mode in RETURN_MODES:
            got = bam_flash_attention(*fargs, return_mode=mode, block_map=bm,
                                      **kw)
            dense = bam_flash_attention(*fargs, return_mode=mode, **kw)
            torch.cuda.synchronize()
            plain = bam_flash_attention_torch(*fargs, return_mode=mode,
                                              block_map=bm, **kw)
            if mode == "stats":
                err, ratio = compare_stats(got, plain, dt)
                err_lse = 0.0
            else:
                err, ratio = compare(as_tuple(got)[0], as_tuple(plain)[0], dt)
                err_lse = (float((got[1] - plain[1]).abs().max())
                           if mode == "residual" else 0.0)
            equal = all(torch.equal(a, b) for a, b in
                        zip(as_tuple(got), as_tuple(dense)))
            errs[mode] = (err, ratio)
            smoke.check(ratio <= 1.0 and err_lse <= 1e-3 and equal,
                        f"K1c {mode} {name}: max_abs_err {err:.3e} (tol "
                        f"{TOL_TEXT[dt]}; worst |d|/tol {ratio:.3f}), lse "
                        f"{err_lse:.3e} (tol 1e-3); torch.equal to the dense "
                        f"K1: {equal}")
            del got, dense, plain
        out, lse = bam_flash_attention(*fargs, return_mode="residual", **kw)
        delta = bwd_delta(out, do)
        bargs = (q, k, v, do, lse, delta, bits, bits, pos, pos)
        dq = bam_bwd_dq(*bargs, block_map=bm, **kw)
        dk, dv = bam_bwd_dkv(*bargs, block_map=bm, **kw)
        eq_dq = torch.equal(dq, bam_bwd_dq(*bargs, **kw))
        eq_dkv = all(torch.equal(a, b) for a, b in
                     zip((dk, dv), bam_bwd_dkv(*bargs, **kw)))
        torch.cuda.synchronize()
        e_dq, r_dq = compare(dq, bam_bwd_dq_torch(*bargs, block_map=bm, **kw),
                             dt)
        dk_p, dv_p = bam_bwd_dkv_torch(*bargs, block_map=bm, **kw)
        e_dk, r_dk = compare(dk, dk_p, dt)
        e_dv, r_dv = compare(dv, dv_p, dt)
        del dk_p, dv_p
        smoke.check(r_dq <= 1.0 and eq_dq,
                    f"K2c {name}: max_abs_err dq {e_dq:.3e} (tol "
                    f"{TOL_TEXT[dt]}; worst |d|/tol {r_dq:.3f}); torch.equal "
                    f"to the dense K2: {eq_dq}")
        smoke.check(r_dk <= 1.0 and r_dv <= 1.0 and eq_dkv,
                    f"K3c {name}: max_abs_err dk {e_dk:.3e} (worst |d|/tol "
                    f"{r_dk:.3f}), dv {e_dv:.3e} (worst {r_dv:.3f}), tol "
                    f"{TOL_TEXT[dt]}; torch.equal to the dense K3: {eq_dkv}")
        mask = bam.allowed_mask(bits, bits, pos, pos, window)     # [1,T,T]
        if softcap == 0.0:
            # the step list is what the kernels walk: drop one tile
            pm, tile = pruned_map(bm, mask[0].cpu().numpy())
            pout, plse = bam_flash_attention(*fargs, return_mode="residual",
                                             block_map=pm, **kw)
            torch.cuda.synchronize()
            pout_p, plse_p = bam_flash_attention_torch(
                *fargs, return_mode="residual", block_map=pm, **kw)
            e_o, r_o = compare(pout, pout_p, dt)
            e_l = float((plse - plse_p).abs().max())
            pdelta = bwd_delta(pout, do)
            pargs = (q, k, v, do, plse, pdelta, bits, bits, pos, pos)
            pdq = bam_bwd_dq(*pargs, block_map=pm, **kw)
            pdk, pdv = bam_bwd_dkv(*pargs, block_map=pm, **kw)
            ddq = bam_bwd_dq(*pargs, **kw)
            ddk, ddv = bam_bwd_dkv(*pargs, **kw)
            torch.cuda.synchronize()
            r_pq = compare(pdq, bam_bwd_dq_torch(*pargs, block_map=pm, **kw),
                           dt)[1]
            pdk_p, pdv_p = bam_bwd_dkv_torch(*pargs, block_map=pm, **kw)
            r_pk = max(compare(pdk, pdk_p, dt)[1], compare(pdv, pdv_p, dt)[1])
            differ = (not torch.equal(pout, out), not torch.equal(pdq, ddq),
                      not (torch.equal(pdk, ddk) and torch.equal(pdv, ddv)))
            smoke.check(r_o <= 1.0 and e_l <= 1e-3 and r_pq <= 1.0
                        and r_pk <= 1.0 and all(differ),
                        f"pruned map (tile {tile} dropped) {dt}: K1c out "
                        f"max_abs_err {e_o:.3e} (worst |d|/tol {r_o:.3f}), "
                        f"lse {e_l:.3e}; K2c worst |d|/tol {r_pq:.3f}; K3c "
                        f"{r_pk:.3f} against their plain versions under the "
                        f"same map; differ from the dense K1, K2, K3: "
                        f"{differ}")
            del pdk_p, pdv_p
        if (dt, softcap, window) != headline:
            continue
        compact_times(smoke, bm, mask, fargs, bargs, errs, (e_dq, r_dq),
                      (max(e_dk, e_dv), max(r_dk, r_dv)),
                      f"q[1,{T},{H},{hd}] kv[1,{T},{Hkv},{hd}] {dt} vlm "
                      f"layout")


def compact_times(smoke: Smoke, bm, mask, fargs, bargs, errs, err_dq,
                  err_dkv, shape: str):
    """Compacted K1 (residual), K2 and K3 against the dense kernels, their
    plain versions and SDPA (boolean mask, and its backward) at the
    headline case; the bound counts the allowed pairs inside the map."""
    torch = smoke.torch
    import torch.nn.functional as F
    from repro_torch.core import bam
    from repro_torch.kernels.bam_attention import (
        bam_bwd_dkv, bam_bwd_dkv_torch, bam_bwd_dq, bam_bwd_dq_torch,
        bam_flash_attention, bam_flash_attention_torch)
    q, k, v = fargs[:3]
    H, Hkv = q.shape[2], k.shape[2]
    hd = q.shape[3]
    do, lse, delta = bargs[3:6]
    tiles = bam.tile_mask(bm, q.shape[1], k.shape[1], q.device)
    mask = mask & tiles
    pairs = float(mask.sum())
    csr = bam.block_csr(bm, q.device)
    map_bytes = {"q": (csr.q_ptr.numel() + csr.q_cols.numel()) * 4,
                 "k": (csr.k_ptr.numel() + csr.k_rows.numel()) * 4}
    small = sum(t.numel() * t.element_size() for t in fargs[3:])
    io = sum(t.numel() * t.element_size() for t in (q, k, v))
    kw = dict(return_mode="residual")
    t = {"K1c": cuda_ms(torch, lambda: bam_flash_attention(
            *fargs, block_map=bm, **kw)),
         "K1": cuda_ms(torch, lambda: bam_flash_attention(*fargs, **kw)),
         "K2c": cuda_ms(torch, lambda: bam_bwd_dq(*bargs, block_map=bm)),
         "K2": cuda_ms(torch, lambda: bam_bwd_dq(*bargs)),
         "K3c": cuda_ms(torch, lambda: bam_bwd_dkv(*bargs, block_map=bm)),
         "K3": cuda_ms(torch, lambda: bam_bwd_dkv(*bargs))}
    plain = {"K1c": cuda_ms(torch, lambda: bam_flash_attention_torch(
                 *fargs, block_map=bm, **kw), iters=3),
             "K2c": cuda_ms(torch, lambda: bam_bwd_dq_torch(
                 *bargs, block_map=bm), iters=3),
             "K3c": cuda_ms(torch, lambda: bam_bwd_dkv_torch(
                 *bargs, block_map=bm), iters=3)}
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib = {"K1c": cuda_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask[:, None], enable_gqa=True))}
    n_rep = H // Hkv
    qt_l = qt.detach().requires_grad_()
    kt_l, vt_l = (x.repeat_interleave(n_rep, dim=1).detach()
                  .requires_grad_() for x in (kt, vt))
    out_l = F.scaled_dot_product_attention(qt_l, kt_l, vt_l,
                                           attn_mask=mask[:, None])
    g_l = do.transpose(1, 2)
    lib["K2c"] = cuda_ms(torch, lambda: torch.autograd.grad(
        out_l, (qt_l,), g_l, retain_graph=True))
    lib["K3c"] = cuda_ms(torch, lambda: torch.autograd.grad(
        out_l, (kt_l, vt_l), g_l, retain_graph=True))
    del out_l
    tile_flops = 2.0 * hd * H * pairs
    out_bytes = {"K1c": q.numel() * q.element_size() + lse.numel() * 4,
                 "K2c": q.numel() * q.element_size(),
                 "K3c": 2 * k.numel() * k.element_size()}
    in_bytes = {"K1c": io + small + map_bytes["q"],
                "K2c": io + do.numel() * do.element_size() + small
                + 2 * lse.numel() * 4 + map_bytes["q"],
                "K3c": io + do.numel() * do.element_size() + small
                + 2 * lse.numel() * 4 + map_bytes["k"]}
    nprod = {"K1c": 2, "K2c": 3, "K3c": 4}
    err = {"K1c": errs["residual"], "K2c": err_dq, "K3c": err_dkv}
    meta = {"K1c": ("bam_fwd compacted grid (K1c, BAM flash-attention "
                    "forward over a block map's active tiles; out, "
                    "residual and stats)", "bam_fwd.cu", 526),
            "K2c": ("bam_bwd_dq compacted grid (K2c, BAM backward dQ over "
                    "the q-major active tiles)", "bam_bwd_dq.cu", 652),
            "K3c": ("bam_bwd_dkv compacted grid (K3c, BAM backward dK/dV "
                    "over the k-major active tiles, GQA folded)",
                    "bam_bwd_dkv.cu", 667)}
    for key in ("K1c", "K2c", "K3c"):
        flops = nprod[key] * tile_flops
        b_ms, b_by = bound(flops, in_bytes[key] + out_bytes[key],
                           "bfloat16")
        dense = key[:2]
        print(f"{key} {shape}: kernel {t[key]:.3f} ms (dense {dense} "
              f"{t[dense]:.3f} ms), plain {plain[key]:.3f} ms, SDPA "
              f"{'backward ' if key != 'K1c' else ''}with bool mask "
              f"{lib[key]:.3f} ms, bound {b_ms:.4f} ms ({b_by}); "
              f"{pairs:.0f} allowed pairs in {bm.n_steps} of "
              f"{bm.n_dense_steps} tiles, {flops / t[key] / 1e9:.1f} "
              f"TFLOP/s", flush=True)
        label, src, line = meta[key]
        smoke.kernels[key] = {
            "name": label, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": f"src/repro/kernels/bam_attention.py:{line}",
            "max_abs_err": err[key][0], "tolerance": TOL_TEXT["bfloat16"],
            "worst_err_over_tol": err[key][1], "ms": t[key],
            "dense_ms": t[dense], "plain_ms": plain[key], "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib[key], "shape": shape}


def compact_layouts(smoke: Smoke):
    """The reference benchmark's layouts, ``random_multimodal_bits(4096,
    mode, seed=0)`` for ep, ee and mp, at the vlm widths in bf16: active
    and dense steps, skip fraction, dense against compacted K1 (residual),
    K2 and K3 times, and torch.equal between the two grids."""
    torch = smoke.torch
    from repro_torch.core import bam
    from repro_torch.data.synthetic import random_multimodal_bits
    from repro_torch.kernels.bam_attention import (
        BLOCK_K, BLOCK_Q, bam_bwd_dkv, bam_bwd_dq, bam_flash_attention,
        bwd_delta)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    H, Hkv, hd, T = 32, 8, 128, COMPACT_T
    smoke.compact_layouts = {}
    for mode in COMPACT_LAYOUTS:
        bits_np, pos_np = random_multimodal_bits(T, mode, seed=SEED)
        bm = bam.build_block_map(bits_np, bits_np, pos_np, pos_np, BLOCK_Q,
                                 BLOCK_K)
        active = sum(s[4] for s in bm.q_steps)
        bits = torch.from_numpy(bits_np).cuda()[None]
        pos = torch.from_numpy(pos_np).cuda()[None]
        q, do = (torch.randn((1, T, H, hd), generator=gen, device="cuda")
                 .to(torch.bfloat16) for _ in range(2))
        k, v = (torch.randn((1, T, Hkv, hd), generator=gen, device="cuda")
                .to(torch.bfloat16) for _ in range(2))
        fargs = (q, k, v, bits, bits, pos, pos)
        kw = dict(return_mode="residual")
        out, lse = bam_flash_attention(*fargs, **kw)
        out_c, lse_c = bam_flash_attention(*fargs, block_map=bm, **kw)
        bargs = (q, k, v, do, lse, bwd_delta(out, do), bits, bits, pos, pos)
        equal = {"K1": torch.equal(out, out_c) and torch.equal(lse, lse_c),
                 "K2": torch.equal(bam_bwd_dq(*bargs),
                                   bam_bwd_dq(*bargs, block_map=bm)),
                 "K3": all(torch.equal(a, b) for a, b in zip(
                     bam_bwd_dkv(*bargs), bam_bwd_dkv(*bargs, block_map=bm)))}
        t = {}
        for key, fn, a, kwk in (("K1", bam_flash_attention, fargs, kw),
                                ("K2", bam_bwd_dq, bargs, {}),
                                ("K3", bam_bwd_dkv, bargs, {})):
            t[key] = cuda_ms(torch, lambda: fn(*a, **kwk), iters=5)
            t[key + "c"] = cuda_ms(torch, lambda: fn(*a, block_map=bm, **kwk),
                                   iters=5)
        pairs = float(bam.allowed_mask(bits, bits, pos, pos).sum())
        row = dict(active_steps=active, dense_steps=bm.n_dense_steps,
                   skip_fraction=bm.skip_fraction, allowed_pairs=pairs,
                   equal=equal, ms=t)
        smoke.compact_layouts[mode] = row
        print(f"layout {mode} T={T} bf16: {active} of {bm.n_dense_steps} "
              f"tiles active (skip fraction {bm.skip_fraction:.3f}), mask "
              f"density {pairs / T / T:.3f}; dense / compacted ms: K1 "
              f"{t['K1']:.3f} / {t['K1c']:.3f}, K2 {t['K2']:.3f} / "
              f"{t['K2c']:.3f}, K3 {t['K3']:.3f} / {t['K3c']:.3f}",
              flush=True)
        smoke.check(all(equal.values()), f"layout {mode} T={T} bf16: "
                    f"compacted K1, K2, K3 torch.equal to dense: {equal}")


def compact_path(smoke: Smoke):
    """The path end to end: ``ops.bam_attention(impl="bam_kernel",
    block_map=bm)`` forward and ``torch.autograd.grad`` for q, k, v at the
    vlm layout in bf16. Launch counts are zeroed just before and read just
    after: K1c, K2c and K3c once each, no dense kernel. Output and
    gradients equal (torch.equal) the same call without a map."""
    torch = smoke.torch
    from repro_torch.core import bam
    from repro_torch.kernels import ops
    from repro_torch.kernels.bam_attention import BLOCK_K, BLOCK_Q

    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    H, Hkv, hd, T = 32, 8, 128, 1600
    bits_np, pos_np = bam.build_sample_bits(vlm_segments(T), T)
    bm = bam.build_block_map(bits_np, bits_np, pos_np, pos_np, BLOCK_Q,
                             BLOCK_K)
    bits = torch.from_numpy(bits_np).cuda()[None]
    pos = torch.from_numpy(pos_np).cuda()[None]
    q, g = (torch.randn((1, T, H, hd), generator=gen, device="cuda")
            .to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn((1, T, Hkv, hd), generator=gen, device="cuda")
            .to(torch.bfloat16) for _ in range(2))
    leaves = [x.requires_grad_() for x in (q, k, v)]

    def run(block_map):
        out = ops.bam_attention(*leaves, bits, bits, pos, pos,
                                impl="bam_kernel", block_map=block_map)
        return (out.detach(), *torch.autograd.grad(out, leaves, g))

    torch.cuda.synchronize()
    zero_counts()
    got = run(bm)
    torch.cuda.synchronize()
    counts = kernel_counts()
    want = dict.fromkeys(counts, 0)
    want.update(K1c=1, K2c=1, K3c=1)
    smoke.launches["compact"] = counts
    print("launches on the compact path (one forward and backward): "
          + ", ".join(f"{k} {n}" for k, n in counts.items()), flush=True)
    smoke.check(counts == want, "the block_map= op launched K1c, K2c, K3c "
                "once each and no dense kernel")
    dense = run(None)
    equal = [bool(torch.equal(a, b)) for a, b in zip(got, dense)]
    smoke.check(all(equal), f"block_map= op vs the same call without a map "
                f"(out, dq, dk, dv): torch.equal {equal}")


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
    plan_prefill_check(smoke, model, cfg, reqs[6], tokens[6], "bfloat16")
    return model, cfg, reqs


def plan_prefill_check(smoke: Smoke, model, cfg, req, want, dtype: str):
    """One multimodal request prefilled in a 4-rank LPT plan's layout
    (the serving side of context parallelism) against its plan-less run:
    its pages must be owned by the plan's 4 ranks, and at f32 its greedy
    tokens must be equal. The layout reorders K1's and K4's sums over
    keys, so in bf16 at full depth the tokens may part at a near-tie of
    these random weights: there the agreement is printed."""
    from repro_torch.parallel import plan_context
    from repro_torch.serving import ServingEngine
    eng = ServingEngine(model, cfg, num_pages=400, page_size=16,
                        max_batch=4, attn="kernel", device="cuda")
    plan = plan_context(req["bits"], req["positions"], 4, block_size=16)
    rid = eng.submit(**req, plan=plan)
    eng.step()
    owners = sorted(set(eng.table.page_owner.tolist()) - {-1})
    got = eng.run()[rid]
    lead = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                len(got))
    text = (f"{dtype} plan-layout prefill ({plan.method}, 4 ranks, imbalance "
            f"{plan.imbalance:.4f}) of a {len(req['tokens'])}-token "
            f"multimodal request, {cfg.num_layers} layers: {lead} of its "
            f"{len(got)} greedy tokens equal the plan-less run's before "
            f"the first difference; page owners {owners}")
    if dtype == "float32":
        smoke.check(got == want and owners == [0, 1, 2, 3], text)
    else:
        smoke.check(owners == [0, 1, 2, 3], text)


def prefill_profile(smoke: Smoke, model, cfg, reqs):
    """Device time of one engine step that prefills the longest prompt
    (and decodes its first token), with K1's share (torch.profiler)."""
    torch = smoke.torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving import ServingEngine
    req = max(reqs, key=lambda r: len(r["tokens"]))
    eng = ServingEngine(model, cfg, num_pages=400, page_size=16,
                        max_batch=4, attn="kernel", device="cuda")
    eng.submit(**req)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    evs = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in evs)
    print(f"prefill profile, one {len(req['tokens'])}-token prompt: wall "
          f"{wall_us / 1e3:.1f} ms, device busy {busy_us / 1e3:.1f} ms"
          + bam_shares(evs), flush=True)


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
    plan_prefill_check(smoke, m32, cfg32.replace(attn_impl="bam_kernel"),
                       reqs[6], got[6], "float32")
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
    # under remat each LLM block's forward runs again in the backward
    n_layers, remat = mllm.llm_cfg.num_layers, mllm.llm_cfg.remat
    want = 3 * n_layers
    want_k1 = want * (2 if remat else 1)
    smoke.check(k1 == want_k1 and k2 == k3 == want and k4 == 0,
                f"K1 launched {k1} times = {n_layers} layers x 3 steps x "
                f"{2 if remat else 1} (remat={remat}) = {want_k1}; K2, K3 "
                f"{k2}, {k3} times = {want}; K4 {k4} times")
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
              f"x{e.count}" for e in top) + bam_shares(evs), flush=True)
    # the same step without remat, for comparison within this run
    mllm.llm_cfg = mllm.llm_cfg.replace(remat=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = [fn.launches for fn in kernels]
    t0 = time.perf_counter()
    params, state, met = step(params, state, batches[0])
    float(met["loss"])
    ms_plain = (time.perf_counter() - t0) * 1e3
    peak_plain = torch.cuda.max_memory_allocated() / 2 ** 30
    k1_plain = kernels[0].launches - before[0]
    mllm.llm_cfg = mllm.llm_cfg.replace(remat=remat)
    print(f"train step without remat (for comparison): {ms_plain:.1f} ms, "
          f"peak memory {peak_plain:.2f} GiB, K1 launched {k1_plain} times",
          flush=True)
    smoke.check(k1_plain == n_layers, f"without remat K1 launched "
                f"{k1_plain} times = {n_layers} layers")
    smoke.train = dict(steps=steps, profile_busy_ms=busy_us / 1e3,
                       profile_wall_ms=wall_us / 1e3, remat=remat,
                       no_remat_step=dict(ms=ms_plain, peak_gib=peak_plain))


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


# ---------------------------------------------------------------------------
# Phases 7 and 8: the context-parallel train path
# ---------------------------------------------------------------------------

def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def cp_batches(torch, vocab: int, lay, n: int):
    """n batches of B = 1, T = 4096 on the CP layout's bits/positions
    (original order), tokens and labels from numpy seeds SEED, SEED+1, ..."""
    out = []
    for i in range(n):
        rng = np.random.default_rng(SEED + i)
        arrays = {"tokens": rng.integers(0, vocab, (1, CP_T)).astype(np.int32),
                  "labels": rng.integers(0, vocab, (1, CP_T)).astype(np.int32),
                  "positions": lay["pos"][None], "bits": lay["bits"][None],
                  "valid": lay["bits"][None] != 0}
        out.append({k: torch.from_numpy(a).cuda() for k, a in arrays.items()})
    return out


def cp_model(torch, cfg, seed: int):
    """A model from a seeded generator on the card, all parameters
    trainable."""
    from repro_torch.models import api
    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = api.init(cfg, device="cuda", generator=gen)
    model.requires_grad_(True)
    return model


def cp_step(cfg, lay, group, ocfg, method):
    """make_cp_train_step on the 4-rank plan; on a 1-rank group it warns
    that the balance is lost, which is expected here."""
    import warnings
    from repro_torch.training.steps import make_cp_train_step
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        step = make_cp_train_step(cfg, lay["layout"], group, ocfg,
                                  method=method)
    assert any("balanced for 4 ranks" in str(w.message) for w in caught)
    return step


def bam_shares(evs) -> str:
    """K1's, K2's and K3's device time in a profiled window (every
    bam_fwd, bam_bwd_dq and bam_bwd_dkv kernel; those that ran)."""
    out = ""
    for key, lib in (("K1", "bam_fwd"), ("K2", "bam_bwd_dq"),
                     ("K3", "bam_bwd_dkv")):
        ev = [e for e in evs if lib in e.key]
        if ev:
            ms = sum(e.self_device_time_total for e in ev) / 1e3
            out += f"; {key} ({lib}) {ms:.2f} ms x{sum(e.count for e in ev)}"
    return out


def profile_step(torch, step, model, state, batch, label: str):
    """One more step under torch.profiler: prints the wall time, the
    device busy share and the top kernels by device time; returns
    (busy ms, wall ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, _, met = step(model, state, batch)
        float(met["loss"])
        wall_us = (time.perf_counter() - t0) * 1e6
    evs = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in evs)
    top = sorted(evs, key=lambda e: -e.self_device_time_total)[:8]
    print(f"{label} profile, 1 step: wall {wall_us / 1e3:.1f} ms, device "
          f"busy {busy_us / 1e3:.1f} ms ({100 * busy_us / wall_us:.1f}% "
          f"busy); top kernels: " + "; ".join(
              f"{e.key[:48]} {e.self_device_time_total / 1e3:.2f} ms "
              f"x{e.count}" for e in top) + bam_shares(evs), flush=True)
    return busy_us / 1e3, wall_us / 1e3


def cp_phase(smoke: Smoke, group):
    """3 allgather and 3 ring CP steps of full-width qwen3-1.7b (28
    layers, bf16, T = 4096, all 1.72 B parameters trainable) on the
    world-size-1 NCCL group, with a 4-rank LPT plan applied to the
    sequence (a fourth allgather step under the profiler); then one
    unpermuted non-CP kernel-path step from the same weights."""
    torch = smoke.torch
    from repro_torch.configs.base import get_config
    from repro_torch.core.context_parallel import simulate_rank_workloads
    from repro_torch.core.distribution import PLANNERS
    from repro_torch.core.bam import block_workload
    from repro_torch.kernels.bam_attention import (
        bam_bwd_dkv, bam_bwd_dq, bam_flash_attention)
    from repro_torch.kernels.paged_decode import paged_decode_attention
    from repro_torch.optim import optimizer as opt
    from repro_torch.training.steps import make_train_step

    lay = cp_layout()
    plan = lay["plan"]
    W = block_workload(lay["bits"], lay["pos"], CP_BLOCK)
    zz = PLANNERS["zigzag"](W, CP_RANKS, CP_BLOCK)
    print(f"CP plan ({plan.method}, {CP_RANKS} ranks, block {CP_BLOCK}): "
          f"makespan {plan.makespan:.0f}, imbalance {plan.imbalance:.4f}; "
          f"simulated rank workloads (allowed pairs) lpt "
          f"{lay['loads'].tolist()} vs zigzag "
          f"{simulate_rank_workloads(zz, lay['bits'], lay['pos']).tolist()} "
          f"(makespan {zz.makespan:.0f}, imbalance {zz.imbalance:.4f})",
          flush=True)
    cfg = get_config("qwen3-1.7b").replace(attn_impl="bam_kernel")
    ocfg = opt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    batches = cp_batches(torch, cfg.vocab_size, lay, 3)
    def counts():
        return {"K1 stats": bam_flash_attention.stats_launches,
                "K2": bam_bwd_dq.launches, "K3": bam_bwd_dkv.launches,
                "K1": bam_flash_attention.launches,
                "K4": paged_decode_attention.launches}

    runs = {}
    bam_flash_attention.stats_launches = 0
    for fn in (bam_flash_attention, bam_bwd_dq, bam_bwd_dkv,
               paged_decode_attention):
        fn.launches = 0
    for method in ("allgather", "ring"):
        model = cp_model(torch, cfg, SEED)
        named = dict(model.named_parameters())
        state = opt.init(ocfg, named)
        step = cp_step(cfg, lay, group, ocfg, method)
        if method == "allgather":
            n = sum(p.numel() for p in named.values())
            print(f"{cfg.name}: {n / 1e9:.3f} B parameters, all trainable, "
                  f"bf16, {cfg.num_layers} layers, d {cfg.d_model}, "
                  f"{cfg.num_heads}/{cfg.num_kv_heads} heads of "
                  f"{cfg.head_dim}; CP group of "
                  f"{torch.distributed.get_world_size(group)} "
                  f"({torch.distributed.get_backend(group)})",
                  flush=True)
        runs[method] = []
        for i, batch in enumerate(batches):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = counts()
            t0 = time.perf_counter()
            model, state, met = step(model, state, batch)
            loss, gnorm = float(met["loss"]), float(met["grad_norm"])
            ms = (time.perf_counter() - t0) * 1e3
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            per = {k: v - before[k] for k, v in counts().items()}
            runs[method].append(dict(loss=loss, grad_norm=gnorm, ms=ms,
                                     peak_gib=peak, launches=per))
            print(f"CP {method} step {i}: loss {loss:.6f}, grad_norm "
                  f"{gnorm:.6f}, {ms:.1f} ms, peak memory {peak:.2f} GiB; "
                  f"launches " + ", ".join(f"{k} {v}" for k, v in
                                           per.items()), flush=True)
            # under remat each block's forward runs again in the backward
            L, fwd = cfg.num_layers, 2 if cfg.remat else 1
            smoke.check(per["K1 stats"] == L * fwd
                        and per["K2"] == per["K3"] == L
                        and per["K1"] == 0 and per["K4"] == 0
                        and np.isfinite(loss) and np.isfinite(gnorm),
                        f"CP {method} step {i}: K1 stats launched "
                        f"{per['K1 stats']} times ({L} layers x {fwd}, "
                        f"remat={cfg.remat}), K2, K3 {per['K2']}, "
                        f"{per['K3']} (one per layer = {L}), K1 residual "
                        f"{per['K1']}, K4 {per['K4']}; loss and grad_norm "
                        f"finite")
        if method == "allgather":
            busy_ms, wall_ms = profile_step(torch, step, model, state,
                                            batches[0], "CP allgather")
            # the same step without remat, for comparison within this run
            step_nr = cp_step(cfg.replace(remat=False), lay, group, ocfg,
                              method)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = counts()
            t0 = time.perf_counter()
            model, state, met = step_nr(model, state, batches[1])
            float(met["loss"])
            ms_nr = (time.perf_counter() - t0) * 1e3
            peak_nr = torch.cuda.max_memory_allocated() / 2 ** 30
            k1s_nr = counts()["K1 stats"] - before["K1 stats"]
            print(f"CP allgather step without remat (for comparison): "
                  f"{ms_nr:.1f} ms, peak memory {peak_nr:.2f} GiB, K1 "
                  f"stats launched {k1s_nr} times", flush=True)
            smoke.check(k1s_nr == cfg.num_layers, f"CP without remat: K1 "
                        f"stats launched {k1s_nr} times = "
                        f"{cfg.num_layers} layers")
            no_remat = dict(ms=ms_nr, peak_gib=peak_nr)
            del step_nr
        del model, state, named, step
        gc.collect()
        torch.cuda.empty_cache()
    total = {k: sum(r["launches"][k] for m in runs for r in runs[m])
             for k in counts()}
    smoke.launches["cp"] = {"K1s": total["K1 stats"], "K2": total["K2"],
                            "K3": total["K3"], "K1": total["K1"],
                            "K4": total["K4"]}
    print(f"launches on the CP path (3 allgather + 3 ring steps): "
          + ", ".join(f"{k} {v}" for k, v in total.items()), flush=True)

    # the unpermuted non-CP step on the kernel path, from the same weights
    model = cp_model(torch, cfg, SEED)
    state = opt.init(ocfg, dict(model.named_parameters()))
    _, _, met = make_train_step(cfg, ocfg)(model, state, batches[0])
    ref = (float(met["loss"]), float(met["grad_norm"]))
    del model, state
    gc.collect()
    torch.cuda.empty_cache()
    for method in ("allgather", "ring"):
        lc, gc_ = runs[method][0]["loss"], runs[method][0]["grad_norm"]
        rl, rg = abs(lc - ref[0]) / abs(ref[0]), abs(gc_ - ref[1]) / abs(ref[1])
        smoke.check(rl <= 2e-2 and rg <= 2e-2,
                    f"bf16 full width, step 0: CP {method} loss {lc:.6f} vs "
                    f"non-CP {ref[0]:.6f} (rel {rl:.2e}), grad_norm "
                    f"{gc_:.6f} vs {ref[1]:.6f} (rel {rg:.2e}); tol 2e-2")
    smoke.cp = dict(runs=runs, profile_busy_ms=busy_ms,
                    profile_wall_ms=wall_ms, non_cp_step0=ref,
                    remat=cfg.remat, no_remat_step=no_remat)


def cp_parity_phase(smoke: Smoke, group):
    """f32, full width, 2 layers: the CP step in plan layout (both
    methods; K1 stats, K2, K3) against the plain non-CP step
    (attn_impl="xla"), from the same weights and batches, 3 steps."""
    torch = smoke.torch
    from repro_torch.configs.base import get_config
    from repro_torch.optim import optimizer as opt
    from repro_torch.training.steps import make_train_step

    lay = cp_layout()
    cfg = get_config("qwen3-1.7b").replace(num_layers=2, dtype="float32")
    ocfg = opt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    batches = cp_batches(torch, cfg.vocab_size, lay, 3)
    runs = {}
    for name in ("allgather", "ring", "plain"):
        model = cp_model(torch, cfg, SEED + 8)
        state = opt.init(ocfg, dict(model.named_parameters()))
        step = make_train_step(cfg.replace(attn_impl="xla"), ocfg) \
            if name == "plain" else cp_step(
                cfg.replace(attn_impl="bam_kernel"), lay, group, ocfg, name)
        runs[name] = []
        for batch in batches:
            model, state, met = step(model, state, batch)
            runs[name].append((float(met["loss"]), float(met["grad_norm"])))
        del model, state
    for method in ("allgather", "ring"):
        for i, ((lc, gc_), (lp, gp)) in enumerate(zip(runs[method],
                                                       runs["plain"])):
            rl, rg = abs(lc - lp) / abs(lp), abs(gc_ - gp) / abs(gp)
            smoke.check(rl <= 1e-5 and rg <= 1e-4,
                        f"f32 2 layers full width, step {i}: CP {method} "
                        f"(kernels) loss {lc:.7f} vs plain non-CP {lp:.7f} "
                        f"(rel {rl:.2e}, tol 1e-5); grad_norm {gc_:.7f} vs "
                        f"{gp:.7f} (rel {rg:.2e}, tol 1e-4)")


def cp_phases(smoke: Smoke):
    """Phases 7 and 8 on a NCCL process group of world size 1 (NCCL
    refuses two ranks on one card), destroyed at the end."""
    torch = smoke.torch
    import torch.distributed as dist
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        group = dist.group.WORLD
        cp_phase(smoke, group)
        gc.collect()
        torch.cuda.empty_cache()
        cp_parity_phase(smoke, group)
    finally:
        dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {','.join(PHASES)}; "
                    f"the result line needs all of them")
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
    sass_check(smoke, _build)
    if "kernels" in phases:
        k1_cases(smoke)
        bwd_cases(smoke)
        bwd_more_cases(smoke)
        k4_cases(smoke)
        cp_kernel_cases(smoke)
    if "compact" in phases:
        compact_kernel_cases(smoke)
        compact_layouts(smoke)
        compact_path(smoke)
        gc.collect()
        torch.cuda.empty_cache()
    if "serving" in phases:
        model, cfg, reqs = serving_phase(smoke)
        prefill_profile(smoke, model, cfg, reqs)
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
        gc.collect()
        torch.cuda.empty_cache()
    if "cp" in phases:
        cp_phases(smoke)
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s after the "
          f"start of the build", flush=True)

    if smoke.failures:
        print(f"chip_smoke: {len(smoke.failures)} failure(s):",
              *smoke.failures, sep="\n  ", file=sys.stderr)
        return 1
    if phases != set(PHASES):
        print(f"chip_smoke: phases {sorted(phases)} passed; no result line "
              f"for a partial run")
        return 0
    # launches: each kernel's count on each path it is on (serving: K1,
    # K4; train: K1, K2, K3; cp: K1 stats, K2, K3; compact: K1c, K2c,
    # K3c); "launches" is the train path's for K1-K3, the CP path's for
    # K1 stats, the compact path's for K1c-K3c
    paths = smoke.launches
    for key in KERNEL_KEYS:
        by_path = {path: counts[key] for path, counts in paths.items()
                   if counts.get(key)}
        smoke.kernels[key]["launches_by_path"] = by_path
        smoke.kernels[key]["launches"] = next(
            (by_path[p] for p in ("train", "cp", "serving", "compact")
             if p in by_path), 0)
    for key, share in smoke.cp_share.items():
        smoke.kernels[key]["cp_share"] = share
    for key in ("K1c", "K2c", "K3c"):
        smoke.kernels[key]["layouts"] = {
            mode: {"active_steps": row["active_steps"],
                   "dense_steps": row["dense_steps"],
                   "skip_fraction": row["skip_fraction"],
                   "ms": row["ms"][key], "dense_ms": row["ms"][key[:2]],
                   "equal_to_dense": row["equal"][key[:2]]}
            for mode, row in smoke.compact_layouts.items()}
    print(json.dumps({"kernels": [smoke.kernels[k] for k in KERNEL_KEYS]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

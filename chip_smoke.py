#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU. Run from the root of the repository:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. Print the card's name and power limit; build both CUDA kernels from
   ``src/repro_torch/kernels/csrc`` with nvcc (in parallel) and print the
   build seconds and ptxas' register/spill report.
2. Hold each kernel against its plain PyTorch version on the card at the
   serving path's shapes: K1 (BAM prefill forward) on q [1,T,32,128],
   k/v [1,T,8,128], T in {512, 2000} causal and T = 2000 multimodal bits, bf16
   and f32, plus a softcap-50/window-256 case; K4 (paged decode) on a
   [P,16,8,128] page pool with 4 rows, one empty. Prints max abs error
   beside its tolerance, kernel/plain/library ms and the roofline bound.
3. Serve 8 requests (6 text, 2 multimodal, 32 new tokens each) through
   ``ServingEngine(attn="kernel")`` at the full width and depth of
   ``llm_config("M")`` (Llama-3.1-8B widths) in bf16, random weights from
   a seeded generator. Launch counts are zeroed just before and read
   just after: K1 must launch once per layer per request, K4 > 0.
   Then a torch.profiler window over 3 decode ticks of 4 rows prints the
   device busy share and the top kernels by device time.
4. End to end parity: at f32 with 2 layers (full width) the kernel
   engine and the plain engine emit identical greedy tokens; at bf16
   full depth, the two paths' last-row prefill logits are compared
   (difference beside the logits' std, token agreement printed).
5. Print a ``{"kernels": [...]}`` line, the nvidia-smi line, and, last,
   ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

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
    smoke.kernels["K1"]["launches"] = k1
    smoke.kernels["K4"]["launches"] = k4
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


def main() -> int:
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
    t0 = time.perf_counter()
    took = _build.build_all()
    print(f"built {sorted(took)} in {time.perf_counter() - t0:.1f} s "
          f"({ {k: round(v, 1) for k, v in took.items()} })", flush=True)
    for name in _build.KERNELS:
        for line in _build.ptxas_report(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    smoke = Smoke(torch)
    k1_cases(smoke)
    k4_cases(smoke)
    model, cfg, reqs = serving_phase(smoke)
    decode_profile(smoke, model, cfg, reqs)
    parity_phase(smoke, model, cfg, reqs)

    if smoke.failures:
        print(f"chip_smoke: {len(smoke.failures)} failure(s):",
              *smoke.failures, sep="\n  ", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": [smoke.kernels["K1"], smoke.kernels["K4"]]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

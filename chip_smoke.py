#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU. Run from the root of the repository:

    python3 chip_smoke.py                       # every phase
    python3 chip_smoke.py --phases kernels      # phases 1-2 only
    python3 chip_smoke.py --phases compact      # phases 1, 2b only
    python3 chip_smoke.py --phases kernels,cp   # phases 1-2, 7-8
    python3 chip_smoke.py --phases pp           # phases 1, 5b
    python3 chip_smoke.py --phases pp,spmd      # phases 1, 5b, 5c
    python3 chip_smoke.py --phases resilience   # phases 1, 5d
    python3 chip_smoke.py --phases dense        # phases 1, 4b
    python3 chip_smoke.py --phases moe,hybrid   # phases 1, 4c, 4d
    python3 chip_smoke.py --phases kernels,hybrid,gemma2  # 1-2c, 4d, 4g
    python3 chip_smoke.py --phases xlstm,whisper  # phases 1, 4e, 4f

Phases (any failure exits non-zero and prints no result line; the result
line is printed only when every phase ran and passed):

1. Print the card's name and power limit; build the four CUDA kernels
   from ``src/repro_torch/kernels/csrc`` with nvcc (in parallel) and print
   the build seconds and ptxas' register/spill report. Then the proof
   that K1, K2 and K3 run on the tensor cores: ``cuobjdump --dump-sass``
   of the built ``bam_fwd``, ``bam_bwd_dq`` and ``bam_bwd_dkv``
   libraries, ``HGMMA`` instructions counted per kernel instantiation
   and printed beside ptxas' registers and spills; a check per library
   fails unless each of its wgmma-body instantiations (bf16 at hd 64,
   80, 128 and 256, ``*_mma_kernel``: 16 of K1, 8 of K2, 8 of K3) has
   HGMMA and no spill, another unless it has no bf16 SIMT-body
   instantiation (bf16 K1-K3 run on the tensor cores at every head
   size), and another unless none of K4's 6 instantiations (hd 64, 128,
   256) spills.
2. Hold each kernel against its plain PyTorch version on the card at its
   main path's shapes, printing max abs error beside its tolerance,
   kernel/plain/library ms and the roofline bound:
   - K1 (BAM forward) on q [1,T,32,128], k/v [1,T,8,128], T in {512,
     2000} causal and T = 2000 multimodal, bf16 and f32, plus a
     softcap-50/window-256 case and a bf16 head_dim-64 case (T = 2000
     multimodal); and at qwen2-vl-7b's heads, q [1,2048,28,128] over k/v
     [1,2048,4,128] (a GQA group of 7), bf16 and f32, on the bits
     ``vlm.make_vlm_batch`` gives a 1024-patch image between two text
     runs;
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
   - K4 (paged decode), bf16 and f32, on [P,16,Hkv,hd] page pools: the
     smoke traffic's rows (text 1500, multimodal 672, text 700, one empty
     row; 32/8 heads of 128), a long context (rows of 8192, 4096, 1024
     and 17 tokens), 16 rows of 128-4096 tokens, softcap 50 / window 256,
     head_dim 64, GQA 1:1 (32/32) and 8:1 (64/8), head_dim 256 on a pool
     of gemma2-9b's shape (rows of 256-1024 text tokens, 8 KV heads, 2
     query heads each, softcap 50, window 4096 and 0): each within
     ``compare`` of its plain version, empty rows exactly 0, a second run
     torch.equal to the first; bf16 times (warm and cold L2, and with one
     split per row) beside SDPA over the gathered pages and the bound;
   - at the most loaded rank's share of a 4-rank LPT plan of
     ``random_multimodal_bits(4096, "ee", seed=0)`` (block 128) with
     qwen3-1.7b's widths (16 query, 8 KV heads of 128), bf16 and f32: K1
     stats on q [1,1024] against all 4096 keys (the allgather share) and
     against one 1024-key ring chunk with rows that see no key there
     (exactly m = -1e30, l = 0, acc = 0); the four chunks' stats combined
     against one K1 residual call; K2 and K3 at Tq 1024, Tk 4096.
2c. (part of ``kernels``) head sizes 80 and 256, K1, K2 and K3 on their
   wgmma bodies in bf16 (80 padded to 128), f32 on the SIMT ones:
   K1 (out, residual, stats), K1c (three modes), K2, K2c, K3 and K3c at
   gemma2-9b's heads (q [1,2048,16,256], k/v 8 heads, softcap 50, window
   4096) and zamba2-2.7b's (q [1,2048,32,80], k/v 32 heads), bf16 and
   f32, on ``lm_batch``'s bits (512 text, 1024 modality-1, 512 text):
   each within ``compare`` (``compare_stats``) of its plain version, the
   compacted grid torch.equal to the dense one, K3 bit-identical on a
   second run, ``kernel_body`` per kernel ("wgmma" in bf16, "simt" in
   f32); kernel, plain, SDPA and bound ms
   of each in both dtypes (K4 at 256 is one of phase 2's K4 cases). On
   CUDA tensors K1-K3 refuse head_dim 96 and K4 96, 80, and at
   256 more than 16 heads per KV head and 64-slot pages.
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
   (device busy share, K4's device time, top kernels by device time).
   One multimodal
   request is served again, prefilled in a 4-rank plan's layout: its
   pages are owned by the 4 ranks, and its agreement with the plan-less
   run is printed.
4. Serving parity: at f32 with 2 layers (full width) the kernel engine
   and the plain engine emit identical greedy tokens, and the request
   prefilled in the plan's layout emits its plan-less tokens; at bf16
   full depth, the two paths' last-row prefill logits are compared.
4b. ``dense``: qwen2-vl-7b (``configs/qwen2_vl_7b.py``, family vlm) at
   full width and depth in bf16 (7.6 B parameters), random weights from a
   seeded generator. ``training.steps.make_prefill`` over B = 2 rows of
   T = 2048 (512 text, a 1024-patch image of grid 1 x 32 x 32, 512 text;
   ``vlm.make_vlm_batch``'s bits and M-RoPE pos3) with
   attn_impl="bam_kernel" (counts zeroed just before and read just
   after: K1 exactly 28 launches, one per layer, and no other kernel),
   "xla", and "xla" with ``attn_q_chunk`` 512: ms and peak memory of
   each; the chunked logits within ``compare`` of the unchunked; the
   kernel path's last-position logits no further from the f32 forward
   of the same weights than ``DENSE_BF16_FACTOR`` times the plain
   path's. Then ``make_serve_step`` on the strip cache (B = 2, a 64-token
   text prompt fed token by token, then 32 greedy tokens, pos3
   carried): ms per tick, the cache's bytes, no kernel launched (K4
   and K1 0). Then f32 at 2 layers, full width: kernel prefill against
   plain, chunked against unchunked, and ``decode_step`` token by token
   against the forward on a 64-token text prompt, each within 1e-4 of
   max |logit|.
4c. ``moe``: deepseek-moe-16b (``configs/deepseek_moe_16b.py``, family
   moe) at full width and depth in bf16 (16.4 B parameters), random
   weights from a seeded generator, the capacity dispatch and
   attn_impl="bam_kernel". K1 at its head layout (16/16 heads of 128,
   T 2048, bf16 and f32) within ``compare`` of its plain version, times
   beside the bound and SDPA; K2 and K3 at the same layout on the
   prefill's bits, bf16 and f32, within ``compare``. ``make_prefill``
   over B 1 x T 2048 (text 512, a modality-1 stream of 1024, text 512):
   counts zeroed just before and read just after, K1 exactly 28
   launches (the dense layer and 27 MoE layers) and no other kernel;
   kernel and plain ms, peak memory and the share of routed (token, k)
   pairs the capacity rule drops (forward hooks on the MoE layers). The
   strip-cache serve loop of phase 4b (B 2, 64 prompt tokens, 32 greedy;
   no kernel). At depth 2 in bf16, against an f32 forward of the same
   weights: the MoE layer's input on the kernel path within
   ``DENSE_BF16_FACTOR`` x the plain path's distance; the last-position
   logits' distance under the capacity and the dense dispatch and the
   routing decisions that differ from f32's, printed; f32 kernel against
   plain within ``DENSE_F32_REL``. f32 at depth 2: one AdamW step on the
   kernel path (K1, K2, K3) and one on the plain path from the same
   weights, loss, grad_norm and parameters within ``DENSE_F32_REL``. At
   depth 3 (the dense layer and two MoE layers, every parameter
   trainable) 2 AdamW steps of ``make_train_step`` in bf16: per step K1
   3 (6 under remat), K2 3, K3 3; ms, losses, the aux loss, peak memory;
   the router moved. Then qwen2-moe-a2.7b at full width, depth 4: one
   prefill (K1 4 launches), its 60 experts stacked as 64.
4d. ``hybrid``: zamba2-2.7b (``configs/zamba2_2_7b.py``, family hybrid)
   at full width and depth in bf16 (2.42 B parameters): ``make_prefill``
   over B 1 x T 2048 with multimodal bits on attn_impl="bam_kernel"
   (counts zeroed just before and read just after: K1 exactly 9
   launches, one per shared-block call at head_dim 80, on its wgmma
   body, and no other kernel) and on the plain path, ms and peak, both last-position
   logits against an f32 forward of the same weights
   (``DENSE_BF16_FACTOR``); the serve loop of phase 4b (plain, no
   kernel); one Mamba2 block at full width in f32, the chunked SSD over
   512 tokens against the block stepped token by token; one f32 AdamW
   step at depth 12 (two shared-block calls) on the kernel path (K1, K2
   and K3 at 80) and on the plain path from the same weights, loss,
   grad_norm and parameters within ``DENSE_F32_REL``; one bf16 AdamW step
   at depth 12 on the kernel path (K1-K3 on their wgmma bodies at 80)
   from the same draws, counts zeroed just before and read just after
   (K1 2 x 2 under remat, K2 2, K3 2), loss and grad_norm finite, the
   loss within ``HYB_BF16_REL`` of the f32 step's.
4g. ``gemma2``: gemma2-9b (``configs/gemma2_9b.py``, head_dim 256) at
   full width and depth in bf16 (9.24 B parameters): (a) 4 text requests
   of 256-1024 tokens served through ``ServingEngine(attn="kernel")``
   with 33 new tokens each (the prefill plain: the local/global
   alternation; K4 once a layer a decode tick with the layer's own
   window, and no other kernel), against ``attn="xla"`` by the serving
   parity rule (f32 at 2 layers identical greedy tokens; bf16 full depth
   agreement printed); (b) the all-local variant
   (``long_context_variant``) prefilled over B 1 x T 2048 with
   multimodal bits through K1 (42 launches, its wgmma body at 256) and
   on the plain path, both against an f32 forward of the same weights; (c) one f32 AdamW step at
   depth 2 of the all-local variant through K1-K3 (softcap 50) against
   the plain step within ``DENSE_F32_REL``; (d) 2 bf16 AdamW steps at
   depth 4, every parameter trainable (K1 once a layer, twice under
   remat, K2 and K3 once a layer), finite losses.
4e. ``xlstm``: xlstm-125m (``configs/xlstm_125m.py``, family ssm) at
   full width and depth in bf16 (no attention, no kernel):
   ``make_prefill`` over B 2 x T 2048 (32 mLSTM chunks of 64, 2048 sLSTM
   steps): ms, peak and a profiled busy share; the serve loop, 64 greedy
   ticks at B 2 (ms a tick); in f32 one full-width mLSTM layer's chunked
   form against the parallel one at T 2048 (within ``XL_MLSTM_REL`` of
   max |h|) and 16 tokens fed one by one through ``decode_step``
   against the forward's logits (|d| <= 2e-3 (1 + |l|), the reference's
   ``test_decode_matches_forward`` rule); 2 AdamW steps of
   ``make_train_step`` at B 1 x T 2048, every parameter trainable (ms,
   peak, finite losses); ``make_cp_train_step``'s refusal on a
   world-size-1 gloo group. Launch counts are zeroed before and read
   after each path: every count must be 0.
4f. ``whisper``: whisper-base (``configs/whisper_base.py``, family audio)
   at full width and depth in bf16 (6 + 6 layers, plain attention, no
   kernel): the forward over B 4 with 1500 encoder frames and 448
   decoder tokens (ms, peak); ``prefill_cross``, then 64 greedy ticks at
   B 4 (ms a tick); in f32 16 decode ticks against the forward's logits
   (the same rule); 2 AdamW steps at B 4 x 448 (ms, peak, finite
   losses). Every launch count 0 after each path.
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
5b. ``pp``: frozen-aware pipeline parallelism replayed on the card. The
   full-width vlm of phase 5 (bf16, remat on, attn_impl="bam_kernel",
   weights from a seeded generator) is planned by ``parallelize`` for 4
   pipeline devices (4 microbatches of 1, text_len 1024), the plan is
   printed (``describe``) and applied (``mode="replay"``), and one batch
   of 4 is replayed through ``execute_schedule`` over
   ``build_mllm_stages``. Launch counts are zeroed just before and read
   just after: K1, K2 and K3 must launch as often as
   ``pp_expected_launches`` derives from the plan and ``cfg.remat``. The
   measured peak activations per simulated device must equal the
   simulated ones; loss/M and the projector gradient/M must agree with
   ``make_mllm_train_step``'s on the same batch (bf16 tolerances
   ``PP_BF16_*``); frozen weights stay bit-identical with no ``.grad``.
   Replay and single-step ms, a profiled replay's busy share and K1-K3
   device time, and peak memory are printed beside the card's line.
   Then f32 parity at 2 + 2 layers (full width) for the searched plan
   and an ft1 plan (trainable LLM) pinned to ZB-H1, whose W items run as
   separate autograd passes (``PP_F32_*``, the JAX replay test's
   tolerances); and the launcher, ``repro_torch.launch.train.main`` with
   ``--mllm vlm --steps 2 --seq 1024 --batch 4 --microbatches 4
   --plan-devices 4`` at full width: finite losses.
5c. ``spmd``: the distributed schedule runner (``parallel.spmd``), one
   process per pipeline rank. The pp phase's model, weights, batch and
   plan (interleaved v=4 on 2 pipeline ranks) with ``apply(mode="spmd")``:
   the schedule lint must find no error (waves and fwd/bwd rounds
   printed). Then 2 rank processes on the one card (NCCL refuses two
   ranks on one card, so gloo, each handoff staged through pinned host
   memory) each keep their own stages and run the wave program once,
   counts zeroed just before and read just after in each: summed over
   the ranks K1, K2 and K3 launch as ``pp_expected_launches`` derives.
   Loss/M within ``SPMD_LOSS_RTOL`` of the pp replay's (bit-equality
   printed), the projector gradient/M within ``SPMD_GRAD_RTOL``
   (relative Frobenius). Each rank then takes one
   ``make_spmd_train_step`` step (AdamW ``SPMD_OCFG``) on the same
   batch: its global gradient norm and the projector's change within
   ``SPMD_GRAD_RTOL`` of the same AdamW step on the pp replay's
   gradients (bit-equality printed), optimizer state only for the
   trained weights, and after it the frozen weights bit-identical with
   no ``.grad``. Each rank's measured peak activations equal to the
   simulated ones,
   and ``validate_schedule_memory(executor="spmd")`` passes on every
   rank. Step ms (2 processes time-slicing one card: no pipeline
   speed), each rank's peak memory and the host-staged bytes per step
   are printed beside the card's line. Last, ``launch.train --spmd`` at
   the launcher phase's arguments spawns its own 2 ranks: its 2 losses
   within ``SPMD_LOSS_RTOL`` of the replay launcher's. Then
   ``ModalityIslands`` on cuda:0: the reduced valm's two encoders each
   on its own CUDA stream, the LLM on the default one, logits within
   1e-5 of max |logit| of ``mllm.forward`` at f32. ``--phases spmd``
   runs the pp phase too.
5d. ``resilience``: the training runtime at full width and depth (the
   train phase's vlm, bf16, remat on, attn_impl="bam_kernel", batches of
   ``PP_BATCH`` at text 1024, seed 0), checkpoints under the checkout's
   ignored ``build/resilience`` (free space checked first with
   ``shutil.disk_usage``: the phase fails, with the numbers, where it is
   short). An uninterrupted run of 4 guarded steps
   (``make_resilient_train_step`` under a ``ResilientTrainer``), launch
   counts zeroed just before and read just after: K1, K2 and K3 per
   step as the train step's (K1 2 x 32 under remat, K2 and K3 32); plain
   and guarded steps in turns, their ms printed (the guard's cost). The
   same run from the same seed under a ``CheckpointManager`` saving
   every 2 steps, crashed by a ``crash`` fault before step 3, then
   ``resume=True`` to step 4: the losses before the crash and after the
   resume bit-equal to the uninterrupted run's (the step that diverged
   and the largest difference printed otherwise); the first save's
   bytes and seconds, the later save's (every frozen shard hardlinked
   forward, only the projector, its moments, AdamW's step, the EMA and
   the placeholders written), the verified loads' seconds. Two
   ``nan_grads`` faults under ``skip_limit=1``: the first is skipped
   (every parameter, moment and the EMA ``torch.equal`` after it), the
   second rolls back to the step-4 checkpoint and the run goes on.
   Then 2 rank processes on the one card over gloo adopt the replay
   checkpoint of step 4 (each loads its stages' layers) and take the
   spmd step 4 under the pp phase's plan: its loss within
   ``SPMD_LOSS_RTOL`` of the single process's. Last, with the LLM cut
   to ``RES_SPMD_LLM_LAYERS`` layers (full width), 2 ranks save one
   checkpoint together every 2 steps and crash before step 3
   (``CrashInjected`` must reach the caller of ``spawn_ranks``); 2 new
   ranks resume it: step 2's loss bit-equal to the crashed run's.
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
8b. gemma2-9b's CP step on the same group: full width, depth
   ``GEMMA_TRAIN_LAYERS`` (local and global layers alternating), bf16,
   one allgather step in the CP layout (counts zeroed just before and
   read just after: K1 stats once a layer, twice under remat, on its
   wgmma body at head_dim 256, K2 and K3 once a layer, nothing else)
   against the plain non-CP step from the same weights and batch (loss
   and grad_norm within rel 2e-2).
9. Print a ``{"kernels": [...]}`` line, the nvidia-smi line, and, last,
   ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

PHASES = ("kernels", "compact", "serving", "dense", "moe", "hybrid",
          "gemma2", "xlstm", "whisper", "train", "pp", "spmd", "resilience",
          "cp")
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
        self.head_dims = {}

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


# the libraries whose bf16 instantiations run on the tensor cores (the
# wgmma bodies, "_mma_kernel"): (kernel, wgmma-body instantiations, bf16
# SIMT-body instantiations). K1 (stats x compact x hd 64, 80, 128, 256),
# K2 and K3 (compact x the four hds) run every bf16 size on wgmma, so no
# bf16 SIMT body may be built
SASS_LIBS = {"bam_fwd": ("K1", 16, 0), "bam_bwd_dq": ("K2", 8, 0),
             "bam_bwd_dkv": ("K3", 8, 0)}


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
    beside ptxas' registers and spills. Every wgmma-body instantiation of
    K1 (16: hd 64, 80, 128, 256), K2 and K3 (8 each: the four hds) must
    hold HGMMA and spill nothing, and none of the three libraries may
    hold a bf16 SIMT-body instantiation."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    for lib, (key, want, want_simt) in SASS_LIBS.items():
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
        mma, simt = [], []
        for fn, count in sorted(hgmma.items()):
            regs, st, ld = ptxas.get(fn, (-1, -1, -1))
            print(f"  {lib} SASS {short_name(fn)}: {count} HGMMA, {regs} "
                  f"registers, spill stores {st} B, loads {ld} B",
                  flush=True)
            if "_mma_kernel" in fn:
                mma.append(count > 0 and st == 0 and ld == 0)
            elif "__nv_bfloat16" in fn:
                simt.append(count == 0)
        smoke.check(len(mma) == want and all(mma),
                    f"{key} SASS: {sum(mma)} of {len(mma)} wgmma-body "
                    f"instantiations (bf16; want {want}) hold HGMMA and "
                    f"spill nothing")
        smoke.check(len(simt) == want_simt and all(simt),
                    f"{key} SASS: {len(simt)} bf16 SIMT-body "
                    f"instantiations (want {want_simt}), none with HGMMA")


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


def vlm_image_bits(torch, T: int, d_model: int = 8):
    """(bits, positions) [1, T] on the card that ``vlm.make_vlm_batch``
    gives a 1024-patch image (grid 1 x 32 x 32) between two text runs of
    (T - 1024) / 2 tokens."""
    from repro_torch.models import vlm
    tokens = torch.zeros((1, T), dtype=torch.int32, device="cuda")
    patches = torch.zeros((1, 1024, d_model), device="cuda")
    b = vlm.make_vlm_batch(tokens, patches, (T - 1024) // 2, (1, 32, 32),
                           d_model)
    return b["bits"].contiguous(), b["positions"].contiguous()


def k1_gqa7_cases(smoke: Smoke):
    """K1 at qwen2-vl-7b's head layout, 28 query heads over 4 KV heads (a
    group of 7), q [1,2048,28,128], k/v [1,2048,4,128], bf16 and f32, on
    the bits of a 1024-patch image between two text runs: within
    ``compare`` of its plain version, with times, bound and SDPA beside
    it (bf16)."""
    k1_head_layout_cases(smoke, 28, 4, "gqa7")


def k1_head_layout_cases(smoke: Smoke, H: int, Hkv: int, key: str):
    """K1 at H query heads over Hkv KV heads of 128, T 2048, bf16 and
    f32, on the vlm image bits: within ``compare`` of its plain version;
    the bf16 times, bound and SDPA's time go under
    ``smoke.kernels["K1"][key]``."""
    torch = smoke.torch
    import torch.nn.functional as F
    from repro_torch.core import bam
    from repro_torch.kernels.bam_attention import (
        bam_flash_attention, bam_flash_attention_torch)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    T, hd = 2048, 128
    bits, pos = vlm_image_bits(torch, T)
    for dt in ("bfloat16", "float32"):
        dtype = getattr(torch, dt)
        q = torch.randn((1, T, H, hd), generator=gen, device="cuda").to(dtype)
        k = torch.randn((1, T, Hkv, hd), generator=gen, device="cuda").to(dtype)
        v = torch.randn((1, T, Hkv, hd), generator=gen, device="cuda").to(dtype)
        args = (q, k, v, bits, bits, pos, pos)
        kw = dict(return_mode="residual")
        out, lse = bam_flash_attention(*args, **kw)
        torch.cuda.synchronize()
        out_p, lse_p = bam_flash_attention_torch(*args, **kw)
        err, ratio = compare(out, out_p, dt)
        err_lse = float((lse - lse_p).abs().max())
        name = (f"K1 {H}/{Hkv} heads (group {H // Hkv}) T={T} vlm image "
                f"{dt}")
        smoke.check(ratio <= 1.0 and err_lse <= 1e-3,
                    f"{name}: max_abs_err out {err:.3e} (tol {TOL_TEXT[dt]}; "
                    f"worst |d|/tol {ratio:.3f}), lse {err_lse:.3e} "
                    f"(tol 1e-3)")
        if dt != "bfloat16":
            continue
        ms = cuda_ms(torch, lambda: bam_flash_attention(*args, **kw))
        plain_ms = cuda_ms(torch, lambda: bam_flash_attention_torch(*args, **kw),
                           iters=3)
        mask = bam.allowed_mask(bits, bits, pos, pos)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lib_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask[:, None], enable_gqa=True))
        pairs = float(mask.sum())
        flops = 4.0 * hd * H * pairs
        nbytes = sum(t.numel() * t.element_size()
                     for t in (q, k, v, out, lse, bits, bits, pos, pos))
        b_ms, b_by = bound(flops, nbytes, dt)
        print(f"{name}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, SDPA "
              f"with bool mask {lib_ms:.3f} ms, bound {b_ms:.4f} ms "
              f"({b_by}); mask density {pairs / T / T:.3f}, "
              f"{flops / ms / 1e9:.1f} TFLOP/s [{smoke.smi}]", flush=True)
        smoke.kernels.setdefault("K1", {})[key] = {
            "shape": f"q[1,{T},{H},{hd}] kv[1,{T},{Hkv},{hd}] {dt} vlm image",
            "max_abs_err": err, "worst_err_over_tol": ratio, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms}


def vlm_segments(T: int):
    """The vlm ``default_layout`` at merged length T as build_sample_bits
    segments: text split around the 576-token modality-1 stream."""
    from repro_torch.models.mllm import build_paper_mllm
    mllm = build_paper_mllm("vlm")
    enc = mllm.encoders["vision"]
    return [("text", 0, seg[1]) if seg[0] == "text"
            else ("mod", enc.modality_id, enc.num_tokens)
            for seg in mllm.default_layout(T - enc.num_tokens)]


def bwd_check(smoke: Smoke, gen, q_shape, Hkv: int, bits, pos, dt: str,
              name: str, **kw) -> dict:
    """K2 and K3 (run twice: bit-identical) against their plain versions
    from the same (out, lse, delta) K1 gives, on q/dO [B,T,H,hd] and K/V
    [B,T,Hkv,hd] drawn from ``gen`` in ``dt``; each within ``compare``.
    Returns the arguments, the kernels' outputs and the errors."""
    torch = smoke.torch
    from repro_torch.kernels.bam_attention import (
        bam_bwd_dkv, bam_bwd_dkv_torch, bam_bwd_dq, bam_bwd_dq_torch,
        bam_flash_attention, bwd_delta)

    dtype = getattr(torch, dt)
    B, T, H, hd = q_shape
    q, do = (torch.randn(q_shape, generator=gen, device="cuda").to(dtype)
             for _ in range(2))
    k, v = (torch.randn((B, T, Hkv, hd), generator=gen,
                        device="cuda").to(dtype) for _ in range(2))
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
    smoke.check(r_dq <= 1.0, f"K2 {name}: max_abs_err dq {e_dq:.3e} "
                f"(tol {TOL_TEXT[dt]}; worst |d|/tol {r_dq:.3f})")
    smoke.check(r_dk <= 1.0 and r_dv <= 1.0 and same,
                f"K3 {name}: max_abs_err dk {e_dk:.3e} (worst |d|/tol "
                f"{r_dk:.3f}), dv {e_dv:.3e} (worst {r_dv:.3f}), tol "
                f"{TOL_TEXT[dt]}; second run bit-identical: {same}")
    return {"args": args, "dq": dq, "dk": dk,
            "errors": (e_dq, r_dq, e_dk, r_dk, e_dv, r_dv)}


def bwd_cases(smoke: Smoke):
    """K2 and K3 against their plain versions from the same (out, lse,
    delta) K1 gives, at the train path's shapes."""
    torch = smoke.torch
    import torch.nn.functional as F
    from repro_torch.core import bam
    from repro_torch.kernels.bam_attention import (
        bam_bwd_dkv, bam_bwd_dkv_torch, bam_bwd_dq, bam_bwd_dq_torch)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    H, Hkv, hd = 32, 8, 128
    cases = [(T, dt, cap, win) for T, cap, win in
             ((1600, 0.0, 0), (1600, 50.0, 256), (1000, 0.0, 0))
             for dt in ("bfloat16", "float32")]
    headline = (1600, "bfloat16", 0.0, 0)
    for T, dt, softcap, window in cases:
        bits_np, pos_np = bam.build_sample_bits(vlm_segments(T), T)
        bits = torch.from_numpy(bits_np).cuda()[None]
        pos = torch.from_numpy(pos_np).cuda()[None]
        kw = dict(softcap=softcap, window=window)
        name = f"T={T} vlm layout {dt} softcap={softcap} window={window}"
        c = bwd_check(smoke, gen, (1, T, H, hd), Hkv, bits, pos, dt, name,
                      **kw)
        args, dq, dk = c["args"], c["dq"], c["dk"]
        q, k, v, do, lse, delta = args[:6]
        e_dq, r_dq, e_dk, r_dk, e_dv, r_dv = c["errors"]
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


GEMMA_ROWS = (256, 512, 768, 1024)   # gemma2-9b's requests' text tokens
SMOKE_ROWS = [[("text", 0, 1500)],
              [("text", 0, 32), ("mod", 1, 576), ("text", 0, 64)],
              [("text", 0, 700)]]


def decode_fixture(torch, dtype, layouts=SMOKE_ROWS, q_bits=None,
                   page_size=16, Hkv=8, hd=128):
    """A page pool holding one request per layout, its query token written
    into the pool before attention runs, plus an empty row for each
    ``q_bits`` entry past the layouts. Default: the smoke traffic's rows
    (text 1500, multimodal 32+576+64 with a query attending modality 1,
    text 700) and one empty row. The grid is built without a window, as
    the serving engine builds it when layers' windows differ."""
    from repro_torch.core import bam
    from repro_torch.serving.paged_cache import PageTable, build_decode_grid
    if q_bits is None:
        q_bits = [bam.text_token(), bam.text_token((1,)), bam.text_token(), 0]
    P = 1 + sum(-(-sum(s[2] for s in segs) // page_size) + 1
                for segs in layouts)
    table = PageTable(P, page_size)
    q_pos = []
    for rid, segs in enumerate(layouts):
        n = sum(s[2] for s in segs)
        bits, pos = bam.build_sample_bits(segs, n)
        table.alloc(rid, n + 1)
        table.write(rid, np.arange(n + 1), np.append(bits, q_bits[rid]),
                    np.append(pos, n))
        q_pos.append(n)
    q_pos += [0] * (len(q_bits) - len(layouts))
    rids = list(range(len(layouts))) + [None] * (len(q_bits) - len(layouts))
    grid = build_decode_grid(table, rids, q_bits, q_pos)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    shape = (P, page_size, Hkv, hd)
    k = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    v = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    return (table, grid, k, v,
            torch.tensor(q_bits, dtype=torch.int32, device="cuda")[:, None],
            torch.tensor(q_pos, dtype=torch.int32, device="cuda")[:, None])


def cuda_graph_ms(torch, fn, iters: int = 20, reps: int = 5) -> float:
    """Mean device time of fn() replayed from a CUDA graph of ``iters``
    calls, so that the host's cost per call stays out of it (a call with
    a few µs of device work costs the host more than that)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def cuda_ms_cold(torch, fn, iters: int = 20) -> float:
    """Mean device time of fn() with the L2 cache flushed before each call
    (a 128 MB read, which leaves no dirty line behind), as a decode tick
    finds each layer's pages."""
    flush = torch.zeros(1 << 27, dtype=torch.uint8, device="cuda")
    fn()
    evs = [(torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for start, end in evs:
        flush.max()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in evs) / iters


def k4_build_check(smoke: Smoke, _build) -> None:
    """ptxas' registers and spills for every K4 instantiation (f32 and
    bf16 at hd 64, 128 and 256): none may spill."""
    ptxas = {fn: v for fn, v in ptxas_by_function(
        _build.ptxas_report("paged_decode")).items()
        if "paged_decode_kernel" in fn}
    for fn, (regs, st, ld) in sorted(ptxas.items()):
        dtype = "bf16" if "__nv_bfloat16" in fn else "f32"
        hd = re.search(r"Li(\d+)E", fn)
        print(f"  paged_decode_kernel<{dtype}, hd "
              f"{hd.group(1) if hd else '?'}>: {regs} registers, spill "
              f"stores {st} B, loads {ld} B", flush=True)
    smoke.check(len(ptxas) == 6 and all(st == 0 and ld == 0 for _, st, ld
                                        in ptxas.values()),
                f"K4 build: {len(ptxas)} of 6 instantiations, none spills")


def k4_cases(smoke: Smoke):
    """K4 against its plain version, bf16 and f32, in every case: the
    smoke traffic's rows (with an empty row); a long context (rows of
    8192, 4096, 1024 and 17 tokens); a batch of 16 rows of 128-4096
    tokens; softcap 50 / window 256; head_dim 64; GQA 1:1 (32/32 heads)
    and 8:1 (64/8); head_dim 256 on a pool of gemma2-9b's shape (rows of
    ``GEMMA_ROWS`` text tokens, 8 KV heads, 2 query heads each, softcap
    50, window 4096 and 0; plain ms too). Empty rows must be exactly 0,
    a second run torch.equal to the first, and the steps' ticket
    counters 0 again. bf16 cases print kernel, SDPA over the gathered
    pages and bound ms with GB/s: kernel and SDPA replayed from
    CUDA graphs (device time; also the kernel called back to back from
    the host, and with a cold L2), and the kernel with one split per row
    (no split over the SMs)."""
    torch = smoke.torch
    import torch.nn.functional as F
    from repro_torch.core import bam
    from repro_torch.kernels.paged_decode import (
        decode_steps, paged_decode_attention, paged_decode_torch, split_rows)

    text = bam.text_token()
    long_rows = [[("text", 0, n)] for n in (8192, 4096, 1024, 17)]
    batch_rows = [[("text", 0, 128 + (4096 - 128) * i // 15)]
                  for i in range(16)]
    # (name, layouts, q bits or None, H, Hkv, hd, softcap, window)
    cases = [("smoke rows", SMOKE_ROWS, None, 32, 8, 128, 0.0, 0),
             ("long context", long_rows, [text] * 4, 32, 8, 128, 0.0, 0),
             ("16 rows", batch_rows, [text] * 16, 32, 8, 128, 0.0, 0),
             ("softcap 50 window 256", SMOKE_ROWS, None, 32, 8, 128, 50.0,
              256),
             ("hd 64", SMOKE_ROWS, None, 32, 8, 64, 0.0, 0),
             ("GQA 1:1", SMOKE_ROWS, None, 32, 32, 128, 0.0, 0),
             ("GQA 8:1", SMOKE_ROWS, None, 64, 8, 128, 0.0, 0)]
    gemma_rows = [[("text", 0, n)] for n in GEMMA_ROWS]
    cases += [(f"hd 256 (gemma2-9b pool) window {w}", gemma_rows,
               [text] * len(gemma_rows), 16, 8, 256, 50.0, w)
              for w in (4096, 0)]
    for case, layouts, qbits, H, Hkv, hd, softcap, window in cases:
        for dt in ("bfloat16", "float32"):
            dtype = getattr(torch, dt)
            table, grid, kp, vp, qb, qp = decode_fixture(
                torch, dtype, layouts, qbits, Hkv=Hkv, hd=hd)
            B = qb.shape[0]
            gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
            q = torch.randn((B, H, hd), generator=gen,
                            device="cuda").to(dtype)
            kvb = torch.from_numpy(table.bits).cuda()
            kvp = torch.from_numpy(table.pos).cuda()
            steps = decode_steps(grid.arrays(), B, "cuda", kv_heads=Hkv,
                                 page_size=kp.shape[1])
            args = (q, kp, vp, qb, qp, kvb, kvp, steps)
            kw = dict(softcap=softcap, window=window)
            out = paged_decode_attention(*args, **kw)
            again = paged_decode_attention(*args, **kw)
            torch.cuda.synchronize()
            out_p = paged_decode_torch(*args, **kw)
            err, ratio = compare(out, out_p, dt)
            empty = steps.empty.long()
            zeros = bool((out[empty] == 0).all())
            same = torch.equal(out, again)
            reset = not bool(steps.tickets.any())
            name = (f"K4 {case}: B={B} H={H} Hkv={Hkv} hd={hd} pool "
                    f"{tuple(kp.shape)} {dt}, {steps.splits.shape[0]} "
                    f"splits")
            smoke.check(ratio <= 1.0 and zeros and same and reset,
                        f"{name}: max_abs_err {err:.3e} (tol {TOL_TEXT[dt]}; "
                        f"worst |d|/tol {ratio:.3f}), {empty.numel()} empty "
                        f"rows exactly 0: {zeros}, second run torch.equal: "
                        f"{same}, ticket counters back to 0: {reset}")
            if dt != "bfloat16":
                continue
            ms = cuda_graph_ms(
                torch, lambda: paged_decode_attention(*args, **kw))
            call_ms = cuda_ms(
                torch, lambda: paged_decode_attention(*args, **kw), iters=50)
            cold_ms = cuda_ms_cold(
                torch, lambda: paged_decode_attention(*args, **kw))
            row_ptr = steps.row_ptr.cpu().numpy().astype(np.int64)
            split_ptr, splits = split_rows(
                row_ptr, max(1, int(np.diff(row_ptr).max())))
            one = dataclasses.replace(
                steps, split_ptr=torch.from_numpy(split_ptr).cuda(),
                splits=torch.from_numpy(splits).cuda())
            one_ms = cuda_graph_ms(torch, lambda: paged_decode_attention(
                q, kp, vp, qb, qp, kvb, kvp, one, **kw))
            # yardstick: SDPA over the rows' pages gathered dense, bool mask
            live = range(len(layouts))
            mp = max(len(table.pages_of(r)) for r in live)
            pt = torch.from_numpy(np.stack(
                [table.page_table_row(r, mp) for r in live]
                + [np.zeros(mp, np.int32)] * (B - len(layouts)))).cuda().long()
            kd = kp[pt].reshape(B, -1, Hkv, hd).transpose(1, 2)
            vd = vp[pt].reshape(B, -1, Hkv, hd).transpose(1, 2)
            mask = bam.allowed_mask(qb, kvb[pt].reshape(B, -1), qp,
                                    kvp[pt].reshape(B, -1), window)[:, None]
            keys = float(mask.sum())
            mask[empty] = True          # SDPA has no empty-row convention
            qd = q[:, :, None]
            lib_ms = cuda_graph_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    qd, kd, vd, attn_mask=mask, enable_gqa=True))
            n_pages = int(steps.pages.numel())
            ps = kp.shape[1]
            page_bytes = ps * Hkv * hd * kp.element_size()
            steps_bytes = sum(t.numel() * 4 for t in (
                steps.pages, steps.split_ptr, steps.splits, steps.empty,
                steps.tickets))
            nbytes = (2 * n_pages * page_bytes + 2 * q.numel()
                      * q.element_size() + n_pages * ps * 8 + steps_bytes)
            b_ms, b_by = bound(4.0 * hd * H * keys, nbytes, dt)
            print(f"{name}: kernel {ms:.4f} ms ({nbytes / ms / 1e6:.1f} "
                  f"GB/s; {call_ms:.4f} ms a call back to back from the "
                  f"host), cold L2 {cold_ms:.4f} ms "
                  f"({nbytes / cold_ms / 1e6:.1f} GB/s), one split per row "
                  f"{one_ms:.4f} ms, SDPA on gathered pages {lib_ms:.4f} ms, "
                  f"bound {b_ms:.5f} ms ({b_by}); {n_pages} active pages, "
                  f"{nbytes / 1e6:.2f} MB", flush=True)
            row = dict(ms=ms, host_paced_ms=call_ms, cold_l2_ms=cold_ms,
                       one_split_per_row_ms=one_ms, library_ms=lib_ms,
                       bound_ms=b_ms, bound_by=b_by)
            if case == "long context":
                smoke.kernels["K4"]["long_context"] = dict(
                    row, shape=f"q[{B},{H},{hd}] pages{tuple(kp.shape)} "
                    f"rows 8192/4096/1024/17 {dt}")
            if hd == 256:
                plain_ms = cuda_ms(
                    torch, lambda: paged_decode_torch(*args, **kw), iters=3)
                print(f"{name}: plain {plain_ms:.3f} ms", flush=True)
                smoke.head_dims.setdefault("K4", {}).setdefault(
                    "hd256", {})[f"window {window}"] = dict(
                    row, max_abs_err=err, worst_err_over_tol=ratio,
                    plain_ms=plain_ms, shape=f"q[{B},{H},{hd}] pages"
                    f"{tuple(kp.shape)} {dt} rows "
                    f"{'/'.join(map(str, GEMMA_ROWS))}")
            if case != "smoke rows":
                continue
            plain_ms = cuda_ms(torch, lambda: paged_decode_torch(*args, **kw),
                               iters=5)
            smoke.kernels["K4"] = dict(
                name="paged_decode (K4, paged BAM flash decode)",
                route="cuda",
                source="src/repro_torch/kernels/csrc/paged_decode.cu",
                replaces="src/repro/kernels/paged_decode.py:138",
                max_abs_err=err, tolerance=TOL_TEXT[dt],
                worst_err_over_tol=ratio, plain_ms=plain_ms,
                shape=f"q[{B},{H},{hd}] pages{tuple(kp.shape)} {dt}", **row)


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


# ---------------------------------------------------------------------------
# Phase 2c: head sizes 80 and 256 (K1, K2 and K3 on wgmma in bf16; K4
# at 256)
# ---------------------------------------------------------------------------

HD_T = 2048
# (model, query heads, KV heads, head_dim, softcap, window): the head
# layouts of gemma2-9b's all-local variant and of zamba2-2.7b's shared block
HD_CASES = (("gemma2-9b", 16, 8, 256, 50.0, 4096),
            ("zamba2-2.7b", 32, 32, 80, 0.0, 0))


def head_dim_cases(smoke: Smoke):
    """K1 (out, residual, stats), K1c (three modes), K2, K2c, K3 and K3c
    at ``HD_CASES``' head layouts, bf16 and f32, T ``HD_T`` on
    ``mm_bits``: each within ``compare`` (stats: ``compare_stats``) of its
    plain version, the compacted grid (a map built at the kernels' tile
    for the case's window) torch.equal to the dense one, K3 bit-identical
    on a second run, ``kernel_body`` naming the body that serves each
    call: "wgmma" in bf16, "simt" in f32.
    Times of every kernel (kernel, plain, SDPA or its backward, bound) in
    both dtypes. Then the refusals (``head_dim_refusals``); K4 at 256 is
    one of ``k4_cases``."""
    torch = smoke.torch
    from repro_torch.core import bam
    from repro_torch.kernels.bam_attention import (
        BLOCK_K, BLOCK_Q, RETURN_MODES, bam_bwd_dkv, bam_bwd_dkv_torch,
        bam_bwd_dq, bam_bwd_dq_torch, bam_flash_attention,
        bam_flash_attention_torch, bwd_delta, kernel_body)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    bits_np, pos_np = mm_bits(HD_T)
    bits, pos = (torch.from_numpy(a).cuda()[None] for a in (bits_np, pos_np))
    smoke.head_dims = {}
    for model, H, Hkv, hd, softcap, window in HD_CASES:
        bm = bam.build_block_map(bits_np, bits_np, pos_np, pos_np, BLOCK_Q,
                                 BLOCK_K, window)
        mask = bam.allowed_mask(bits, bits, pos, pos, window)   # [1,T,T]
        for dt in ("bfloat16", "float32"):
            dtype = getattr(torch, dt)
            bodies = {kk: kernel_body(hd, dtype, kk)
                      for kk in ("K1", "K2", "K3")}
            tc = "wgmma" if dt == "bfloat16" else "simt"
            want = {"K1": tc, "K2": tc, "K3": tc}
            q, do = (torch.randn((1, HD_T, H, hd), generator=gen,
                                 device="cuda").to(dtype) for _ in range(2))
            k, v = (torch.randn((1, HD_T, Hkv, hd), generator=gen,
                                device="cuda").to(dtype) for _ in range(2))
            fargs = (q, k, v, bits, bits, pos, pos)
            kw = dict(softcap=softcap, window=window)
            name = (f"hd {hd} ({model}: {H}/{Hkv} heads) T={HD_T} text/"
                    f"modality-1/text {dt} softcap={softcap} "
                    f"window={window}")
            errs = {}
            for mode in RETURN_MODES:
                dense = bam_flash_attention(*fargs, return_mode=mode, **kw)
                comp = bam_flash_attention(*fargs, return_mode=mode,
                                           block_map=bm, **kw)
                torch.cuda.synchronize()
                for key, got, bmap in (("K1", dense, None),
                                       ("K1c", comp, bm)):
                    plain = bam_flash_attention_torch(
                        *fargs, return_mode=mode, block_map=bmap, **kw)
                    if mode == "stats":
                        err, ratio = compare_stats(got, plain, dt)
                        err_lse = 0.0
                    else:
                        err, ratio = compare(as_tuple(got)[0],
                                             as_tuple(plain)[0], dt)
                        err_lse = (float((got[1] - plain[1]).abs().max())
                                   if mode == "residual" else 0.0)
                    equal = all(torch.equal(a, b) for a, b in
                                zip(as_tuple(got), as_tuple(dense)))
                    label = "K1s" if key == "K1" and mode == "stats" else key
                    errs[(label, mode)] = (err, ratio)
                    smoke.check(ratio <= 1.0 and err_lse <= 1e-3 and equal
                                and bodies["K1"] == want["K1"],
                                f"{key} {mode} {name}, {bodies['K1']} body "
                                f"(want {want['K1']}): max_abs_err "
                                f"{err:.3e} (tol {TOL_TEXT[dt]}; worst "
                                f"|d|/tol {ratio:.3f}), lse {err_lse:.3e} "
                                f"(tol 1e-3); torch.equal to the dense K1: "
                                f"{equal}")
                    del plain
                del dense, comp
            out, lse = bam_flash_attention(*fargs, return_mode="residual",
                                           **kw)
            delta = bwd_delta(out, do)
            bargs = (q, k, v, do, lse, delta, bits, bits, pos, pos)
            dq = bam_bwd_dq(*bargs, **kw)
            dk, dv = bam_bwd_dkv(*bargs, **kw)
            dk2, dv2 = bam_bwd_dkv(*bargs, **kw)
            dqc = bam_bwd_dq(*bargs, block_map=bm, **kw)
            dkc, dvc = bam_bwd_dkv(*bargs, block_map=bm, **kw)
            torch.cuda.synchronize()
            same = bool(torch.equal(dk, dk2) and torch.equal(dv, dv2))
            for key, got, bmap, eq in (
                    ("K2", (dq,), None, True),
                    ("K2c", (dqc,), bm, bool(torch.equal(dqc, dq))),
                    ("K3", (dk, dv), None, same),
                    ("K3c", (dkc, dvc), bm, bool(torch.equal(dkc, dk)
                                                 and torch.equal(dvc, dv)))):
                fn = bam_bwd_dq_torch if key[:2] == "K2" else \
                    bam_bwd_dkv_torch
                plain = as_tuple(fn(*bargs, block_map=bmap, **kw))
                pairs = [compare(a, b, dt) for a, b in zip(got, plain)]
                err = max(e for e, _ in pairs)
                ratio = max(r for _, r in pairs)
                errs[(key, None)] = (err, ratio)
                what = ("second run bit-identical" if key == "K3" else
                        "torch.equal to the dense kernel")
                body = bodies[key[:2]]
                smoke.check(ratio <= 1.0 and eq and body == want[key[:2]],
                            f"{key} {name}, {body} body (want "
                            f"{want[key[:2]]}): max_abs_err {err:.3e} (tol "
                            f"{TOL_TEXT[dt]}; worst |d|/tol {ratio:.3f}); "
                            f"{what}: {eq}")
                del plain
            del dq, dk, dv, dk2, dv2, dqc, dkc, dvc
            head_dim_times(smoke, bm, mask, fargs, bargs, errs, kw,
                           f"q[1,{HD_T},{H},{hd}] kv[1,{HD_T},{Hkv},{hd}] "
                           f"{dt} text/modality-1/text softcap {softcap} "
                           f"window {window} ({model})", bodies)
            del q, k, v, do, out, lse, delta, fargs, bargs
            gc.collect()
            torch.cuda.empty_cache()
    head_dim_refusals(smoke)


def head_dim_times(smoke: Smoke, bm, mask, fargs, bargs, errs, kw,
                   shape: str, bodies: dict) -> None:
    """Kernel, plain, SDPA (boolean mask; its backward for K2 and K3) and
    bound ms of K1 (residual), K1 stats, K1c (residual), K2, K2c, K3 and
    K3c at one head-size case; the rows go under
    ``smoke.head_dims[key]["hd<N>"][dtype]``. Bound: K1 2, K2 3, K3 4
    products of 2·hd·H FLOPs per allowed pair (inside the map's tiles
    for the compacted grid) against the dtype's peak, and the inputs and
    outputs once against HBM."""
    torch = smoke.torch
    import torch.nn.functional as F
    from repro_torch.core import bam
    from repro_torch.kernels.bam_attention import (
        bam_bwd_dkv, bam_bwd_dkv_torch, bam_bwd_dq, bam_bwd_dq_torch,
        bam_flash_attention, bam_flash_attention_torch)
    q, k, v = fargs[:3]
    B, T, H, hd = q.shape
    Hkv = k.shape[2]
    do, lse = bargs[3], bargs[4]
    dt = str(q.dtype).split(".")[-1]
    tiles = bam.tile_mask(bm, T, T, q.device)
    pairs = {False: float(mask.sum()), True: float((mask & tiles).sum())}
    csr = bam.block_csr(bm, q.device)
    map_bytes = {"q": (csr.q_ptr.numel() + csr.q_cols.numel()) * 4,
                 "k": (csr.k_ptr.numel() + csr.k_rows.numel()) * 4}
    def nb(*ts):
        return sum(t.numel() * t.element_size() for t in ts)
    small = nb(*fargs[3:])
    io, row = nb(q, k, v), nb(lse)
    res = dict(return_mode="residual", **kw)
    st = dict(return_mode="stats", **kw)
    # key: (kernel call, plain call, compacted, products, bytes)
    calls = {
        "K1": (lambda: bam_flash_attention(*fargs, **res),
               lambda: bam_flash_attention_torch(*fargs, **res), False, 2,
               io + small + nb(q) + row),
        "K1s": (lambda: bam_flash_attention(*fargs, **st),
                lambda: bam_flash_attention_torch(*fargs, **st), False, 2,
                io + small + 4 * q.numel() + 2 * row),
        "K1c": (lambda: bam_flash_attention(*fargs, block_map=bm, **res),
                lambda: bam_flash_attention_torch(*fargs, block_map=bm,
                                                  **res), True, 2,
                io + small + nb(q) + row + map_bytes["q"]),
        "K2": (lambda: bam_bwd_dq(*bargs, **kw),
               lambda: bam_bwd_dq_torch(*bargs, **kw), False, 3,
               io + nb(do) + small + 2 * row + nb(q)),
        "K2c": (lambda: bam_bwd_dq(*bargs, block_map=bm, **kw),
                lambda: bam_bwd_dq_torch(*bargs, block_map=bm, **kw), True, 3,
                io + nb(do) + small + 2 * row + nb(q) + map_bytes["q"]),
        "K3": (lambda: bam_bwd_dkv(*bargs, **kw),
               lambda: bam_bwd_dkv_torch(*bargs, **kw), False, 4,
               io + nb(do) + small + 2 * row + 2 * nb(k)),
        "K3c": (lambda: bam_bwd_dkv(*bargs, block_map=bm, **kw),
                lambda: bam_bwd_dkv_torch(*bargs, block_map=bm, **kw), True,
                4, io + nb(do) + small + 2 * row + 2 * nb(k)
                + map_bytes["k"])}
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    fwd_lib = {c: cuda_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=m[:, None], enable_gqa=True))
        for c, m in ((False, mask), (True, mask & tiles))}
    n_rep = H // Hkv
    bwd_lib = {}
    for c, m in ((False, mask), (True, mask & tiles)):
        qt_l = qt.detach().requires_grad_()
        kt_l, vt_l = (x.repeat_interleave(n_rep, dim=1).detach()
                      .requires_grad_() for x in (kt, vt))
        out_l = F.scaled_dot_product_attention(qt_l, kt_l, vt_l,
                                               attn_mask=m[:, None])
        g_l = do.transpose(1, 2)
        bwd_lib[c] = (cuda_ms(torch, lambda: torch.autograd.grad(
            out_l, (qt_l,), g_l, retain_graph=True)),
            cuda_ms(torch, lambda: torch.autograd.grad(
                out_l, (kt_l, vt_l), g_l, retain_graph=True)))
        del out_l, qt_l, kt_l, vt_l
    for key, (fn, plain_fn, comp, nprod, nbytes) in calls.items():
        ms = cuda_ms(torch, fn, iters=5, warmup=1)
        plain = cuda_ms(torch, plain_fn, iters=2, warmup=1)
        lib = (fwd_lib[comp] if key.startswith("K1") else
               bwd_lib[comp][0 if key.startswith("K2") else 1])
        flops = nprod * 2.0 * hd * H * pairs[comp]
        b_ms, b_by = bound(flops, nbytes, dt)
        err = max(e for (kk, _), (e, _r) in errs.items() if kk == key)
        ratio = max(r for (kk, _), (_e, r) in errs.items() if kk == key)
        sdpa = "SDPA" if key.startswith("K1") else "SDPA backward"
        body = bodies[key[:2]]
        print(f"{key} {shape}: {body} body, kernel {ms:.3f} ms, plain "
              f"{plain:.3f} ms, {sdpa} with bool mask {lib:.3f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}); {flops / ms / 1e9:.1f} TFLOP/s "
              f"[{smoke.smi}]", flush=True)
        smoke.head_dims.setdefault(key, {}).setdefault(f"hd{hd}", {})[dt] = {
            "shape": shape, "body": body, "max_abs_err": err,
            "worst_err_over_tol": ratio, "ms": ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib}


def head_dim_refusals(smoke: Smoke):
    """On CUDA tensors: K1, K2 and K3 refuse head_dim 96 and K4 96 and
    80 with the wrappers' ``ValueError``, K4 refuses more than 16 query
    heads per KV head and 64-slot pages at 256; none launches."""
    torch = smoke.torch
    from repro_torch.core import bam
    from repro_torch.kernels.bam_attention import (
        bam_bwd_dkv, bam_bwd_dq, bam_flash_attention)
    from repro_torch.kernels.paged_decode import (decode_steps,
                                                  paged_decode_attention)

    def raises(fn) -> str:
        try:
            fn()
        except ValueError as e:
            return str(e)
        return ""

    zero_counts()
    T, H = 64, 4
    bits = torch.full((1, T), bam.text_token(), dtype=torch.int32,
                      device="cuda")
    pos = torch.arange(T, dtype=torch.int32, device="cuda")[None]
    q = torch.randn((1, T, H, 96), device="cuda", dtype=torch.bfloat16)
    lse = torch.zeros((1, H, T), device="cuda")
    bargs = (q, q, q, q, lse, lse, bits, bits, pos, pos)
    got = {"K1": raises(lambda: bam_flash_attention(q, q, q, bits, bits, pos,
                                                    pos)),
           "K2": raises(lambda: bam_bwd_dq(*bargs)),
           "K3": raises(lambda: bam_bwd_dkv(*bargs))}
    for hd, rep, ps, dt in ((96, 2, 16, torch.bfloat16),
                            (80, 2, 16, torch.bfloat16),
                            (256, 32, 16, torch.float32),
                            (256, 2, 64, torch.bfloat16)):
        Hkv, P = 2, 4
        kp = torch.zeros((P, ps, Hkv, hd), device="cuda", dtype=dt)
        meta = torch.zeros((P, ps), dtype=torch.int32, device="cuda")
        qd = torch.zeros((1, Hkv * rep, hd), device="cuda", dtype=dt)
        one = torch.zeros((1, 1), dtype=torch.int32, device="cuda")
        steps = decode_steps(
            (np.zeros(1), np.ones(1), np.zeros(1), np.zeros(1), np.ones(1)),
            1, "cuda", kv_heads=Hkv, page_size=ps)
        got[f"K4 hd {hd}, {rep} heads a KV head, {ps}-slot pages, {dt}"] = \
            raises(lambda: paged_decode_attention(qd, kp, kp, one, one, meta,
                                                  meta, steps))
    counts = kernel_counts()
    smoke.check(all(got.values()) and not any(counts.values()),
                "refusals on CUDA tensors: " + "; ".join(
                    f"{k}: {v or 'NOT REFUSED'}" for k, v in got.items())
                + f"; launches {counts}")


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
    # every kernel of K4's library (csrc/paged_decode.cu)
    k4 = [e for e in kernels if "paged_decode" in e.key]
    k4_us = sum(e.self_device_time_total for e in k4)
    print(f"decode profile, 3 ticks x 4 rows: wall {wall_us / 3e3:.2f} "
          f"ms/tick, device busy {busy_us / 3e3:.2f} ms/tick "
          f"({100 * busy_us / wall_us:.1f}% busy); K4 {k4_us / 3e3:.3f} "
          f"ms/tick x{sum(e.count for e in k4) // 3}; top kernels: "
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
# Phase 4b: the dense family (qwen2-vl-7b prefill and strip-cache decode)
# ---------------------------------------------------------------------------

DENSE_B, DENSE_T, DENSE_PROMPT, DENSE_NEW = 2, 2048, 64, 32
DENSE_CHUNK = 512
# bf16 through 28 layers: the kernel path's last-position logits may be
# no further from the f32 forward of the same bf16 weights than the plain
# bf16 path's are, up to this factor
DENSE_BF16_FACTOR = 2.0
DENSE_F32_REL = 1e-4          # f32: |d| <= 1e-4 max |logit|


def dense_batch(torch, cfg, gen, dtype):
    """B = 2 rows of T = 2048: text, a 1024-patch image (grid 1 x 32 x
    32, random patch embeddings of the embedding table's scale), text;
    ``vlm.make_vlm_batch``'s bits, positions and M-RoPE pos3."""
    from repro_torch.models import vlm
    tokens = torch.randint(0, cfg.vocab_size, (DENSE_B, DENSE_T),
                           generator=gen, device="cuda", dtype=torch.int32)
    patches = (torch.randn((DENSE_B, 1024, cfg.d_model), generator=gen,
                           device="cuda") * 0.02).to(dtype)
    return vlm.make_vlm_batch(tokens, patches, (DENSE_T - 1024) // 2,
                              (1, 32, 32), cfg.d_model)


def text_feeds(torch, tokens):
    """One-token decode batches of a text prompt [B, n]: positions and
    pos3 (three equal streams) carried."""
    B = tokens.shape[0]
    for t in range(tokens.shape[1]):
        p = torch.full((B, 1), t, dtype=torch.int32, device="cuda")
        yield {"tokens": tokens[:, t:t + 1], "positions": p,
               "pos3": p[None].expand(3, B, 1)}


def rel_err(a, b):
    """max |a - b| / max |b| in f32."""
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.abs().max())


def dense_phase(smoke: Smoke):
    """qwen2-vl-7b at full width and depth, bf16, weights from a seeded
    generator: the prefill (K1 on every layer), the plain and q-chunked
    prefills, their logits against an f32 forward of the same weights;
    f32 parity at 2 layers; the strip-cache serve loop."""
    torch = smoke.torch
    from repro_torch.configs.base import get_config
    from repro_torch.models import api
    from repro_torch.training import steps

    cfg = get_config("qwen2-vl-7b").replace(attn_impl="bam_kernel")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    t0 = time.perf_counter()
    model = api.init(cfg, device="cuda", generator=gen)
    torch.cuda.synchronize()
    print(f"{cfg.name}: {cfg.param_count() / 1e9:.3f} B parameters ("
          f"{cfg.num_layers} layers, d {cfg.d_model}, {cfg.num_heads}/"
          f"{cfg.num_kv_heads} heads of {cfg.head_dim}, M-RoPE "
          f"{cfg.mm.mrope_sections}), bf16, init "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    batch = dense_batch(torch, cfg, gen, torch.bfloat16)

    variants = {"kernel": cfg, "plain": cfg.replace(attn_impl="xla"),
                f"plain q-chunked {DENSE_CHUNK}": cfg.replace(
                    attn_impl="xla", attn_q_chunk=DENSE_CHUNK)}
    logits, times = {}, {}
    for name, c in variants.items():
        prefill = steps.make_prefill(c)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        logits[name] = prefill(model, batch)
        torch.cuda.synchronize()
        counts = kernel_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        if name == "kernel":
            smoke.launches["dense"] = dict(counts)
            others = {k: n for k, n in counts.items() if k != "K1" and n}
            smoke.check(counts["K1"] == cfg.num_layers and not others,
                        f"K1 launched {counts['K1']} times in one bf16 "
                        f"prefill = {cfg.num_layers} layers; other kernels "
                        f"{others or 0}")
        ms = cuda_ms(torch, lambda: prefill(model, batch), iters=3, warmup=1)
        times[name] = (ms, peak)
    n_text = (DENSE_T - 1024) // 2
    print(f"{cfg.name} prefill through make_prefill, B {DENSE_B} x T "
          f"{DENSE_T} ({n_text} text, 1024 image patches, {n_text} text): "
          + ", ".join(f"{n} {ms:.1f} ms (peak {pk:.2f} GiB)"
                      for n, (ms, pk) in times.items())
          + f" [{smoke.smi}]", flush=True)
    lk, lx = logits["kernel"], logits["plain"]
    lc = logits[f"plain q-chunked {DENSE_CHUNK}"]
    smoke.check(all(bool(torch.isfinite(v).all()) for v in logits.values())
                and lk.shape == (DENSE_B, 1, cfg.vocab_size),
                f"bf16 prefill logits finite, shape {tuple(lk.shape)}")
    err, ratio = compare(lc, lx, "bfloat16")
    smoke.check(ratio <= 1.0, f"bf16 q-chunked ({DENSE_CHUNK}) plain "
                f"prefill vs unchunked: max |d| {err:.3e}, worst |d|/tol "
                f"{ratio:.3f} ({TOL_TEXT['bfloat16']})")

    ek, ex = against_f32(
        smoke, model, cfg,
        dict(batch, inputs_embeds=batch["inputs_embeds"].float()), lk, lx)
    smoke.dense = {"prefill": {n: {"ms": ms, "peak_gib": pk}
                               for n, (ms, pk) in times.items()},
                   "bf16_err_kernel": ek, "bf16_err_plain": ex}

    dense_serve(smoke, model, cfg)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    dense_f32_parity(smoke, cfg)


def against_f32(smoke: Smoke, model, cfg, batch, lk, lx):
    """The dense phase's rule: the kernel prefill's last-position logits
    ``lk`` no further from an f32 forward of the same (bf16-valued)
    weights than ``DENSE_BF16_FACTOR`` times the plain prefill's ``lx``.
    Returns (kernel's max |d|, plain's)."""
    torch = smoke.torch
    from repro_torch.models import api
    from repro_torch.training import steps

    m32 = api.init(cfg.replace(dtype="float32"), device="meta").to_empty(
        device="cuda")
    m32.load_state_dict(model.state_dict())
    l32 = steps.make_prefill(cfg.replace(dtype="float32", attn_impl="xla"))(
        m32, batch)
    del m32
    gc.collect()
    torch.cuda.empty_cache()
    ek, ex = (float((v.float() - l32).abs().max()) for v in (lk, lx))
    agree = int((lk[:, -1].argmax(-1) == lx[:, -1].argmax(-1)).sum())
    smoke.check(ek <= DENSE_BF16_FACTOR * ex,
                f"{cfg.name} bf16 full depth, last-position logits against "
                f"the f32 forward of the same weights: kernel max |d| "
                f"{ek:.4f}, plain {ex:.4f} (kernel <= {DENSE_BF16_FACTOR} x "
                f"plain); kernel vs plain {float((lk - lx).abs().max()):.4f},"
                f" f32 logits max |l| {float(l32.abs().max()):.3f}; argmax "
                f"agreement {agree}/{lk.shape[0]}")
    return ek, ex


def tree_bytes(tree) -> int:
    """Bytes of the tensors in a (nested) dict."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def dense_serve(smoke: Smoke, model, cfg, into=None):
    """``make_serve_step`` on the strip cache: a 64-token text prompt
    fed token by token, then 32 greedy tokens, B = 2, pos3 carried. Launch
    counts zeroed just before and read just after: no kernel launches
    (the strip-cache decode is the plain path, as in JAX). The numbers go
    under ``into["serve"]`` (default ``smoke.dense``)."""
    torch = smoke.torch
    from repro_torch.models import api
    from repro_torch.training import steps

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    prompt = torch.randint(0, cfg.vocab_size, (DENSE_B, DENSE_PROMPT),
                           generator=gen, device="cuda", dtype=torch.int32)
    cache = api.init_cache(cfg, DENSE_B, DENSE_PROMPT + DENSE_NEW,
                           device="cuda")
    cache_bytes = tree_bytes(cache)
    serve = steps.make_serve_step(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    for b in text_feeds(torch, prompt):
        tok, cache = serve(model, cache, b)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = []
    for t in range(DENSE_PROMPT, DENSE_PROMPT + DENSE_NEW):
        p = torch.full((DENSE_B, 1), t, dtype=torch.int32, device="cuda")
        out.append(tok)
        tok, cache = serve(model, cache, {"tokens": tok[:, None],
                                          "positions": p,
                                          "pos3": p[None].expand(3, DENSE_B,
                                                                 1)})
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = kernel_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    gen_toks = torch.stack(out, 1)
    prompt_ms = (t1 - t0) * 1e3 / DENSE_PROMPT
    tick_ms = (t2 - t1) * 1e3 / DENSE_NEW
    print(f"{cfg.name} strip-cache serve, B {DENSE_B}, cache "
          f"{DENSE_PROMPT + DENSE_NEW} slots ({cache_bytes} bytes): prompt "
          f"{prompt_ms:.2f} ms/tick over {DENSE_PROMPT}, greedy "
          f"{tick_ms:.2f} ms/tick over {DENSE_NEW}, peak memory "
          f"{peak:.2f} GiB; launches {counts} [{smoke.smi}]", flush=True)
    smoke.check(not any(counts.values()),
                f"no kernel launched on the strip-cache decode path "
                f"(K1 {counts['K1']}, K4 {counts['K4']})")
    smoke.check(gen_toks.shape == (DENSE_B, DENSE_NEW)
                and bool(((gen_toks >= 0) & (gen_toks < cfg.vocab_size))
                         .all()),
                f"serve loop generated {DENSE_NEW} in-vocab tokens a row")
    (smoke.dense if into is None else into)["serve"] = {
        "prompt_ms_per_tick": prompt_ms, "ms_per_tick": tick_ms,
        "cache_bytes": cache_bytes, "peak_gib": peak}


def dense_f32_parity(smoke: Smoke, cfg):
    """f32, 2 layers, full width: the kernel prefill against the plain
    one, the q-chunked against the unchunked, and decode_step fed a
    64-token text prompt token by token against the forward, each within
    ``DENSE_F32_REL`` of max |logit|."""
    torch = smoke.torch
    from repro_torch.models import api
    from repro_torch.training import steps

    c32 = cfg.replace(num_layers=2, dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    m32 = api.init(c32, device="cuda", generator=gen)
    batch = dense_batch(torch, c32, gen, torch.float32)
    zero_counts()
    lk = steps.make_prefill(c32)(m32, batch)
    k1 = kernel_counts()["K1"]
    lx = steps.make_prefill(c32.replace(attn_impl="xla"))(m32, batch)
    lc = steps.make_prefill(c32.replace(attn_impl="xla",
                                        attn_q_chunk=DENSE_CHUNK))(m32, batch)
    for what, got, want in (("kernel vs plain", lk, lx),
                            (f"q-chunked ({DENSE_CHUNK}) vs unchunked", lc,
                             lx)):
        r = rel_err(got, want)
        smoke.check(r <= DENSE_F32_REL and k1 == c32.num_layers,
                    f"f32 {cfg.name} 2 layers, full width, T {DENSE_T}: "
                    f"{what} last-position logits max |d| / max |l| "
                    f"{r:.2e} (tol {DENSE_F32_REL}); K1 {k1} launches")

    prompt = torch.randint(0, c32.vocab_size, (DENSE_B, DENSE_PROMPT),
                           generator=gen, device="cuda", dtype=torch.int32)
    pos = torch.arange(DENSE_PROMPT, dtype=torch.int32,
                       device="cuda")[None].expand(DENSE_B, DENSE_PROMPT)
    with torch.no_grad():
        full, _ = api.forward(m32, c32, {"tokens": prompt, "positions": pos,
                                         "pos3": pos[None].expand(3, -1, -1)})
        cache = api.init_cache(c32, DENSE_B, DENSE_PROMPT, device="cuda")
        got = []
        for b in text_feeds(torch, prompt):
            logits, cache = api.decode_step(m32, c32, cache, b)
            got.append(logits[:, 0])
    r = rel_err(torch.stack(got, 1), full)
    smoke.check(r <= DENSE_F32_REL,
                f"f32 {cfg.name} 2 layers: decode_step over a "
                f"{DENSE_PROMPT}-token text prompt vs the forward, max |d| / "
                f"max |l| {r:.2e} (tol {DENSE_F32_REL})")


# ---------------------------------------------------------------------------
# Phase 4c: the MoE family (deepseek-moe-16b, qwen2-moe-a2.7b)
# ---------------------------------------------------------------------------

MOE_T = 2048
MOE_TRAIN_LAYERS, MOE_TRAIN_STEPS = 3, 2
QWEN_MOE_LAYERS = 4


def full_config(name: str):
    """The registered config at full width and depth."""
    from repro_torch.configs.base import get_config
    return get_config(name)


def mm_bits(T: int):
    """(bits, positions) of T tokens, numpy int32: text T/4, a modality-1
    stream of T/2, text T/4 (``bam.build_sample_bits``)."""
    from repro_torch.core import bam
    n = T // 4
    return bam.build_sample_bits(
        [("text", 0, n), ("mod", 1, T - 2 * n), ("text", 0, n)], T)


def lm_batch(torch, cfg, gen, B: int = 1, T: int = MOE_T):
    """B rows of T tokens on the card with ``mm_bits``' layout, random
    tokens and labels."""
    bits, pos = mm_bits(T)

    def rows(a):
        return torch.as_tensor(a, dtype=torch.int32,
                               device="cuda")[None].expand(B, T).contiguous()

    def draw():
        return torch.randint(0, cfg.vocab_size, (B, T), generator=gen,
                             device="cuda", dtype=torch.int32)
    return {"tokens": draw(), "labels": draw(), "positions": rows(pos),
            "bits": rows(bits)}


@contextlib.contextmanager
def moe_routing(torch, model, inputs: bool = False):
    """Forward hooks on every MoE layer's ``mlp`` of ``model``: the
    yielded list gets, for each call, the top-k expert ids [B,T,K], the
    capacity rule's kept mask [B,T*K] (``moe.router_probs`` and
    ``moe.capacity_slots`` on the layer's input, as the dispatch computes
    them) and, with ``inputs``, the input [B,T,d]; device tensors, no
    host sync."""
    from repro_torch.models import moe
    log = []

    def hook(mlp, args, out):
        h, cfg = args
        with torch.no_grad():
            idx = moe.router_probs(mlp, h, cfg)[2]
            slot, cap = moe.capacity_slots(idx, cfg)
        log.append({"idx": idx, "keep": slot < cap,
                    "h": h.detach() if inputs else None})
    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, moe.MoEFFN)]
    try:
        yield log
    finally:
        for handle in handles:
            handle.remove()


def drop_fraction(log) -> float:
    """Dropped share of the (token, k) pairs that ``moe_routing``
    logged."""
    kept = sum(int(r["keep"].sum()) for r in log)
    routed = sum(r["keep"].numel() for r in log)
    return 1.0 - kept / routed if routed else 0.0


def kept_experts(torch, r, E: int):
    """[B,T,E] bool: the experts each token's kept pairs reach."""
    idx = r["idx"]
    got = torch.zeros(idx.shape[:2] + (E,), dtype=torch.bool,
                      device=idx.device)
    return got.scatter_(-1, idx, r["keep"].view(idx.shape))


def moe_phase(smoke: Smoke):
    """deepseek-moe-16b at full width and depth, bf16, capacity dispatch,
    attn_impl="bam_kernel": K1 at its 16/16 heads against the plain
    version; the prefill (K1 once a layer); the strip-cache serve loop;
    bf16 against f32 at depth 2; 2 AdamW steps at depth 3 (K1, K2, K3);
    qwen2-moe-a2.7b's prefill at depth 4 with its padded experts."""
    torch = smoke.torch
    from repro_torch.models import api
    from repro_torch.training import steps

    cfg = full_config("deepseek-moe-16b").replace(attn_impl="bam_kernel")
    k1_head_layout_cases(smoke, cfg.num_heads, cfg.num_kv_heads, "moe")
    moe_bwd_cases(smoke, cfg)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    t0 = time.perf_counter()
    model = api.init(cfg, device="cuda", generator=gen)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    m = cfg.moe
    print(f"{cfg.name}: {n_params / 1e9:.3f} B parameters ({cfg.num_layers}"
          f" layers, {m.first_dense_layers} dense; {m.num_experts} experts "
          f"top-{m.top_k} + {m.num_shared_experts} shared of {m.d_expert}; "
          f"d {cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads of "
          f"{cfg.head_dim}), bf16, {m.backend} dispatch (capacity factor "
          f"{m.capacity_factor}), init {time.perf_counter() - t0:.1f} s",
          flush=True)
    batch = lm_batch(torch, cfg, gen)
    smoke.moe = {"params": n_params}

    prefill = steps.make_prefill(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    with moe_routing(torch, model) as log:
        logits = prefill(model, batch)
    torch.cuda.synchronize()
    counts = kernel_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    drops = drop_fraction(log)
    smoke.launches["moe"] = dict(counts)
    others = {k: n for k, n in counts.items() if k != "K1" and n}
    smoke.check(counts["K1"] == cfg.num_layers and not others,
                f"K1 launched {counts['K1']} times in one bf16 prefill = "
                f"{cfg.num_layers} layers ({m.first_dense_layers} dense, "
                f"{cfg.num_layers - m.first_dense_layers} MoE); other "
                f"kernels {others or 0}")
    smoke.check(bool(torch.isfinite(logits).all())
                and logits.shape == (1, 1, cfg.vocab_size),
                f"bf16 prefill logits finite, shape {tuple(logits.shape)}")
    ms = cuda_ms(torch, lambda: prefill(model, batch), iters=3, warmup=1)
    plain = steps.make_prefill(cfg.replace(attn_impl="xla"))
    plain_ms = cuda_ms(torch, lambda: plain(model, batch), iters=3, warmup=1)
    print(f"{cfg.name} prefill through make_prefill, B 1 x T {MOE_T} "
          f"({MOE_T // 4} text, {MOE_T // 2} modality-1, {MOE_T // 4} "
          f"text): kernel {ms:.1f} ms, plain {plain_ms:.1f} ms, peak "
          f"{peak:.2f} GiB; routed pairs dropped {drops:.4f} "
          f"({len(log)} MoE layers) [{smoke.smi}]", flush=True)
    busy, wall = profile_call(
        torch, lambda: float(prefill(model, batch)[0, 0, 0]),
        f"{cfg.name} prefill profile")
    smoke.moe["prefill"] = {"ms": ms, "plain_ms": plain_ms,
                            "peak_gib": peak, "drop_fraction": drops,
                            "launches": dict(counts),
                            "profile_busy_ms": busy, "profile_wall_ms": wall}
    dense_serve(smoke, model, cfg, into=smoke.moe)
    del model, logits
    gc.collect()
    torch.cuda.empty_cache()
    moe_precision(smoke, cfg)
    moe_train_parity(smoke, cfg)
    moe_train(smoke, cfg)
    qwen_moe_prefill(smoke)


def moe_bwd_cases(smoke: Smoke, cfg):
    """K2 and K3 at the MoE train path's head layout (16/16 heads of 128,
    a GQA group of 1) on its bits (``lm_batch``: T/4 text, T/2
    modality-1, T/4 text), T ``MOE_T``, bf16 and f32: each against its
    plain version within ``compare``."""
    torch = smoke.torch
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    b = lm_batch(torch, cfg, gen)
    H, Hkv = cfg.num_heads, cfg.num_kv_heads
    for dt in ("bfloat16", "float32"):
        bwd_check(smoke, gen, (1, MOE_T, H, cfg.head_dim), Hkv, b["bits"],
                  b["positions"], dt, f"{H}/{Hkv} heads (group {H // Hkv}) "
                  f"T={MOE_T} moe layout {dt}")


def moe_precision(smoke: Smoke, cfg):
    """Depth 2 (the dense layer and one MoE layer), full width, bf16
    kernel and plain prefills against an f32 forward of the same weights.
    Bounded, as the dense phase bounds its logits: the MoE layer's input
    (after both layers' attention, so K1's error at this layout) within
    ``DENSE_BF16_FACTOR`` x the plain path's distance. Printed: the
    last-position logits' distance, under the capacity dispatch and under
    the dense one (nothing dropped), with the routing decisions that
    differ from f32's: a top-k flip or a changed drop moves a logit by
    more than rounding. f32 kernel against f32 plain within
    ``DENSE_F32_REL``."""
    torch = smoke.torch
    from repro_torch.models import api
    from repro_torch.training import steps

    c2 = cfg.replace(num_layers=2)
    dense = c2.replace(moe=dataclasses.replace(c2.moe, backend="dense"))
    E = c2.moe.num_experts_padded
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    model = api.init(c2, device="cuda", generator=gen)
    batch = lm_batch(torch, c2, gen)
    c32 = c2.replace(dtype="float32")
    m32 = api.init(c32, device="meta").to_empty(device="cuda")
    m32.load_state_dict(model.state_dict())
    runs = {}
    for name, m, c in (("kernel", model, c2),
                       ("plain", model, c2.replace(attn_impl="xla")),
                       ("f32", m32, c32.replace(attn_impl="xla"))):
        with moe_routing(torch, m, inputs=True) as log:
            logits = steps.make_prefill(c)(m, batch)
        dense_logits = steps.make_prefill(
            c.replace(moe=dense.moe))(m, batch)
        runs[name] = (logits, dense_logits, log[0])
    zero_counts()
    lk32 = steps.make_prefill(c32)(m32, batch)
    k1 = kernel_counts()["K1"]
    l32, l32d, r32 = runs["f32"]
    del model, m32
    gc.collect()
    torch.cuda.empty_cache()
    kept32 = kept_experts(torch, r32, E)
    sets32 = r32["idx"].sort(-1).values
    out = {}
    for name in ("kernel", "plain"):
        lg, lgd, r = runs[name]
        kept = kept_experts(torch, r, E)
        out[name] = {
            "hidden": rel_err(r["h"], r32["h"]),
            "logits": rel_err(lg, l32), "logits_dense": rel_err(lgd, l32d),
            "topk_flips": int((r["idx"].sort(-1).values != sets32)
                              .any(-1).sum()),
            "kept_changed": int((kept != kept32).any(-1).sum()),
            "last_changed": bool((kept[0, -1] != kept32[0, -1]).any()),
            "last_flip": bool((r["idx"][0, -1].sort().values
                               != sets32[0, -1]).any())}
    k, x = out["kernel"], out["plain"]
    print(f"{cfg.name} depth 2, full width, B 1 x T {MOE_T}, bf16 against "
          f"the f32 forward of the same weights, max |d| / max: " + "; ".join(
              f"{n}: MoE layer input {o['hidden']:.4f}, last-position "
              f"logits {o['logits']:.4f} (dense dispatch "
              f"{o['logits_dense']:.4f}), "
              f"tokens with another top-k set {o['topk_flips']}, with another "
              f"kept set {o['kept_changed']} of {MOE_T}, the last token's "
              f"top-k {'changed' if o['last_flip'] else 'same'}, its kept "
              f"set {'changed' if o['last_changed'] else 'same'}"
              for n, o in out.items())
          + f"; f32 max |l| {float(l32.abs().max()):.3f} [{smoke.smi}]",
          flush=True)
    smoke.check(k["hidden"] <= DENSE_BF16_FACTOR * x["hidden"],
                f"bf16 {cfg.name} depth 2: the MoE layer's input against "
                f"f32's, kernel {k['hidden']:.4f} <= {DENSE_BF16_FACTOR} x "
                f"plain {x['hidden']:.4f}")
    r = rel_err(lk32, l32)
    smoke.check(r <= DENSE_F32_REL and k1 == c2.num_layers,
                f"f32 {cfg.name} 2 layers, full width, T {MOE_T}: kernel "
                f"vs plain last-position logits max |d| / max |l| {r:.2e} "
                f"(tol {DENSE_F32_REL}); K1 {k1} launches")
    smoke.moe["bf16_vs_f32"] = dict(out, f32_kernel=r)


def moe_train_parity(smoke: Smoke, cfg):
    """f32, depth 2 (the dense layer and one MoE layer), full width, B 1 x
    T ``MOE_T``: one AdamW ``make_train_step`` on the kernel path (K1, K2
    and K3 at 16/16 heads) and one on the plain path from the same
    weights. Loss, grad_norm and the parameters after the step within
    ``DENSE_F32_REL`` (relative; parameters of max |parameter|). AdamW's
    eps is 1e-3, as in the CPU tests: the first update is g / (|g| + eps),
    which at eps 1e-8 turns f32 rounding of a gradient near 1e-8 into a
    whole learning rate."""
    torch = smoke.torch
    from repro_torch.models import api
    from repro_torch.optim import optimizer as opt
    from repro_torch.training import steps

    c2 = cfg.replace(num_layers=2, dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    model = api.init(c2, device="cuda", generator=gen)
    model.requires_grad_(True)
    batch = lm_batch(torch, c2, gen)
    ocfg = opt.AdamWConfig(lr=1e-4, warmup_steps=1, total_steps=10,
                           eps=1e-3)
    want = {"K1": (2 if c2.remat else 1) * c2.num_layers,
            "K2": c2.num_layers, "K3": c2.num_layers}
    res, params = {}, {}
    for impl in ("bam_kernel", "xla"):
        m = copy.deepcopy(model) if impl == "bam_kernel" else model
        state = opt.init(ocfg, dict(m.named_parameters()))
        step = steps.make_train_step(c2.replace(attn_impl=impl), ocfg)
        zero_counts()
        with moe_routing(torch, m) as log:
            m, state, met = step(m, state, batch)
        torch.cuda.synchronize()
        counts = kernel_counts()
        res[impl] = (float(met["loss"]), float(met["grad_norm"]),
                     {k: counts[k] for k in want},
                     torch.cat([r["idx"] for r in log]))
        params[impl] = m
        del state
    (lk, gk, got, ik), (lx, gx, plain, ix) = res["bam_kernel"], res["xla"]
    pk = dict(params["bam_kernel"].named_parameters())
    worst, top = 0.0, 0.0
    with torch.no_grad():
        for n, p in params["xla"].named_parameters():
            worst = max(worst, float((pk[n] - p).abs().max()))
            top = max(top, float(p.abs().max()))
    del params, pk, model
    gc.collect()
    torch.cuda.empty_cache()
    rl, rg, rp = abs(lk - lx) / abs(lx), abs(gk - gx) / abs(gx), worst / top
    same = bool(torch.equal(ik, ix))
    smoke.check(got == want and not any(plain.values())
                and max(rl, rg, rp) <= DENSE_F32_REL,
                f"f32 {cfg.name} depth 2, full width, one AdamW step, kernel "
                f"vs plain: loss {lk:.7f} vs {lx:.7f} (rel {rl:.2e}), "
                f"grad_norm {gk:.7f} vs {gx:.7f} (rel {rg:.2e}), parameters "
                f"max |d| / max |p| {rp:.2e} (tol {DENSE_F32_REL}); "
                f"launches {got} (want {want}), plain path {plain}; top-k "
                f"ids identical: {same}")
    smoke.moe["train_parity_f32"] = {"loss_rel": rl, "grad_norm_rel": rg,
                                     "params_rel": rp, "launches": got,
                                     "same_routing": same}


def moe_train(smoke: Smoke, cfg):
    """``MOE_TRAIN_STEPS`` AdamW steps of ``make_train_step`` at full
    width and depth ``MOE_TRAIN_LAYERS`` (the dense layer and two MoE
    layers), every parameter trainable, B 1 x T ``MOE_T``. Counts zeroed
    just before and read just after each step: K1 once a layer, twice
    under ``cfg.remat`` (the recompute), K2 and K3 once a layer."""
    torch = smoke.torch
    from repro_torch.models import api
    from repro_torch.optim import optimizer as opt
    from repro_torch.training import steps

    c3 = cfg.replace(num_layers=MOE_TRAIN_LAYERS)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    model = api.init(c3, device="cuda", generator=gen)
    model.requires_grad_(True)
    named = dict(model.named_parameters())
    n_params = sum(p.numel() for p in named.values())
    ocfg = opt.AdamWConfig(lr=1e-4, warmup_steps=1, total_steps=10)
    state = opt.init(ocfg, named)
    step = steps.make_train_step(c3, ocfg)
    batch = lm_batch(torch, c3, gen)
    router = model.layers[0].mlp.router.detach().clone()
    want = {"K1": (2 if c3.remat else 1) * c3.num_layers,
            "K2": c3.num_layers, "K3": c3.num_layers}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rows = []
    for i in range(MOE_TRAIN_STEPS):
        zero_counts()
        t0 = time.perf_counter()
        model, state, met = step(model, state, batch)
        torch.cuda.synchronize()
        took = (time.perf_counter() - t0) * 1e3
        counts = kernel_counts()
        got = {k: counts[k] for k in want}
        others = {k: n for k, n in counts.items() if k not in want and n}
        smoke.check(got == want and not others,
                    f"{cfg.name} depth {c3.num_layers} train step {i}: "
                    f"launches {got} (want {want}, remat {c3.remat}); "
                    f"others {others or 0}")
        rows.append({"ms": took, "loss": float(met["loss"]),
                     "aux_loss": float(met["aux_loss"].detach()),
                     "grad_norm": float(met["grad_norm"])})
    smoke.launches["moe_train"] = dict(counts)
    busy, wall = profile_step(torch, step, model, state, batch,
                              f"{cfg.name} depth {c3.num_layers} train")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    moved = float((model.layers[0].mlp.router.detach() - router).abs().max())
    print(f"{cfg.name} train, full width, depth {c3.num_layers} "
          f"({n_params / 1e9:.3f} B parameters, all trainable), B 1 x T "
          f"{MOE_T}, AdamW: " + ", ".join(
              f"step {i} {r['ms']:.1f} ms loss {r['loss']:.4f} (aux "
              f"{r['aux_loss']:.5f}) grad_norm {r['grad_norm']:.4f}"
              for i, r in enumerate(rows))
          + f"; peak {peak:.2f} GiB [{smoke.smi}]", flush=True)
    smoke.check(all(np.isfinite([r["loss"], r["grad_norm"]]).all()
                    and r["aux_loss"] > 0 for r in rows) and moved > 0,
                f"{cfg.name} train: losses finite, aux loss > 0, the "
                f"router moved (max |d| {moved:.3e})")
    smoke.moe["train"] = {"steps": rows, "peak_gib": peak,
                          "params": n_params, "launches": dict(counts),
                          "profile_busy_ms": busy, "profile_wall_ms": wall}
    del model, state, named
    gc.collect()
    torch.cuda.empty_cache()


def qwen_moe_prefill(smoke: Smoke):
    """qwen2-moe-a2.7b at full width, depth ``QWEN_MOE_LAYERS``, bf16:
    one prefill through K1 (once a layer); its 60 experts padded to 64,
    the 4 pads never routed to."""
    torch = smoke.torch
    from repro_torch.models import api
    from repro_torch.training import steps

    cfg = full_config("qwen2-moe-a2.7b").replace(
        num_layers=QWEN_MOE_LAYERS, attn_impl="bam_kernel")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    model = api.init(cfg, device="cuda", generator=gen)
    batch = lm_batch(torch, cfg, gen)
    prefill = steps.make_prefill(cfg)
    zero_counts()
    with moe_routing(torch, model) as log:
        logits = prefill(model, batch)
    torch.cuda.synchronize()
    counts = kernel_counts()
    lp = model.layers[0].mlp
    padded = (lp.w_gate.shape[0], lp.router.shape[1])
    smoke.check(counts["K1"] == cfg.num_layers
                and bool(torch.isfinite(logits).all())
                and padded == (cfg.moe.num_experts_padded,
                               cfg.moe.num_experts),
                f"{cfg.name} depth {cfg.num_layers}: K1 {counts['K1']} "
                f"launches, logits finite; experts stacked {padded[0]}, "
                f"routed over {padded[1]}")
    ms = cuda_ms(torch, lambda: prefill(model, batch), iters=3, warmup=1)
    drops = drop_fraction(log)
    print(f"{cfg.name} prefill, full width, depth {cfg.num_layers}, B 1 x "
          f"T {MOE_T}: {ms:.1f} ms; routed pairs dropped {drops:.4f} "
          f"[{smoke.smi}]", flush=True)
    smoke.moe["qwen2_moe_prefill"] = {"ms": ms, "drop_fraction": drops,
                                      "layers": cfg.num_layers}
    del model
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 4d: the hybrid family (zamba2-2.7b)
# ---------------------------------------------------------------------------

HYB_SSD_T = 512               # 4 chunks of 128
HYB_TRAIN_LAYERS = 12         # two shared-block calls
HYB_BF16_REL = 2e-2           # the bf16 step's loss, relative to f32's


def hybrid_phase(smoke: Smoke):
    """zamba2-2.7b at full width and depth, bf16, its shared attention
    block (head_dim 80) on attn_impl="bam_kernel": the prefill over B 1 x
    T 2048 with multimodal bits (K1 once per shared-block call and no
    other kernel), the plain prefill beside it, both last-position logits
    against an f32 forward of the same weights; the strip-cache serve
    loop and the chunked SSD against the recurrence in f32 (no kernel);
    one f32 AdamW step at depth ``HYB_TRAIN_LAYERS`` through K1-K3 at 80
    against the plain step, and one bf16 step from the same draws through
    K1-K3's wgmma bodies."""
    torch = smoke.torch
    from repro_torch.kernels.bam_attention import kernel_body
    from repro_torch.models import api
    from repro_torch.training import steps

    cfg = full_config("zamba2-2.7b").replace(attn_impl="bam_kernel")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    t0 = time.perf_counter()
    model = api.init(cfg, device="cuda", generator=gen)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    n_calls = cfg.num_layers // cfg.attn_layer_period
    print(f"{cfg.name}: {n_params / 1e9:.3f} B parameters ({cfg.num_layers}"
          f" Mamba2 layers, a shared attention block every "
          f"{cfg.attn_layer_period}; d {cfg.d_model}, {cfg.num_heads} heads "
          f"of {cfg.head_dim}; SSD chunk {cfg.ssm.chunk}), bf16, init "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    batch = lm_batch(torch, cfg, gen)
    prefill = steps.make_prefill(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    lk = prefill(model, batch)
    torch.cuda.synchronize()
    counts = kernel_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    smoke.launches["hybrid"] = dict(counts)
    others = {k: n for k, n in counts.items() if k != "K1" and n}
    body = kernel_body(cfg.head_dim, torch.bfloat16, "K1")
    smoke.check(counts["K1"] == n_calls and not others and body == "wgmma",
                f"{cfg.name}: K1 launched {counts['K1']} times in one bf16 "
                f"prefill = {n_calls} shared-block calls (head_dim "
                f"{cfg.head_dim}, {body} body); other kernels "
                f"{others or 0}")
    smoke.check(bool(torch.isfinite(lk).all())
                and lk.shape == (1, 1, cfg.vocab_size),
                f"{cfg.name} bf16 prefill logits finite, shape "
                f"{tuple(lk.shape)}")
    ms = cuda_ms(torch, lambda: prefill(model, batch), iters=3, warmup=1)
    plain = steps.make_prefill(cfg.replace(attn_impl="xla"))
    lx = plain(model, batch)
    plain_ms = cuda_ms(torch, lambda: plain(model, batch), iters=3, warmup=1)
    print(f"{cfg.name} prefill through make_prefill, B 1 x T {MOE_T} "
          f"(multimodal bits): kernel {ms:.1f} ms, plain {plain_ms:.1f} ms, "
          f"peak {peak:.2f} GiB [{smoke.smi}]", flush=True)
    busy, wall = profile_call(
        torch, lambda: float(prefill(model, batch)[0, 0, 0]),
        f"{cfg.name} prefill profile")
    ek, ex = against_f32(smoke, model, cfg, batch, lk, lx)
    smoke.hybrid = {"params": n_params,
                    "prefill": {"ms": ms, "plain_ms": plain_ms,
                                "peak_gib": peak, "launches": dict(counts),
                                "profile_busy_ms": busy,
                                "profile_wall_ms": wall},
                    "bf16_err_kernel": ek, "bf16_err_plain": ex}
    dense_serve(smoke, model, cfg.replace(attn_impl="xla"), into=smoke.hybrid)
    del model, lk, lx
    gc.collect()
    torch.cuda.empty_cache()
    hybrid_ssd_check(smoke, cfg)
    counts = kernel_counts()
    smoke.check(not any(counts.values()),
                f"{cfg.name}: no kernel launched in the serve loop and the "
                f"SSD check ({counts})")
    c12 = cfg.replace(num_layers=HYB_TRAIN_LAYERS, dtype="float32")
    n12 = c12.num_layers // c12.attn_layer_period
    want = {"K1": (2 if c12.remat else 1) * n12, "K2": n12, "K3": n12}
    smoke.hybrid["train_parity_f32"] = train_parity(
        smoke, c12, lm_batch, SEED + 15, want)
    smoke.hybrid["train_bf16"] = bf16_train_step(
        smoke, c12, lm_batch, SEED + 15, want,
        smoke.hybrid["train_parity_f32"]["loss"])
    smoke.launches["hybrid_train_bf16"] = smoke.hybrid["train_bf16"][
        "launches"]


def bf16_train_step(smoke: Smoke, c32, make_batch, seed: int, want,
                    f32_loss: float) -> dict:
    """One bf16 AdamW ``make_train_step`` on the kernel path from the
    draws ``train_parity`` makes at ``seed`` (the same weights, cast to
    bf16 as the init casts them, and the same batch): launches counted
    (``want``, each kernel on its wgmma body), loss and grad_norm finite,
    the loss within ``HYB_BF16_REL`` of the f32 step's ``f32_loss``."""
    torch = smoke.torch
    from repro_torch.kernels.bam_attention import kernel_body
    from repro_torch.models import api
    from repro_torch.optim import optimizer as opt
    from repro_torch.training import steps

    cfg = c32.replace(dtype="bfloat16", attn_impl="bam_kernel")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = api.init(cfg, device="cuda", generator=gen)
    model.requires_grad_(True)
    batch = make_batch(torch, cfg, gen)
    ocfg = opt.AdamWConfig(lr=1e-4, warmup_steps=1, total_steps=10,
                           eps=1e-3)
    state = opt.init(ocfg, dict(model.named_parameters()))
    step = steps.make_train_step(cfg, ocfg)
    zero_counts()
    t0 = time.perf_counter()
    model, state, met = step(model, state, batch)
    torch.cuda.synchronize()
    took = (time.perf_counter() - t0) * 1e3
    counts = kernel_counts()
    got = {k: counts[k] for k in want}
    others = {k: n for k, n in counts.items() if n and k not in want}
    loss, gn = float(met["loss"]), float(met["grad_norm"])
    rel = abs(loss - f32_loss) / abs(f32_loss)
    bodies = {k: kernel_body(cfg.head_dim, torch.bfloat16, k) for k in want}
    smoke.check(got == want and not others
                and bool(np.isfinite([loss, gn]).all())
                and rel <= HYB_BF16_REL
                and set(bodies.values()) == {"wgmma"},
                f"bf16 {cfg.name} depth {cfg.num_layers}, full width, one "
                f"AdamW step on the kernel path: loss {loss:.6f} against "
                f"f32's {f32_loss:.6f} (rel {rel:.2e}, tol {HYB_BF16_REL}), "
                f"grad_norm {gn:.6f}; launches {got} (want {want}), others "
                f"{others or 0}; bodies {bodies} (head_dim "
                f"{cfg.head_dim}); {took:.0f} ms (first call) "
                f"[{smoke.smi}]")
    del model, state
    gc.collect()
    torch.cuda.empty_cache()
    return {"loss": loss, "grad_norm": gn, "loss_rel_f32": rel,
            "launches": got, "ms": took}


def train_parity(smoke: Smoke, c32, make_batch, seed: int, want) -> dict:
    """f32, full width: one AdamW ``make_train_step`` on the kernel path
    (launches counted: ``want``) and one on the plain path from the same
    weights and batch (``make_batch(torch, cfg, gen)``). Loss, grad_norm
    and the parameters after the step within ``DENSE_F32_REL`` (relative;
    parameters of max |parameter|); AdamW eps 1e-3, as in
    ``moe_train_parity``."""
    torch = smoke.torch
    from repro_torch.models import api
    from repro_torch.optim import optimizer as opt
    from repro_torch.training import steps

    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = api.init(c32, device="cuda", generator=gen)
    model.requires_grad_(True)
    batch = make_batch(torch, c32, gen)
    ocfg = opt.AdamWConfig(lr=1e-4, warmup_steps=1, total_steps=10,
                           eps=1e-3)
    res, params = {}, {}
    for impl in ("bam_kernel", "xla"):
        m = copy.deepcopy(model) if impl == "bam_kernel" else model
        state = opt.init(ocfg, dict(m.named_parameters()))
        step = steps.make_train_step(c32.replace(attn_impl=impl), ocfg)
        zero_counts()
        t0 = time.perf_counter()
        m, state, met = step(m, state, batch)
        torch.cuda.synchronize()
        took = (time.perf_counter() - t0) * 1e3
        counts = kernel_counts()
        res[impl] = (float(met["loss"]), float(met["grad_norm"]),
                     {k: counts[k] for k in want},
                     {k: n for k, n in counts.items() if n and k not in want},
                     took)
        params[impl] = m
        del state
    (lk, gk, got, oth, mk), (lx, gx, plain, _, mx) = (res["bam_kernel"],
                                                     res["xla"])
    pk = dict(params["bam_kernel"].named_parameters())
    worst, top = 0.0, 0.0
    with torch.no_grad():
        for n, p in params["xla"].named_parameters():
            worst = max(worst, float((pk[n] - p).abs().max()))
            top = max(top, float(p.abs().max()))
    del params, pk, model
    gc.collect()
    torch.cuda.empty_cache()
    rl, rg, rp = abs(lk - lx) / abs(lx), abs(gk - gx) / abs(gx), worst / top
    smoke.check(got == want and not oth and not any(plain.values())
                and max(rl, rg, rp) <= DENSE_F32_REL,
                f"f32 {c32.name} depth {c32.num_layers}, full width, one "
                f"AdamW step, kernel vs plain: loss {lk:.7f} vs {lx:.7f} "
                f"(rel {rl:.2e}), grad_norm {gk:.7f} vs {gx:.7f} (rel "
                f"{rg:.2e}), parameters max |d| / max |p| {rp:.2e} (tol "
                f"{DENSE_F32_REL}); launches {got} (want {want}), others "
                f"{oth or 0}, plain path {plain}; {mk:.0f} vs {mx:.0f} ms")
    return {"loss": lk, "grad_norm": gk, "loss_rel": rl,
            "grad_norm_rel": rg, "params_rel": rp, "launches": got,
            "ms": mk, "plain_ms": mx}


def hybrid_ssd_check(smoke: Smoke, cfg):
    """One Mamba2 block at full width in f32 (decay per head drawn from
    the seed): the chunked SSD over ``HYB_SSD_T`` tokens against the
    block stepped one token at a time, the block's output (less its
    residual) and final state each within ``DENSE_F32_REL`` of its max."""
    torch = smoke.torch
    from repro_torch.models import mamba2

    c32 = cfg.replace(dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    lp = mamba2.MambaLayer(c32, torch.float32, "cuda", gen)
    s = c32.ssm
    nh = s.n_heads(c32.d_model)
    with torch.no_grad():
        lp.A_log.copy_(torch.randn((nh,), generator=gen, device="cuda") * 0.5)
        lp.dt_bias.copy_(torch.randn((nh,), generator=gen, device="cuda"))
        x = torch.randn((1, HYB_SSD_T, c32.d_model), generator=gen,
                        device="cuda")
        y, h, _ = mamba2.mamba_block(lp, c32, x)
        state = torch.zeros_like(h)
        conv = torch.zeros((1, s.d_conv - 1, mamba2._conv_channels(c32)),
                           device="cuda")
        ys = []
        for t in range(HYB_SSD_T):
            yt, state, conv = mamba2.mamba_block(
                lp, c32, x[:, t:t + 1], h0=state, conv_state=conv, step=True)
            ys.append(yt)
        ry = rel_err(torch.cat(ys, 1) - x, y - x)
        rh = rel_err(state, h)
    smoke.check(ry <= DENSE_F32_REL and rh <= DENSE_F32_REL,
                f"f32 {cfg.name} Mamba2 block at full width (d "
                f"{c32.d_model}, {nh} heads of {s.head_dim}, state "
                f"{s.d_state}), T {HYB_SSD_T} = {HYB_SSD_T // s.chunk} "
                f"chunks: chunked SSD vs the recurrence, output max |d| / "
                f"max {ry:.2e}, final state {rh:.2e} (tol {DENSE_F32_REL})")
    smoke.hybrid["ssd_check"] = {"output_rel": ry, "state_rel": rh}


# ---------------------------------------------------------------------------
# Phase 4g: gemma2-9b (head_dim 256)
# ---------------------------------------------------------------------------

GEMMA_TICKS = 32                     # decode ticks a request
GEMMA_TRAIN_LAYERS = 4


def gemma2_requests(vocab: int):
    """4 text prompts of ``GEMMA_ROWS`` tokens, each asking for one token
    from its prefill and ``GEMMA_TICKS`` from decode ticks."""
    rng = np.random.default_rng(SEED + 14)
    return [dict(tokens=rng.integers(1, vocab, size=n),
                 max_new_tokens=GEMMA_TICKS + 1) for n in GEMMA_ROWS]


def gemma2_phase(smoke: Smoke):
    """gemma2-9b at full width and depth, bf16 (head_dim 256): paged
    serving through K4 at each layer's own window; the all-local
    variant's prefill through K1; f32 train parity at depth 2 and 2 bf16
    steps at depth ``GEMMA_TRAIN_LAYERS`` through K1-K3 (the all-local
    variant: the alternation stays on the plain path off CP)."""
    torch = smoke.torch
    from repro_torch.configs import gemma2_9b
    from repro_torch.kernels.bam_attention import kernel_body
    from repro_torch.models import api
    from repro_torch.training import steps

    t_phase = time.perf_counter()
    cfg = full_config("gemma2-9b").replace(attn_impl="bam_kernel")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    t0 = time.perf_counter()
    model = api.init(cfg, device="cuda", generator=gen)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"{cfg.name}: {n_params / 1e9:.3f} B parameters ({cfg.num_layers}"
          f" layers, windows {cfg.sliding_window}/0 alternating; d "
          f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads of "
          f"{cfg.head_dim}, softcap {cfg.attn_softcap}), bf16, init "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    smoke.gemma2 = {"params": n_params}

    # (a) paged serving: K4 once a layer a tick, the prefill plain (the
    # alternation), against the dense-gather path
    reqs = gemma2_requests(cfg.vocab_size)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    got, eng = serve(model, cfg, "kernel", reqs)
    wall = time.perf_counter() - t0
    counts = kernel_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    smoke.launches["gemma2_serving"] = dict(counts)
    others = {k: n for k, n in counts.items() if k != "K4" and n}
    ticks = eng.decode_ticks
    smoke.check(counts["K4"] == cfg.num_layers * ticks and ticks > 0
                and not others,
                f"{cfg.name} paged serving: K4 launched {counts['K4']} times "
                f"= {cfg.num_layers} layers x {ticks} decode ticks (head_dim "
                f"{cfg.head_dim}); other kernels {others or 0}")
    tick_ms = eng.decode_seconds * 1e3 / max(ticks, 1)
    eng_prefill_ms = eng.prefill_seconds * 1e3
    t0 = time.perf_counter()
    ref, eng_x = serve(model, cfg.replace(attn_impl="xla"), "xla", reqs)
    wall_x = time.perf_counter() - t0
    tick_x = eng_x.decode_seconds * 1e3 / max(eng_x.decode_ticks, 1)
    same = sum(a == b for a, b in zip(got, ref))
    first = [next((i for i, (a, b) in enumerate(zip(g, r)) if a != b),
                  len(g)) for g, r in zip(got, ref)]
    print(f"{cfg.name} paged serving, {len(reqs)} text requests of "
          f"{'/'.join(map(str, GEMMA_ROWS))} tokens, {GEMMA_TICKS + 1} new "
          f"each: kernel prefill {eng_prefill_ms:.1f} ms total, "
          f"decode {tick_ms:.2f} ms/tick over {ticks} ticks, wall "
          f"{wall:.2f} s, peak {peak:.2f} GiB; xla decode {tick_x:.2f} "
          f"ms/tick, wall {wall_x:.2f} s; bf16 greedy tokens equal for "
          f"{same}/{len(reqs)} requests (first difference at "
          f"{first}) [{smoke.smi}]", flush=True)
    smoke.check(all(len(t) == GEMMA_TICKS + 1
                    and all(0 <= x < cfg.vocab_size for x in t)
                    for t in got + ref),
                f"{cfg.name}: every request generated {GEMMA_TICKS + 1} "
                f"in-vocab tokens on both paths")
    del eng, eng_x
    gc.collect()
    torch.cuda.empty_cache()
    # parity_phase's rule: at f32 with 2 layers (one local, one global)
    # the two paths emit identical greedy tokens
    c32 = cfg.replace(num_layers=2, dtype="float32")
    m32 = api.init(c32, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(SEED + 18))
    got32, _ = serve(m32, c32, "kernel", reqs)
    ref32, _ = serve(m32, c32.replace(attn_impl="xla"), "xla", reqs)
    same32 = sum(a == b for a, b in zip(got32, ref32))
    smoke.check(same32 == len(reqs),
                f"f32 {cfg.name} 2 layers, full width: kernel engine == "
                f"plain engine greedy tokens for {same32}/{len(reqs)} "
                f"requests")
    smoke.gemma2["serving"] = {"decode_ms_per_tick": tick_ms,
                               "xla_decode_ms_per_tick": tick_x,
                               "prefill_ms": eng_prefill_ms,
                               "ticks": ticks, "peak_gib": peak,
                               "launches": dict(counts),
                               "same_tokens_bf16": same,
                               "same_tokens_f32": same32}
    del m32
    gc.collect()
    torch.cuda.empty_cache()

    # (b) the all-local variant's prefill through K1, against plain and f32
    lc = gemma2_9b.long_context_variant().replace(attn_impl="bam_kernel")
    batch = lm_batch(torch, lc, gen)
    prefill = steps.make_prefill(lc)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    lk = prefill(model, batch)
    torch.cuda.synchronize()
    counts = kernel_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    smoke.launches["gemma2"] = dict(counts)
    others = {k: n for k, n in counts.items() if k != "K1" and n}
    body = kernel_body(lc.head_dim, torch.bfloat16, "K1")
    smoke.check(counts["K1"] == lc.num_layers and not others
                and bool(torch.isfinite(lk).all()) and body == "wgmma",
                f"{lc.name}: K1 launched {counts['K1']} times in one bf16 "
                f"prefill = {lc.num_layers} layers (head_dim {lc.head_dim}, "
                f"window {lc.sliding_window}, {body} body); other kernels "
                f"{others or 0}; logits finite")
    ms = cuda_ms(torch, lambda: prefill(model, batch), iters=3, warmup=1)
    plain = steps.make_prefill(lc.replace(attn_impl="xla"))
    lx = plain(model, batch)
    plain_ms = cuda_ms(torch, lambda: plain(model, batch), iters=3, warmup=1)
    print(f"{lc.name} prefill through make_prefill, B 1 x T {MOE_T} "
          f"(multimodal bits): kernel {ms:.1f} ms, plain {plain_ms:.1f} ms, "
          f"peak {peak:.2f} GiB [{smoke.smi}]", flush=True)
    ek, ex = against_f32(smoke, model, lc, batch, lk, lx)
    smoke.gemma2["prefill"] = {"ms": ms, "plain_ms": plain_ms,
                               "peak_gib": peak, "launches": dict(counts),
                               "bf16_err_kernel": ek, "bf16_err_plain": ex}
    del model, lk, lx
    gc.collect()
    torch.cuda.empty_cache()

    # (c) f32 train parity at depth 2; (d) 2 bf16 steps at depth 4
    c2 = lc.replace(num_layers=2, dtype="float32")
    smoke.gemma2["train_parity_f32"] = train_parity(
        smoke, c2, lm_batch, SEED + 16,
        {"K1": (2 if c2.remat else 1) * 2, "K2": 2, "K3": 2})
    c4 = lc.replace(num_layers=GEMMA_TRAIN_LAYERS)
    smoke.gemma2["train"] = family_train(
        smoke, c4, lm_batch(torch, c4, gen), SEED + 17,
        f"{c4.name} depth {c4.num_layers}, B 1 x T {MOE_T}",
        {"K1": (2 if c4.remat else 1) * c4.num_layers,
         "K2": c4.num_layers, "K3": c4.num_layers})
    print(f"{cfg.name} phase: {time.perf_counter() - t_phase:.1f} s",
          flush=True)


# ---------------------------------------------------------------------------
# Phase 4e: the ssm family (xlstm-125m)
# ---------------------------------------------------------------------------

XL_B, XL_T = 2, 2048          # the prefill: 32 chunks of 64
XL_TICKS = 64                 # the serve loop's ticks
XL_DECODE = 16                # f32 decode-vs-forward tokens
XL_MLSTM_REL = 1e-4           # f32 chunked vs parallel mLSTM, of max |h|
DECODE_TOL = 2e-3             # |d| <= 2e-3 + 2e-3 |forward|, the reference's


def no_launches(smoke: Smoke, what: str) -> dict:
    """Read the launch counts and check that they are all zero (these
    families have no kernel: nothing may launch one unseen)."""
    counts = kernel_counts()
    smoke.check(not any(counts.values()),
                f"{what}: no kernel launched ({counts})")
    return counts


def decode_close(got, want) -> tuple:
    """(max |d|, whether |d| <= DECODE_TOL (1 + |want|) everywhere)."""
    d = (got.float() - want.float()).abs()
    return float(d.max()), bool((d <= DECODE_TOL * (1 + want.float().abs()))
                                .all())


def serve_ticks(torch, model, cfg, cache, first, n: int):
    """``make_serve_step`` fed its own greedy tokens for n ticks from
    ``first`` [B] at position 0; returns (ms per tick, tokens [B, n])."""
    from repro_torch.training import steps
    serve = steps.make_serve_step(cfg)
    B = first.shape[0]
    tok, out = first, []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(n):
        p = torch.full((B, 1), t, dtype=torch.int32, device="cuda")
        tok, cache = serve(model, cache, {"tokens": tok[:, None],
                                          "positions": p})
        out.append(tok)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n, torch.stack(out, 1)


def family_train(smoke: Smoke, cfg, batch, seed: int, label: str,
                 want=None) -> dict:
    """2 AdamW steps of ``make_train_step`` at full width and depth, every
    parameter trainable: ms per step, losses, peak memory. Launch counts
    are zeroed before the steps and read after them: each kernel of
    ``want`` ({key: launches a step}) as often as it says, every other
    count 0 (with no ``want``, no kernel at all)."""
    torch = smoke.torch
    from repro_torch.models import api
    from repro_torch.optim import optimizer as opt
    from repro_torch.training import steps

    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = api.init(cfg, device="cuda", generator=gen)
    model.requires_grad_(True)
    named = dict(model.named_parameters())
    ocfg = opt.AdamWConfig(lr=1e-4, warmup_steps=1, total_steps=10)
    state = opt.init(ocfg, named)
    step = steps.make_train_step(cfg, ocfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    rows = []
    for _ in range(2):
        t0 = time.perf_counter()
        model, state, met = step(model, state, batch)
        torch.cuda.synchronize()
        rows.append({"ms": (time.perf_counter() - t0) * 1e3,
                     "loss": float(met["loss"]),
                     "grad_norm": float(met["grad_norm"])})
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if want is None:
        counts = no_launches(smoke, f"{label} train, 2 steps")
    else:
        counts = kernel_counts()
        got = {k: counts[k] for k in want}
        others = {k: n for k, n in counts.items() if k not in want and n}
        smoke.check(got == {k: 2 * n for k, n in want.items()}
                    and not others,
                    f"{label} train, 2 steps: launches {got} (want "
                    f"{want} a step, remat {cfg.remat}); others "
                    f"{others or 0}")
    print(f"{label} train, {sum(p.numel() for p in named.values()) / 1e9:.3f}"
          f" B parameters ({len(named)} tensors, all trainable), AdamW: "
          + ", ".join(
              f"step {i} {r['ms']:.1f} ms loss {r['loss']:.4f} grad_norm "
              f"{r['grad_norm']:.4f}" for i, r in enumerate(rows))
          + f"; peak {peak:.2f} GiB [{smoke.smi}]", flush=True)
    smoke.check(all(np.isfinite([r["loss"], r["grad_norm"]]).all()
                    for r in rows),
                f"{label} train: losses and gradient norms finite")
    del model, state, named
    gc.collect()
    torch.cuda.empty_cache()
    return {"steps": rows, "peak_gib": peak, "launches": counts}


def xlstm_phase(smoke: Smoke):
    """xlstm-125m at full width and depth, bf16 (no attention, no kernel):
    the prefill over B 2 x T 2048, its busy share, the serve loop, the
    chunked mLSTM against the parallel one and decode against the forward
    in f32, 2 train steps, the CP step's refusal."""
    torch = smoke.torch
    from repro_torch.models import api
    from repro_torch.training import steps

    t_phase = time.perf_counter()
    cfg = full_config("xlstm-125m")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    model = api.init(cfg, device="cuda", generator=gen)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"{cfg.name}: {n_params / 1e6:.1f} M parameters ({cfg.num_layers}"
          f" blocks, sLSTM at {cfg.xlstm.slstm_at}; d {cfg.d_model}, "
          f"{cfg.num_heads} heads; mLSTM chunk {cfg.xlstm.chunk}), bf16",
          flush=True)
    batch = lm_batch(torch, cfg, gen, B=XL_B, T=XL_T)
    prefill = steps.make_prefill(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    logits = prefill(model, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    smoke.check(bool(torch.isfinite(logits).all())
                and logits.shape == (XL_B, 1, cfg.vocab_size),
                f"{cfg.name} bf16 prefill logits finite, shape "
                f"{tuple(logits.shape)}")
    ms = cuda_ms(torch, lambda: prefill(model, batch), iters=2, warmup=0)
    print(f"{cfg.name} prefill through make_prefill, B {XL_B} x T {XL_T} "
          f"({XL_T // cfg.xlstm.chunk} mLSTM chunks, {XL_T} sLSTM steps): "
          f"{ms:.1f} ms, peak {peak:.2f} GiB [{smoke.smi}]", flush=True)
    t0 = time.perf_counter()
    busy, wall = profile_call(
        torch, lambda: float(prefill(model, batch)[0, 0, 0]),
        f"{cfg.name} prefill profile (device trace)", cpu=False)
    print(f"  (the profiled call and its summary: "
          f"{time.perf_counter() - t0:.1f} s)", flush=True)
    smoke.launches["xlstm"] = no_launches(
        smoke, f"{cfg.name} prefill and its timed and profiled reruns")
    smoke.xlstm = {"params": n_params,
                   "prefill": {"ms": ms, "peak_gib": peak,
                               "profile_busy_ms": busy,
                               "profile_wall_ms": wall}}

    cache = api.init_cache(cfg, XL_B, XL_TICKS, device="cuda")
    first = batch["tokens"][:, 0]
    with torch.no_grad():
        tick_ms, toks = serve_ticks(torch, model, cfg, cache, first, XL_TICKS)
    no_launches(smoke, f"{cfg.name} serve loop")
    print(f"{cfg.name} serve loop, B {XL_B}, {XL_TICKS} ticks: {tick_ms:.2f} "
          f"ms/tick (state {tree_bytes(cache)} bytes) [{smoke.smi}]",
          flush=True)
    smoke.check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
                f"{cfg.name} serve loop: {XL_TICKS} in-vocab tokens a row")
    smoke.xlstm["serve"] = {"ms_per_tick": tick_ms}
    del model, logits, cache
    gc.collect()
    torch.cuda.empty_cache()

    xlstm_f32_checks(smoke, cfg)
    tb = lm_batch(torch, cfg, torch.Generator(device="cuda").manual_seed(
        SEED + 10), B=1, T=XL_T)
    smoke.xlstm["train"] = family_train(smoke, cfg, tb, SEED + 11, cfg.name)
    xlstm_cp_refusal(smoke, cfg)
    print(f"xlstm phase: {time.perf_counter() - t_phase:.1f} s", flush=True)


def xlstm_f32_checks(smoke: Smoke, cfg):
    """f32, full width: one mLSTM layer's chunked form against the
    parallel one at T 2048 (within ``XL_MLSTM_REL`` of max |h|), and the
    full-depth model fed ``XL_DECODE`` tokens one by one through
    ``decode_step`` against its forward's logits (the reference's rule)."""
    torch = smoke.torch
    from repro_torch.models import api, xlstm
    from repro_torch.models.layers import apply_norm

    c32 = cfg.replace(dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    lp = xlstm.MLSTMLayer(c32, torch.float32, "cuda", gen)
    with torch.no_grad():
        x = torch.randn((1, XL_T, c32.d_model), generator=gen, device="cuda")
        q, k, v, log_i, log_f, _, _ = xlstm._mlstm_qkvif(
            lp, c32, apply_norm(c32, lp.ln, x))
        hc, _ = xlstm.mlstm_chunked(q, k, v, log_i, log_f, c32.xlstm.chunk)
        hp = xlstm.mlstm_parallel(q, k, v, log_i, log_f)
    r = rel_err(hc, hp)
    _, dm, nh, hd = xlstm._dims(c32)
    smoke.check(r <= XL_MLSTM_REL,
                f"f32 {cfg.name} mLSTM layer at full width (dm {dm}, {nh} "
                f"heads of {hd}), T {XL_T}: chunked ({XL_T // c32.xlstm.chunk}"
                f" chunks of {c32.xlstm.chunk}) vs parallel, max |d| / max "
                f"|h| {r:.2e} (tol {XL_MLSTM_REL})")
    del lp, q, k, v, hc, hp
    model = api.init(c32, device="cuda", generator=gen)
    toks = torch.randint(0, c32.vocab_size, (XL_B, XL_DECODE), generator=gen,
                         device="cuda", dtype=torch.int32)
    pos = torch.arange(XL_DECODE, dtype=torch.int32,
                       device="cuda")[None].expand(XL_B, -1)
    with torch.no_grad():
        full, _ = api.forward(model, c32, {"tokens": toks, "positions": pos})
        cache = api.init_cache(c32, XL_B, XL_DECODE, device="cuda")
        got = []
        for t in range(XL_DECODE):
            lg, cache = api.decode_step(model, c32, cache, {
                "tokens": toks[:, t:t + 1], "positions": pos[:, t:t + 1]})
            got.append(lg[:, 0])
    err, ok = decode_close(torch.stack(got, 1), full)
    smoke.check(ok, f"f32 {cfg.name} full depth: decode_step over "
                f"{XL_DECODE} tokens vs the forward, max |d| {err:.2e} "
                f"(|d| <= {DECODE_TOL} (1 + |l|))")
    no_launches(smoke, f"{cfg.name} f32 checks")
    smoke.xlstm["f32"] = {"mlstm_chunked_rel": r, "decode_max_abs": err}
    del model, cache
    gc.collect()
    torch.cuda.empty_cache()


def xlstm_cp_refusal(smoke: Smoke, cfg):
    """``make_cp_train_step`` refuses xLSTM (its recurrence runs along the
    token axis) on a world-size-1 gloo group, destroyed after."""
    import torch.distributed as dist
    from repro_torch.training import steps

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", rank=0, world_size=1)
    refused = None
    try:
        steps.make_cp_train_step(cfg, {"perm": np.arange(XL_T),
                                       "num_ranks": 1}, dist.group.WORLD)
    except ValueError as e:
        refused = str(e)
    finally:
        dist.destroy_process_group()
    smoke.check(refused is not None and "recurrence" in refused,
                f"{cfg.name}: make_cp_train_step refuses: {refused}")


# ---------------------------------------------------------------------------
# Phase 4f: the audio family (whisper-base)
# ---------------------------------------------------------------------------

WH_B, WH_T = 4, 448           # the decoder's own context
WH_TICKS = 64
WH_F32_B = 2


def whisper_batch(torch, cfg, gen, B: int, T: int, dtype):
    """B rows: ``encoder_seq`` frame embeddings (N(0, 0.5^2)), T random
    decoder tokens and labels at positions 0..T-1 (causal)."""
    def draw():
        return torch.randint(0, cfg.vocab_size, (B, T), generator=gen,
                             device="cuda", dtype=torch.int32)
    frames = torch.randn((B, cfg.encdec.encoder_seq, cfg.d_model),
                         generator=gen, device="cuda") * 0.5
    pos = torch.arange(T, dtype=torch.int32, device="cuda")[None].expand(B, T)
    return {"tokens": draw(), "labels": draw(), "positions": pos,
            "encoder_embeds": frames.to(dtype)}


def whisper_phase(smoke: Smoke):
    """whisper-base at full width and depth, bf16 (plain attention, no
    kernel): the forward over B 4 (1500 frames, 448 decoder tokens),
    ``prefill_cross`` and the serve loop, decode against the forward in
    f32, 2 train steps."""
    torch = smoke.torch
    from repro_torch.models import api, whisper

    t_phase = time.perf_counter()
    cfg = full_config("whisper-base")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    model = api.init(cfg, device="cuda", generator=gen)
    n_params = sum(p.numel() for p in model.parameters())
    e = cfg.encdec
    print(f"{cfg.name}: {n_params / 1e6:.1f} M parameters ("
          f"{e.num_encoder_layers} + {cfg.num_layers} layers, d "
          f"{cfg.d_model}, {cfg.num_heads} heads of {cfg.head_dim}, "
          f"{e.encoder_seq} frames), bf16", flush=True)
    batch = whisper_batch(torch, cfg, gen, WH_B, WH_T, torch.bfloat16)

    def fwd():
        with torch.no_grad():
            return api.forward(model, cfg, batch)[0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    logits = fwd()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    smoke.check(bool(torch.isfinite(logits).all())
                and logits.shape == (WH_B, WH_T, cfg.vocab_size),
                f"{cfg.name} bf16 forward logits finite, shape "
                f"{tuple(logits.shape)}")
    del logits
    ms = cuda_ms(torch, fwd, iters=3, warmup=1)
    print(f"{cfg.name} forward, B {WH_B}: {e.encoder_seq} frames, {WH_T} "
          f"decoder tokens: {ms:.1f} ms, peak {peak:.2f} GiB [{smoke.smi}]",
          flush=True)
    smoke.launches["whisper"] = no_launches(
        smoke, f"{cfg.name} forward and its timed reruns")
    smoke.whisper = {"params": n_params,
                     "forward": {"ms": ms, "peak_gib": peak}}

    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cache = whisper.prefill_cross(
            model, cfg, api.init_cache(cfg, WH_B, WH_TICKS, device="cuda"),
            batch["encoder_embeds"])
        torch.cuda.synchronize()
        cross_ms = (time.perf_counter() - t0) * 1e3
        tick_ms, toks = serve_ticks(torch, model, cfg, cache,
                                    batch["tokens"][:, 0], WH_TICKS)
    no_launches(smoke, f"{cfg.name} prefill_cross and the serve loop")
    print(f"{cfg.name} prefill_cross {cross_ms:.1f} ms, then {WH_TICKS} "
          f"ticks at B {WH_B}: {tick_ms:.2f} ms/tick (cache "
          f"{tree_bytes(cache)} bytes) [{smoke.smi}]", flush=True)
    smoke.check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
                f"{cfg.name} serve loop: {WH_TICKS} in-vocab tokens a row")
    smoke.whisper["serve"] = {"prefill_cross_ms": cross_ms,
                              "ms_per_tick": tick_ms}
    del model, cache
    gc.collect()
    torch.cuda.empty_cache()

    whisper_f32_decode(smoke, cfg)
    tb = whisper_batch(torch, cfg, torch.Generator(device="cuda").manual_seed(
        SEED + 14), WH_B, WH_T, torch.bfloat16)
    smoke.whisper["train"] = family_train(smoke, cfg, tb, SEED + 15,
                                          cfg.name)
    print(f"whisper phase: {time.perf_counter() - t_phase:.1f} s",
          flush=True)


def whisper_f32_decode(smoke: Smoke, cfg):
    """f32, full width and depth: ``prefill_cross``, then ``XL_DECODE``
    tokens one by one through ``decode_step`` against the forward's
    logits over the same frames (the reference's rule)."""
    torch = smoke.torch
    from repro_torch.models import api, whisper

    c32 = cfg.replace(dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    model = api.init(c32, device="cuda", generator=gen)
    b = whisper_batch(torch, c32, gen, WH_F32_B, XL_DECODE, torch.float32)
    with torch.no_grad():
        full, _ = api.forward(model, c32, b)
        cache = whisper.prefill_cross(
            model, c32, api.init_cache(c32, WH_F32_B, XL_DECODE,
                                       device="cuda"), b["encoder_embeds"])
        got = []
        for t in range(XL_DECODE):
            lg, cache = api.decode_step(model, c32, cache, {
                "tokens": b["tokens"][:, t:t + 1],
                "positions": b["positions"][:, t:t + 1]})
            got.append(lg[:, 0])
    err, ok = decode_close(torch.stack(got, 1), full)
    smoke.check(ok, f"f32 {cfg.name} full depth: decode_step over "
                f"{XL_DECODE} tokens vs the forward, max |d| {err:.2e} "
                f"(|d| <= {DECODE_TOL} (1 + |l|))")
    no_launches(smoke, f"{cfg.name} f32 decode check")
    smoke.whisper["f32_decode_max_abs"] = err
    del model, cache
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phases 5 and 6: the train path
# ---------------------------------------------------------------------------

TEXT_LEN = 1024


def mllm_dataset(mllm, seed: int, batch_size: int = 1):
    from repro_torch.data.synthetic import MultimodalDataset
    encs = mllm.encoders
    return MultimodalDataset(
        vocab_size=mllm.llm_cfg.vocab_size, text_len=TEXT_LEN,
        batch_size=batch_size,
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
# Phase 5b: frozen-aware pipeline parallelism, replayed on one card
# ---------------------------------------------------------------------------

PP_MICROBATCHES, PP_BATCH, PP_DEVICES = 4, 4, 4
#: bf16 replay vs single step: the loss's relative error, and the
#: projector gradient's relative Frobenius error (the replay adds the 4
#: microbatches' bf16 partial gradients; eps(bf16) = 2^-8)
PP_BF16_LOSS_RTOL, PP_BF16_GRAD_RTOL = 2e-3, 3e-2
#: f32 parity, the JAX package's own replay-test tolerances
PP_F32_LOSS_RTOL, PP_F32_GRAD_RTOL, PP_F32_GRAD_ATOL = 2e-5, 2e-4, 1e-6


def pp_plan(mllm, **kw):
    from repro_torch.parallel import ClusterSpec, WorkloadShape, parallelize
    return parallelize(mllm, ClusterSpec(num_devices=PP_DEVICES),
                       WorkloadShape(text_len=TEXT_LEN,
                                     num_microbatches=PP_MICROBATCHES,
                                     microbatch_size=1, block_size=128),
                       **kw)


def pp_replay(mllm, ex, params, batch):
    """(bundle, execute_schedule's result, {name: grad}) for one batch
    replayed through the plan's timeline."""
    from repro_torch.core.modality_parallel import execute_schedule
    from repro_torch.models.stages import build_mllm_stages
    bundle = build_mllm_stages(mllm, ex, text_len=TEXT_LEN)
    res = execute_schedule(
        bundle.stage_fns, bundle.partition(params),
        bundle.encode_microbatches(batch, PP_MICROBATCHES),
        ex["sim_graph"], ex["schedule"],
        microbatch_loss=bundle.microbatch_loss,
        trainable=list(bundle.trainable))
    grads = {}
    for g in res["param_grads"]:
        grads.update(g)
    return bundle, res, grads


def pp_single(mllm, params, batch):
    """make_mllm_train_step's loss and gradients on the whole batch."""
    from repro_torch.training.steps import _grads, make_mllm_train_step
    _, loss_fn = make_mllm_train_step(mllm)
    loss, _ = loss_fn(params, batch)
    return loss.detach(), _grads(loss, dict(params.named_parameters()))


def pp_adamw_step(named, grads) -> dict:
    """One AdamW step (``SPMD_OCFG``) of copies of the trained weights
    ``named`` on the replay's summed ``grads`` scaled by 1/M, as
    ``make_spmd_train_step`` scales them: {"grad_norm", "delta": {name:
    f32 change on the CPU}}."""
    from repro_torch.optim import optimizer as opt
    ocfg = opt.AdamWConfig(**SPMD_OCFG)
    upd = {n: p.detach().clone() for n, p in named.items()}
    _, _, om = opt.update(ocfg, {n: grads[n] * (1.0 / PP_MICROBATCHES)
                                 for n in named},
                          opt.init(ocfg, upd), upd)
    return {"grad_norm": float(om["grad_norm"]),
            "delta": {n: (upd[n].float() - p.detach().float()).cpu()
                      for n, p in named.items()}}


def pp_phase(smoke: Smoke):
    """The full-width vlm's pipeline plan, replayed on the card and held
    against the single-process step on the same weights and batch."""
    torch = smoke.torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models.mllm import build_paper_mllm

    mllm = build_paper_mllm("vlm", llm_size="M", vision_size="S")
    mllm.llm_cfg = mllm.llm_cfg.replace(attn_impl="bam_kernel")
    remat = mllm.llm_cfg.remat
    plan = pp_plan(mllm)
    print(plan.describe(), flush=True)
    ex = plan.apply(mllm, mode="replay")
    sim = ex["schedule"]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    params = mllm.init(device="cuda", generator=gen)
    named = dict(params.named_parameters())
    fmask = mllm.frozen_mask(params)
    frozen = {n: p.detach().clone() for n, p in named.items() if fmask[n]}
    batch = next(iter(mllm_dataset(mllm, SEED + 8, PP_BATCH)))
    torch.cuda.synchronize()

    zero_counts()
    t0 = time.perf_counter()
    bundle, res, grads = pp_replay(mllm, ex, params, batch)
    loss_r = float(res["loss"]) / PP_MICROBATCHES
    ms_first = (time.perf_counter() - t0) * 1e3
    counts = kernel_counts()
    smoke.launches["pp"] = {k: counts[k] for k in ("K1", "K2", "K3", "K4")}
    want = pp_expected_launches(bundle, ex["sim_graph"], sim, remat)
    llm_stages = [(sp.lo, sp.hi) for sp in bundle.specs if sp.kind == "llm"]
    print(f"pp replay: {len(bundle.specs)} stages ({', '.join(f'{sp.module}[{sp.lo}:{sp.hi}]' for sp in bundle.specs)}) "
          f"on {sim['num_devices']} simulated devices, "
          f"{len(sim['items'])} items, {PP_MICROBATCHES} microbatches of "
          f"{PP_BATCH // PP_MICROBATCHES}; launches K1 {counts['K1']}, K2 "
          f"{counts['K2']}, K3 {counts['K3']}, K4 {counts['K4']}; derived: "
          f"per LLM layer and microbatch K1 once at F, and per backward "
          f"pass (B through the frozen LLM for the projector's input "
          f"gradient; a W pass only for a trainable LLM) K2 and K3 once "
          f"and K1 once more under remat={remat}: {want} over LLM stages "
          f"{llm_stages}", flush=True)
    smoke.check(all(counts[k] == want[k] for k in want)
                and counts["K4"] == 0 and counts["K1s"] == 0,
                f"pp replay launched K1 {counts['K1']}, K2 {counts['K2']}, "
                f"K3 {counts['K3']} times = derived {want}; K4, K1 stats 0")
    smoke.check(res["peak_activations_per_device"]
                == sim["peak_activations_per_device"],
                f"measured peak activations per simulated device "
                f"{res['peak_activations_per_device']} == simulated "
                f"{sim['peak_activations_per_device']}")

    t0 = time.perf_counter()
    loss_s, ref = pp_single(mllm, params, batch)
    loss_s = float(loss_s)
    ms_single_first = (time.perf_counter() - t0) * 1e3
    rl = abs(loss_r - loss_s) / abs(loss_s)
    smoke.check(np.isfinite(loss_r) and rl <= PP_BF16_LOSS_RTOL,
                f"bf16 full width: replay loss/M {loss_r:.6f} vs single step "
                f"{loss_s:.6f} (rel {rl:.2e}, tol {PP_BF16_LOSS_RTOL})")
    trained = sorted(n for n, g in ref.items() if g is not None)
    smoke.check(sorted(grads) == trained,
                f"the replay's gradients are the single step's trainable "
                f"set ({len(trained)}: {', '.join(trained)})")
    for name in trained:
        got = grads[name].float() / PP_MICROBATCHES
        want_g = ref[name].float()
        rel = float((got - want_g).norm() / want_g.norm())
        smoke.check(rel <= PP_BF16_GRAD_RTOL,
                    f"bf16 full width: {name} gradient/M vs single step, "
                    f"relative Frobenius error {rel:.2e} (tol "
                    f"{PP_BF16_GRAD_RTOL}); max |d| "
                    f"{float((got - want_g).abs().max()):.3e}")
    smoke.pp_ref = {"loss": loss_r, "n_frozen": len(frozen),
                    "grads": {n: (grads[n].float() / PP_MICROBATCHES).cpu()
                              for n in trained},
                    "step": pp_adamw_step({n: named[n] for n in trained},
                                          grads)}
    del grads, ref
    same = sum(torch.equal(named[n], c) for n, c in frozen.items())
    no_grad = all(named[n].grad is None for n in frozen)
    smoke.check(same == len(frozen) and no_grad,
                f"{same}/{len(frozen)} frozen parameters bit-identical, "
                f"none with a .grad ({no_grad})")
    del frozen

    # times (host clock ending in a host read of the loss) and peak
    # memory of second runs, the frozen copies freed
    gc.collect()
    torch.cuda.empty_cache()
    weights_gib = torch.cuda.memory_allocated() / 2 ** 30
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, res2, _ = pp_replay(mllm, ex, params, batch)
    float(res2["loss"])
    ms_replay = (time.perf_counter() - t0) * 1e3
    peak_replay = torch.cuda.max_memory_allocated() / 2 ** 30
    smoke.pp_ref["ms"] = ms_replay
    del res2
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss2, _ = pp_single(mllm, params, batch)
    float(loss2)
    ms_single = (time.perf_counter() - t0) * 1e3
    peak_single = torch.cuda.max_memory_allocated() / 2 ** 30
    del loss2
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, res3, _ = pp_replay(mllm, ex, params, batch)
        float(res3["loss"])
        wall_us = (time.perf_counter() - t0) * 1e6
    del res3
    evs = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in evs)
    top = sorted(evs, key=lambda e: -e.self_device_time_total)[:6]
    print(f"pp [{smoke.smi}]: replay {ms_replay:.1f} ms (first "
          f"{ms_first:.1f}), single step {ms_single:.1f} ms (first "
          f"{ms_single_first:.1f}) on the same batch of {PP_BATCH}; peak "
          f"memory replay {peak_replay:.2f} GiB (every simulated device's "
          f"in-flight activations on this card, simulated peaks "
          f"{sim['peak_activations_per_device']}), single step "
          f"{peak_single:.2f} GiB, of which {weights_gib:.2f} GiB held "
          f"before either (weights, batch)", flush=True)
    print(f"pp [{smoke.smi}]: profiled replay wall {wall_us / 1e3:.1f} ms, "
          f"device busy {busy_us / 1e3:.1f} ms ({100 * busy_us / wall_us:.1f}"
          f"% busy); top kernels: " + "; ".join(
              f"{e.key[:48]} {e.self_device_time_total / 1e3:.2f} ms "
              f"x{e.count}" for e in top) + bam_shares(evs), flush=True)
    del params, named, batch
    gc.collect()
    torch.cuda.empty_cache()


def pp_parity_phase(smoke: Smoke):
    """f32, 2 LLM and 2 encoder layers at full width, remat on: the replay
    of the searched plan, and of an ft1 plan (trainable LLM) pinned to
    ZB-H1 whose W items run on the card, against the single step."""
    torch = smoke.torch
    from repro_torch.models.mllm import build_paper_mllm

    def build(train_llm):
        m = build_paper_mllm("vlm", llm_size="M", vision_size="S")
        m.llm_cfg = m.llm_cfg.replace(num_layers=2, dtype="float32",
                                      attn_impl="bam_kernel")
        enc = m.encoders["vision"]
        enc.cfg = enc.cfg.replace(num_layers=2, dtype="float32")
        if train_llm:
            m.freeze("llm", module=False)
        return m

    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    params = build(False).init(device="cuda", generator=gen)
    batch = next(iter(mllm_dataset(build(False), SEED + 9, PP_BATCH)))
    for label, train_llm, kw in (
            ("searched plan", False, {}),
            ("ft1 ZB-H1 plan", True, {"schedules": ("zb-h1",)})):
        mllm = build(train_llm)
        mllm.apply_freeze(params)
        plan = pp_plan(mllm, **kw)
        ex = plan.apply(mllm, mode="replay")
        n_w = sum(1 for it in ex["schedule"]["items"] if it[3] == "W")
        zero_counts()
        _, res, grads = pp_replay(mllm, ex, params, batch)
        counts = kernel_counts()
        loss_s, ref = pp_single(mllm, params, batch)
        loss_r, loss_s = float(res["loss"]) / PP_MICROBATCHES, float(loss_s)
        rl = abs(loss_r - loss_s) / abs(loss_s)
        worst, worst_name = 0.0, ""
        for name, g in ref.items():
            if g is None:
                continue
            d = (grads[name] / PP_MICROBATCHES - g).abs()
            ratio = float((d / (PP_F32_GRAD_ATOL
                                + PP_F32_GRAD_RTOL * g.abs())).max())
            if ratio > worst:
                worst, worst_name = ratio, name
        n_grads = sum(g is not None for g in ref.values())
        smoke.check(
            rl <= PP_F32_LOSS_RTOL and worst <= 1.0
            and len(grads) == n_grads,
            f"f32 2+2 layers full width, {label} ({plan.schedule.name}, "
            f"v={plan.schedule.virtual_chunks}, {n_w} W items; K1 "
            f"{counts['K1']}, K2 {counts['K2']}, K3 {counts['K3']}): replay "
            f"loss/M {loss_r:.7f} vs single step {loss_s:.7f} (rel "
            f"{rl:.2e}, tol {PP_F32_LOSS_RTOL}); {len(grads)} gradients, "
            f"worst |d| / (atol + rtol |ref|) {worst:.3f} at {worst_name} "
            f"(rtol {PP_F32_GRAD_RTOL}, atol {PP_F32_GRAD_ATOL})")
        if train_llm:
            smoke.check(n_w > 0 and counts["K2"] > 0,
                        f"the ft1 plan's {n_w} W items ran on the card")
        del res, grads, ref
    del params
    gc.collect()
    torch.cuda.empty_cache()


def launch_phase(smoke: Smoke):
    """The launcher at full width: plan search, then 2 steps."""
    torch = smoke.torch
    from repro_torch.launch import train as launch
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = launch.main(["--mllm", "vlm", "--steps", "2", "--seq",
                       str(TEXT_LEN), "--batch", str(PP_BATCH),
                       "--microbatches", str(PP_MICROBATCHES),
                       "--plan-devices", str(PP_DEVICES), "--log-every",
                       "1"])
    took = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    smoke.launch_losses = res["losses"]
    smoke.check(len(res["losses"]) == 2
                and all(np.isfinite(x) for x in res["losses"]),
                f"launcher [{smoke.smi}]: --mllm vlm at full width, "
                f"{res['params'] / 1e9:.2f} B parameters, losses "
                f"{res['losses']} finite; {took:.1f} s including init and "
                f"plan, peak memory {peak:.2f} GiB")
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 5c: the distributed schedule runner, one process per pipeline rank
# ---------------------------------------------------------------------------

#: the spmd run against the pp replay (bf16 on both sides, one schedule);
#: the gradient tolerance also bounds the AdamW step's norm and change
SPMD_LOSS_RTOL, SPMD_GRAD_RTOL = 1e-3, 1e-2
#: the optimizer of the spmd step's check: the launcher's at --steps 2
#: (lr 1e-3, one warmup step), so that the first step moves bf16 weights
SPMD_OCFG = dict(lr=1e-3, warmup_steps=1, total_steps=2)


def spmd_rank(rank: int, world: int, payload) -> dict:
    """One of the spmd phase's rank processes, on the one card over
    gloo: the pp phase's model and batch, only this rank's stages kept,
    the plan's wave program run once with the launch counts zeroed just
    before and read just after, then one ``make_spmd_train_step`` step
    on the same batch, the memory check and two timed runs."""
    import torch
    import torch.distributed as dist
    from repro_torch.core.schedule.memory import (MemoryModelMismatch,
                                                  validate_schedule_memory)
    from repro_torch.models.mllm import build_paper_mllm
    from repro_torch.optim import optimizer as opt
    from repro_torch.parallel import spmd
    from repro_torch.training.steps import make_spmd_train_step
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mllm = build_paper_mllm("vlm", llm_size="M", vision_size="S")
    mllm.llm_cfg = mllm.llm_cfg.replace(attn_impl="bam_kernel")
    ex = pp_plan(mllm).apply(mllm, mode="spmd")
    bundle, prog, sim = ex["stage_bundle"], ex["spmd_program"], \
        ex["schedule"]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    params = mllm.init(device="cuda", generator=gen)
    fmask = mllm.frozen_mask(params)
    batch = next(iter(mllm_dataset(mllm, SEED + 8, PP_BATCH)))
    mbs = bundle.encode_microbatches(batch, PP_MICROBATCHES)
    stage_params, masks = bundle.hosted_share(params, prog.hosted[rank])
    mine = {n: p for sp in stage_params if sp is not None
            for n, p in sp.named_parameters()}
    del params, batch
    gc.collect()
    torch.cuda.empty_cache()
    weights_gib = torch.cuda.memory_allocated() / 2 ** 30
    frozen = {n: p.detach().clone() for n, p in mine.items() if fmask[n]}
    before = {n: p.detach().clone() for n, p in mine.items() if not fmask[n]}
    runner = spmd.build_spmd_runner(
        bundle.stage_fns, ex["sim_graph"], sim,
        microbatch_loss=bundle.microbatch_loss, program=prog,
        trainable=list(bundle.trainable))
    torch.cuda.synchronize()
    dist.barrier()

    zero_counts()
    t0 = time.perf_counter()
    res = runner(stage_params, mbs)
    loss = float(res["loss"])
    ms_first = (time.perf_counter() - t0) * 1e3
    counts = kernel_counts()
    full = spmd.gather_result(res)
    grads = {}
    if rank == 0:
        for g in full["param_grads"]:
            grads.update({n: (t.float() / PP_MICROBATCHES).cpu()
                          for n, t in (g or {}).items()})
    out = {"rank": rank, "loss": loss, "counts": counts, "grads": grads,
           "peaks": res["peak_activations_per_device"],
           "sim_peaks": sim["peak_activations_per_device"],
           "trace_len": len(res["activation_trace"]),
           "ms_first": ms_first, "weights_gib": weights_gib}
    del full, res
    # one train step on the same batch: the runner again, 1/M, AdamW
    # over this rank's stages (only the trained ones get a state)
    step = make_spmd_train_step(
        bundle.stage_fns, ex["sim_graph"], sim, opt.AdamWConfig(**SPMD_OCFG),
        microbatch_loss=bundle.microbatch_loss, frozen_mask=masks,
        trainable=list(bundle.trainable), grad_scale=1.0 / PP_MICROBATCHES,
        program=prog)
    _, state, om = step(stage_params, None, mbs)
    out["step"] = {"loss": float(om["loss"]),
                   "grad_norm": float(om["grad_norm"]),
                   "states": sum(m is not None for m in state["m"].values()),
                   "delta": {n: (mine[n].detach().float() - b.float()).cpu()
                             for n, b in before.items()}}
    del step, state, before
    out["frozen"] = (sum(torch.equal(mine[n], c) for n, c in frozen.items()),
                     len(frozen),
                     all(mine[n].grad is None for n in frozen))
    del frozen
    gc.collect()
    torch.cuda.empty_cache()
    try:
        rep = validate_schedule_memory(
            ex["sim_graph"], PP_MICROBATCHES, sim=sim,
            stage_fn=bundle.stage_fns, stage_params=stage_params,
            microbatches=mbs, executor="spmd")
        out["memory"] = (True, rep["executor_peaks"])
    except MemoryModelMismatch as e:                 # a failed check
        out["memory"] = (False, str(e)[:400])
    ms, staged = [], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        r = runner(stage_params, mbs)
        float(r["loss"])
        ms.append((time.perf_counter() - t0) * 1e3)
        staged.append(r["staged_bytes"])
        del r
    out.update(ms=ms, staged=staged,
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    return out


def spmd_phase(smoke: Smoke):
    """The pp phase's full-width vlm and plan, run by the distributed
    runner with one process per pipeline rank (2 processes on the one
    card over gloo, tensors staged through pinned host memory), held
    against the pp replay; then the launcher's --spmd against its replay
    run."""
    torch = smoke.torch
    from repro_torch.analysis import (format_findings, gate,
                                      lint_executor_contract, lint_plan)
    from repro_torch.launch import train as launch
    from repro_torch.models.mllm import build_paper_mllm

    mllm = build_paper_mllm("vlm", llm_size="M", vision_size="S")
    mllm.llm_cfg = mllm.llm_cfg.replace(attn_impl="bam_kernel")
    plan = pp_plan(mllm)
    ex = plan.apply(mllm, mode="spmd")
    prog, sim = ex["spmd_program"], ex["schedule"]
    found = lint_plan(plan) + lint_executor_contract(ex)
    rounds = [r.kind for w in prog.waves for r in w.rounds]
    smoke.check(not gate(found),
                f"schedule lint of apply(mode='spmd'): {len(found)} "
                f"findings, no error"
                f"{'; ' + format_findings(found) if found else ''}; "
                f"program {plan.schedule.name} v="
                f"{plan.schedule.virtual_chunks}: {len(prog.waves)} waves, "
                f"{rounds.count('fwd')} fwd and {rounds.count('bwd')} bwd "
                f"rounds, {len(prog.items)} items, stages per rank "
                f"{prog.hosted}")
    want = pp_expected_launches(ex["stage_bundle"], ex["sim_graph"], sim,
                                mllm.llm_cfg.remat)
    del ex
    gc.collect()
    torch.cuda.empty_cache()
    D = prog.num_devices
    t0 = time.perf_counter()
    res = launch.spawn_ranks(D, "gloo", spmd_rank, None)
    took = time.perf_counter() - t0
    r0 = res[0]
    ref = smoke.pp_ref
    total = {k: sum(res[r]["counts"][k] for r in res) for k in KERNEL_KEYS}
    smoke.launches["spmd"] = {k: total[k] for k in ("K1", "K2", "K3", "K4")}
    smoke.check(all(total[k] == want[k] for k in want)
                and total["K4"] == 0 and total["K1s"] == 0,
                f"spmd: launches summed over {D} ranks K1 {total['K1']}, K2 "
                f"{total['K2']}, K3 {total['K3']}, K4 {total['K4']} = "
                f"derived {want} (per rank: "
                + "; ".join(f"{r}: K1 {res[r]['counts']['K1']} K2 "
                            f"{res[r]['counts']['K2']} K3 "
                            f"{res[r]['counts']['K3']}" for r in res) + ")")
    loss = r0["loss"] / PP_MICROBATCHES
    rl = abs(loss - ref["loss"]) / abs(ref["loss"])
    smoke.check(rl <= SPMD_LOSS_RTOL,
                f"spmd loss/M {loss!r} vs pp replay {ref['loss']!r} (rel "
                f"{rl:.2e}, tol {SPMD_LOSS_RTOL}); bit-equal: "
                f"{loss == ref['loss']}")
    smoke.check(sorted(r0["grads"]) == sorted(ref["grads"]),
                f"spmd gradients gathered on rank 0: {sorted(r0['grads'])}")
    for name, want_g in ref["grads"].items():
        got = r0["grads"].get(name)
        rel = float((got - want_g).norm() / want_g.norm()) \
            if got is not None else float("inf")
        smoke.check(rel <= SPMD_GRAD_RTOL,
                    f"spmd {name} gradient/M vs pp replay, relative "
                    f"Frobenius error {rel:.2e} (tol {SPMD_GRAD_RTOL}); "
                    f"bit-equal: {got is not None and torch.equal(got, want_g)}")
    steps_ = [res[r]["step"] for r in sorted(res)]
    gn, gn_ref = steps_[0]["grad_norm"], ref["step"]["grad_norm"]
    rel = abs(gn - gn_ref) / gn_ref
    smoke.check(all(st["grad_norm"] == gn for st in steps_)
                and rel <= SPMD_GRAD_RTOL,
                f"spmd make_spmd_train_step: global gradient norm {gn!r} "
                f"(all-reduced over the ranks, 1/M) vs the pp replay's "
                f"{gn_ref!r} (rel {rel:.2e}, tol {SPMD_GRAD_RTOL}); step loss "
                f"{steps_[0]['loss']!r}")
    delta = {}
    for st in steps_:
        delta.update(st["delta"])
    smoke.check(sorted(delta) == sorted(ref["step"]["delta"])
                and sum(st["states"] for st in steps_) == len(delta),
                f"spmd AdamW: {len(delta)} trained parameters moved over "
                f"the ranks, {[st['states'] for st in steps_]} optimizer "
                f"states per rank (frozen slots none): {sorted(delta)}")
    for name, want_d in ref["step"]["delta"].items():
        got = delta.get(name)
        rel = float((got - want_d).norm() / want_d.norm()) \
            if got is not None else float("inf")
        smoke.check(rel <= SPMD_GRAD_RTOL and float(want_d.norm()) > 0,
                    f"spmd AdamW change of {name} vs the same step on the pp "
                    f"replay's gradients, relative Frobenius {rel:.2e} (tol "
                    f"{SPMD_GRAD_RTOL}), |change| {float(want_d.norm()):.3e}; "
                    f"bit-equal: {got is not None and torch.equal(got, want_d)}")
    same = sum(res[r]["frozen"][0] for r in res)
    n_frozen = sum(res[r]["frozen"][1] for r in res)
    no_grad = all(res[r]["frozen"][2] for r in res)
    smoke.check(same == n_frozen == ref["n_frozen"] and no_grad,
                f"spmd: {same}/{n_frozen} frozen parameters bit-identical "
                f"over the ranks after the AdamW step (pp phase: "
                f"{ref['n_frozen']}), none with a .grad ({no_grad})")
    smoke.check(all(res[r]["peaks"][r] == r0["sim_peaks"][r] for r in res),
                f"spmd: each rank's measured peak activations "
                f"{[res[r]['peaks'][r] for r in sorted(res)]} == simulated "
                f"{r0['sim_peaks']}; trace of {r0['trace_len']} items")
    smoke.check(all(res[r]["memory"][0] for r in res),
                f"spmd: validate_schedule_memory(executor='spmd') on every "
                f"rank: {[res[r]['memory'][1] for r in sorted(res)]}")
    ms = [max(res[r]["ms"][i] for r in res) for i in range(2)]
    staged = [sum(res[r]["staged"][i] for r in res) for i in range(2)]
    print(f"spmd [{smoke.smi}]: {D} rank processes time-slicing this one "
          f"card (no pipeline overlap: not a pipeline's speed): step "
          f"{ms[0]:.1f} / {ms[1]:.1f} ms (first "
          f"{max(res[r]['ms_first'] for r in res):.1f}) against the pp "
          f"replay's {ref['ms']:.1f} ms on the same batch; peak memory per "
          f"rank " + ", ".join(f"{r}: {res[r]['peak_gib']:.2f} GiB "
                               f"(weights and microbatches "
                               f"{res[r]['weights_gib']:.2f})"
                               for r in sorted(res))
          + f"; host staging {staged[0] / 1e6:.1f} MB per step (card to "
          f"host and back, both ranks); {took:.1f} s with spawn and init",
          flush=True)

    argv = ["--mllm", "vlm", "--steps", "2", "--seq", str(TEXT_LEN),
            "--batch", str(PP_BATCH), "--microbatches",
            str(PP_MICROBATCHES), "--plan-devices", str(PP_DEVICES),
            "--log-every", "1"]
    t0 = time.perf_counter()
    got = launch.main(argv + ["--spmd"])
    took = time.perf_counter() - t0
    rel = max(abs(a - b) / abs(b)
              for a, b in zip(got["losses"], smoke.launch_losses))
    smoke.check(len(got["losses"]) == 2 and rel <= SPMD_LOSS_RTOL,
                f"launcher --spmd [{smoke.smi}]: losses {got['losses']} vs "
                f"the replay launcher's {smoke.launch_losses} (max rel "
                f"{rel:.2e}, tol {SPMD_LOSS_RTOL}); {took:.1f} s including "
                f"spawn, init and plan")
    gc.collect()
    torch.cuda.empty_cache()
    islands_check(smoke)


def islands_check(smoke: Smoke):
    """``ModalityIslands`` on the card: the reduced valm's two encoders,
    each on its own CUDA stream of cuda:0, then the copy to the LLM's
    device and the LLM, held against ``mllm.forward`` at f32."""
    torch = smoke.torch
    from repro_torch.core.modality_parallel import (ModalityIslands,
                                                    split_devices)
    from repro_torch.models.mllm import build_paper_mllm
    mllm = build_paper_mllm("valm", reduced=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    params = mllm.init(device="cuda", generator=gen)
    batch = {"text_tokens": torch.randint(
        0, mllm.llm_cfg.vocab_size, (2, 64), generator=gen, device="cuda")}
    for name, enc in mllm.encoders.items():
        batch[f"{name}_embeds"] = torch.randn(
            (2, enc.num_tokens, enc.cfg.d_model), generator=gen,
            device="cuda")
    isl = ModalityIslands(mllm, split_devices(mllm, ["cuda:0"] * 3))
    streams = {n: i.stream for n, i in isl.islands.items()}
    with torch.no_grad():
        got, _ = isl.run(params, batch)
        (want, _), _ = mllm.forward(params, batch)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    tol = 1e-5 * float(want.abs().max())
    cur = torch.cuda.current_stream()
    smoke.check(all(s is not None and s != cur for s in streams.values())
                and got.shape == want.shape and err <= tol,
                f"ModalityIslands on cuda:0: encoders {sorted(streams)} each "
                f"on its own stream, logits {tuple(got.shape)} vs "
                f"mllm.forward max |d| {err:.3e} (tol {tol:.3e}, 1e-5 of "
                f"max |logit|, f32); bit-equal: {torch.equal(got, want)}")


# ---------------------------------------------------------------------------
# Phase 5d: the training runtime (checkpoints, the resilience runtime)
# ---------------------------------------------------------------------------

#: guarded steps of the uninterrupted run; the interrupted run saves
#: every RES_CKPT_EVERY steps and crashes before step RES_CRASH
RES_STEPS, RES_CKPT_EVERY, RES_CRASH = 4, 2, 3
#: AdamW of the runtime's runs (the train phase's)
RES_OCFG = dict(lr=1e-3, warmup_steps=1, total_steps=10)
#: LLM depth of the rank-sharded spmd save, crash and resume (full
#: width; the depth keeps its two checkpoints to a few GB of disk)
RES_SPMD_LLM_LAYERS = 8


def res_root(name: str) -> Path:
    """A checkpoint root under the checkout's ignored build/, empty."""
    root = ROOT / "build" / "resilience" / name
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    return root


def res_vlm(llm_layers=None):
    from repro_torch.models.mllm import build_paper_mllm
    mllm = build_paper_mllm("vlm", llm_size="M", vision_size="S")
    mllm.llm_cfg = mllm.llm_cfg.replace(attn_impl="bam_kernel")
    if llm_layers:
        mllm.llm_cfg = mllm.llm_cfg.replace(num_layers=llm_layers)
    return mllm


def res_timed(torch, manager, log: list):
    """Wrap ``manager.save``/``restore`` to time each call (ending in a
    device sync) and, for a save, count the bytes it wrote (files with
    one link) and the frozen shards it hardlinked forward."""
    save, restore = manager.save, manager.restore

    def timed_save(step, tree, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d = save(step, tree, **kw)
        secs = time.perf_counter() - t0
        st = {f: os.stat(os.path.join(d, f)) for f in os.listdir(d)
              if f.endswith(".npy")}
        log.append({"op": "save", "step": step, "s": secs, "dir": d,
                    "bytes": sum(s.st_size for s in st.values()
                                 if s.st_nlink == 1),
                    "new": {f for f, s in st.items() if s.st_nlink == 1},
                    "reused": sum(s.st_nlink > 1 for s in st.values()),
                    "shards": len(st)})
        return d

    def timed_restore(like=None, **kw):
        t0 = time.perf_counter()
        out = restore(like, **kw)
        torch.cuda.synchronize()
        log.append({"op": "load", "step": out[1],
                    "s": time.perf_counter() - t0})
        return out

    manager.save, manager.restore = timed_save, timed_restore
    return manager


def res_trainer(mllm, params, *, root=None, faults=(), ckpt_every=0,
                resume=False, monitor=None, log=None, step_fn=None):
    """A ``ResilientTrainer`` over the guarded vlm step, the replay
    launcher's frozen checkpoint paths, and ``mllm_dataset``'s stream of
    batches of PP_BATCH."""
    import torch
    from repro_torch.launch.train import frozen_ckpt_paths
    from repro_torch.optim import optimizer as opt
    from repro_torch.resilience import (CheckpointManager, CursorStream,
                                        FaultInjector, FaultPlan,
                                        ResilientTrainer,
                                        make_resilient_train_step)
    from repro_torch.training.steps import make_mllm_train_step
    ocfg = opt.AdamWConfig(**RES_OCFG)
    fmask = mllm.frozen_mask(params)
    if step_fn is None:
        step_fn = make_resilient_train_step(
            make_mllm_train_step(mllm, ocfg)[1], ocfg, fmask)
    manager = None
    if root is not None:
        manager = res_timed(torch, CheckpointManager(
            str(root), frozen_paths=frozen_ckpt_paths(mllm, False)), log)
    return ResilientTrainer(
        step_fn, params, opt.init(ocfg, dict(params.named_parameters()),
                                  fmask),
        CursorStream(lambda: mllm_dataset(mllm, SEED, PP_BATCH)),
        monitor=monitor, manager=manager,
        injector=FaultInjector(FaultPlan.make(list(faults))),
        ckpt_every=ckpt_every, resume=resume,
        meta={"seed": SEED, "mllm": "vlm", "mode": "replay"})


def res_disk_need(mllm) -> int:
    """Bytes of the phase's two roots together, with 5% headroom: the
    replay root's leaves once (the later saves hardlink the frozen ones;
    the trainable ones and their two f32 moments once per retained
    step) and the depth-cut spmd root's two checkpoints. The replay root
    is deleted before the spmd one is written, so this bounds the disk
    the phase holds at once from above."""
    params = mllm.init(device="meta")
    fmask = mllm.frozen_mask(params)
    frozen = sum(p.numel() * p.element_size()
                 for n, p in params.named_parameters() if fmask[n])
    train = sum(p.numel() * (p.element_size() + 8)
                for n, p in params.named_parameters() if not fmask[n])
    cut = res_vlm(RES_SPMD_LLM_LAYERS).init(device="meta")
    cut_bytes = sum(p.numel() * p.element_size()
                    for p in cut.parameters())
    return int(1.05 * (frozen + 3 * train + 2 * cut_bytes))


def resilience_phase(smoke: Smoke):
    """The guarded vlm step and its checkpoints at full width and depth
    (the train phase's model, bf16, remat on, batches of PP_BATCH): an
    uninterrupted run, an interrupted one resumed bit for bit, frozen
    shards hardlinked forward, a NaN skip and rollback; then --spmd's
    cross-mode adopt and a rank-sharded save, crash and resume on 2 rank
    processes."""
    torch = smoke.torch
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.launch import train as launch
    from repro_torch.optim import optimizer as opt
    from repro_torch.resilience import (CrashInjected, Fault, HealthMonitor,
                                        MonitorConfig, default_controls)
    from repro_torch.training.steps import make_mllm_train_step

    mllm = res_vlm()
    need = res_disk_need(mllm)
    (ROOT / "build").mkdir(exist_ok=True)
    free = shutil.disk_usage(ROOT / "build").free
    smoke.check(free >= need, f"resilience: {free / 1e9:.1f} GB free under "
                f"build/, the phase needs {need / 1e9:.1f} GB")
    if free < need:
        return
    L, remat = mllm.llm_cfg.num_layers, mllm.llm_cfg.remat
    want = {"K1": L * (2 if remat else 1), "K2": L, "K3": L}
    if "train" in smoke.launches:
        smoke.check(all(smoke.launches["train"][k] == 3 * want[k]
                        for k in want), f"train phase per step {want}")

    # 1. an uninterrupted run: RES_STEPS guarded steps, no disk
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = mllm.init(device="cuda", generator=gen)
    tr = res_trainer(mllm, params)
    zero_counts()
    run1 = tr.run(RES_STEPS)["losses"]
    counts = kernel_counts()
    per = {k: counts[k] / RES_STEPS for k in want}
    smoke.check(per == {k: float(v) for k, v in want.items()}
                and counts["K4"] == 0,
                f"resilience: launches per guarded step K1 {per['K1']}, K2 "
                f"{per['K2']}, K3 {per['K3']} = the train step's {want} "
                f"({RES_STEPS} steps, K4 {counts['K4']}); losses {run1}")
    # the guard's cost: plain and guarded steps in turns, same params
    plain_step, _ = make_mllm_train_step(mllm, opt.AdamWConfig(**RES_OCFG))
    batch = tr.stream.next()
    ms = {"plain": [], "guarded": []}
    for _ in range(3):
        for kind in ("plain", "guarded"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if kind == "plain":
                _, tr.opt_state, met = plain_step(tr.params, tr.opt_state,
                                                  batch)
                float(met["loss"])
            else:
                _, tr.opt_state, tr.health, _ = tr.step_fn(
                    tr.params, tr.opt_state, tr.health, batch,
                    default_controls())
            torch.cuda.synchronize()
            ms[kind].append((time.perf_counter() - t0) * 1e3)
    smoke.resilience = {"plain_ms": ms["plain"], "guarded_ms": ms["guarded"]}
    print(f"resilience [{smoke.smi}]: step ms, plain "
          f"{[round(x, 1) for x in ms['plain']]}, guarded (one bundle read "
          f"before the update) {[round(x, 1) for x in ms['guarded']]}; "
          f"medians {sorted(ms['plain'])[1]:.1f} / "
          f"{sorted(ms['guarded'])[1]:.1f} ms", flush=True)
    del tr, params
    gc.collect()
    torch.cuda.empty_cache()

    # 2. the same run from the same seed, saved every RES_CKPT_EVERY
    # steps and crashed before step RES_CRASH; then resumed
    root = res_root("replay")
    saves: list = []
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = mllm.init(device="cuda", generator=gen)
    tr = res_trainer(mllm, params, root=root, log=saves,
                     faults=[Fault("crash", RES_CRASH)],
                     ckpt_every=RES_CKPT_EVERY)
    try:
        tr.run(RES_STEPS)
        crashed = None
    except CrashInjected as e:
        crashed = str(e)
    pre = dict(tr.losses)
    smoke.check(crashed is not None and pre == {k: run1[k] for k in pre}
                and sorted(pre) == list(range(RES_CRASH)),
                f"resilience: crash injected ({crashed}); steps {sorted(pre)} "
                f"before it bit-equal to the uninterrupted run")
    tr = res_trainer(mllm, params, root=root, log=saves, resume=True,
                     ckpt_every=RES_CKPT_EVERY)
    post = tr.run(RES_STEPS)["losses"]
    diverged = [k for k in post if post[k] != run1[k]]
    worst = max((abs(post[k] - run1[k]) for k in post), default=0.0)
    smoke.check(sorted(post) == list(range(RES_CKPT_EVERY, RES_STEPS))
                and not diverged,
                f"resilience: resumed at step {RES_CKPT_EVERY}, losses "
                f"{post} bit-equal to the uninterrupted run's "
                f"{ {k: run1[k] for k in post} } (diverged at "
                f"{diverged or 'none'}, max |d| {worst:.3e})")
    first = next(s for s in saves if s["op"] == "save")
    later = [s for s in saves if s["op"] == "save" and s is not first]
    loads = [s for s in saves if s["op"] == "load"]
    man = ckpt.read_manifest(later[-1]["dir"]) if later else {"entries": []}
    frozen_entries = [e for e in man["entries"] if e["path"].startswith(
        ("params/encoders/vision/module", "params/llm"))]
    # a later save writes the projector, its moments, AdamW's step and
    # the EMA, and links every frozen shard
    rest = {e["file"] for e in man["entries"]} - {
        e["file"] for e in frozen_entries}
    smoke.check(bool(later) and later[-1]["reused"] == len(frozen_entries)
                > 0 and later[-1]["new"] == rest
                and later[-1]["shards"] == len(man["entries"]),
                f"resilience [{smoke.smi}]: first save (step "
                f"{first['step']}) {first['bytes']} bytes in {first['s']:.2f} "
                f"s ({first['bytes'] / first['s'] / 1e9:.2f} GB/s); later "
                f"save(s) " + "; ".join(
                    f"step {s['step']}: {s['bytes']} bytes in {s['s']:.2f} s, "
                    f"{s['reused']} of {s['shards']} shards hardlinked "
                    f"forward" for s in later)
                + f" (frozen: {len(frozen_entries)}; written: "
                f"{len(rest)} shards, the projector, its moments, AdamW's "
                f"step, the EMA and the frozen slots' (0,) placeholders); "
                f"verified load(s) "
                + ", ".join(f"{s['s']:.2f} s" for s in loads))

    # 3. a NaN skip, then a NaN rollback, from the resumed state
    monitor = HealthMonitor(MonitorConfig(skip_limit=1))
    inner, skip_seen = tr.step_fn, []

    def watched(p, state, health, batch, controls):
        if controls["inject_nan"] == 0 or skip_seen:
            return inner(p, state, health, batch, controls)
        before = ({n: t.detach().clone() for n, t in p.named_parameters()},
                  {k: {n: None if t is None else t.clone()
                       for n, t in state[k].items()} for k in ("m", "v")},
                  state["step"], dict(health))
        out = inner(p, state, health, batch, controls)
        same = (all(torch.equal(t, before[0][n])
                    for n, t in out[0].named_parameters())
                and all((t is None and before[1][k][n] is None)
                        or torch.equal(t, before[1][k][n])
                        for k in ("m", "v") for n, t in out[1][k].items())
                and out[1]["step"] == before[2] and out[2] == before[3])
        skip_seen.append((same, float(out[3][0])))
        return out

    resumed = tr
    tr = res_trainer(mllm, params, root=root, log=saves, monitor=monitor,
                     faults=[Fault("nan_grads", RES_STEPS),
                             Fault("nan_grads", RES_STEPS + 1)],
                     step_fn=watched)
    tr.adopt_state(params, resumed.opt_state, resumed.health,
                   step=RES_STEPS, cursor=RES_STEPS)
    del resumed
    res = tr.run(RES_STEPS + 2)
    smoke.res_loss4 = res["losses"].get(RES_STEPS)
    smoke.check(res["skipped"] == 1 and res["rollbacks"] == 1
                and skip_seen and skip_seen[0][0]
                and sorted(res["losses"]) == [RES_STEPS, RES_STEPS + 1]
                and all(np.isfinite(v) for v in res["losses"].values())
                and skip_seen[0][1] == smoke.res_loss4,
                f"resilience: NaN at step {RES_STEPS} skipped, every "
                f"parameter, moment and the EMA torch.equal after it "
                f"({bool(skip_seen and skip_seen[0][0])}); NaN at step "
                f"{RES_STEPS + 1} rolled back to step "
                f"{[e['step'] for e in monitor.log.of_kind('restore')]} and "
                f"retried at clip_scale {res['clip_scale']} (its verified "
                f"load {saves[-1]['s']:.2f} s): losses {res['losses']} (the "
                f"skipped step's loss "
                f"{skip_seen[0][1] if skip_seen else None})")
    del tr, inner, watched, params
    gc.collect()
    torch.cuda.empty_cache()

    # 4. --spmd: a cross-mode adopt of the replay checkpoint, one step
    adopt = str(root / f"step_{RES_STEPS:08d}")
    t0 = time.perf_counter()
    out = launch.spawn_ranks(2, "gloo", resilience_rank, {
        "adopt": adopt, "steps": RES_STEPS + 1})
    took = time.perf_counter() - t0
    got = out[0]["losses"].get(RES_STEPS)
    rel = abs(got - smoke.res_loss4) / abs(smoke.res_loss4) \
        if got is not None and smoke.res_loss4 else float("inf")
    smoke.check(rel <= SPMD_LOSS_RTOL and out[1]["losses"] == out[0]["losses"],
                f"resilience --spmd [{smoke.smi}]: 2 ranks adopt the replay "
                f"checkpoint of step {RES_STEPS} (each loads its share: "
                + ", ".join(f"{out[r]['load_s']:.2f} s" for r in sorted(out))
                + f"), step {RES_STEPS} loss {got!r} vs the single process's "
                f"{smoke.res_loss4!r} (rel {rel:.2e}, tol {SPMD_LOSS_RTOL}); "
                f"{took:.1f} s with spawn and init")
    shutil.rmtree(root, ignore_errors=True)

    # 5. --spmd, LLM cut to RES_SPMD_LLM_LAYERS: the ranks' save, a crash
    # on both, and a resume
    sroot = res_root("spmd")
    payload = {"root": str(sroot), "steps": RES_STEPS,
               "llm_layers": RES_SPMD_LLM_LAYERS,
               "ckpt_every": RES_CKPT_EVERY,
               "faults": [("crash", RES_CRASH)]}
    try:
        launch.spawn_ranks(2, "gloo", resilience_rank, payload)
        crash = None
    except CrashInjected as e:
        crash = str(e)
    pre = json.loads((sroot / "losses_0.json").read_text())
    d = sroot / f"step_{RES_CKPT_EVERY:08d}"
    man = ckpt.read_manifest(str(d))
    size = sum(f.stat().st_size for f in d.iterdir())
    out = launch.spawn_ranks(2, "gloo", resilience_rank, dict(
        payload, faults=[], resume=True))
    post = out[0]["losses"]
    k = RES_CKPT_EVERY
    first_s = json.loads((sroot / "saves_0.json").read_text())
    smoke.check(crash is not None and man["meta"]["mode"] == "spmd"
                and sorted(post) == list(range(k, RES_STEPS))
                and post[k] == pre[str(k)]
                and all(np.isfinite(v) for v in post.values()),
                f"resilience --spmd [{smoke.smi}], LLM "
                f"{RES_SPMD_LLM_LAYERS} layers: CrashInjected reached the "
                f"caller ({crash}); the ranks' checkpoint of step {k}: "
                f"{len(man['entries'])} shards, {size} bytes, saved in "
                f"{first_s} s; resumed losses {post} (saves "
                f"{[round(x, 2) for x in out[0]['save_s']]} s), step {k} "
                f"bit-equal to the crashed run's {pre[str(k)]!r}")
    shutil.rmtree(ROOT / "build" / "resilience", ignore_errors=True)


def resilience_rank(rank: int, world: int, payload) -> dict:
    """One of the resilience phase's spmd rank processes on the one card
    over gloo: the vlm (LLM cut to ``llm_layers`` if given) under the pp
    phase's plan, this rank's stages kept, the guarded spmd step under a
    ``ResilientTrainer`` whose checkpoints the ranks write together."""
    import torch
    import torch.distributed as dist
    from repro_torch import bridge
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.optim import optimizer as opt
    from repro_torch.resilience import (CheckpointManager, CursorStream,
                                        Fault, FaultInjector, FaultPlan,
                                        ResilientTrainer,
                                        make_resilient_train_step)
    from repro_torch.training.steps import make_spmd_train_step
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    mllm = res_vlm(payload.get("llm_layers"))
    ex = pp_plan(mllm).apply(mllm, mode="spmd")
    bundle, prog = ex["stage_bundle"], ex["spmd_program"]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = mllm.init(device="cuda", generator=gen)
    stage_params, masks = bundle.hosted_share(params, prog.hosted[rank])
    del params
    gc.collect()
    torch.cuda.empty_cache()
    skeleton = bundle.partition(mllm.init(device="meta"))
    stages = [sp if sp is not None else skeleton[s]
              for s, sp in enumerate(stage_params)]
    ocfg = opt.AdamWConfig(**RES_OCFG)
    spmd_step = make_spmd_train_step(
        bundle.stage_fns, ex["sim_graph"], ex["schedule"], ocfg,
        microbatch_loss=bundle.microbatch_loss, frozen_mask=masks,
        trainable=list(bundle.trainable),
        grad_scale=1.0 / PP_MICROBATCHES, program=prog)

    def value_and_grad(sp, batch):
        loss, grads = spmd_step.value_and_grad(
            sp, bundle.encode_microbatches(batch, PP_MICROBATCHES))
        return (loss, {}), grads

    step_fn = make_resilient_train_step(
        None, ocfg, spmd_step.frozen_mask, value_and_grad_fn=value_and_grad,
        global_norm_fn=spmd_step.global_norm,
        named_parameters=spmd_step.named_parameters)
    state = opt.init(ocfg, spmd_step.named_parameters(stages),
                     spmd_step.frozen_mask)
    manager = None
    saves: list = []
    if payload.get("root"):
        manager = res_timed(torch, CheckpointManager(
            payload["root"], group=dist.group.WORLD), saves)
    tr = ResilientTrainer(
        step_fn, stages, state,
        CursorStream(lambda: mllm_dataset(mllm, SEED, PP_BATCH)),
        manager=manager, injector=FaultInjector(FaultPlan.make(
            [Fault(k, s) for k, s in payload.get("faults", [])])),
        ckpt_every=payload.get("ckpt_every", 0),
        resume=payload.get("resume", False),
        meta={"seed": SEED, "mllm": "vlm", "mode": "spmd",
              "spmd_layout": json.dumps(bundle.layout_meta)})
    out = {"rank": rank}
    if payload.get("adopt"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, step = ckpt.load(payload["adopt"], {
            "params": bridge.params_tree(bundle.unpartition(stages))})
        torch.cuda.synchronize()
        out["load_s"] = time.perf_counter() - t0
        tr.adopt_state(stages, state, step=step, cursor=step)
    try:
        res = tr.run(payload["steps"])
    finally:
        if payload.get("root") and rank == 0:
            root = Path(payload["root"])
            (root / "losses_0.json").write_text(json.dumps(tr.losses))
            (root / "saves_0.json").write_text(json.dumps(
                [s["s"] for s in saves if s["op"] == "save"]))
    out["losses"] = res["losses"]
    out["save_s"] = [s["s"] for s in saves if s["op"] == "save"]
    return out


# ---------------------------------------------------------------------------
# Phases 7 and 8: the context-parallel train path
# ---------------------------------------------------------------------------

def pp_expected_launches(bundle, graph, sim, remat: bool) -> dict:
    """K1, K2 and K3 launches that ``execute_schedule`` makes replaying
    ``sim`` through ``bundle``'s LLM stages, where every layer's
    attention runs through BamAttention. Per layer and microbatch: one
    K1 at F; a backward pass at B when B returns an input gradient
    (bwd_b > 0 and a predecessor) or glues the weight gradients (a
    trainable stage with no W item), and another at W for a trainable
    stage whose W item is separate. Each backward pass runs K2 and K3
    once and, under remat, K1 once more (non-reentrant checkpoint
    recomputes the block in every backward call)."""
    has_w = any(it[3] == "W" for it in sim["items"])
    M = 1 + max(it[5] for it in sim["items"])
    preds = graph.preds
    k1 = k23 = 0
    for s, sp in enumerate(bundle.specs):
        if sp.kind != "llm":
            continue
        st = graph.stages[s]
        defer = sp.trainable and has_w and st.bwd_w > 0
        b_pass = (st.bwd_b > 0 and bool(preds[s])) or \
            (sp.trainable and not defer)
        passes = int(b_pass) + int(defer)
        layers = sp.hi - sp.lo
        k1 += M * layers * (1 + (passes if remat else 0))
        k23 += M * layers * passes
    return {"K1": k1, "K2": k23, "K3": k23}


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
    return profile_call(
        torch, lambda: float(step(model, state, batch)[2]["loss"]),
        f"{label} profile, 1 step")


def profile_call(torch, fn, label: str, cpu: bool = True):
    """fn() under torch.profiler (it must end by reading a result from
    the card): prints the wall time, the device busy share and the top
    kernels by device time; returns (busy ms, wall ms). ``cpu=False``
    traces the device alone: fewer events to summarise where a call
    issues many small host ops."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU] if cpu else []
    with profile(activities=acts + [ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall_us = (time.perf_counter() - t0) * 1e6
    evs = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in evs)
    top = sorted(evs, key=lambda e: -e.self_device_time_total)[:8]
    print(f"{label}: wall {wall_us / 1e3:.1f} ms, device "
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


def gemma2_cp_phase(smoke: Smoke, group):
    """gemma2-9b at full width, depth ``GEMMA_TRAIN_LAYERS`` (local and
    global layers alternating), bf16, all parameters trainable: one
    allgather CP step on the world-size-1 NCCL group, in the CP layout's
    4-rank plan, through K1 stats, K2 and K3 at head_dim 256, against the
    plain non-CP step (attn_impl="xla") from the same weights and batch
    (the CP phase's bf16 tolerance, 2e-2 relative)."""
    torch = smoke.torch
    from repro_torch.kernels.bam_attention import kernel_body
    from repro_torch.optim import optimizer as opt
    from repro_torch.training.steps import make_train_step

    lay = cp_layout()
    cfg = full_config("gemma2-9b").replace(num_layers=GEMMA_TRAIN_LAYERS,
                                           attn_impl="bam_kernel")
    ocfg = opt.AdamWConfig(lr=1e-4, warmup_steps=1, total_steps=10)
    batch = cp_batches(torch, cfg.vocab_size, lay, 1)[0]
    runs = {}
    for name in ("cp", "plain"):
        model = cp_model(torch, cfg, SEED + 19)
        state = opt.init(ocfg, dict(model.named_parameters()))
        step = (cp_step(cfg, lay, group, ocfg, "allgather") if name == "cp"
                else make_train_step(cfg.replace(attn_impl="xla"), ocfg))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        _, _, met = step(model, state, batch)
        loss, gnorm = float(met["loss"]), float(met["grad_norm"])
        runs[name] = dict(loss=loss, grad_norm=gnorm,
                          ms=(time.perf_counter() - t0) * 1e3,
                          peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                          launches=kernel_counts())
        del model, state, step, met
        gc.collect()
        torch.cuda.empty_cache()
    cp, plain = runs["cp"], runs["plain"]
    L, fwd = cfg.num_layers, 2 if cfg.remat else 1
    want = {"K1s": L * fwd, "K2": L, "K3": L}
    got = {k: cp["launches"][k] for k in want}
    others = {k: n for k, n in cp["launches"].items() if k not in want and n}
    body = kernel_body(cfg.head_dim, torch.bfloat16, "K1")
    smoke.launches["gemma2_cp"] = dict(cp["launches"])
    smoke.check(got == want and not others and body == "wgmma"
                and not any(plain["launches"].values()),
                f"{cfg.name} CP allgather step, depth {L}: launches {got} "
                f"(want {want}: {L} layers, remat {cfg.remat}), others "
                f"{others or 0}, K1 stats on its {body} body at head_dim "
                f"{cfg.head_dim}; the plain step launched "
                f"{sum(plain['launches'].values())}")
    rl = abs(cp["loss"] - plain["loss"]) / abs(plain["loss"])
    rg = abs(cp["grad_norm"] - plain["grad_norm"]) / abs(plain["grad_norm"])
    smoke.check(np.isfinite([cp["loss"], cp["grad_norm"]]).all()
                and rl <= 2e-2 and rg <= 2e-2,
                f"bf16 {cfg.name} full width depth {L}, T {CP_T} (CP "
                f"layout, world size 1): CP allgather loss {cp['loss']:.6f} "
                f"vs plain non-CP {plain['loss']:.6f} (rel {rl:.2e}), "
                f"grad_norm {cp['grad_norm']:.6f} vs "
                f"{plain['grad_norm']:.6f} (rel {rg:.2e}); tol 2e-2")
    print(f"{cfg.name} depth {L} CP allgather step {cp['ms']:.1f} ms, "
          f"peak {cp['peak_gib']:.2f} GiB; plain step {plain['ms']:.1f} ms, "
          f"peak {plain['peak_gib']:.2f} GiB (first calls) [{smoke.smi}]",
          flush=True)
    smoke.gemma2_cp = runs


def cp_phases(smoke: Smoke):
    """Phases 7 and 8 on a NCCL process group of world size 1 (NCCL
    refuses two ranks on one card), then gemma2-9b's CP step on the same
    group (K1 stats at head_dim 256), destroyed at the end."""
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
        gc.collect()
        torch.cuda.empty_cache()
        gemma2_cp_phase(smoke, group)
    finally:
        dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {','.join(PHASES)}; "
                    f"the result line needs all of them")
    phases = set(ap.parse_args().phases.split(","))
    if "spmd" in phases:            # held against the pp phase's numbers
        phases.add("pp")
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
    smoke.smi = smi
    sass_check(smoke, _build)
    k4_build_check(smoke, _build)
    if "kernels" in phases:
        k1_cases(smoke)
        k1_gqa7_cases(smoke)
        bwd_cases(smoke)
        bwd_more_cases(smoke)
        k4_cases(smoke)
        cp_kernel_cases(smoke)
        head_dim_cases(smoke)
        gc.collect()
        torch.cuda.empty_cache()
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
    if "dense" in phases:
        dense_phase(smoke)
        gc.collect()
        torch.cuda.empty_cache()
    if "moe" in phases:
        moe_phase(smoke)
        gc.collect()
        torch.cuda.empty_cache()
    if "hybrid" in phases:
        hybrid_phase(smoke)
        gc.collect()
        torch.cuda.empty_cache()
    if "gemma2" in phases:
        gemma2_phase(smoke)
        gc.collect()
        torch.cuda.empty_cache()
    if "xlstm" in phases:
        xlstm_phase(smoke)
        gc.collect()
        torch.cuda.empty_cache()
    if "whisper" in phases:
        whisper_phase(smoke)
        gc.collect()
        torch.cuda.empty_cache()
    if "train" in phases:
        train_phase(smoke)
        gc.collect()
        torch.cuda.empty_cache()
        train_parity_phase(smoke)
        gc.collect()
        torch.cuda.empty_cache()
    if "pp" in phases:
        pp_phase(smoke)
        pp_parity_phase(smoke)
        launch_phase(smoke)
    if "spmd" in phases:
        spmd_phase(smoke)
    if "resilience" in phases:
        resilience_phase(smoke)
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
    # K4; dense, moe, hybrid and gemma2: K1; gemma2_serving: K4; train,
    # moe_train and pp: K1, K2, K3; cp: K1 stats, K2, K3;
    # compact: K1c, K2c, K3c); "launches" is the train path's for K1-K3,
    # the CP path's
    # for K1 stats, the compact path's for K1c-K3c
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
    for key, rows in smoke.head_dims.items():   # hd80 / hd256 rows
        smoke.kernels[key].update(rows)
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

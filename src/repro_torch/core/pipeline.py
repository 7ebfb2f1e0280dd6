"""Frozen-status-aware pipeline parallelism (Cornstarch §4.2, Alg. 1):
the port's own copy of ``repro.core.pipeline``. The float arithmetic is
the reference's, operation for operation and in the same order, so the
simulated times and the winner ``auto_parallelize`` picks (ties
included) are equal to the reference's.

The paper's key observation: the rule of thumb "backward ≈ 2× forward"
breaks for MLLMs with frozen constituents. The corrected per-module rule

    T_bwd = 0·T_fwd   frozen, no trainable module upstream (forward order)
            1·T_fwd   frozen, trainable module upstream (input grads only)
            2·T_fwd   trainable
    (+1·T_fwd recompute when activation checkpointing is on AND the
     module has gradients to compute)

drives stage partitioning: balance **fwd+bwd** per stage, not fwd.

Backward further decomposes into an input-grad pass B (blocks the
upstream stage's backward) and a weight-grad pass W (blocks only the
optimizer step). Frozen modules have **no W at all** — the decomposition
the zero-bubble schedulers in ``core.schedule`` exploit:

    module kind                    B factor   W factor
    frozen, nothing trainable up      0          0
    frozen, trainable upstream        1          0
    trainable                         1          1
    (+1 to B for recompute when any gradient exists)

The cost oracle is the analytic per-layer FLOPs model; the same
interfaces accept measured profiles (the paper itself profiles). The
partitioning algorithm is unchanged.

Scheduling lives in ``core.schedule``: the F/B/W discrete-event
simulator and the four schedulers (1F1B / interleaved-1F1B / ZB-H1 /
ZB-V) used to reproduce Table 3 / Fig. 7, plus the simulator-vs-
executor memory validation harness. This module supplies the cost
model and the search: ``auto_parallelize`` (paper Algorithm 1)
partitions stages frozen-aware and searches (schedule, virtual-chunk
count) jointly — chunked schedules (interleaved, zb-v) fold v-times
finer partitions back onto the planned devices so every candidate is
compared at the same device budget. The graph types and
``simulate_1f1b`` are re-exported here for compatibility.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core.schedule import (  # noqa: F401
    PipelineGraph, SCHEDULES, Stage, chain_graph, get_scheduler)


# ---------------------------------------------------------------------------
# Cost model
# ---------------------------------------------------------------------------

def layer_fwd_flops(cfg: ModelConfig, seq: int, batch: int = 1) -> float:
    """Analytic forward FLOPs of ONE transformer layer (2·m·n·k matmuls
    + attention scores)."""
    d, hd = cfg.d_model, cfg.head_dim
    t = seq * batch
    qkvo = 2 * t * d * (cfg.q_dim + 2 * cfg.kv_dim + cfg.q_dim)
    attn = 2 * 2 * batch * seq * seq * cfg.num_heads * hd  # scores + AV
    if cfg.family == "moe" and cfg.moe is not None:
        m = cfg.moe
        ff = 2 * 3 * t * d * m.d_expert * (m.top_k + m.num_shared_experts)
    else:
        n_mat = 3 if (cfg.act == "silu" or cfg.name.startswith("gemma2")) \
            else 2
        ff = 2 * n_mat * t * d * cfg.d_ff
    return float(qkvo + attn + ff)


@dataclasses.dataclass
class ModuleProfile:
    """One ModalityModule (or LLM) as seen by the partitioner."""
    name: str
    layer_fwd: np.ndarray          # per-layer forward cost (time units)
    frozen: bool
    # trainable module upstream in FORWARD order? (set by analyze_chain)
    trainable_upstream: bool = False
    recompute: bool = False        # activation checkpointing enabled

    @property
    def bwd_factor(self) -> float:
        if not self.frozen:
            f = 2.0
        elif self.trainable_upstream:
            f = 1.0
        else:
            return 0.0
        if self.recompute:
            f += 1.0
        return f

    @property
    def bwd_weight_factor(self) -> float:
        """W (weight-grad) share of bwd_factor — frozen ⇒ no W pass."""
        return 0.0 if self.frozen else 1.0

    @property
    def bwd_input_factor(self) -> float:
        """B (input-grad) share of bwd_factor; recompute time attaches
        here because recomputation must precede the grad matmuls."""
        return self.bwd_factor - self.bwd_weight_factor

    @property
    def layer_bwd(self) -> np.ndarray:
        return self.layer_fwd * self.bwd_factor

    @property
    def layer_bwd_w(self) -> np.ndarray:
        return self.layer_fwd * self.bwd_weight_factor


def profile_from_config(cfg: ModelConfig, seq: int, *, frozen: bool,
                        batch: int = 1, recompute: bool = False,
                        name: Optional[str] = None) -> ModuleProfile:
    f = np.array([layer_fwd_flops(cfg, seq, batch)] * cfg.num_layers)
    return ModuleProfile(name or cfg.name, f, frozen, recompute=recompute)


def analyze_chain(modules: Sequence[ModuleProfile],
                  projector_trainable: Sequence[bool]) -> None:
    """Set trainable_upstream flags along a forward-order chain
    (projectors sit between modules; a trainable projector upstream
    forces input-grad backward in all later modules)."""
    upstream = False
    for i, m in enumerate(modules):
        m.trainable_upstream = upstream
        if not m.frozen:
            upstream = True
        if i < len(projector_trainable) and projector_trainable[i]:
            upstream = True


# ---------------------------------------------------------------------------
# Stage partitioning (contiguous layers -> stages, minimize max stage cost)
# ---------------------------------------------------------------------------

def partition_layers(costs: np.ndarray, k: int) -> List[Tuple[int, int]]:
    """DP optimal contiguous partition of ``costs`` into k parts
    minimizing the max part-sum. Returns [(start, end), ...)."""
    n = len(costs)
    k = min(k, n)
    prefix = np.concatenate([[0.0], np.cumsum(costs)])

    def part_sum(a, b):
        return prefix[b] - prefix[a]

    INF = float("inf")
    dp = np.full((k + 1, n + 1), INF)
    cut = np.zeros((k + 1, n + 1), np.int64)
    dp[0, 0] = 0.0
    for parts in range(1, k + 1):
        for end in range(parts, n + 1):
            best, arg = INF, parts - 1
            for mid in range(parts - 1, end):
                v = max(dp[parts - 1, mid], part_sum(mid, end))
                if v < best - 1e-12:
                    best, arg = v, mid
            dp[parts, end] = best
            cut[parts, end] = arg
    bounds = []
    end = n
    for parts in range(k, 0, -1):
        start = int(cut[parts, end])
        bounds.append((start, end))
        end = start
    return bounds[::-1]


def _stages_from_bounds(name, fwd, bwd, bwd_w, bounds,
                        names: Optional[List[str]] = None) -> List[Stage]:
    out = []
    for a, b in bounds:
        if names is not None:
            mod = names[a] if names[a] == names[b - 1] else \
                f"{names[a]}+{names[b - 1]}"
        else:
            mod = name
        out.append(Stage(mod, float(fwd[a:b].sum()), float(bwd[a:b].sum()),
                         (a, b), bwd_w=float(bwd_w[a:b].sum())))
    return out


def partition_module(m: ModuleProfile, k: int, *,
                     frozen_aware: bool = True) -> List[Stage]:
    """Partition one module into k stages. frozen_aware balances
    fwd+bwd (Cornstarch); frozen_unaware balances fwd alone assuming
    bwd = 2·fwd (the baseline's broken assumption)."""
    costs = m.layer_fwd + m.layer_bwd if frozen_aware else m.layer_fwd
    bounds = partition_layers(costs, k)
    return _stages_from_bounds(m.name, m.layer_fwd, m.layer_bwd,
                               m.layer_bwd_w, bounds)


def simulate_1f1b(graph: PipelineGraph, num_microbatches: int
                  ) -> Dict[str, float]:
    """Legacy entry point: classic 1F1B (see core.schedule)."""
    return get_scheduler("1f1b").simulate(graph, num_microbatches)


def _chunk_candidates(schedule: str, virtual_chunks) -> Tuple[int, ...]:
    """Virtual-chunk counts a schedule searches over. ``virtual_chunks``
    is an int ceiling (legacy: try v, v-1, ..., 1) or an explicit
    sequence of candidates. zb-v places exactly two chunks per device,
    so its candidate set is {2, 1} (an explicit sequence can pin it to
    one of those — how ``MLLMParallelPlan.apply`` replays a recorded
    winner deterministically); the unchunked schedules pin v = 1."""
    if schedule == "zb-v":
        if isinstance(virtual_chunks, int):
            return (2, 1)
        vs = tuple(v for v in (2, 1)
                   if v in {int(x) for x in virtual_chunks})
        if not vs:
            # an explicit candidate set is a pin (MLLMParallelPlan.
            # apply replaying a recorded winner) — silently widening
            # it back to {2, 1} would execute a different placement
            # than the plan records
            raise ValueError(
                f"zb-v places two chunks per device: explicit "
                f"virtual_chunks must come from {{1, 2}}, got "
                f"{tuple(virtual_chunks)!r}")
        return vs
    if schedule != "interleaved":
        return (1,)
    if isinstance(virtual_chunks, int):
        return tuple(range(max(1, virtual_chunks), 0, -1))
    vs = tuple(int(v) for v in virtual_chunks)
    assert vs and all(v >= 1 for v in vs), "virtual_chunks must be >= 1"
    return vs


def _chunked_search(schedule: str, build_graph, feasible, virtual_chunks,
                    num_microbatches: int
                    ) -> Tuple[PipelineGraph, Dict[str, float]]:
    """Search the virtual-chunk count for a schedule, keeping the
    fastest simulation. v=1 is the one-chunk-per-device degenerate (the
    1F1B placement for interleaved, the ZB-H1 placement for zb-v) — on
    heterogeneous MLLM chains a device's chunk set mixes forward-heavy
    frozen-encoder chunks with LLM chunks and chunking can lose, so the
    degenerate v is a legitimate winner and chunked schedules are never
    scheduled worse than their unchunked selves."""
    candidates = _chunk_candidates(schedule, virtual_chunks)
    if not any(feasible(v) for v in candidates):
        # an explicit candidate tuple may be entirely infeasible for a
        # shallow module (e.g. virtual_chunks=(4,) on an 8-layer LLM
        # split 4 ways); degrade to the always-feasible v=1 placement
        # rather than dying — the documented fold-back behavior
        candidates = (1,)
    best = None
    for v in candidates:
        if not feasible(v):
            continue
        g = build_graph(v)
        kwargs = {"virtual_chunks": v} \
            if schedule in ("interleaved", "zb-v") else {}
        sim = get_scheduler(schedule, **kwargs).simulate(
            g, num_microbatches)
        if best is None or sim["iteration_time"] < \
                best[1]["iteration_time"]:
            best = (g, sim)
    assert best is not None, \
        f"{schedule}: v=1 must always be feasible"
    return best


def simulate_plan(encoders: Sequence[ModuleProfile], llm: ModuleProfile,
                  enc_counts: Sequence[int], llm_stages: int,
                  num_microbatches: int, *, schedule: str = "1f1b",
                  frozen_aware: bool = True, virtual_chunks=2
                  ) -> Tuple[PipelineGraph, Dict[str, float]]:
    """Build the modality-parallel graph for a stage plan and simulate
    it under ``schedule`` at a FIXED device budget of one device per
    planned stage (a stage count exceeding a module's layer count is
    clamped first, matching the partitioner). Chunked schedules
    (interleaved, zb-v) multiply the stage counts by v virtual chunks
    and fold the chunks back onto the same devices — round-robin for
    interleaved, V-shaped for zb-v — searching their candidate v set
    down to the v=1 degenerate, so ``sim["num_devices"]`` always equals
    the planned stage count and schedules compare apples-to-apples on
    the same hardware. ``virtual_chunks`` is an int ceiling or an
    explicit candidate sequence for the interleaved search; zb-v always
    searches {2, 1}."""
    llm_stages = min(llm_stages, len(llm.layer_fwd))
    enc_counts = [min(k, len(e.layer_fwd))
                  for e, k in zip(encoders, enc_counts)]
    return _chunked_search(
        schedule,
        lambda v: build_modality_parallel(
            encoders, llm, [k * v for k in enc_counts], llm_stages * v,
            frozen_aware=frozen_aware),
        lambda v: llm_stages * v <= len(llm.layer_fwd) and all(
            k * v <= len(e.layer_fwd)
            for e, k in zip(encoders, enc_counts)),
        virtual_chunks, num_microbatches)


# ---------------------------------------------------------------------------
# MLLM pipeline construction: colocated / replicated / modality-parallel
# ---------------------------------------------------------------------------

def build_colocated(encoders: Sequence[ModuleProfile], llm: ModuleProfile,
                    enc_stages: int, llm_stages: int, *,
                    frozen_aware: bool) -> PipelineGraph:
    """Encoders fused into one chain of enc_stages, then LLM chain
    (Megatron-style encoders-colocated, Fig. 1c)."""
    fused_fwd = np.concatenate([e.layer_fwd for e in encoders])
    fused_bwd = np.concatenate([e.layer_bwd for e in encoders])
    fused_bwd_w = np.concatenate([e.layer_bwd_w for e in encoders])
    costs = fused_fwd + fused_bwd if frozen_aware else fused_fwd
    bounds = partition_layers(costs, enc_stages)
    stages = _stages_from_bounds("encoders", fused_fwd, fused_bwd,
                                 fused_bwd_w, bounds)
    stages += partition_module(llm, llm_stages, frozen_aware=frozen_aware)
    return chain_graph(stages)


def build_replicated(encoders: Sequence[ModuleProfile], llm: ModuleProfile,
                     llm_stages: int, *, frozen_aware: bool
                     ) -> PipelineGraph:
    """Meta-Llama style: encoders replicated into EVERY LLM stage
    (Fig. 1b) — each stage's cost includes a full encoder pass."""
    stages = partition_module(llm, llm_stages, frozen_aware=frozen_aware)
    enc_f = sum(float(e.layer_fwd.sum()) for e in encoders)
    enc_b = sum(float(e.layer_bwd.sum()) for e in encoders)
    enc_w = sum(float(e.layer_bwd_w.sum()) for e in encoders)
    out = [Stage(s.module, s.fwd + enc_f, s.bwd + enc_b, s.layer_range,
                 bwd_w=s.bwd_w + enc_w)
           for s in stages]
    return chain_graph(out)


def build_modality_parallel(encoders: Sequence[ModuleProfile],
                            llm: ModuleProfile,
                            enc_stage_counts: Sequence[int],
                            llm_stages: int, *,
                            frozen_aware: bool = True) -> PipelineGraph:
    """Cornstarch modality parallelism (Fig. 6): each encoder is its own
    chain; all encoder chains feed the first LLM stage."""
    stages: List[Stage] = []
    edges: List[Tuple[int, int]] = []
    enc_last: List[int] = []
    for e, k in zip(encoders, enc_stage_counts):
        sub = partition_module(e, k, frozen_aware=frozen_aware)
        base = len(stages)
        stages += sub
        edges += [(base + i, base + i + 1) for i in range(len(sub) - 1)]
        enc_last.append(base + len(sub) - 1)
    llm_sub = partition_module(llm, llm_stages, frozen_aware=frozen_aware)
    base = len(stages)
    stages += llm_sub
    edges += [(base + i, base + i + 1) for i in range(len(llm_sub) - 1)]
    for last in enc_last:
        edges.append((last, base))
    return PipelineGraph(stages, edges)


def build_chain_fused(modules: Sequence[ModuleProfile], total_stages: int,
                      *, frozen_aware: bool) -> PipelineGraph:
    """Fuse all modules into one layer chain and partition into
    ``total_stages`` — boundaries may fall anywhere (the paper's §6.4
    comparison: frozen-aware partitions on true fwd+bwd; the unaware
    baseline partitions on fwd alone, implicitly assuming bwd = 2·fwd).
    Simulation always uses TRUE costs; only the *partitioning objective*
    changes."""
    fwd = np.concatenate([m.layer_fwd for m in modules])
    bwd = np.concatenate([m.layer_bwd for m in modules])
    bwd_w = np.concatenate([m.layer_bwd_w for m in modules])
    names = sum(([m.name] * len(m.layer_fwd) for m in modules), [])
    costs = (fwd + bwd) if frozen_aware else fwd
    bounds = partition_layers(costs, total_stages)
    return chain_graph(_stages_from_bounds(None, fwd, bwd, bwd_w, bounds,
                                           names=names))


def simulate_fused_chain(modules: Sequence[ModuleProfile],
                         total_stages: int, num_microbatches: int, *,
                         schedule: str = "1f1b",
                         frozen_aware: bool = True,
                         virtual_chunks=2
                         ) -> Tuple[PipelineGraph, Dict[str, float]]:
    """``build_chain_fused`` + schedule simulation at a fixed device
    budget of ``total_stages`` devices. Chunked schedules (interleaved,
    zb-v) partition the same chain v times finer and fold the chunks
    onto the same devices — round-robin or V-shaped — searching v down
    to the v=1 degenerate; see ``simulate_plan`` for why the degenerate
    v may win."""
    n_layers = sum(len(m.layer_fwd) for m in modules)
    total_stages = min(total_stages, n_layers)
    return _chunked_search(
        schedule,
        lambda v: build_chain_fused(modules, total_stages * v,
                                    frozen_aware=frozen_aware),
        lambda v: total_stages * v <= n_layers,
        virtual_chunks, num_microbatches)


# ---------------------------------------------------------------------------
# Algorithm 1: loosely-coupled multimodal auto-parallelization
# ---------------------------------------------------------------------------

#: candidate-ranking objectives for auto_parallelize: maximize
#: throughput per device (the paper's), or minimize time / bubble
AUTO_OBJECTIVES = ("tput_per_device", "iteration_time",
                   "bubble_fraction")


def _beats(cand: dict, best: dict, objective: str) -> bool:
    if objective == "tput_per_device":
        return cand["tput_per_device"] > best["tput_per_device"]
    return cand[objective] < best[objective]


def auto_parallelize(encoders: Sequence[ModuleProfile], llm: ModuleProfile,
                     total_devices: int, num_microbatches: int,
                     *, frozen_aware: bool = True,
                     max_llm_stages: Optional[int] = None,
                     schedules: Sequence[str] = SCHEDULES,
                     virtual_chunks: Sequence[int] = (1, 2, 4),
                     objective: str = "tput_per_device") -> dict:
    """For each feasible LLM stage count i: partition the LLM, derive the
    per-stage time target t_i, fit each encoder to that target, simulate
    every candidate (schedule, virtual-chunk count) pair, return the
    best combination (paper Algorithm 1, extended to search schedules
    and chunking jointly). ``virtual_chunks`` is the candidate v set
    for the interleaved schedule (zb-v always searches {2, 1}; 1f1b
    and zb-h1 pin v = 1). ``objective`` ranks candidates:
    ``"tput_per_device"`` (default, maximized) or ``"iteration_time"``
    / ``"bubble_fraction"`` (minimized — these spend every device the
    budget allows, where throughput/device prefers small footprints).
    The result dict carries the winning schedule name under
    ``"schedule"`` and the winning chunk count under
    ``"virtual_chunks"``."""
    if objective not in AUTO_OBJECTIVES:
        raise ValueError(f"unknown objective {objective!r}; pick from "
                         f"{AUTO_OBJECTIVES}")
    best = None
    max_llm = max_llm_stages or min(len(llm.layer_fwd),
                                    total_devices - len(encoders))
    for i in range(1, max_llm + 1):
        llm_sub = partition_module(llm, i, frozen_aware=frozen_aware)
        t_i = max(s.total for s in llm_sub)
        enc_counts = []
        for e in encoders:
            tot = float((e.layer_fwd + e.layer_bwd).sum()) if frozen_aware \
                else float(e.layer_fwd.sum() * 3)
            k = max(1, int(np.ceil(tot / max(t_i, 1e-9))))
            k = min(k, len(e.layer_fwd),
                    max(1, total_devices - i - (len(encoders) - 1)))
            enc_counts.append(k)
        if i + sum(enc_counts) > total_devices:
            continue
        def fits(v, i=i, enc_counts=enc_counts):
            return i * v <= len(llm.layer_fwd) and all(
                k * v <= len(e.layer_fwd)
                for e, k in zip(encoders, enc_counts))

        candidates = []
        for sched in schedules:
            if sched == "interleaved":
                candidates += [(sched, (v,))
                               for v in virtual_chunks if fits(v)]
            else:
                # the int sentinel means "schedule default": zb-v
                # searches its inherent {2, 1}; 1f1b/zb-h1 pin v = 1.
                # The interleaved-specific candidate tuple must not
                # leak here (e.g. (4,) would be an invalid zb-v pin)
                candidates.append((sched, 2))
        for sched, vs in candidates:
            g, sim = simulate_plan(encoders, llm, enc_counts, i,
                                   num_microbatches, schedule=sched,
                                   frozen_aware=frozen_aware,
                                   virtual_chunks=vs)
            devices = sim["num_devices"]        # == i + sum(enc_counts)
            cand = {"llm_stages": i, "encoder_stages": enc_counts,
                    "encoder_names": [e.name for e in encoders],
                    "graph": g, **sim,
                    "devices": devices,
                    "tput_per_device": num_microbatches /
                    (sim["iteration_time"] * devices)}
            if best is None or _beats(cand, best, objective):
                best = cand
    assert best is not None, "no feasible configuration"
    return best

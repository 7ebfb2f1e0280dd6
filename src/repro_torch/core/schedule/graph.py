"""Pipeline stage graph with B/W-decomposed backward costs (the
port's own copy of ``repro.core.schedule.graph``).

A :class:`Stage` carries three cost terms per microbatch:

    fwd     forward pass (F)
    bwd     TOTAL backward = B + W (kept as one field so legacy callers
            that build ``Stage(name, f, b)`` see unchanged semantics)
    bwd_w   weight-gradient (W) share of ``bwd``; the input-gradient
            share B = ``bwd - bwd_w`` is what blocks the upstream
            stage's backward.

Frozen modules have ``bwd_w == 0`` (no weights to update), which is
why zero-bubble-style scheduling composes so well with Cornstarch's
frozen-aware costs: there is simply no W work to defer on frozen
stages, and all the deferral headroom concentrates on trainable ones.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple


@dataclasses.dataclass
class Stage:
    module: str
    fwd: float
    bwd: float                          # total backward (B + W)
    layer_range: Tuple[int, int] = (0, 0)
    bwd_w: float = 0.0                  # weight-grad (W) share of bwd

    @property
    def bwd_b(self) -> float:
        """Input-grad (B) share of backward — the part on the critical
        path to the upstream stage (includes recompute time)."""
        return self.bwd - self.bwd_w

    @property
    def total(self) -> float:
        return self.fwd + self.bwd


@dataclasses.dataclass
class PipelineGraph:
    """stages: flat list in topological order; edges: forward-order
    dependencies (src_stage_idx -> dst_stage_idx). A chain is edges
    (i, i+1)."""
    stages: List[Stage]
    edges: List[Tuple[int, int]]

    @property
    def preds(self) -> Dict[int, List[int]]:
        p: Dict[int, List[int]] = {i: [] for i in range(len(self.stages))}
        for a, b in self.edges:
            p[b].append(a)
        return p

    @property
    def succs(self) -> Dict[int, List[int]]:
        s: Dict[int, List[int]] = {i: [] for i in range(len(self.stages))}
        for a, b in self.edges:
            s[a].append(b)
        return s

    def depth_from_end(self, i: int) -> int:
        succ = self.succs
        memo: Dict[int, int] = {}

        def rec(j):
            if j in memo:
                return memo[j]
            memo[j] = 1 + max((rec(s) for s in succ[j]), default=0)
            return memo[j]
        return rec(i)


def chain_graph(stages: List[Stage]) -> PipelineGraph:
    return PipelineGraph(stages, [(i, i + 1) for i in range(len(stages) - 1)])


def interleave_devices(graph: PipelineGraph, virtual_chunks: int
                       ) -> List[int]:
    """Megatron-style round-robin stage->device map for interleaved
    1F1B: with S stages and v virtual chunks, D = ceil(S/v) devices and
    stage s (topological order) runs on device ``s % D`` — device d
    hosts chunks {d, d+D, d+2D, ...}."""
    S = len(graph.stages)
    v = max(1, int(virtual_chunks))
    D = max(1, -(-S // v))
    return [s % D for s in range(S)]


def v_shape_devices(num_stages: int) -> List[int]:
    """ZB-V stage->device map (Qi et al. 2023): S = 2p chunk-stages on
    p devices, device i hosting chunks i and 2p-1-i. The forward chain
    walks down the device column and back up — a V — so the LAST chunk
    lives on device 0, whose backward can start the moment its own
    forward ramp finishes, and the W passes of both hosted chunks fill
    the two ramps."""
    S = int(num_stages)
    assert S >= 2 and S % 2 == 0, \
        "ZB-V placement needs an even chunk-stage count (2 per device)"
    p = S // 2
    return [s if s < p else S - 1 - s for s in range(S)]


def refine_chain(graph: PipelineGraph, virtual_chunks: int
                 ) -> PipelineGraph:
    """Split every stage of a CHAIN graph into ``virtual_chunks`` equal
    sub-stages (costs divided evenly, layer ranges split contiguously).
    This is the generalized virtual-chunk construction used when a
    finer partition cannot be re-derived from module profiles — e.g.
    raw ``Stage`` fixtures; ``auto_parallelize`` re-partitions from
    profiles instead, which respects real per-layer costs."""
    v = max(1, int(virtual_chunks))
    if v == 1:
        return graph
    assert sorted(graph.edges) == [(i, i + 1)
                                   for i in range(len(graph.stages) - 1)], \
        "refine_chain only applies to chain graphs"
    out: List[Stage] = []
    for st in graph.stages:
        a, b = st.layer_range
        n = b - a
        for c in range(v):
            la = a + (n * c) // v
            lb = a + (n * (c + 1)) // v
            out.append(Stage(st.module, st.fwd / v, st.bwd / v,
                             (la, lb), bwd_w=st.bwd_w / v))
    return chain_graph(out)

"""Workload-balanced token distribution for multimodal context
parallelism (Cornstarch §4.3.2, §5.3, Appendix A): the port's copy of
``repro.core.distribution``, numpy on the host.

Tokens go to CP ranks in whole blocks of ``block_size`` contiguous
tokens; a block's workload is the sum of its rows of the BAM mask
(``core.bam.block_workload``). Planners, each returning a ``Plan``:

* ``zigzag``: the causal balancing of Llama-3/Megatron, rank i gets
  blocks i and 2G-1-i of every group of 2G;
* ``ring``: a contiguous equal-count split;
* ``lpt``: greedy Longest-Processing-Time-First (Algorithm 2), whose
  makespan is at most Σw/G + w_max (``graham_bound``);
* ``random``: uniform random blocks;
* ``ilp``: exact makespan minimisation by branch and bound, for small
  instances (tests certify LPT against it).
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import List, Optional

import numpy as np

from repro_torch.core.bam import block_workload


@dataclasses.dataclass
class Plan:
    """Block -> rank assignment: ``assignment`` [num_blocks] rank ids,
    ``loads`` [G] the summed workload of each rank."""
    assignment: np.ndarray
    block_size: int
    num_ranks: int
    loads: np.ndarray

    @property
    def per_rank_blocks(self) -> List[np.ndarray]:
        return [np.where(self.assignment == g)[0]
                for g in range(self.num_ranks)]

    @property
    def makespan(self) -> float:
        return float(self.loads.max())

    @property
    def imbalance(self) -> float:
        """max/mean load (1.0 = perfect)."""
        mean = self.loads.mean()
        return float(self.loads.max() / mean) if mean > 0 else 1.0

    def rank_token_slices(self, tokens_per_block: Optional[int] = None):
        bs = tokens_per_block or self.block_size
        return [np.concatenate([np.arange(b * bs, (b + 1) * bs)
                                for b in blocks]) if len(blocks) else
                np.zeros((0,), np.int64)
                for blocks in self.per_rank_blocks]


def _finalize(assignment, W, block_size, G) -> Plan:
    loads = np.zeros(G, np.float64)
    np.add.at(loads, assignment, W)
    return Plan(assignment=assignment.astype(np.int32),
                block_size=block_size, num_ranks=G, loads=loads)


def zigzag(W: np.ndarray, G: int, block_size: int = 128) -> Plan:
    """Blocks paired (i, 2G-1-i) in every group of 2G."""
    pattern = np.concatenate([np.arange(G), np.arange(G)[::-1]])
    assignment = pattern[np.arange(len(W)) % (2 * G)]
    return _finalize(assignment, W, block_size, G)


def ring(W: np.ndarray, G: int, block_size: int = 128) -> Plan:
    """Contiguous equal-count split."""
    nb = len(W)
    assignment = np.minimum(np.arange(nb) * G // max(nb, 1), G - 1)
    return _finalize(assignment, W, block_size, G)


def lpt(W: np.ndarray, G: int, block_size: int = 128) -> Plan:
    """Greedy LPT: blocks by falling workload, each to the least loaded
    rank (ties to the lower rank). O(nb (log nb + log G))."""
    order = np.argsort(-W, kind="stable")
    assignment = np.zeros(len(W), np.int64)
    heap = [(0.0, g) for g in range(G)]
    heapq.heapify(heap)
    for b in order:
        load, g = heapq.heappop(heap)
        assignment[b] = g
        heapq.heappush(heap, (load + float(W[b]), g))
    return _finalize(assignment, W, block_size, G)


def random_plan(W: np.ndarray, G: int, block_size: int = 128,
                seed: int = 0) -> Plan:
    rng = np.random.default_rng(seed)
    assignment = rng.integers(0, G, size=len(W))
    return _finalize(assignment, W, block_size, G)


def ilp(W: np.ndarray, G: int, block_size: int = 128,
        node_limit: int = 2_000_000) -> Plan:
    """Exact makespan minimisation by branch and bound: blocks in falling
    order, pruned by the incumbent and the (Σremaining)/G lower bound,
    ranks of equal load tried once. Starts from the LPT plan."""
    W = np.asarray(W, np.float64)
    nb = len(W)
    order = np.argsort(-W, kind="stable")
    Ws = W[order]
    suffix = np.concatenate([np.cumsum(Ws[::-1])[::-1], [0.0]])

    start = lpt(W, G, block_size)
    best = start.makespan
    best_assign = start.assignment[order].copy()
    loads = np.zeros(G, np.float64)
    assign = np.zeros(nb, np.int64)
    nodes = 0

    def rec(i):
        nonlocal best, best_assign, nodes
        nodes += 1
        if nodes > node_limit:
            return
        if i == nb:
            m = loads.max()
            if m < best - 1e-12:
                best = m
                best_assign = assign.copy()
            return
        if max(loads.max(), (loads.sum() + suffix[i]) / G) >= best - 1e-12:
            return
        tried = set()
        for g in np.argsort(loads, kind="stable"):
            key = round(loads[g], 9)
            if key in tried:          # ranks of equal load are symmetric
                continue
            tried.add(key)
            if loads[g] + Ws[i] >= best - 1e-12:
                continue
            loads[g] += Ws[i]
            assign[i] = g
            rec(i + 1)
            loads[g] -= Ws[i]

    rec(0)
    final = np.zeros(nb, np.int64)
    final[order] = best_assign
    return _finalize(final, W, block_size, G)


PLANNERS = {"zigzag": zigzag, "ring": ring, "lpt": lpt,
            "random": random_plan, "ilp": ilp}


def plan_tokens(bits: np.ndarray, pos: np.ndarray, G: int,
                block_size: int = 128, method: str = "lpt",
                window: int = 0, **kw) -> Plan:
    """BAM bitfields -> block workloads -> plan."""
    W = block_workload(bits, pos, block_size, window)
    return PLANNERS[method](W, G, block_size, **kw)


def graham_bound(W: np.ndarray, G: int) -> float:
    """LPT's worst-case makespan: Σw/G + w_max."""
    return float(W.sum() / G + W.max())

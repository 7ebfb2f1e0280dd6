"""Plan entry points (the counterpart of ``repro.parallel.api``):
``plan_context`` builds a ``ContextPlan`` from BAM bitfields."""
from __future__ import annotations

import numpy as np

from repro_torch.core import bam
from repro_torch.core import distribution as dist
from repro_torch.parallel.plan import ContextPlan

#: the balancers ``method="auto"`` chooses among (ilp is the offline
#: certificate, not a live planner)
_AUTO_CP_METHODS = ("lpt", "zigzag", "ring")


def plan_context(bits: np.ndarray, pos: np.ndarray, num_ranks: int, *,
                 block_size: int = 128, method: str = "lpt",
                 window: int = 0, **kw) -> ContextPlan:
    """BAM bitfields [T] -> block workloads -> ContextPlan.
    ``method="auto"`` picks the live balancer with the smallest
    makespan (the first of equals)."""
    W = bam.block_workload(bits, pos, block_size, window)
    if method == "auto":
        best = None
        for m in _AUTO_CP_METHODS:
            cand = dist.PLANNERS[m](W, num_ranks, block_size)
            if best is None or cand.makespan < best[1].makespan - 1e-12:
                best = (m, cand)
        method, core = best
    elif method in dist.PLANNERS:
        core = dist.PLANNERS[method](W, num_ranks, block_size, **kw)
    else:
        raise ValueError(f"unknown balancer {method!r}; pick from "
                         f"{sorted(dist.PLANNERS)} or 'auto'")
    return ContextPlan.from_core(core, method)

"""Plan data model (the counterpart of ``repro.parallel.plan``): the
context-parallel ``ContextPlan``."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np

from repro_torch.core import context_parallel as cp
from repro_torch.core import distribution as dist


@dataclasses.dataclass(frozen=True)
class ContextPlan:
    """Context-parallel token distribution: the balancer and its block ->
    rank assignment (a typed wrapper over ``core.distribution.Plan``)."""
    method: str
    num_ranks: int
    block_size: int
    assignment: Tuple[int, ...]     # block index -> CP rank
    loads: Tuple[float, ...]        # per-rank workload

    def __post_init__(self):
        if self.method not in dist.PLANNERS:
            raise ValueError(f"unknown balancer {self.method!r}; pick from "
                             f"{sorted(dist.PLANNERS)}")
        if len(self.loads) != self.num_ranks:
            raise ValueError(f"{len(self.loads)} loads for "
                             f"{self.num_ranks} ranks")

    @classmethod
    def from_core(cls, plan: dist.Plan, method: str) -> "ContextPlan":
        return cls(method=method, num_ranks=plan.num_ranks,
                   block_size=plan.block_size,
                   assignment=tuple(int(a) for a in plan.assignment),
                   loads=tuple(float(x) for x in plan.loads))

    def core_plan(self) -> dist.Plan:
        return dist.Plan(assignment=np.array(self.assignment, np.int32),
                         block_size=self.block_size,
                         num_ranks=self.num_ranks,
                         loads=np.array(self.loads, np.float64))

    @property
    def makespan(self) -> float:
        return max(self.loads)

    @property
    def imbalance(self) -> float:
        mean = sum(self.loads) / len(self.loads)
        return max(self.loads) / mean if mean > 0 else 1.0

    def rank_token_slices(self):
        """Per-rank token index arrays."""
        return self.core_plan().rank_token_slices()

    def apply(self, seq_len: int) -> Dict[str, Any]:
        """The CP layout of one sequence: ``perm`` (plan layout <-
        original, a true permutation of ``arange(seq_len)``), its inverse
        ``inv_perm``, ``num_ranks`` and ``block_size``, as
        ``training.steps.make_cp_train_step`` and the serving engine take
        it. Raises ``ValueError`` if the blocks do not cover seq_len."""
        perm = cp.plan_permutation(self.core_plan(), seq_len)
        return {"perm": perm, "inv_perm": cp.invert_perm(perm),
                "num_ranks": self.num_ranks,
                "block_size": self.block_size}

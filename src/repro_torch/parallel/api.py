"""The user-facing parallelisation entry points (the counterpart of
``repro.parallel.api``).

    plan = parallelize(mllm, ClusterSpec(num_devices=8, cp_size=8),
                       WorkloadShape(text_len=1024, num_microbatches=8))

runs Cornstarch's joint decision for one MLLM and one workload:

* PP: Algorithm 1 (``core.pipeline.auto_parallelize``) partitions every
  module frozen-aware and searches (stage allocation, schedule,
  virtual-chunk count) jointly over the discrete-event simulator;
* CP: the merged sequence's BAM block workloads are balanced over the
  CP ranks by the chosen balancer (LPT by default, Algorithm 2).

``search_plan`` is the profile-level sibling for callers that hold
``ModuleProfile``s; ``plan_context`` builds a ``ContextPlan`` alone from
BAM bitfields.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import bam
from repro_torch.core import distribution as dist
from repro_torch.core import pipeline as pp
from repro_torch.core.schedule import SCHEDULES
from repro_torch.parallel.plan import (ClusterSpec, ContextPlan,
                                       MLLMParallelPlan, SchedulePlan,
                                       StagePlan, WorkloadShape)

#: objectives auto_parallelize ranks candidates by
OBJECTIVES = pp.AUTO_OBJECTIVES

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


def mllm_workload_bits(mllm, text_len: int
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """The merged sequence's BAM bits and positions for an MLLM's token
    layout, the layout ``MultimodalModule.build_merge`` builds at train
    time, rebuilt on the host for planning."""
    layout = mllm.layout or mllm.default_layout(text_len)
    segs = []
    for seg in layout:
        if seg[0] == "text":
            segs.append(("text", 0, seg[1]))
        else:
            enc = mllm.encoders[seg[0]]
            segs.append(("mod", enc.modality_id, enc.num_tokens))
    return bam.build_sample_bits(segs, mllm.merged_length(text_len))


def search_plan(encoders: Sequence[pp.ModuleProfile],
                llm: pp.ModuleProfile, cluster: ClusterSpec,
                shape: WorkloadShape, *,
                objective: str = "tput_per_device",
                schedules: Sequence[str] = SCHEDULES,
                virtual_chunks: Sequence[int] = (1, 2, 4),
                frozen_aware: bool = True,
                cp_workload: Optional[Tuple[np.ndarray, np.ndarray]]
                = None,
                cp_method: str = "lpt") -> MLLMParallelPlan:
    """Profile-level joint search: Algorithm 1 over the pipeline side,
    the chosen balancer over ``cp_workload`` (BAM ``(bits, pos)``; None
    gives a PP-only plan with ``context=None``). Unknown objectives
    raise ``ValueError``."""
    best = pp.auto_parallelize(
        encoders, llm, cluster.num_devices, shape.num_microbatches,
        frozen_aware=frozen_aware, schedules=schedules,
        virtual_chunks=virtual_chunks, objective=objective)
    stage = StagePlan(
        encoder_names=tuple(best["encoder_names"]),
        encoder_stages=tuple(int(k) for k in best["encoder_stages"]),
        llm_stages=int(best["llm_stages"]), frozen_aware=frozen_aware)
    schedule = SchedulePlan(
        name=best["schedule"],
        virtual_chunks=int(best["virtual_chunks"]),
        num_microbatches=shape.num_microbatches,
        iteration_time=float(best["iteration_time"]),
        bubble_fraction=float(best["bubble_fraction"]),
        num_devices=int(best["num_devices"]),
        peak_activations_per_device=tuple(
            int(p) for p in best["peak_activations_per_device"]),
        tput_per_device=float(best["tput_per_device"]))
    context = None
    if cp_workload is not None:
        bits, pos = cp_workload
        context = plan_context(bits, pos, cluster.cp_size,
                               block_size=shape.block_size,
                               method=cp_method)
    return MLLMParallelPlan(stage=stage, schedule=schedule,
                            context=context, text_len=shape.text_len,
                            microbatch_size=shape.microbatch_size)


def parallelize(mllm, cluster: ClusterSpec, shape: WorkloadShape, *,
                objective: str = "tput_per_device",
                schedules: Sequence[str] = SCHEDULES,
                virtual_chunks: Sequence[int] = (1, 2, 4),
                frozen_aware: bool = True,
                cp_method: str = "lpt") -> MLLMParallelPlan:
    """One typed call -> one joint PP x CP plan, from the MLLM's
    frozen-aware module profiles and its merged-sequence BAM workload.
    The plan round-trips through JSON, prints via ``describe()`` and
    instantiates against the model via ``apply(mllm)``."""
    encs, llm_prof = mllm.profiles(shape.text_len,
                                   batch=shape.microbatch_size)
    bits, pos = mllm_workload_bits(mllm, shape.text_len)
    return search_plan(encs, llm_prof, cluster, shape,
                       objective=objective, schedules=schedules,
                       virtual_chunks=virtual_chunks,
                       frozen_aware=frozen_aware,
                       cp_workload=(bits, pos), cp_method=cp_method)

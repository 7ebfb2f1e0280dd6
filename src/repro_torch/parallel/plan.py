"""Typed parallelisation plans (the counterpart of
``repro.parallel.plan``): the one object every launch path shares.

    MLLMParallelPlan
    ├── StagePlan      per-module pipeline stage counts (Algorithm 1)
    ├── SchedulePlan   schedule name, virtual-chunk count and the
    │                  simulator's verdict (iteration time, bubble,
    │                  per-device peak activations)
    └── ContextPlan    CP balancer and its block -> rank assignment

plus the typed inputs :class:`ClusterSpec` and :class:`WorkloadShape`
that ``parallel.api.parallelize`` takes. Plans are plain frozen
dataclasses that round-trip through ``to_json``/``from_json`` in the
reference's schema (format version 1), so a plan written by either
package loads in the other and compares by value.

``plan.apply(mllm)`` turns a plan back into the executor contract: it
re-partitions the module profiles at the planned stage counts,
re-simulates the pinned (schedule, virtual_chunks) pair and returns a
dict whose ``"graph"`` has one stage per device and whose
``"sim_graph"`` and ``"schedule"`` are what ``models.stages`` and
``core.modality_parallel.execute_schedule`` replay;
``plan.apply(mllm, mode="spmd")`` adds the compiled wave program and the
stage bundle the distributed runner (``parallel.spmd``) executes.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import context_parallel as cp
from repro_torch.core import distribution as dist
from repro_torch.core import pipeline as pp
from repro_torch.core.schedule import SCHEDULES

PLAN_FORMAT_VERSION = 1


# ---------------------------------------------------------------------------
# Typed inputs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """The device budget a plan is searched against: ``num_devices``
    pipeline ranks (one per planned stage) and ``cp_size``
    context-parallel ranks."""
    num_devices: int
    cp_size: int = 1

    def __post_init__(self):
        if self.num_devices < 1 or self.cp_size < 1:
            raise ValueError(f"{self}: counts must be >= 1")


@dataclasses.dataclass(frozen=True)
class WorkloadShape:
    """The training workload a plan is searched for."""
    text_len: int = 1024
    num_microbatches: int = 8
    microbatch_size: int = 1
    block_size: int = 128           # CP token-block granularity

    def __post_init__(self):
        if min(self.text_len, self.num_microbatches, self.microbatch_size,
               self.block_size) < 1:
            raise ValueError(f"{self}: every field must be >= 1")


# ---------------------------------------------------------------------------
# Plan components
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StagePlan:
    """Per-module pipeline stage counts, one device per stage (chunked
    schedules fold their virtual chunks onto these devices)."""
    encoder_names: Tuple[str, ...]
    encoder_stages: Tuple[int, ...]
    llm_stages: int
    frozen_aware: bool = True

    def __post_init__(self):
        if len(self.encoder_names) != len(self.encoder_stages) or \
                self.llm_stages < 1 or \
                any(k < 1 for k in self.encoder_stages):
            raise ValueError(f"invalid {self}")

    @property
    def num_devices(self) -> int:
        return self.llm_stages + sum(self.encoder_stages)

    def counts_by_name(self) -> Dict[str, int]:
        """{module: stage count}."""
        return dict(zip(self.encoder_names, self.encoder_stages))


@dataclasses.dataclass(frozen=True)
class SchedulePlan:
    """The winning pipeline schedule and the simulator's verdict on it
    (the numbers Algorithm 1 compared candidates by)."""
    name: str
    virtual_chunks: int
    num_microbatches: int
    iteration_time: float
    bubble_fraction: float
    num_devices: int
    peak_activations_per_device: Tuple[int, ...]
    tput_per_device: float

    def __post_init__(self):
        if self.name not in SCHEDULES:
            raise ValueError(f"unknown schedule {self.name!r}; pick from "
                             f"{SCHEDULES}")
        if self.virtual_chunks < 1 or (self.name == "zb-v" and
                                       self.virtual_chunks not in (1, 2)):
            raise ValueError(f"{self.name} cannot run "
                             f"v={self.virtual_chunks}")


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


# ---------------------------------------------------------------------------
# Executor contract
# ---------------------------------------------------------------------------

def build_executor_plan(encoders: Sequence[pp.ModuleProfile],
                        llm: pp.ModuleProfile,
                        enc_counts: Sequence[int], llm_stages: int,
                        num_microbatches: int, *,
                        schedule: str = "1f1b", virtual_chunks: Any = 2,
                        frozen_aware: bool = True) -> Dict[str, Any]:
    """Partition and simulate one stage allocation and return the
    executor contract: ``"graph"`` has one stage per simulated device;
    a chunked winner's v-times finer graph, which the timeline's stage
    indices refer to, is ``"sim_graph"``."""
    sim_graph, sim = pp.simulate_plan(
        encoders, llm, enc_counts, llm_stages, num_microbatches,
        schedule=schedule, frozen_aware=frozen_aware,
        virtual_chunks=virtual_chunks)
    graph = sim_graph
    if len(graph.stages) != sim["num_devices"]:
        llm_k = min(llm_stages, len(llm.layer_fwd))
        counts = [min(k, len(e.layer_fwd))
                  for e, k in zip(encoders, enc_counts)]
        graph = pp.build_modality_parallel(
            encoders, llm, counts, llm_k, frozen_aware=frozen_aware)
    return {
        "graph": graph,
        "sim_graph": sim_graph,
        "encoder_profiles": list(encoders),
        "llm_profile": llm,
        "schedule": sim,
        "schedule_name": sim["schedule"],
        "virtual_chunks": sim["virtual_chunks"],
        "devices": sim["num_devices"],
    }


# ---------------------------------------------------------------------------
# The composed plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MLLMParallelPlan:
    """One joint PP x CP decision for one MLLM and one workload."""
    stage: StagePlan
    schedule: SchedulePlan
    context: Optional[ContextPlan]
    text_len: int
    microbatch_size: int = 1

    # -- serialization -----------------------------------------------------
    def to_json(self, indent: Optional[int] = None) -> str:
        d = {
            "format_version": PLAN_FORMAT_VERSION,
            "stage": dataclasses.asdict(self.stage),
            "schedule": dataclasses.asdict(self.schedule),
            "context": dataclasses.asdict(self.context)
            if self.context is not None else None,
            "workload": {"text_len": self.text_len,
                         "microbatch_size": self.microbatch_size},
        }
        return json.dumps(d, indent=indent)

    @classmethod
    def from_json(cls, s: str) -> "MLLMParallelPlan":
        d = json.loads(s)
        version = d.get("format_version")
        if version != PLAN_FORMAT_VERSION:
            raise ValueError(
                f"unsupported plan format_version {version!r} "
                f"(this build reads {PLAN_FORMAT_VERSION})")
        try:
            st = d["stage"]
            stage = StagePlan(
                encoder_names=tuple(st["encoder_names"]),
                encoder_stages=tuple(int(k) for k in st["encoder_stages"]),
                llm_stages=int(st["llm_stages"]),
                frozen_aware=bool(st["frozen_aware"]))
            sc = d["schedule"]
            schedule = SchedulePlan(
                name=sc["name"],
                virtual_chunks=int(sc["virtual_chunks"]),
                num_microbatches=int(sc["num_microbatches"]),
                iteration_time=float(sc["iteration_time"]),
                bubble_fraction=float(sc["bubble_fraction"]),
                num_devices=int(sc["num_devices"]),
                peak_activations_per_device=tuple(
                    int(p) for p in sc["peak_activations_per_device"]),
                tput_per_device=float(sc["tput_per_device"]))
            cx = d["context"]
            context = None if cx is None else ContextPlan(
                method=cx["method"], num_ranks=int(cx["num_ranks"]),
                block_size=int(cx["block_size"]),
                assignment=tuple(int(a) for a in cx["assignment"]),
                loads=tuple(float(x) for x in cx["loads"]))
            wl = d["workload"]
            return cls(stage=stage, schedule=schedule, context=context,
                       text_len=int(wl["text_len"]),
                       microbatch_size=int(wl["microbatch_size"]))
        except (KeyError, TypeError) as e:
            raise ValueError(f"malformed MLLMParallelPlan JSON: {e}") \
                from e

    def save(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            f.write(self.to_json(indent=1) + "\n")

    @classmethod
    def load(cls, path: str) -> "MLLMParallelPlan":
        with open(path, encoding="utf-8") as f:
            return cls.from_json(f.read())

    # -- derived views -----------------------------------------------------
    @property
    def pp_devices(self) -> int:
        return self.stage.num_devices

    @property
    def cp_ranks(self) -> int:
        return self.context.num_ranks if self.context is not None else 1

    @property
    def total_devices(self) -> int:
        """Pipeline ranks x CP group size."""
        return self.pp_devices * self.cp_ranks

    def stage_counts_by_name(self) -> Dict[str, int]:
        return self.stage.counts_by_name()

    # -- executor contract -------------------------------------------------
    def apply(self, mllm, text_len: Optional[int] = None, *,
              mode: str = "replay") -> Dict[str, Any]:
        """Instantiate the plan against ``mllm``: re-derive the module
        profiles, partition at the planned stage counts, re-simulate the
        pinned (schedule, virtual_chunks) pair and return the executor
        contract (:func:`build_executor_plan`) with ``"plan"`` and
        ``"context"``. ``mode="replay"`` is the contract
        ``core.modality_parallel.execute_schedule`` replays in one
        process; ``mode="spmd"`` also ships the compiled wave program
        (``parallel.spmd.compile_spmd_program``) under ``"spmd_program"``,
        which the distributed runner executes and
        ``analysis.schedlint.lint_spmd_program`` checks, and the real
        MLLM's stage partition (``models.stages.build_mllm_stages``)
        under ``"stage_bundle"``."""
        if mode not in ("replay", "spmd"):
            raise ValueError(
                f"unknown executor mode {mode!r}; pick 'replay' "
                f"(sequential timeline replay) or 'spmd' (one process "
                f"per pipeline rank)")
        names = tuple(sorted(mllm.encoders))
        if names != tuple(sorted(self.stage.encoder_names)):
            raise ValueError(
                f"plan was searched for encoders "
                f"{sorted(self.stage.encoder_names)}, mllm has "
                f"{list(names)}")
        encs, llm = mllm.profiles(text_len or self.text_len,
                                  batch=self.microbatch_size)
        counts = self.stage.counts_by_name()
        out = build_executor_plan(
            encs, llm, [counts[e.name] for e in encs],
            self.stage.llm_stages, self.schedule.num_microbatches,
            schedule=self.schedule.name,
            virtual_chunks=(self.schedule.virtual_chunks,),
            frozen_aware=self.stage.frozen_aware)
        out["plan"] = self
        out["context"] = self.context
        if mode == "spmd":
            from repro_torch.models.stages import build_mllm_stages
            from repro_torch.parallel.spmd import compile_spmd_program
            out["spmd_program"] = compile_spmd_program(
                out["sim_graph"], out["schedule"])
            out["stage_bundle"] = build_mllm_stages(
                mllm, out, text_len=text_len or self.text_len)
        return out

    # -- human-readable dump -----------------------------------------------
    def describe(self) -> str:
        lines = [
            f"MLLMParallelPlan (text_len={self.text_len}, "
            f"microbatch_size={self.microbatch_size})",
            f"  stages : llm={self.stage.llm_stages}"
            + "".join(f", {n}={k}" for n, k in
                      zip(self.stage.encoder_names,
                          self.stage.encoder_stages))
            + f"  ({self.stage.num_devices} pipeline ranks, "
            f"frozen_aware={self.stage.frozen_aware})",
            f"  sched  : {self.schedule.name} "
            f"(v={self.schedule.virtual_chunks}, "
            f"microbatches={self.schedule.num_microbatches}) "
            f"bubble={self.schedule.bubble_fraction:.3f} "
            f"peak_act={list(self.schedule.peak_activations_per_device)}",
        ]
        if self.context is not None:
            c = self.context
            lines.append(
                f"  cp     : {c.method} over {c.num_ranks} ranks "
                f"(block={c.block_size}, blocks={len(c.assignment)}) "
                f"imbalance={c.imbalance:.3f}")
        else:
            lines.append("  cp     : none")
        lines.append(f"  devices: {self.pp_devices} pp x "
                     f"{self.cp_ranks} cp = {self.total_devices}")
        return "\n".join(lines)

"""Typed parallelisation plans (the counterpart of ``repro.parallel``).

    plan = parallelize(mllm, ClusterSpec(8, cp_size=8),
                       WorkloadShape(text_len=1024))
    plan.save("plan.json")
    executor = plan.apply(mllm)         # the replay contract

``plan`` holds the data model, ``api`` the search entry points and
``spmd`` the distributed schedule runner (one process per pipeline
rank, ``plan.apply(mllm, mode="spmd")``).
"""
from .plan import (ClusterSpec, ContextPlan,  # noqa: F401
                   MLLMParallelPlan, PLAN_FORMAT_VERSION, SchedulePlan,
                   StagePlan, WorkloadShape, build_executor_plan)
from .api import (OBJECTIVES, mllm_workload_bits,  # noqa: F401
                  parallelize, plan_context, search_plan)

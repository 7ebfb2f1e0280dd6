"""The port's typed plans (``repro_torch.parallel``) against the JAX
package's ``repro.parallel``, on the CPU.

``parallelize`` and ``search_plan`` must return the reference's plan
(compared through the shared JSON schema, byte for byte) for the paper's
models under every objective; the golden 8-rank plan must load and be
reproduced; a plan written by either package loads in the other;
``apply`` must give the reference's executor contract (graphs,
timeline, device map, peaks) and ``describe`` its text. The port's plans
pass the reference's ``schedlint.lint_plan`` once read back with
``repro.parallel.MLLMParallelPlan.from_json``. ``mode="spmd"`` is
refused (ROADMAP.md queue 1 item 16)."""
import dataclasses
import os
import warnings

import pytest

from repro import parallel as jpar
from repro.analysis import schedlint
from repro.core import schedule as jsch
from repro.models.mllm import build_paper_mllm as jbuild
from repro_torch import parallel as tpar
from repro_torch.core import modality_parallel as tmp
from repro_torch.models.mllm import build_paper_mllm as tbuild

GOLDEN = os.path.join(os.path.dirname(__file__), "data",
                      "paper_mllm_8rank_plan.json")
KINDS = ("vlm", "alm", "valm")
OBJECTIVES = ("tput_per_device", "iteration_time", "bubble_fraction")


def models(kind, reduced=False, train_llm=False):
    jm, tm = jbuild(kind, reduced=reduced), tbuild(kind, reduced=reduced)
    if train_llm:
        jm.freeze("llm", module=False)
        tm.freeze("llm", module=False)
    return jm, tm


def plans(kind, devices=8, cp=8, microbatches=8, text=1024, reduced=False,
          train_llm=False, **kw):
    jm, tm = models(kind, reduced, train_llm)
    block = 128 if not reduced else 8
    want = jpar.parallelize(
        jm, jpar.ClusterSpec(devices, cp_size=cp),
        jpar.WorkloadShape(text_len=text, num_microbatches=microbatches,
                           block_size=block), **kw)
    got = tpar.parallelize(
        tm, tpar.ClusterSpec(devices, cp_size=cp),
        tpar.WorkloadShape(text_len=text, num_microbatches=microbatches,
                           block_size=block), **kw)
    return jm, tm, want, got


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("objective", OBJECTIVES)
@pytest.mark.parametrize("train_llm", [False, True])
@pytest.mark.parametrize("devices,cp", [(4, 1), (8, 8)])
def test_parallelize_equals_reference(kind, objective, train_llm, devices,
                                      cp):
    _, _, want, got = plans(kind, devices, cp, train_llm=train_llm,
                            objective=objective)
    assert got.to_json() == want.to_json()
    assert got.describe() == want.describe()
    assert got.total_devices == want.total_devices


@pytest.mark.parametrize("kind", KINDS)
def test_reduced_plans_equal_reference(kind):
    _, _, want, got = plans(kind, devices=3, cp=2, microbatches=2, text=16,
                            reduced=True)
    assert got.to_json() == want.to_json()


def test_golden_plan_loads_and_is_reproduced():
    golden = tpar.MLLMParallelPlan.load(GOLDEN)
    _, _, want, got = plans("vlm")
    assert got == golden
    assert got.schedule.name == "zb-v" and got.schedule.virtual_chunks == 2
    assert golden.to_json() == jpar.MLLMParallelPlan.load(GOLDEN).to_json()


def test_plans_cross_the_package_boundary(tmp_path):
    _, _, want, got = plans("valm", devices=6, cp=4)
    path = tmp_path / "p.json"
    got.save(str(path))
    assert jpar.MLLMParallelPlan.load(str(path)) == want
    want.save(str(path))
    assert tpar.MLLMParallelPlan.load(str(path)) == got
    assert tpar.MLLMParallelPlan.from_json(got.to_json()) == got


@pytest.mark.parametrize("objective", OBJECTIVES)
@pytest.mark.parametrize("schedules", [jsch.SCHEDULES, ("1f1b", "zb-h1")])
def test_search_plan_equals_reference(objective, schedules):
    jm, tm = models("valm")
    kw = dict(objective=objective, schedules=schedules,
              virtual_chunks=(1, 2))
    want = jpar.search_plan(*jm.profiles(1024), jpar.ClusterSpec(6),
                            jpar.WorkloadShape(num_microbatches=4), **kw)
    got = tpar.search_plan(*tm.profiles(1024), tpar.ClusterSpec(6),
                           tpar.WorkloadShape(num_microbatches=4), **kw)
    assert got.context is None
    assert got.to_json() == want.to_json()


def test_unknown_objective_refused():
    _, tm = models("vlm")
    with pytest.raises(ValueError, match="objective"):
        tpar.parallelize(tm, tpar.ClusterSpec(4), tpar.WorkloadShape(),
                         objective="speed")


def test_workload_bits_equal_reference():
    import numpy as np
    for kind in KINDS:
        jm, tm = models(kind)
        for got, want in zip(tpar.mllm_workload_bits(tm, 1024),
                             jpar.mllm_workload_bits(jm, 1024)):
            np.testing.assert_array_equal(got, want)


def assert_contract_equal(got, want):
    for key in ("graph", "sim_graph"):
        assert [vars(s) for s in got[key].stages] == \
            [vars(s) for s in want[key].stages]
        assert got[key].edges == want[key].edges
    for key in ("items", "device_of", "peak_activations_per_device",
                "iteration_time", "bubble_fraction", "num_devices"):
        assert got["schedule"][key] == want["schedule"][key], key
    for key in ("schedule_name", "virtual_chunks", "devices"):
        assert got[key] == want[key], key


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("devices", [3, 5, 8])
def test_apply_contract_equals_reference(kind, devices):
    jm, tm, want, got = plans(kind, devices=devices, cp=2,
                              objective="iteration_time")
    jex, tex = want.apply(jm), got.apply(tm)
    assert_contract_equal(tex, jex)
    assert tex["plan"] is got and tex["context"] == got.context
    assert len(tex["graph"].stages) == tex["devices"] == got.pp_devices
    assert tex["schedule"]["peak_activations_per_device"] == \
        list(got.schedule.peak_activations_per_device)
    assert_contract_equal(got.apply(tm, text_len=512),
                          want.apply(jm, text_len=512))


def test_apply_refuses_spmd_and_other_encoders():
    """mode="spmd" (ported) ships the reference's compiled program and a
    stage bundle; other modes and another MLLM's encoders are refused."""
    jm, tm, want, got = plans("vlm")
    tex, jex = got.apply(tm, mode="spmd"), want.apply(jm, mode="spmd")
    assert_contract_equal(tex, jex)
    tprog, jprog = tex["spmd_program"], jex["spmd_program"]
    assert tprog.counts() == jprog.counts()
    assert [(sorted(w.compute.items()), [r.pairs for r in w.rounds])
            for w in tprog.waves] == \
        [(sorted(w.compute.items()), [r.pairs for r in w.rounds])
         for w in jprog.waves]
    assert len(tex["stage_bundle"].specs) == len(tex["sim_graph"].stages)
    with pytest.raises(ValueError, match="executor mode"):
        got.apply(tm, mode="threads")
    with pytest.raises(ValueError, match="encoders"):
        got.apply(tbuild("valm"))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("train_llm", [False, True])
def test_port_plans_lint_clean(kind, train_llm):
    _, _, want, got = plans(kind, devices=6, cp=4, train_llm=train_llm)
    assert schedlint.lint_plan(
        jpar.MLLMParallelPlan.from_json(got.to_json())) == \
        schedlint.lint_plan(want) == []


def test_from_json_rejects_malformed():
    good = tpar.MLLMParallelPlan.load(GOLDEN).to_json()
    with pytest.raises(ValueError, match="format_version"):
        tpar.MLLMParallelPlan.from_json(good.replace(
            '"format_version": 1', '"format_version": 2'))
    with pytest.raises(ValueError, match="malformed"):
        tpar.MLLMParallelPlan.from_json(good.replace('"stage"', '"stages"'))
    with pytest.raises(ValueError, match="unknown schedule"):
        tpar.MLLMParallelPlan.from_json(good.replace('"zb-v"', '"gpipe"'))


def test_component_validation():
    with pytest.raises(ValueError):
        tpar.ClusterSpec(0)
    with pytest.raises(ValueError):
        tpar.WorkloadShape(num_microbatches=0)
    with pytest.raises(ValueError):
        tpar.StagePlan(("vision",), (1, 2), 1)
    plan = tpar.MLLMParallelPlan.load(GOLDEN)
    with pytest.raises(ValueError, match="zb-v"):
        dataclasses.replace(plan.schedule, virtual_chunks=4)
    assert plan.stage_counts_by_name() == {"vision": 1}
    assert plan.pp_devices == 2 and plan.cp_ranks == 8


def test_executor_plan_folds_chunks_back():
    jm, tm = models("vlm")
    kw = dict(schedule="interleaved", virtual_chunks=(2,))
    je, jl = jm.profiles(1024)
    te, tl = tm.profiles(1024)
    want = jpar.build_executor_plan(je, jl, [2], 3, 6, **kw)
    got = tpar.build_executor_plan(te, tl, [2], 3, 6, **kw)
    assert_contract_equal(got, want)
    assert len(got["sim_graph"].stages) == 2 * len(got["graph"].stages)


def test_deprecated_plan_readers():
    from repro.core import modality_parallel as jmp
    _, tm, want, got = plans("vlm")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        assert tmp.schedule_from_plan(got) == \
            jmp.schedule_from_plan(want) == "zb-v"
        assert tmp.virtual_chunks_from_plan(got) == 2
        assert tmp.schedule_from_plan(None) == "1f1b"
        assert tmp.virtual_chunks_from_plan(None) == 1
        ex = got.apply(tm)
        assert tmp.schedule_from_plan(ex) == "zb-v"
        assert tmp.virtual_chunks_from_plan({"schedule": "1f1b"}) == 1
        for bad in ({"schedule": "gpipe"}, 3):
            with pytest.raises(ValueError):
                tmp.schedule_from_plan(bad)
        with pytest.raises(ValueError):
            tmp.virtual_chunks_from_plan({"virtual_chunks": 0})
    with pytest.warns(DeprecationWarning):
        tmp.schedule_from_plan(got)

"""The port's cost model and Algorithm 1 (``repro_torch.core.pipeline``)
and the MLLM's planning views (``core.modality``: profiles, execution
graph, ``MultimodalParallelSpec``) against the JAX package's, on the CPU.

Everything is held EQUAL, floats included: per-layer FLOPs, profiles,
DP partitions, the graph constructors' stages, ``simulate_plan``'s
simulations and ``auto_parallelize``'s winner (its tie-break included)
for the paper's vlm, alm and valm, reduced and full width, under every
objective. Profiles need no weights. A fixed-seed hypothesis property
draws random module profiles; its overlap check follows the rule for
zero-length ops (a frozen stage's B item has length 0 and occupies no
time on its device; starts compare with a tolerance)."""
import numpy as np
import pytest

from repro.configs import paper_mllm as jcfgs
from repro.configs.base import get_config as jget_config
from repro.core import pipeline as jpp
from repro.core import schedule as jsch
from repro.core.modality import (MultimodalParallelSpec as JSpec,
                                 ParallelSpec as JPSpec)
from repro.models.mllm import build_paper_mllm as jbuild
from repro_torch.configs import paper_mllm as tcfgs
from repro_torch.configs.base import get_config as tget_config
from repro_torch.core import pipeline as tpp
from repro_torch.core.modality import (MultimodalParallelSpec as TSpec,
                                       ParallelSpec as TPSpec,
                                       topological_generations)
from repro_torch.models.mllm import build_paper_mllm as tbuild

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, seed, settings, strategies as st  # noqa: E402

KINDS = ("vlm", "alm", "valm")
OBJECTIVES = ("tput_per_device", "iteration_time", "bubble_fraction")
OVERLAP_TOL = 1e-9


def models(kind, reduced, train_llm=False):
    jm, tm = jbuild(kind, reduced=reduced), tbuild(kind, reduced=reduced)
    if train_llm:
        jm.freeze("llm", module=False)
        tm.freeze("llm", module=False)
    return jm, tm


def assert_profile_equal(got, want):
    assert got.name == want.name and got.frozen == want.frozen
    assert got.trainable_upstream == want.trainable_upstream
    assert got.recompute == want.recompute
    for attr in ("layer_fwd", "layer_bwd", "layer_bwd_w"):
        assert np.array_equal(getattr(got, attr), getattr(want, attr)), attr
    assert got.bwd_factor == want.bwd_factor
    assert got.bwd_input_factor == want.bwd_input_factor


def assert_graph_equal(got, want):
    assert [vars(s) for s in got.stages] == [vars(s) for s in want.stages]
    assert got.edges == want.edges


def assert_sim_equal(got, want):
    for key in ("iteration_time", "bubble_fraction", "per_device_busy",
                "num_devices", "device_of", "items",
                "peak_activations_per_device", "schedule",
                "virtual_chunks"):
        assert got[key] == want[key], key


def assert_winner_equal(got, want):
    assert_graph_equal(got.pop("graph"), want.pop("graph"))
    assert_sim_equal(got, want)
    assert got == want


# ---------------------------------------------------------------------------
# Cost model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["llm_config", "vision_encoder_config",
                                   "audio_encoder_config"])
@pytest.mark.parametrize("size", ["S", "M", "L"])
@pytest.mark.parametrize("seq,batch", [(1024, 1), (1600, 2), (77, 3)])
def test_layer_flops_equal_reference(which, size, seq, batch):
    j = getattr(jcfgs, which)(size)
    t = getattr(tcfgs, which)(size)
    assert tpp.layer_fwd_flops(t, seq, batch) == \
        jpp.layer_fwd_flops(j, seq, batch)


def test_qwen3_flops_equal_reference():
    for reduced in (False, True):
        assert tpp.layer_fwd_flops(tget_config("qwen3-1.7b", reduced),
                                   4096) == \
            jpp.layer_fwd_flops(jget_config("qwen3-1.7b", reduced), 4096)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("recompute", [False, True])
@pytest.mark.parametrize("train_llm", [False, True])
def test_profiles_equal_reference(kind, reduced, recompute, train_llm):
    jm, tm = models(kind, reduced, train_llm)
    for text_len in (16, 1024):
        je, jl = jm.profiles(text_len, batch=2, recompute=recompute)
        te, tl = tm.profiles(text_len, batch=2, recompute=recompute)
        assert len(te) == len(je)
        for got, want in zip(te + [tl], je + [jl]):
            assert_profile_equal(got, want)
    for name, enc in tm.encoders.items():
        assert_profile_equal(enc.profile(0), jm.encoders[name].profile(0))


def test_profile_factors_follow_the_frozen_rule():
    f = np.ones(3)
    rows = [(True, False, False, 0, 0), (True, True, False, 1, 0),
            (False, False, False, 2, 1), (True, True, True, 2, 0),
            (False, True, True, 3, 1), (True, False, True, 0, 0)]
    for frozen, up, rec, bwd, w in rows:
        m = tpp.ModuleProfile("m", f, frozen, up, rec)
        assert (m.bwd_factor, m.bwd_weight_factor) == (bwd, w)
    mods = [tpp.ModuleProfile(str(i), f, fr) for i, fr in
            enumerate([True, False, True])]
    tpp.analyze_chain(mods, [False, False])
    assert [m.trainable_upstream for m in mods] == [False, False, True]


# ---------------------------------------------------------------------------
# Partitioning and graph constructors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 7, 16, 40])
@pytest.mark.parametrize("k", [1, 2, 3, 5, 8])
def test_partition_layers_equal_reference(n, k):
    rng = np.random.default_rng(100 * n + k)
    costs = rng.uniform(0.1, 5.0, n)
    assert tpp.partition_layers(costs, k) == jpp.partition_layers(costs, k)
    flat = np.full(n, 3.0)
    assert tpp.partition_layers(flat, k) == jpp.partition_layers(flat, k)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("frozen_aware", [True, False])
def test_graph_constructors_equal_reference(kind, frozen_aware):
    jm, tm = models(kind, reduced=False)
    je, jl = jm.profiles(1024)
    te, tl = tm.profiles(1024)
    kw = dict(frozen_aware=frozen_aware)
    for k in (1, 3, 4):
        assert_graph_equal(tpp.build_colocated(te, tl, k, 2, **kw),
                           jpp.build_colocated(je, jl, k, 2, **kw))
        assert_graph_equal(tpp.build_replicated(te, tl, k, **kw),
                           jpp.build_replicated(je, jl, k, **kw))
        assert_graph_equal(
            tpp.build_modality_parallel(te, tl, [k] * len(te), 3, **kw),
            jpp.build_modality_parallel(je, jl, [k] * len(je), 3, **kw))
        assert_graph_equal(
            tpp.build_chain_fused(te + [tl], 2 * k + 1, **kw),
            jpp.build_chain_fused(je + [jl], 2 * k + 1, **kw))
        got = tpp.partition_module(tl, k, **kw)
        want = jpp.partition_module(jl, k, **kw)
        assert [vars(s) for s in got] == [vars(s) for s in want]


@pytest.mark.parametrize("schedule", jsch.SCHEDULES)
@pytest.mark.parametrize("kind", KINDS)
def test_simulate_plan_equal_reference(schedule, kind):
    jm, tm = models(kind, reduced=False)
    je, jl = jm.profiles(1024)
    te, tl = tm.profiles(1024)
    counts = [2] * len(te)
    for vc in (2, (1,), (2,), 4):
        if schedule == "zb-v" and vc == (4,):
            continue
        jg, js = jpp.simulate_plan(je, jl, counts, 3, 8, schedule=schedule,
                                   virtual_chunks=vc)
        tg, ts = tpp.simulate_plan(te, tl, counts, 3, 8, schedule=schedule,
                                   virtual_chunks=vc)
        assert_graph_equal(tg, jg)
        assert_sim_equal(ts, js)
    jg, js = jpp.simulate_fused_chain(je + [jl], 4, 8, schedule=schedule)
    tg, ts = tpp.simulate_fused_chain(te + [tl], 4, 8, schedule=schedule)
    assert_graph_equal(tg, jg)
    assert_sim_equal(ts, js)


def test_zbv_pin_outside_its_placements_refused():
    _, tm = models("vlm", reduced=True)
    te, tl = tm.profiles(16)
    with pytest.raises(ValueError, match="zb-v"):
        tpp.simulate_plan(te, tl, [1], 1, 4, schedule="zb-v",
                          virtual_chunks=(4,))


# ---------------------------------------------------------------------------
# Algorithm 1
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("objective", OBJECTIVES)
@pytest.mark.parametrize("devices,microbatches", [(4, 4), (8, 8)])
def test_auto_parallelize_winner_equals_reference(kind, reduced, objective,
                                                  devices, microbatches):
    jm, tm = models(kind, reduced)
    text = 16 if reduced else 1024
    want = jpp.auto_parallelize(*jm.profiles(text), devices, microbatches,
                                objective=objective)
    got = tpp.auto_parallelize(*tm.profiles(text), devices, microbatches,
                               objective=objective)
    assert_winner_equal(got, want)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("schedules", [("1f1b",), ("zb-h1",),
                                       ("interleaved", "zb-v")])
@pytest.mark.parametrize("frozen_aware", [True, False])
def test_auto_parallelize_restricted_equals_reference(kind, schedules,
                                                      frozen_aware):
    jm, tm = models(kind, reduced=False, train_llm=True)
    want = jpp.auto_parallelize(*jm.profiles(1024), 6, 8,
                                schedules=schedules,
                                frozen_aware=frozen_aware)
    got = tpp.auto_parallelize(*tm.profiles(1024), 6, 8,
                               schedules=schedules,
                               frozen_aware=frozen_aware)
    assert_winner_equal(got, want)


def test_unknown_objective_refused():
    _, tm = models("vlm", reduced=True)
    with pytest.raises(ValueError, match="objective"):
        tpp.auto_parallelize(*tm.profiles(16), 4, 4, objective="speed")


def device_overlaps(items, tol=OVERLAP_TOL):
    """Pairs of items that overlap on one device. A zero-length item
    occupies no time; two items overlap when one starts more than tol
    before the other ends and vice versa."""
    bad = []
    by_dev = {}
    for it in items:
        by_dev.setdefault(it[2], []).append(it)
    for its in by_dev.values():
        busy = sorted((it for it in its if it[1] - it[0] > tol),
                      key=lambda it: it[0])
        for a, b in zip(busy, busy[1:]):
            if b[0] < a[1] - tol:
                bad.append((a, b))
    return bad


@seed(20261017)
@settings(max_examples=25, deadline=None, database=None)
@given(enc_layers=st.lists(st.integers(1, 6), min_size=1, max_size=2),
       enc_cost=st.lists(st.floats(0.1, 4.0), min_size=2, max_size=2),
       llm_layers=st.integers(2, 8), llm_frozen=st.booleans(),
       devices=st.integers(2, 6), microbatches=st.integers(1, 6))
def test_random_profiles_pick_the_reference_winner(
        enc_layers, enc_cost, llm_layers, llm_frozen, devices,
        microbatches):
    def profiles(pkg):
        encs = [pkg.ModuleProfile(f"e{i}", np.full(n, enc_cost[i]), True)
                for i, n in enumerate(enc_layers)]
        llm = pkg.ModuleProfile("llm", np.linspace(1.0, 2.0, llm_layers),
                                llm_frozen, trainable_upstream=True)
        return encs, llm

    if devices < len(enc_layers) + 1:
        return
    want = jpp.auto_parallelize(*profiles(jpp), devices, microbatches)
    got = tpp.auto_parallelize(*profiles(tpp), devices, microbatches)
    assert not device_overlaps(got["items"])
    assert_winner_equal(got, want)


def test_zero_length_ops_occupy_no_time():
    items = [(0.0, 2.0, 0, "F", 0, 0), (1.0, 1.0, 0, "B", 1, 0),
             (2.0 - 1e-12, 3.0, 0, "F", 0, 1)]
    assert device_overlaps(items) == []
    assert device_overlaps(items + [(2.5, 4.0, 0, "W", 0, 0)])


# ---------------------------------------------------------------------------
# Execution graph and the spec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_execution_graph_equals_reference(kind):
    jm, tm = models(kind, reduced=True)
    g = jm.execution_graph()
    adj = tm.execution_graph()
    assert set(adj) == set(g.nodes)
    assert {(a, b) for a, succ in adj.items() for b in succ} == \
        set(g.edges)
    assert tm.independent_sets() == jm.independent_sets()


def test_topological_generations_refuses_a_cycle():
    assert topological_generations({"a": ["b"], "b": ["c"], "c": []}) == \
        [["a"], ["b"], ["c"]]
    with pytest.raises(ValueError, match="cycle"):
        topological_generations({"a": ["b"], "b": ["a"]})


@pytest.mark.parametrize("schedule", jsch.SCHEDULES)
@pytest.mark.parametrize("kind", KINDS)
def test_spec_apply_equals_reference(schedule, kind):
    jm, tm = models(kind, reduced=False)
    kw = dict(num_microbatches=4, schedule=schedule, virtual_chunks=2)
    want = JSpec({n: JPSpec(pp_size=2, tp_size=2) for n in jm.encoders},
                 JPSpec(pp_size=3), **kw).apply(jm)
    got = TSpec({n: TPSpec(pp_size=2, tp_size=2) for n in tm.encoders},
                TPSpec(pp_size=3), **kw).apply(tm)
    assert_graph_equal(got["graph"], want["graph"])
    assert_graph_equal(got["sim_graph"], want["sim_graph"])
    assert_sim_equal(got["schedule"], want["schedule"])
    for key in ("schedule_name", "virtual_chunks", "devices"):
        assert got[key] == want[key], key
    with pytest.raises(ValueError):
        TSpec({"other": TPSpec()}, TPSpec()).apply(tm)

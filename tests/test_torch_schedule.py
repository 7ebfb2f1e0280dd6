"""The port's schedule package (``repro_torch.core.schedule``) and its
replay executor against the JAX package's, on the CPU.

Simulations must be EQUAL, not close: item timelines (start and end
times as floats), device maps, bubble fractions, iteration times and
per-device peaks, for 1F1B, interleaved, ZB-H1 and ZB-V on chain,
frozen-head, refined and modality-parallel (fan-in) graphs.
``validate_schedule_memory(executor="replay")`` must measure the
reference's integer peaks and W-residual peaks, and the replay's loss
and gradients on the toy residual stage (same numpy weights) agree with
JAX's ``execute_schedule`` within RTOL/ATOL."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import schedule as jsch
from repro.core.modality_parallel import execute_schedule as jexecute
from repro.core.schedule import memory as jmem
from repro.core.schedule.simulator import item_id as jitem_id
from repro_torch.core import schedule as tsch
from repro_torch.core.modality_parallel import (execute_schedule,
                                                normalize_stage_fns,
                                                pipeline_reference,
                                                stack_stage_params)
from repro_torch.core.schedule import memory as tmem

RTOL, ATOL = 1e-5, 1e-6
M = 8
CHUNKED = ("interleaved", "zb-v")


def _stages(pkg, spec):
    return [pkg.Stage(name, f, b, rng, bwd_w=w)
            for name, f, b, rng, w in spec]


#: name -> (stage specs, edges or None for a chain)
GRAPHS = {
    "chain4": ([("m", 1.0, 2.0, (0, 2), 1.0)] * 4, None),
    "frozen_head": ([("enc", 1.0, 0.0, (0, 2), 0.0),
                     ("enc", 1.3, 0.0, (2, 4), 0.0),
                     ("llm", 2.0, 2.0, (0, 3), 0.0),
                     ("llm", 2.5, 2.5, (3, 6), 0.0)], None),
    "ft1": ([("enc", 0.7, 0.0, (0, 2), 0.0),
             ("llm", 2.0, 4.0, (0, 3), 2.0),
             ("llm", 1.5, 3.0, (3, 6), 1.5)], None),
    "uneven": ([("a", 1.0, 2.0, (0, 1), 1.0), ("b", 3.0, 6.0, (0, 1), 3.0),
                ("c", 0.5, 1.0, (0, 1), 0.5), ("d", 2.0, 4.0, (0, 1), 2.0)],
               None),
    # two encoder chains feeding the first LLM stage (modality parallel)
    "fan_in": ([("vision", 1.0, 0.0, (0, 2), 0.0),
                ("vision", 1.0, 0.0, (2, 4), 0.0),
                ("audio", 1.5, 0.0, (0, 3), 0.0),
                ("llm", 3.0, 3.0, (0, 4), 0.0),
                ("llm", 3.0, 3.0, (4, 8), 0.0)],
               [(0, 1), (2, 3), (3, 4), (1, 3)]),
}


def graphs(name, refine=False):
    spec, edges = GRAPHS[name]
    out = []
    for pkg in (jsch, tsch):
        g = pkg.PipelineGraph(_stages(pkg, spec), list(edges)) if edges \
            else pkg.chain_graph(_stages(pkg, spec))
        if refine and edges is None:
            g = pkg.refine_chain(g, 2)
        out.append(g)
    return out


def _kw(schedule):
    return {"virtual_chunks": 2} if schedule in CHUNKED else {}


def assert_sim_equal(got, want):
    for key in ("iteration_time", "bubble_fraction", "per_device_busy",
                "num_devices", "device_of", "items",
                "peak_activations_per_device", "schedule",
                "virtual_chunks"):
        assert got[key] == want[key], key


@pytest.mark.parametrize("schedule", jsch.SCHEDULES)
@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("refine", [False, True])
@pytest.mark.parametrize("microbatches", [4, 8])
def test_simulation_equals_reference(schedule, name, refine, microbatches):
    jg, tg = graphs(name, refine)
    want = jsch.get_scheduler(schedule, **_kw(schedule)).simulate(
        jg, microbatches)
    got = tsch.get_scheduler(schedule, **_kw(schedule)).simulate(
        tg, microbatches)
    assert_sim_equal(got, want)
    assert [tsch.item_id(it) for it in got["items"]] == \
        [jitem_id(it) for it in want["items"]]


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_graph_helpers_equal_reference(name):
    jg, tg = graphs(name)
    assert tg.preds == jg.preds and tg.succs == jg.succs
    assert [tg.depth_from_end(i) for i in range(len(tg.stages))] == \
        [jg.depth_from_end(i) for i in range(len(jg.stages))]
    for v in (1, 2, 3):
        assert tsch.interleave_devices(tg, v) == \
            jsch.interleave_devices(jg, v)
    if GRAPHS[name][1] is None:
        for v in (1, 2, 3):
            jr, tr = jsch.refine_chain(jg, v), tsch.refine_chain(tg, v)
            assert [vars(s) for s in tr.stages] == \
                [vars(s) for s in jr.stages]
            assert tr.edges == jr.edges
    for n in (2, 4, 8):
        assert tsch.v_shape_devices(n) == jsch.v_shape_devices(n)


def test_sort_items_and_peaks_equal_reference():
    rng = np.random.default_rng(3)
    kinds = "FBW"
    items = [(float(rng.integers(0, 4)), 0.0, int(rng.integers(0, 3)),
              kinds[int(rng.integers(0, 3))], int(rng.integers(0, 4)),
              int(rng.integers(0, 3))) for _ in range(60)]
    assert tsch.sort_items(items) == jsch.sort_items(items)
    assert tsch.peak_live_activations(tsch.sort_items(items), 3) == \
        jsch.peak_live_activations(jsch.sort_items(items), 3)


def test_unknown_schedule_refused():
    with pytest.raises(ValueError, match="unknown schedule"):
        tsch.get_scheduler("gpipe")
    with pytest.raises(AssertionError):
        tsch.get_scheduler("zb-v", virtual_chunks=3)


# ---------------------------------------------------------------------------
# Memory validation and the replay executor
# ---------------------------------------------------------------------------

def two_rank(schedule, frozen_head):
    spec = [("enc", 1.0, 0.0, (0, 0), 0.0) if frozen_head
            else ("s0", 1.0, 2.0, (0, 0), 1.0), ("s1", 1.0, 2.0, (0, 0), 1.0)]
    out = []
    for pkg in (jsch, tsch):
        g = pkg.chain_graph(_stages(pkg, spec))
        out.append(pkg.refine_chain(g, 2) if schedule in CHUNKED else g)
    return out


@pytest.mark.parametrize("schedule", jsch.SCHEDULES)
@pytest.mark.parametrize("frozen_head", [False, True])
def test_validate_memory_peaks_equal_reference(schedule, frozen_head):
    jg, tg = two_rank(schedule, frozen_head)
    want = jmem.validate_schedule_memory(jg, M, schedule, **_kw(schedule))
    got = tmem.validate_schedule_memory(
        tg, M, schedule, generator=torch.Generator().manual_seed(0),
        **_kw(schedule))
    for key in ("schedule", "virtual_chunks", "num_devices",
                "simulated_peaks", "executor_peaks", "caps",
                "peak_w_residuals"):
        assert got[key] == want[key], key
    assert got["simulated_peaks"] == got["executor_peaks"]


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("schedule", jsch.SCHEDULES)
def test_replay_equals_reference_replay(name, schedule):
    """Same numpy weights and microbatches through both executors: loss,
    outputs, stacked weight grads, peaks and the per-item trace."""
    jg, tg = graphs(name, refine=schedule in CHUNKED)
    S = len(tg.stages)
    jsim = jsch.get_scheduler(schedule, **_kw(schedule)).simulate(jg, M)
    tsim = tsch.get_scheduler(schedule, **_kw(schedule)).simulate(tg, M)
    rng = np.random.default_rng(1)
    w = (rng.normal(size=(S, 8, 8)) * 0.1).astype(np.float32)
    mbs = rng.normal(size=(M, 1, 3, 8)).astype(np.float32)
    want = jexecute(lambda lp, x: x + jnp.tanh(x @ lp["w"]),
                    {"w": jnp.asarray(w)}, jnp.asarray(mbs), jg, jsim)
    got = execute_schedule(lambda lp, x: x + torch.tanh(x @ lp["w"]),
                           {"w": torch.tensor(w, requires_grad=True)},
                           torch.tensor(mbs), tg, tsim)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=RTOL)
    np.testing.assert_allclose(got["outputs"].numpy(),
                               np.asarray(want["outputs"]), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got["param_grads"]["w"].numpy(),
                               np.asarray(want["param_grads"]["w"]),
                               rtol=RTOL, atol=ATOL)
    for key in ("peak_activations_per_device",
                "peak_w_residuals_per_device", "activation_trace",
                "activation_nbytes"):
        assert got[key] == want[key], key


def test_replay_grads_equal_autograd():
    _, tg = two_rank("zb-h1", False)
    stage_fn, params, mbs = tmem.toy_stage_model(
        len(tg.stages), M, generator=torch.Generator().manual_seed(2))
    sim = tsch.get_scheduler("zb-h1").simulate(tg, M)
    res = execute_schedule(stage_fn, params, mbs, tg, sim)
    ref = pipeline_reference(stage_fn, params, mbs,
                             num_stages=len(tg.stages))
    loss = sum(torch.mean(y ** 2) for y in ref)
    (g,) = torch.autograd.grad(loss, params["w"])
    torch.testing.assert_close(res["param_grads"]["w"], g, rtol=RTOL,
                               atol=ATOL)
    torch.testing.assert_close(res["outputs"], ref.detach())
    assert params["w"].grad is None


def test_replay_skips_frozen_stage():
    """A frozen head (bwd = 0) gets no W, no weight grads and no
    cotangent: its B only frees memory."""
    _, tg = two_rank("zb-h1", True)
    stage_fn, params, mbs = tmem.toy_stage_model(len(tg.stages), M)
    sim = tsch.get_scheduler("zb-h1").simulate(tg, M)
    res = execute_schedule(stage_fn, params, mbs, tg, sim)
    assert not res["param_grads"]["w"][0].any()
    assert res["param_grads"]["w"][1].abs().max() > 0


def test_replay_of_an_incomplete_timeline_fails():
    _, tg = two_rank("1f1b", False)
    stage_fn, params, mbs = tmem.toy_stage_model(len(tg.stages), M)
    sim = tsch.get_scheduler("1f1b").simulate(tg, M)
    sim = dict(sim, items=[it for it in sim["items"]
                           if not (it[3] == "B" and it[5] == M - 1)])
    with pytest.raises(RuntimeError, match="live activations"):
        execute_schedule(stage_fn, params, mbs, tg, sim)


def test_divergent_claim_fails_loudly():
    _, tg = two_rank("zb-h1", False)
    sim = tsch.get_scheduler("zb-h1").simulate(tg, M)
    bad = dict(sim, peak_activations_per_device=[
        p + 1 for p in sim["peak_activations_per_device"]])
    with pytest.raises(tmem.MemoryModelMismatch) as err:
        tmem.validate_schedule_memory(tg, M, "zb-h1", sim=bad)
    assert err.value.first_divergence is None
    trace = tmem.simulated_activation_trace(tg, sim)
    jtrace = jmem.simulated_activation_trace(two_rank("zb-h1", False)[0],
                                             sim)
    assert trace == jtrace
    shifted = [(i, d, c + 1) for i, d, c in trace]
    assert tmem.diff_activation_traces(trace, shifted, 4) == \
        jmem.diff_activation_traces(trace, shifted, 4)


def test_spmd_executor_not_ported(tmp_path):
    """executor="spmd" (ported) runs the distributed runner on the
    current process group: a one-device schedule on a world-size-1 gloo
    group in this process passes; a two-device one is refused there
    (tests/test_torch_spmd.py runs it on 2 and 4 ranks)."""
    import torch.distributed as dist
    _, tg = two_rank("1f1b", False)
    one = tsch.chain_graph([tsch.Stage("m", 1.0, 2.0, bwd_w=1.0)])
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        rep = tmem.validate_schedule_memory(one, M, executor="spmd")
        assert rep["executor"] == "spmd"
        assert rep["executor_peaks"] == rep["simulated_peaks"] == [1]
        assert rep["loss"] == tmem.validate_schedule_memory(one, M)["loss"]
        with pytest.raises(ValueError, match="compiled for 2"):
            tmem.validate_schedule_memory(tg, M, executor="spmd")
    finally:
        dist.destroy_process_group()
    with pytest.raises(ValueError, match="unknown executor"):
        tmem.validate_schedule_memory(tg, M, executor="other")


def test_activation_caps_equal_reference():
    for pkg, mem in ((jsch, jmem), (tsch, tmem)):
        g = pkg.chain_graph([pkg.Stage("m", 1.0, 2.0) for _ in range(4)])
        assert mem.activation_caps(g) == [4, 3, 2, 1]
        assert mem.activation_caps(g, num_microbatches=2) == [2, 2, 2, 1]
        assert mem.activation_caps(g, device_of=[0, 1, 1, 0]) == [5, 5]


def test_stage_argument_helpers():
    rng = np.random.default_rng(0)
    per = [{"w": torch.tensor(rng.normal(size=(2, 2)))} for _ in range(3)]
    stacked = stack_stage_params(per)
    assert stacked["w"].shape == (3, 2, 2)
    with pytest.raises(ValueError):
        stack_stage_params([{"w": per[0]["w"]}, {"v": per[0]["w"]}])
    fns = normalize_stage_fns(lambda lp, x: x + 1, 2)
    assert len(fns) == 2 and fns[1](None, 1, None) == 2
    with pytest.raises(ValueError, match="stage fns"):
        normalize_stage_fns([lambda lp, x, mb: x], 2)

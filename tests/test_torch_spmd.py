"""The port's distributed schedule runner (``repro_torch.parallel.spmd``)
and the rest of ``core.modality_parallel`` against the JAX package, on
the CPU.

- ``compile_spmd_program``'s waves and comm rounds, as plain tuples,
  equal the reference's for the four schedules on a chain and on a
  fan-in graph, and for the golden 8-rank plan; its refusal of an
  unreachable cotangent too.
- The runner over 2 and 4 gloo ranks, each rank its own spawned process
  (``torch_spmd_ranks``; one spawn per world size carries every case):
  on the toy residual stage (chains under the four schedules, a fan-in
  DAG, a frozen prefix) and on the reduced vlm's stage bundle (f32,
  weights carried over from the JAX init by ``bridge``), its loss,
  outputs and gradients match the port's ``execute_schedule`` and the
  JAX ``execute_schedule`` within RTOL/ATOL (the JAX replay's own f32
  tolerances; the bundle against JAX, once, within test_torch_stages'
  LOSS_RTOL/GRAD_RTOL/GRAD_ATOL, JAX running attention as "xla"), and
  its reassembled activation trace and peaks equal the simulator's
  exactly; ``validate_schedule_memory(executor="spmd")`` passes; frozen
  stages get exactly zero gradients; 2 steps of ``make_spmd_train_step``
  equal 2 replay steps with the port's AdamW; a group of the wrong size
  is refused.
- ``pipeline_forward`` over 4 ranks against JAX's ``pipeline_reference``
  (forward 1e-5, gradients 1e-6: the reference test's bounds).
- ``split_devices`` equals the reference's; ``ModalityIslands`` on the
  reduced valm equals the MLLM forward.
"""
import dataclasses
import functools
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import modality_parallel as jmp
from repro.core import schedule as jsch
from repro.data import synthetic as jdata
from repro.models.mllm import build_paper_mllm as jbuild
from repro.models.stages import build_mllm_stages as jstages
from repro import parallel as jpar
from repro.parallel import spmd as jspmd
from repro_torch import bridge
from repro_torch import parallel as tpar
from repro_torch.core import modality_parallel as tmp
from repro_torch.data import synthetic as tdata
from repro_torch.models.mllm import build_paper_mllm as tbuild
from repro_torch.models.stages import build_mllm_stages
from repro_torch.optim import optimizer as opt
from repro_torch.parallel import spmd as tspmd

from .test_torch_stages import _jax_grads_by_name, batch_of, weights
from .torch_cp_ranks import run_ranks
from .torch_spmd_ranks import graph_of

GOLDEN = pathlib.Path(__file__).parent / "data" / "paper_mllm_8rank_plan.json"
RTOL, ATOL = 1e-5, 1e-6                      # runner vs execute_schedule
LOSS_RTOL, GRAD_RTOL, GRAD_ATOL = 2e-5, 2e-4, 1e-6   # bundle vs JAX
SCHEDULES = ("1f1b", "interleaved", "zb-h1", "zb-v")
CHUNKED = ("interleaved", "zb-v")
M, D_MODEL, TEXT = 4, 8, 16
BM = 2                  # the bundle's microbatches (batch of 2)
OCFG = dict(lr=1e-2, warmup_steps=1, total_steps=4)
TRAIN = ("s", 1.0, 2.0, 1.0)
FROZEN = ("e", 1.0, 0.0, 0.0)
FAN_IN = [("enc0", 1.0, 1.0, 0.0), ("enc1", 1.2, 1.2, 0.0),
          ("llm", 1.0, 2.0, 1.0), ("llm", 1.0, 2.0, 1.0)]
FAN_IN_EDGES = [(0, 2), (1, 2), (2, 3)]


def spec(schedule, devices, frozen_prefix=0, stages=None, edges=None,
         microbatches=M):
    """A case's graph spec: a chain of ``devices`` stages, one per
    device (refined 2x for the chunked schedules: two chunk-stages per
    device), or the given stages and edges."""
    if stages is None:
        chunked = schedule in CHUNKED
        stages = [FROZEN if s < frozen_prefix else TRAIN
                  for s in range(devices)]
        return {"stages": stages, "edges": None, "refine": chunked,
                "schedule": schedule, "microbatches": microbatches}
    return {"stages": stages, "edges": edges, "refine": False,
            "schedule": schedule, "microbatches": microbatches}


def jgraph(sp):
    stages = [jsch.Stage(n, f, b, bwd_w=w) for n, f, b, w in sp["stages"]]
    g = jsch.PipelineGraph(stages, sp["edges"]) if sp["edges"] \
        else jsch.chain_graph(stages)
    if sp["refine"]:
        g = jsch.refine_chain(g, 2)
    kw = {"virtual_chunks": 2} if sp["schedule"] in CHUNKED else {}
    return g, jsch.get_scheduler(sp["schedule"], **kw).simulate(
        g, sp["microbatches"])


def toy_case(sp, seed, validate=False):
    rng = np.random.default_rng(seed)
    S = len(graph_of(sp)[0].stages)
    w = (rng.normal(size=(S, D_MODEL, D_MODEL)) * 0.1).astype(np.float32)
    mbs = rng.normal(size=(sp["microbatches"], 1, 4, D_MODEL)).astype(
        np.float32)
    return dict(sp, kind="toy", w=w, mbs=mbs, validate=validate)


def vlm_plan(train_llm, devices):
    """A reduced-vlm plan with ``devices`` pipeline ranks: the searched
    one for 2 (ZB-H1 pinned for ft1); for 4, 2 vision and 2 LLM stages
    under 1F1B (ZB-H1 for ft1)."""
    tm = tbuild("vlm", reduced=True)
    if train_llm:
        tm.freeze("llm", module=False)
    kw = {"schedules": ("zb-h1",)} if train_llm else {}
    plan = tpar.parallelize(
        tm, tpar.ClusterSpec(num_devices=devices),
        tpar.WorkloadShape(text_len=TEXT, num_microbatches=BM,
                           block_size=8), **kw)
    if devices == 4:
        plan = dataclasses.replace(
            plan, stage=dataclasses.replace(plan.stage, encoder_stages=(2,),
                                            llm_stages=2),
            schedule=dataclasses.replace(
                plan.schedule, name="zb-h1" if train_llm else "1f1b",
                virtual_chunks=1, num_devices=4,
                peak_activations_per_device=(4, 3, 2, 1)))
    return plan


@functools.lru_cache(maxsize=None)
def jax_weights():
    """The reduced vlm's JAX init at seed 0, as numpy (shared by every
    bundle case; the frozen flags do not change the init)."""
    jp, _ = weights(tbuild("vlm", reduced=True))
    return jax.tree.map(np.asarray, jp)


def bundle_case(train_llm, devices):
    tm = tbuild("vlm", reduced=True)
    if train_llm:
        tm.freeze("llm", module=False)
    plan = vlm_plan(train_llm, devices)
    ex = plan.apply(tm, text_len=TEXT, mode="spmd")
    assert ex["schedule"]["num_devices"] == devices
    bundle = ex["stage_bundle"]
    mbs = [bundle.encode_microbatches(
        batch_of(tdata, tm, device="cpu", seed=seed), BM).numpy()
        for seed in (0, 1, 2)]
    return {"kind": "bundle", "train_llm": train_llm, "plan": plan.to_json(),
            "text_len": TEXT, "params": jax_weights(),
            "mbs": mbs[0], "steps": mbs[1:], "ocfg": OCFG}


def payload(world):
    cases = {}
    for schedule in SCHEDULES:
        cases[f"chain-{schedule}"] = toy_case(
            spec(schedule, world), seed=len(cases),
            validate=schedule == "zb-v")
    cases["vlm"] = bundle_case(False, world)
    cases["vlm-ft1"] = bundle_case(True, world)
    if world == 2:
        cases["wrong-size"] = dict(spec("1f1b", 4), kind="wrong_size")
        rng = np.random.default_rng(5)
        cases["plan-toy"] = {
            "kind": "plan_toy", "plan": vlm_plan(False, 2).to_json(),
            "mbs": rng.normal(size=(BM, 1, 4, 16)).astype(np.float32)}
    else:
        for schedule in ("1f1b", "zb-h1"):
            cases[f"fan-in-{schedule}"] = toy_case(
                spec(schedule, 4, stages=FAN_IN, edges=FAN_IN_EDGES,
                     microbatches=6), seed=10 + len(cases))
        for schedule in ("1f1b", "zb-v"):
            cases[f"frozen-{schedule}"] = toy_case(
                spec(schedule, 4, frozen_prefix=1), seed=20 + len(cases))
        rng = np.random.default_rng(9)
        cases["pipeline"] = {
            "kind": "pipeline", "stages": 4,
            "w": (rng.normal(size=(4, 32, 32)) * 0.1).astype(np.float32),
            "mbs": rng.normal(size=(6, 2, 8, 32)).astype(np.float32)}
    return cases


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """world -> (payload, {rank: results}); each world size is spawned
    once, on first use."""
    done = {}

    def get(world):
        if world not in done:
            pl = payload(world)
            done[world] = pl, run_ranks(
                world, "tests.torch_spmd_ranks:cases", pl,
                tmp_path_factory.mktemp(f"spmd{world}"), timeout=240)
        return done[world]
    return get


# ---------------------------------------------------------------------------
# Compilation
# ---------------------------------------------------------------------------

def waves_of(prog):
    return [(sorted(w.compute.items()),
             [(r.kind, [dataclasses.astuple(t) for t in r.transfers],
               r.pairs) for r in w.rounds]) for w in prog.waves]


def assert_program_equal(got, want):
    assert waves_of(got) == waves_of(want)
    for key in ("items", "device_of", "num_devices", "hosted", "chunk_of",
                "max_chunks", "has_w_items"):
        assert getattr(got, key) == getattr(want, key), key
    assert got.counts() == want.counts()


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("graph", ["chain", "fan-in", "frozen"])
def test_compile_equals_reference(schedule, graph):
    sp = {"chain": spec(schedule, 4),
          "fan-in": spec(schedule, 4, stages=FAN_IN, edges=FAN_IN_EDGES),
          "frozen": spec(schedule, 4, frozen_prefix=1)}[graph]
    tg, tsim = graph_of(sp)
    jg, jsim = jgraph(sp)
    assert_program_equal(tspmd.compile_spmd_program(tg, tsim),
                         jspmd.compile_spmd_program(jg, jsim))


def test_golden_plan_compiles_as_the_reference():
    jplan = jpar.MLLMParallelPlan.load(str(GOLDEN))
    tplan = tpar.MLLMParallelPlan.load(str(GOLDEN))
    jm = jbuild("vlm", reduced=True, text_len=jplan.text_len)
    tm = tbuild("vlm", reduced=True, text_len=tplan.text_len)
    jex, tex = jplan.apply(jm, mode="spmd"), tplan.apply(tm, mode="spmd")
    assert_program_equal(tex["spmd_program"], jex["spmd_program"])
    assert [dataclasses.astuple(s) for s in tex["stage_bundle"].specs] == \
        [dataclasses.astuple(s) for s in jex["stage_bundle"].specs]


def test_compile_rejects_unreachable_cotangent():
    stages = [("a", 1.0, 2.0, 1.0), ("b", 1.0, 0.0, 0.0),
              ("c", 1.0, 2.0, 1.0)]
    sp = spec("1f1b", 3, stages=stages, edges=[(0, 1), (1, 2)],
              microbatches=2)
    tg, tsim = graph_of(sp)
    jg, jsim = jgraph(sp)
    with pytest.raises(ValueError, match="no successor produces") as got:
        tspmd.compile_spmd_program(tg, tsim)
    with pytest.raises(ValueError) as want:
        jspmd.compile_spmd_program(jg, jsim)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# The runner on the toy stage
# ---------------------------------------------------------------------------

def toy_refs(case):
    """(port execute_schedule, JAX execute_schedule) on the case."""
    tg, tsim = graph_of(case)
    jg, jsim = jgraph(case)
    w = torch.from_numpy(case["w"]).requires_grad_(True)
    tref = tmp.execute_schedule(lambda lp, x: x + torch.tanh(x @ lp["w"]),
                                {"w": w}, torch.from_numpy(case["mbs"]),
                                tg, tsim)
    jref = jmp.execute_schedule(lambda lp, x: x + jnp.tanh(x @ lp["w"]),
                                {"w": jnp.asarray(case["w"])},
                                jnp.asarray(case["mbs"]), jg, jsim)
    return tref, jref


def toy_names(world):
    names = [f"chain-{s}" for s in SCHEDULES]
    if world == 4:
        names += ["fan-in-1f1b", "fan-in-zb-h1", "frozen-1f1b",
                  "frozen-zb-v"]
    return names


@pytest.mark.parametrize("world", [2, 4])
def test_toy_runner_matches_both_replays(spawned, world):
    pl, res = spawned(world)
    for name in toy_names(world):
        case, got = pl[name], res[0][name]
        tref, jref = toy_refs(case)
        for ref in (tref, jref):
            np.testing.assert_allclose(got["loss"], float(ref["loss"]),
                                       rtol=RTOL, err_msg=name)
            np.testing.assert_allclose(got["outputs"],
                                       np.asarray(ref["outputs"]),
                                       rtol=RTOL, atol=ATOL, err_msg=name)
            np.testing.assert_allclose(got["grads"],
                                       np.asarray(ref["param_grads"]["w"]),
                                       rtol=RTOL, atol=ATOL, err_msg=name)
            for key in ("activation_trace", "peak_activations_per_device",
                        "peak_w_residuals_per_device"):
                short = {"activation_trace": "trace",
                         "peak_activations_per_device": "peaks",
                         "peak_w_residuals_per_device": "w_peaks"}[key]
                assert got[short] == list(ref[key]), (name, key)
        # the comparison is not vacuous: every trainable stage trained
        tg, tsim = graph_of(case)
        for s, st in enumerate(tg.stages):
            assert got["grads"][s].any() == (st.bwd_w > 0), (name, s)
        assert got["peaks"] == tsim["peak_activations_per_device"]
        assert got["counts"]["devices"] == world
        for r in range(world):     # every rank reassembles the same trace
            assert res[r][name]["trace"] == got["trace"]
            assert res[r][name]["loss"] == got["loss"]


@pytest.mark.parametrize("world", [2, 4])
def test_memory_validation_spmd(spawned, world):
    pl, res = spawned(world)
    case = pl["chain-zb-v"]
    _, tsim = graph_of(case)
    for r in range(world):
        executor, sim_peaks, exe_peaks = res[r]["chain-zb-v"]["memory"]
        assert executor == "spmd"
        assert sim_peaks == exe_peaks == tsim["peak_activations_per_device"]


def test_fan_in_and_frozen_prefix(spawned):
    pl, res = spawned(4)
    for name in ("fan-in-1f1b", "fan-in-zb-h1"):
        case, got = pl[name], res[0][name]
        tg, _ = graph_of(case)
        loss, grads = tspmd.reference_dag_loss(
            lambda lp, x: x + torch.tanh(x @ lp["w"]),
            {"w": torch.from_numpy(case["w"])},
            torch.from_numpy(case["mbs"]), tg)
        np.testing.assert_allclose(got["loss"], float(loss), rtol=RTOL)
        np.testing.assert_allclose(got["grads"], grads["w"].numpy(),
                                   rtol=RTOL, atol=ATOL)
        assert not got["grads"][:2].any()         # frozen encoders
    for name in ("frozen-1f1b", "frozen-zb-v"):
        got = res[0][name]
        tg, _ = graph_of(pl[name])
        frozen = [s for s, st in enumerate(tg.stages)
                  if st.bwd_w <= 0 and st.bwd_b <= 0]
        assert frozen and not got["grads"][frozen].any()


def test_wrong_group_size_is_refused(spawned):
    _, res = spawned(2)
    assert all("compiled for 4 devices" in res[r]["wrong-size"]
               for r in range(2))


def test_plan_form_and_parity_report(spawned):
    """run_schedule_spmd(plan, mllm, mbs): the "toy" sentinel and None
    (with its warning) run the same toy model; spmd_parity_report finds
    the runner and the replay in agreement on the plan's contract."""
    pl, res = spawned(2)
    for r in range(2):
        got = res[r]["plan-toy"]
        assert got["warned"] and got["toy"] == got["default"]
        rep = got["report"]
        assert rep["peaks_match"] and rep["trace_match"]
        assert rep["max_grad_diff"] <= ATOL
        np.testing.assert_allclose(rep["loss_spmd"], rep["loss_replay"],
                                   rtol=RTOL)
        assert rep["program"]["devices"] == 2


def test_parity_report_and_toy_stage_default_to_the_card(monkeypatch):
    """Without device=, the report and the toy stage ask for the card:
    where torch sees none they raise before touching a process group,
    and nothing moves to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ex = vlm_plan(False, 2).apply(tbuild("vlm", reduced=True), mode="spmd")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tspmd.spmd_parity_report(ex)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tspmd.toy_stage_model(4, 8)
    fn, params = tspmd.toy_stage_model(4, 8, seed=3, device="cpu")
    gen = torch.Generator().manual_seed(3)
    want = torch.randn((4, 8, 8), generator=gen) * 0.1
    assert params["w"].requires_grad and torch.equal(params["w"], want)


# ---------------------------------------------------------------------------
# The runner on the reduced vlm's stage bundle, and make_spmd_train_step
# ---------------------------------------------------------------------------

def bundle_refs(case, with_jax):
    """The port's execute_schedule on the case's plan and weights (and
    JAX's, ``with_jax``), plus the port's replay of the training steps
    with AdamW."""
    tm = tbuild("vlm", reduced=True)
    jm = jbuild("vlm", reduced=True)
    if case["train_llm"]:
        tm.freeze("llm", module=False)
        jm.freeze("llm", module=False)
    tm.llm_cfg = tm.llm_cfg.replace(attn_impl="bam_kernel")
    tplan = tpar.MLLMParallelPlan.from_json(case["plan"])
    jplan = jpar.MLLMParallelPlan.from_json(case["plan"])
    tex = tplan.apply(tm, text_len=TEXT)
    jex = jplan.apply(jm, text_len=TEXT)
    tb = build_mllm_stages(tm, tex, text_len=TEXT)
    params = bridge.mllm_from_jax_params(case["params"], tm, device="cpu")
    sp = tb.partition(params)
    run = dict(microbatch_loss=tb.microbatch_loss,
               trainable=list(tb.trainable))
    tref = tmp.execute_schedule(tb.stage_fns, sp,
                                torch.from_numpy(case["mbs"]),
                                tex["sim_graph"], tex["schedule"], **run)
    jref = jgrads = None
    if with_jax:
        jb = jstages(jm, jex, text_len=TEXT)
        jp = jax.tree.map(jnp.asarray, case["params"])
        jbatch = batch_of(jdata, jm, seed=0)
        jref = jmp.execute_schedule(jb.stage_fns, jb.partition(jp),
                                    jb.encode_microbatches(jbatch, BM),
                                    jex["sim_graph"], jex["schedule"],
                                    microbatch_loss=jb.microbatch_loss,
                                    trainable=list(jb.trainable))
        jgrads = _jax_grads_by_name(jb.unpartition(jref["param_grads"]), tm)
    # the replay's training steps, AdamW over "<stage>:<name>" as the
    # SPMD step keys it
    masks = tb.frozen_masks(sp)
    named = {f"{s}:{n}": p for s, st in enumerate(sp)
             for n, p in st.named_parameters()}
    mask = {f"{s}:{n}": f for s, m in enumerate(masks) for n, f in m.items()}
    ocfg = opt.AdamWConfig(**case["ocfg"])
    state = opt.init(ocfg, named, mask)
    losses = []
    for mb in case["steps"]:
        res = tmp.execute_schedule(tb.stage_fns, sp, torch.from_numpy(mb),
                                   tex["sim_graph"], tex["schedule"], **run)
        grads = {f"{s}:{n}": g / BM
                 for s, per in enumerate(res["param_grads"])
                 for n, g in per.items()}
        _, state, om = opt.update(ocfg, grads, state, named, mask)
        losses.append((float(res["loss"]) / BM, float(om["grad_norm"])))
    after = {n: p.detach().numpy() for st in sp
             for n, p in st.named_parameters()}
    return tref, jref, jgrads, losses, after


@pytest.mark.parametrize("world", [2, 4])
def test_bundle_runner_and_train_step(spawned, world):
    pl, res = spawned(world)
    for name in ("vlm", "vlm-ft1"):
        case, got = pl[name], res[0][name]
        # the port's replay equals JAX's on these plans
        # (test_torch_stages); JAX's slow eager replay runs once here
        with_jax = (world, name) == (2, "vlm")
        tref, jref, jgrads, losses, after = bundle_refs(case, with_jax)
        np.testing.assert_allclose(got["loss"], float(tref["loss"]),
                                   rtol=RTOL, err_msg=name)
        np.testing.assert_allclose(got["outputs"],
                                   tref["outputs"].numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=name)
        tgrads = {n: g for per in tref["param_grads"] for n, g in
                  per.items()}
        assert set(got["grads"]) == set(tgrads), name
        for n, g in tgrads.items():
            np.testing.assert_allclose(got["grads"][n], g.numpy(),
                                       rtol=RTOL, atol=ATOL, err_msg=n)
        if with_jax:
            np.testing.assert_allclose(got["loss"], float(jref["loss"]),
                                       rtol=LOSS_RTOL, err_msg=name)
            for n, arr in jgrads.items():
                if n in got["grads"]:
                    np.testing.assert_allclose(got["grads"][n], arr,
                                               rtol=GRAD_RTOL,
                                               atol=GRAD_ATOL, err_msg=n)
                else:
                    assert not np.asarray(arr).any(), n
            assert got["trace"] == jref["activation_trace"]
        assert got["trace"] == tref["activation_trace"]
        assert got["peaks"] == tref["peak_activations_per_device"]
        # training: the losses and weights of 2 replay steps with AdamW
        np.testing.assert_allclose(got["losses"], losses, rtol=RTOL)
        for r in range(world):
            assert not any(res[r][name]["frozen_grads"])
            for n, arr in res[r][name]["after"].items():
                np.testing.assert_allclose(arr, after[n], rtol=RTOL,
                                           atol=ATOL, err_msg=n)
        seen = set().union(*(res[r][name]["after"] for r in range(world)))
        assert seen == set(after)


# ---------------------------------------------------------------------------
# pipeline_forward, split_devices, ModalityIslands
# ---------------------------------------------------------------------------

def test_pipeline_forward_matches_reference(spawned):
    pl, res = spawned(4)
    case = pl["pipeline"]
    sp = {"w": jnp.asarray(case["w"])}
    mbs = jnp.asarray(case["mbs"])

    def stage_fn(lp, x):
        return x + jnp.tanh(x @ lp["w"])

    ref = jmp.pipeline_reference(stage_fn, sp, mbs, num_stages=4)
    g = jax.grad(lambda p: jnp.mean(jmp.pipeline_reference(
        stage_fn, p, mbs, num_stages=4) ** 2))(sp)["w"]
    for r in range(4):
        got = res[r]["pipeline"]
        assert float(np.abs(got["out"] - np.asarray(ref)).max()) < 1e-5
        assert float(np.abs(got["grad"] - np.asarray(g[r])).max()) < 1e-6
        assert got["others_zero"]


def test_split_devices_equals_reference():
    jm, tm = jbuild("valm", reduced=True), tbuild("valm", reduced=True)
    devs = list(range(8))
    for plan in (None, {"vision": 2, "audio": 1},
                 {"encoder_names": ["audio", "vision"],
                  "encoder_stages": [3, 1]}):
        assert tmp.split_devices(tm, devs, plan) == \
            jmp.split_devices(jm, devs, plan)
    jplan = jpar.MLLMParallelPlan.load(str(GOLDEN))
    tplan = tpar.MLLMParallelPlan.load(str(GOLDEN))
    jv, tv = jbuild("vlm", reduced=True), tbuild("vlm", reduced=True)
    assert tmp.split_devices(tv, devs, tplan) == \
        jmp.split_devices(jv, devs, jplan)
    with pytest.raises(ValueError, match="no devices left"):
        tmp.split_devices(tm, devs[:2])


def test_modality_islands_equal_the_mllm_forward():
    tm = tbuild("valm", reduced=True)
    gen = torch.Generator().manual_seed(0)
    params = tm.init(device="cpu", generator=gen)
    batch = {"text_tokens": torch.randint(0, tm.llm_cfg.vocab_size, (2, 24),
                                          generator=gen)}
    for name, enc in tm.encoders.items():
        batch[f"{name}_embeds"] = torch.randn(
            (2, enc.num_tokens, enc.cfg.d_model), generator=gen)
    split = tmp.split_devices(tm, ["cpu"] * 4)
    isl = tmp.ModalityIslands(tm, split)
    logits, _ = isl.run(params, batch)
    (want, _), _ = tm.forward(params, batch)
    assert torch.equal(logits, want)
    assert sorted(isl.islands) == ["audio", "vision"]
    assert split["vision"] == ["cpu"] and split["audio"] == ["cpu"]
    assert len(split["llm"]) == 2

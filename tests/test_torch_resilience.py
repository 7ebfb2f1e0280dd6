"""The port's fault-tolerant runtime (``repro_torch.resilience`` and the
launcher's loop) against the JAX package's ``repro.resilience`` on the
CPU.

The reference's own runtime tests run against the port on the same tiny
regression problem: the verdict ladder, the event log, the manager's
retention, ``LATEST`` and meta, a save killed mid-shard, the fault
plan's JSON (byte-equal to the reference's), ``CursorStream.seek``, and
the acceptance properties (a crash and ``resume=True`` give the losses
of an uninterrupted run bit for bit; a NaN step rolls back and the run
re-converges; skip; abort; device loss; ``shrink_plan`` JSON-equal to
the reference's). The guarded step is held against the reference's on
the reduced vlm from bridged weights: bundle lanes, parameters and
moments after ok steps and under ``clip_scale`` 0.5, and bad steps that
leave every tensor ``torch.equal``. The launcher: LM and MLLM resume,
the MLLM checkpoint's contents and hardlinks, ``--spmd`` checkpoints
written by 2 gloo ranks (a crash reported as ``CrashInjected``, the
manifest and shards byte-equal to a one-process save of the same stage
list), cross-mode resume both ways, and a JAX launcher checkpoint
resumed by the port."""
import argparse
import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax

from repro.data import synthetic as jdata
from repro.launch import train as jtrain
from repro.models import mllm as jmllm
from repro.optim import optimizer as jopt
from repro.resilience import faults as jfaults
from repro.resilience import monitor as jmon
from repro.training import steps as jsteps
from repro_torch import bridge
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.data import synthetic as tdata
from repro_torch.launch import train as ttrain
from repro_torch.models import mllm as tmllm
from repro_torch.optim import optimizer as opt
from repro_torch.resilience import (ABORT, BUNDLE_KEYS, OK, ROLLBACK, SKIP,
                                    CheckpointManager, CrashInjected,
                                    CursorStream, EventLog, Fault,
                                    FaultInjector, FaultPlan, HealthMonitor,
                                    MonitorConfig, ResilientTrainer,
                                    RetryPolicy, TrainingAborted,
                                    bundle_dict, default_controls,
                                    init_health, make_resilient_train_step)
from repro_torch.training import steps as tsteps

#: the launcher tests' loss tolerance (test_torch_launch.py's)
LOSS_RTOL = 2e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread in this process: the suite's workers share the
    CPU, and these tests' many tiny ops wait on each other's threads
    when every worker runs a full pool (30-50 s instead of under 1 s)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# A tiny deterministic regression problem: fast, converges, bit-exact
# ---------------------------------------------------------------------------

_W_TRUE = np.random.default_rng(7).normal(size=(4, 1)).astype(np.float32)


class _Linear(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(4, 1))


def _loss_fn(model, batch):
    pred = batch["x"] @ model.w
    return torch.mean((pred - batch["y"]) ** 2), {}


def _batches():
    rng = np.random.default_rng(42)
    while True:
        x = rng.normal(size=(8, 4)).astype(np.float32)
        yield {"x": torch.from_numpy(x), "y": torch.from_numpy(x @ _W_TRUE)}


def _fresh(lr=3e-2):
    model = _Linear()
    ocfg = opt.AdamWConfig(lr=lr, warmup_steps=0, schedule="constant",
                           weight_decay=0.0)
    state = opt.init(ocfg, dict(model.named_parameters()))
    return model, state, make_resilient_train_step(_loss_fn, ocfg)


def _trainer(tmp=None, *, faults=(), monitor=None, ckpt_every=0,
             resume=False, policy=None, on_device_loss=None):
    params, state, step_fn = _fresh()
    return ResilientTrainer(
        step_fn, params, state, CursorStream(_batches),
        monitor=monitor,
        manager=CheckpointManager(str(tmp)) if tmp is not None else None,
        injector=FaultInjector(FaultPlan.make(list(faults))),
        ckpt_every=ckpt_every, resume=resume, policy=policy,
        on_device_loss=on_device_loss)


# ---------------------------------------------------------------------------
# The guarded step's gate, and the host classifier
# ---------------------------------------------------------------------------

def test_guarded_step_trains_and_gates():
    params, state, step_fn = _fresh()
    health = init_health()
    it = iter(_batches())
    first = None
    for _ in range(25):
        params, state, health, bundle = step_fn(
            params, state, health, next(it), default_controls())
        b = bundle_dict(bundle)
        first = first if first is not None else b["loss"]
    assert set(b) == set(BUNDLE_KEYS)
    assert b["applied"] == 1.0 and b["nonfinite"] == 0.0
    assert b["loss"] < first * 0.5
    assert int(health["count"]) == 25 and state["step"] == 25
    # an injected NaN step and an over-norm step change nothing
    for key, val in (("inject_nan", 1.0), ("max_grad_norm", 1e-9)):
        before = (params.w.detach().clone(), state["m"]["w"].clone(),
                  state["v"]["w"].clone(), dict(health))
        ctl = default_controls()
        ctl[key] = np.float32(val)
        params, state, health, bundle = step_fn(params, state, health,
                                                next(it), ctl)
        b = bundle_dict(bundle)
        assert b["applied"] == 0.0
        assert (b["nonfinite"] == 1.0) == (key == "inject_nan")
        assert torch.equal(params.w, before[0])
        assert torch.equal(state["m"]["w"], before[1])
        assert torch.equal(state["v"]["w"], before[2])
        assert health == before[3] and state["step"] == 25


def _bundle(loss=1.0, gnorm=1.0, spike=0.0, nonfinite=0.0):
    return {"loss": loss, "grad_norm": gnorm, "spike": spike,
            "nonfinite": nonfinite, "applied": 1.0 - nonfinite}


def test_classifier_escalation_ladder():
    mon = HealthMonitor(MonitorConfig(skip_limit=1, max_rollbacks=1,
                                      spike_sigma=4.0, spike_warmup=2))
    ref = jmon.HealthMonitor(jmon.MonitorConfig(
        skip_limit=1, max_rollbacks=1, spike_sigma=4.0, spike_warmup=2))
    seq = [_bundle(), _bundle(nonfinite=1.0), _bundle(nonfinite=1.0),
           _bundle(), _bundle(nonfinite=1.0), _bundle(spike=9.0)]
    got = [mon.classify(i, b) for i, b in enumerate(seq)]
    assert got == [OK, SKIP, ROLLBACK, OK, SKIP, ABORT]
    assert got == [ref.classify(i, b) for i, b in enumerate(seq)]
    assert mon.log.events == ref.log.events
    warm = HealthMonitor(MonitorConfig(spike_sigma=4.0, spike_warmup=3))
    assert [warm.classify(i, _bundle(spike=100.0)) for i in range(4)] == \
        [OK, OK, OK, ROLLBACK]


def test_event_log_jsonl_roundtrip(tmp_path):
    path = str(tmp_path / "events.jsonl")
    log = EventLog(path)
    log.emit("verdict", 3, verdict=SKIP, reason="nonfinite")
    log.emit("checkpoint", 4, dir="x")
    with open(path, encoding="utf-8") as f:
        lines = [json.loads(ln) for ln in f]
    assert lines == log.events
    assert lines[0]["kind"] == "verdict" and lines[0]["step"] == 3


# ---------------------------------------------------------------------------
# CheckpointManager, faults, the stream
# ---------------------------------------------------------------------------

def test_manager_latest_retention_and_meta(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    assert mgr.latest() is None and mgr.peek_meta() == {}
    w = torch.arange(4, dtype=torch.float32)
    for s in (2, 4, 6):
        mgr.save(s, {"w": w * s}, meta={"cursor": s * 10})
    assert mgr.steps() == [4, 6]                 # keep=2 retention
    assert mgr.latest().endswith("step_00000006")
    assert mgr.peek_meta() == {"cursor": 60}
    into = torch.zeros(4)
    _, step, meta = mgr.restore({"w": into})
    assert step == 6 and meta["cursor"] == 60 and torch.equal(into, w * 6)
    # stale/missing LATEST pointer: discovery falls back to a scan
    os.remove(os.path.join(str(tmp_path), "LATEST"))
    assert CheckpointManager(str(tmp_path)).latest() \
        .endswith("step_00000006")


def test_kill_mid_save_leaves_previous_checkpoint_loadable(tmp_path):
    """A save killed mid-shard leaves the prior checkpoint intact and
    discoverable, and the torn temp dir is collected on the next
    manager construction."""
    params, state, step_fn = _fresh()
    tr = ResilientTrainer(
        step_fn, params, state, CursorStream(_batches),
        manager=CheckpointManager(str(tmp_path)),
        injector=FaultInjector(FaultPlan.make(
            [Fault("crash_in_save", 7, arg=2)])),
        ckpt_every=4)
    with pytest.raises(CrashInjected, match="mid-save at step 7"):
        tr.run(20)
    assert any(n.startswith(".tmp-") for n in os.listdir(str(tmp_path)))
    mgr = CheckpointManager(str(tmp_path))       # a fresh process
    assert not any(n.startswith(".tmp-")
                   for n in os.listdir(str(tmp_path)))
    assert mgr.steps() == [4]
    _, step, meta = mgr.restore(bridge.state_tree(params, state,
                                                  init_health()))
    assert step == 4 and meta["cursor"] == 4


def test_fault_plan_json_is_the_references(tmp_path):
    faults = [("nan_grads", 3, 0), ("crash", 9, 0), ("corrupt_shard", 5, 2),
              ("device_loss", 9, 2), ("crash_in_save", 1, 4)]
    plan = FaultPlan.make([Fault(*f) for f in faults])
    ref = jfaults.FaultPlan.make([jfaults.Fault(*f) for f in faults])
    assert plan.to_json() == ref.to_json()
    path = str(tmp_path / "faults.json")
    plan.save(path)
    assert FaultPlan.load(path) == plan
    assert jfaults.FaultPlan.load(path) == ref
    with pytest.raises(ValueError, match="unknown fault kind"):
        Fault("meteor", 1)


def test_public_names_are_the_references():
    import repro.checkpoint.checkpoint as jck
    import repro.resilience as jres
    import repro_torch.resilience as tres
    assert tres.__all__ == jres.__all__
    assert all(hasattr(tres, n) for n in tres.__all__)
    for name in ("CheckpointError", "save", "read_manifest", "load"):
        assert hasattr(jck, name) and hasattr(ckpt, name)
    assert issubclass(ckpt.CheckpointError, ValueError)


def test_cursor_stream_seek_replays_exactly():
    s1, s2 = CursorStream(_batches), CursorStream(_batches)
    for _ in range(5):
        b5 = s1.next()
    s2.seek(4)
    assert torch.equal(s2.next()["x"], b5["x"])
    assert s1.cursor == s2.cursor == 5


# ---------------------------------------------------------------------------
# The trainer: the acceptance properties
# ---------------------------------------------------------------------------

def test_resume_equivalence_after_injected_crash(tmp_path):
    """Crash at step 13 (ckpt every 4), resume from latest(): the losses
    before the crash and after the resume are an uninterrupted run's,
    bit for bit."""
    ref = _trainer().run(20)["losses"]
    tr = _trainer(tmp_path, faults=[Fault("crash", 13)], ckpt_every=4)
    with pytest.raises(CrashInjected):
        tr.run(20)
    pre = dict(tr.losses)
    tr2 = _trainer(tmp_path, resume=True)
    assert tr2.step == 12                        # latest checkpoint
    post = tr2.run(20)["losses"]
    merged = {**{k: v for k, v in pre.items() if k < tr2.step}, **post}
    assert merged == ref


def test_nan_grad_rollback_and_reconvergence(tmp_path):
    mon = HealthMonitor(MonitorConfig(skip_limit=0))   # bad step ->
    #                                                    rollback now
    tr = _trainer(tmp_path, faults=[Fault("nan_grads", 12)],
                  monitor=mon, ckpt_every=5)
    res = tr.run(30)
    assert res["rollbacks"] == 1
    assert [f["kind"] for f in res["fired_faults"]] == ["nan_grads"]
    restores = mon.log.of_kind("restore")
    assert len(restores) == 1 and restores[0]["step"] == 10
    assert sorted(res["losses"]) == list(range(30))
    vals = [res["losses"][k] for k in sorted(res["losses"])]
    assert np.isfinite(vals).all() and vals[-1] < vals[0] * 0.1
    retries = mon.log.of_kind("retry")
    assert retries and retries[0]["clip_scale"] == 0.5


def test_skip_policy_drops_poisoned_step_and_continues(tmp_path):
    mon = HealthMonitor(MonitorConfig(skip_limit=3))
    tr = _trainer(tmp_path, faults=[Fault("nan_grads", 6)], monitor=mon)
    res = tr.run(15)
    assert res["rollbacks"] == 0 and res["skipped"] == 1
    assert 6 not in res["losses"] and len(res["losses"]) == 14
    vals = [res["losses"][k] for k in sorted(res["losses"])]
    assert np.isfinite(vals).all() and vals[-1] < vals[0]


def test_abort_after_retry_budget(tmp_path):
    faults = [Fault("nan_grads", s) for s in range(4, 10)]
    mon = HealthMonitor(MonitorConfig(skip_limit=0, max_rollbacks=100))
    tr = _trainer(tmp_path, faults=faults, monitor=mon, ckpt_every=2,
                  policy=RetryPolicy(max_attempts=2))
    with pytest.raises(TrainingAborted, match="retry attempts"):
        tr.run(30)


def test_rollback_without_checkpoint_aborts():
    mon = HealthMonitor(MonitorConfig(skip_limit=0))
    tr = _trainer(None, faults=[Fault("nan_grads", 3)], monitor=mon)
    with pytest.raises(TrainingAborted, match="no checkpoint"):
        tr.run(10)


def test_device_loss_replans_and_resumes(tmp_path):
    seen = []
    tr = _trainer(tmp_path, faults=[Fault("device_loss", 9, arg=2)],
                  ckpt_every=4, on_device_loss=seen.append)
    res = tr.run(16)
    assert seen == [2] and res["last_step"] == 16
    assert sorted(res["losses"]) == list(range(16))
    ev = tr.monitor.log
    assert ev.of_kind("device-loss")[0] == {"kind": "device-loss",
                                           "step": 9, "lost": 2}
    assert any(e["why"] == "device-loss" for e in ev.of_kind("restore"))


def test_shrink_plan_is_the_references(capsys):
    from repro.parallel import ClusterSpec as JCluster
    from repro.parallel import WorkloadShape as JShape
    from repro.parallel import parallelize as jparallelize
    from repro_torch.parallel import (ClusterSpec, WorkloadShape,
                                      parallelize)
    jm = jmllm.build_paper_mllm("vlm", reduced=True, text_len=32)
    tm = tmllm.build_paper_mllm("vlm", reduced=True, text_len=32)
    jplan = jparallelize(jm, JCluster(num_devices=4),
                         JShape(text_len=32, num_microbatches=4,
                                block_size=8))
    plan = parallelize(tm, ClusterSpec(num_devices=4),
                       WorkloadShape(text_len=32, num_microbatches=4,
                                     block_size=8))
    args = argparse.Namespace(seq=32, microbatches=4, batch=2)
    for lost in (1, 2):
        got = ttrain.shrink_plan(tm, plan, lost, args)
        said = capsys.readouterr().out
        want = jtrain.shrink_plan(jm, jplan, lost, args)
        assert said == capsys.readouterr().out
        assert said.startswith("device loss: re-planned")
        assert got.to_json() == want.to_json()
        assert 1 + len(tm.encoders) <= got.pp_devices <= plan.pp_devices
        got.apply(tm, text_len=32)


# ---------------------------------------------------------------------------
# The guarded step against the reference's, on the reduced vlm
# ---------------------------------------------------------------------------

OCFG = dict(lr=1e-3, warmup_steps=2, total_steps=10)
#: the reduced vlm step's tolerances (test_torch_train.py)
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)


def _dataset(pkg, mm, **kw):
    encs = mm.encoders
    return pkg.MultimodalDataset(
        vocab_size=mm.llm_cfg.vocab_size, text_len=32, batch_size=2,
        encoder_dims={n: e.cfg.d_model for n, e in encs.items()},
        encoder_tokens={n: e.num_tokens for n, e in encs.items()},
        modality_ids={n: e.modality_id for n, e in encs.items()},
        seed=2, **kw)


@pytest.fixture(scope="module")
def vlm():
    """The reduced vlm in both packages from the JAX init, the
    reference's guarded step jitted once, and the port's."""
    jm = jmllm.build_paper_mllm("vlm", reduced=True)
    tm = tmllm.build_paper_mllm("vlm", reduced=True)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = bridge.mllm_from_jax_params(jax.tree.map(np.asarray, jp), tm,
                                     device="cpu")
    _, jloss = jsteps.make_mllm_train_step(jm, jopt.AdamWConfig(**OCFG))
    jstep = jax.jit(jmon.make_resilient_train_step(
        jloss, jopt.AdamWConfig(**OCFG), jm.frozen_mask(jp)))
    _, tloss = tsteps.make_mllm_train_step(tm, opt.AdamWConfig(**OCFG))
    fmask = tm.frozen_mask(tp)
    tstep = make_resilient_train_step(tloss, opt.AdamWConfig(**OCFG), fmask)
    return dict(jm=jm, tm=tm, jp=jp, tp=tp, jstep=jstep, tstep=tstep,
                jstate=jopt.init(jopt.AdamWConfig(**OCFG), jp,
                                 jm.frozen_mask(jp)),
                tstate=opt.init(opt.AdamWConfig(**OCFG),
                                dict(tp.named_parameters()), fmask))


def test_guarded_step_matches_the_references(vlm):
    jp, tp = vlm["jp"], vlm["tp"]
    jstate, tstate = vlm["jstate"], vlm["tstate"]
    jh, th = jmon.init_health(), init_health()
    jit = iter(_dataset(jdata, vlm["jm"]))
    tit = iter(_dataset(tdata, vlm["tm"], device="cpu"))
    # two ok steps, then one under a rollback's clip_scale of 0.5
    for i, scale in enumerate((1.0, 1.0, 0.5)):
        jc, tc = jmon.default_controls(), default_controls()
        jc["clip_scale"] = jax.numpy.float32(scale)
        tc["clip_scale"] = np.float32(scale)
        ema0 = th["ema"]
        jp, jstate, jh, jb = vlm["jstep"](jp, jstate, jh, next(jit), jc)
        tp, tstate, th, tb = vlm["tstep"](tp, tstate, th, next(tit), tc)
        jb, tb = jmon.bundle_dict(jb), bundle_dict(tb)
        for k in ("loss", "grad_norm", "nonfinite", "applied"):
            np.testing.assert_allclose(tb[k], jb[k], rtol=1e-5,
                                       err_msg=f"step {i} {k}")
        assert tb["applied"] == 1.0
        np.testing.assert_allclose(th["ema"], float(jh["ema"]), rtol=1e-5)
        # spike and var are built on loss - EMA, a difference of two
        # losses: their 1e-5 is scaled by how much that difference
        # magnifies the loss lane's relative error (var squares it)
        cond = 1.0 if i == 0 else 1 + abs(tb["loss"] / (tb["loss"] - ema0))
        np.testing.assert_allclose(tb["spike"], jb["spike"],
                                   rtol=1e-5 * cond, err_msg=f"step {i}")
        np.testing.assert_allclose(th["var"], float(jh["var"]),
                                   rtol=2e-5 * cond, err_msg=f"step {i}")
        assert int(th["count"]) == int(jh["count"]) == i + 1
        assert tstate["step"] == int(jstate["step"]) == i + 1
        want = bridge.mllm_to_jax_params(tp, vlm["tm"])
        for (path, a), (_, b) in zip(
                ckpt.paths_and_leaves(want),
                ckpt.paths_and_leaves(jax.tree.map(np.asarray, jp))):
            np.testing.assert_allclose(a, b, **PARAM_TOL,
                                       err_msg=f"step {i} {path}")
        tm_ = bridge.opt_state_to_jax(tstate, tp)
        for kind, tol in (("m", PARAM_TOL), ("v", dict(rtol=1e-4,
                                                       atol=1e-9))):
            for (path, a), (_, b) in zip(
                    ckpt.paths_and_leaves(tm_[kind]),
                    ckpt.paths_and_leaves(jax.tree.map(np.asarray,
                                                       jstate[kind]))):
                np.testing.assert_allclose(a, b, **tol,
                                           err_msg=f"step {i} {kind}/{path}")
    # a NaN step and an over-norm step leave every tensor as it was
    for key, val in (("inject_nan", 1.0), ("max_grad_norm", 1e-3)):
        before = ({n: p.detach().clone() for n, p in tp.named_parameters()},
                  {k: {n: None if t is None else t.clone()
                       for n, t in tstate[k].items()} for k in ("m", "v")},
                  tstate["step"], dict(th))
        tc = default_controls()
        tc[key] = np.float32(val)
        tp, tstate, th, tb = vlm["tstep"](tp, tstate, th, next(tit), tc)
        jc = jmon.default_controls()
        jc[key] = jax.numpy.float32(val)
        jp, jstate, jh, jb = vlm["jstep"](jp, jstate, jh, next(jit), jc)
        assert bundle_dict(tb)["applied"] == 0.0 == \
            jmon.bundle_dict(jb)["applied"]
        assert all(torch.equal(p, before[0][n])
                   for n, p in tp.named_parameters()), key
        for k in ("m", "v"):
            assert all((t is None and before[1][k][n] is None)
                       or torch.equal(t, before[1][k][n])
                       for n, t in tstate[k].items()), (key, k)
        assert tstate["step"] == before[2] and th == before[3]


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------

MLLM = ["--mllm", "vlm", "--reduced", "--steps", "4", "--seq", "32",
        "--batch", "2", "--microbatches", "2", "--plan-devices", "3",
        "--log-every", "0"]
LM = ["--arch", "qwen3-1.7b", "--reduced", "--steps", "4", "--seq", "32",
      "--batch", "2", "--log-every", "0"]


def _plan(tmp_path, name="fault.json", faults=()):
    path = str(tmp_path / name)
    FaultPlan.make(list(faults)).save(path)
    return path


def _only_step(root, src, step):
    """A root holding only ``src``'s checkpoint of ``step``."""
    name = f"step_{step:08d}"
    os.makedirs(root)
    shutil.copytree(os.path.join(src, name), os.path.join(root, name))
    return root


def test_lm_crash_and_resume_logs_the_uninterrupted_losses(tmp_path):
    ref = ttrain.main(LM + ["--device", "cpu"])
    run = LM + ["--device", "cpu", "--ckpt-dir", str(tmp_path / "run"),
                "--ckpt-every", "2"]
    with pytest.raises(CrashInjected):
        ttrain.main(run + ["--fault-plan", _plan(tmp_path, faults=[
            Fault("crash", 3)])])
    res = ttrain.main(run + ["--resume"])
    assert res["resilience"]["losses"] == {2: ref["losses"][2],
                                           3: ref["losses"][3]}


@pytest.fixture(scope="module")
def replay_run(tmp_path_factory):
    """The reduced vlm's replay launcher, 4 steps, checkpoints at 2 and
    4 (and its plan, which the --spmd runs train under)."""
    tmp = tmp_path_factory.mktemp("replay")
    root, plan = str(tmp / "ck"), str(tmp / "plan.json")
    res = ttrain.main(MLLM + ["--device", "cpu", "--ckpt-dir", root,
                              "--ckpt-every", "2", "--plan-out", plan])
    return root, plan, res


def test_mllm_checkpoint_bundles_everything(replay_run):
    root, _, res = replay_run
    mgr = CheckpointManager(root)
    last = mgr.latest()
    assert last.endswith("step_00000004") and mgr.steps() == [2, 4]
    arrays, step = ckpt.load(last)
    assert step == 4
    assert {p.split("/", 1)[0] for p in arrays} == {"params", "opt",
                                                    "health"}
    man = ckpt.read_manifest(last)
    meta = man["meta"]
    assert list(meta) == ["seed", "mllm", "plan", "mode", "step", "cursor",
                          "clip_scale"]
    assert meta["step"] == meta["cursor"] == 4 and meta["mode"] == "replay"
    # frozen modules' shards are hardlinked forward, not rewritten; the
    # projector, its moments and the EMA are written anew
    for e in man["entries"]:
        frozen = e["path"].startswith(("params/encoders/vision/module",
                                       "params/llm"))
        links = os.stat(os.path.join(last, e["file"])).st_nlink
        assert (links > 1) == frozen, e["path"]
    assert arrays["opt/m/encoders/vision/projector/w1"].abs().sum() > 0
    assert res["resilience"]["losses"] == dict(enumerate(res["losses"]))


def test_spmd_checkpoints_and_cross_mode_resume(replay_run, tmp_path):
    """--spmd on 2 gloo ranks: a crash fired on every rank reaches the
    caller as CrashInjected, the ranks' checkpoint is a one-process save
    of the same stage list byte for byte, and it resumes an --spmd run
    and a replay run; a replay checkpoint resumes an --spmd run."""
    root, plan, ref = replay_run
    spmd = MLLM + ["--device", "cpu", "--plan", plan, "--spmd"]
    crashed = str(tmp_path / "spmd")
    with pytest.raises(CrashInjected, match="crash injected at step 3"):
        ttrain.main(spmd + ["--ckpt-dir", crashed, "--ckpt-every", "2",
                            "--fault-plan", _plan(tmp_path, faults=[
                                Fault("crash", 3)])])
    d = os.path.join(crashed, "step_00000002")
    man = ckpt.read_manifest(d)
    assert man["meta"]["mode"] == "spmd"

    # one process, every stage held: load the ranks' files, save again
    from repro_torch.parallel import MLLMParallelPlan
    tm = tmllm.build_paper_mllm("vlm", reduced=True, text_len=32)
    ex = MLLMParallelPlan.load(plan).apply(tm, text_len=32, mode="spmd")
    bundle = ex["stage_bundle"]
    stages = bundle.partition(tm.init(device="cpu"))
    masks = bundle.frozen_masks(stages)
    named = {f"{s}:{n}": p for s, st in enumerate(stages)
             for n, p in st.named_parameters()}
    state = opt.init(opt.AdamWConfig(), named,
                     {f"{s}:{n}": f for s, m in enumerate(masks)
                      for n, f in m.items()})
    tree, step = ckpt.load(d, bridge.state_tree(stages, state,
                                                init_health()))
    one = str(tmp_path / "one")
    ckpt.save(one, tree, step=step, meta=man["meta"])
    files = sorted(n for n in os.listdir(d))
    assert sorted(os.listdir(one)) == files
    for name in files:
        with open(os.path.join(d, name), "rb") as a, \
                open(os.path.join(one, name), "rb") as b:
            assert a.read() == b.read(), name

    # --spmd resumes its own checkpoint; the replay's losses within tol
    res = ttrain.main(spmd + ["--ckpt-dir", crashed, "--resume"])
    assert sorted(res["resilience"]["losses"]) == [2, 3]
    np.testing.assert_allclose(res["losses"], ref["losses"][2:],
                               rtol=LOSS_RTOL)
    # spmd -> replay: the stage list into the whole model; moments and
    # EMA restart, so step 2 is the replay's and step 3 is not
    back = ttrain.main(MLLM + ["--device", "cpu", "--plan", plan,
                               "--ckpt-dir", _only_step(
                                   str(tmp_path / "back"), crashed, 2),
                               "--resume"])
    np.testing.assert_allclose(back["losses"][0], ref["losses"][2],
                               rtol=LOSS_RTOL)
    assert back["losses"][1] != ref["losses"][3]
    # replay -> spmd
    fwd = ttrain.main(spmd + ["--ckpt-dir", _only_step(
        str(tmp_path / "fwd"), root, 2), "--resume"])
    np.testing.assert_allclose(fwd["losses"], back["losses"],
                               rtol=LOSS_RTOL)


def test_jax_launcher_checkpoint_resumes_in_the_port(tmp_path):
    """A checkpoint written by the JAX launcher (reduced vlm, replay,
    steps 0-1) resumed by the port for steps 2-3 logs the JAX run's own
    steps 2-3."""
    jroot = str(tmp_path / "jax")
    want = jtrain.main(MLLM + ["--ckpt-dir", jroot, "--ckpt-every", "2"])
    got = ttrain.main(MLLM + ["--device", "cpu", "--ckpt-dir", _only_step(
        str(tmp_path / "port"), jroot, 2), "--resume"])
    assert sorted(got["resilience"]["losses"]) == [2, 3]
    np.testing.assert_allclose(got["losses"], want["losses"][2:],
                               rtol=LOSS_RTOL)

"""The port's single-process launcher, ``repro_torch.launch.train``,
against the JAX package's ``repro.launch.train.main`` on the CPU.

Both launchers start from the same weights: the port's ``init_lm`` and
``init_mllm`` are replaced by the JAX init at the same seed carried over
by ``repro_torch.bridge``, and both read equal synthetic streams (the
same numpy draws). The logged losses must agree within LOSS_RTOL at
every step for ``--mllm vlm --reduced`` (also with ``--train-llm``),
``--arch qwen3-1.7b --reduced`` and ``--arch xlstm-125m --reduced
--vocab 64``. ``--plan-out`` writes the JAX launcher's
plan JSON byte for byte, ``--plan`` trains under a saved plan, every
plan passes the schedule lint gate, a corrupted plan is refused by it
(and ``--no-lint`` lets it through), ``--spmd`` spawns the plan's 2
ranks and logs the ``--plan`` replay's losses, and each of the runtime
flags (checkpoints, resume, fault plans, the spike threshold) takes
effect."""
import json
import os

import numpy as np
import pytest

import jax

from repro.configs.base import get_config as jget_config
from repro.launch import train as jtrain
from repro.models import api as japi
from repro_torch import bridge
from repro_torch.launch import train as ttrain

LOSS_RTOL = 2e-5
MLLM_ARGS = ["--mllm", "vlm", "--reduced", "--steps", "3", "--seq", "16",
             "--batch", "2", "--microbatches", "2", "--plan-devices", "3",
             "--log-every", "0"]
LM_ARGS = ["--arch", "qwen3-1.7b", "--reduced", "--steps", "3", "--seq",
           "16", "--batch", "2", "--log-every", "0"]
#: the reference's own resume test's arch and argv
#: (tests/test_resilience.py::_lm_argv)
XLSTM_ARGS = ["--arch", "xlstm-125m", "--reduced", "--steps", "3", "--seq",
              "16", "--batch", "2", "--vocab", "64", "--log-every", "0"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread in this process: the suite's workers share the
    CPU, and the reduced models' many tiny ops wait on each other's
    threads when every worker runs a full pool."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def jax_weights(monkeypatch):
    """The port's inits return the JAX launcher's initial weights."""
    def init_lm(cfg, args, device):
        jcfg = jget_config(args.arch, reduced=args.reduced)
        if args.vocab:
            jcfg = jcfg.replace(vocab_size=args.vocab)
        jp = japi.init(jax.random.PRNGKey(args.seed), jcfg)
        return bridge.from_jax_params(jax.tree.map(np.asarray, jp), cfg,
                                      device=device)

    def init_mllm(mllm, args, device):
        from repro.models.mllm import build_paper_mllm
        jm = build_paper_mllm(args.mllm, reduced=args.reduced,
                              text_len=args.seq)
        jp = jm.init(jax.random.PRNGKey(args.seed))
        return bridge.mllm_from_jax_params(jax.tree.map(np.asarray, jp),
                                           mllm, device=device)

    monkeypatch.setattr(ttrain, "init_lm", init_lm)
    monkeypatch.setattr(ttrain, "init_mllm", init_mllm)


@pytest.mark.parametrize("argv", [MLLM_ARGS, MLLM_ARGS + ["--train-llm"],
                                  LM_ARGS, XLSTM_ARGS],
                         ids=["vlm", "vlm-ft1", "qwen3-1.7b", "xlstm-125m"])
def test_launcher_logs_the_reference_losses(jax_weights, argv, capsys):
    want = jtrain.main(argv)
    got = ttrain.main(argv + ["--device", "cpu"])
    assert got["params"] == want["params"]
    np.testing.assert_allclose(got["losses"], want["losses"],
                               rtol=LOSS_RTOL)
    assert got["first_loss"] == got["losses"][0]
    assert got["last_loss"] == got["losses"][-1]
    out = capsys.readouterr().out
    if "--mllm" in argv:
        assert "plan passed the schedule lint" in out


def test_plan_out_and_plan(tmp_path, jax_weights):
    """--plan-out writes the JAX launcher's plan; --plan trains under it
    and gives the searched run's losses."""
    jpath, tpath = tmp_path / "j.json", tmp_path / "t.json"
    jtrain.main(MLLM_ARGS[:4] + ["1"] + MLLM_ARGS[5:]
                + ["--plan-out", str(jpath), "--no-lint"])
    searched = ttrain.main(MLLM_ARGS + ["--device", "cpu", "--plan-out",
                                        str(tpath)])
    assert tpath.read_text() == jpath.read_text()
    assert json.loads(tpath.read_text())["format_version"] == 1
    loaded = ttrain.main(MLLM_ARGS + ["--device", "cpu", "--plan",
                                      str(jpath)])
    assert loaded["losses"] == searched["losses"]


def test_plan_for_other_encoders_is_refused(tmp_path):
    path = tmp_path / "valm.json"
    ttrain.main(["--mllm", "valm"] + MLLM_ARGS[2:]
                + ["--steps", "1", "--device", "cpu", "--plan-out",
                   str(path)])
    with pytest.raises(ValueError, match="encoders"):
        ttrain.main(MLLM_ARGS + ["--device", "cpu", "--plan", str(path)])


@pytest.mark.parametrize("flag", ["spmd", "ckpt-dir", "resume", "ckpt-every",
                                  "keep", "fault-plan", "spike-sigma"])
def test_runtime_flags_take_effect(flag, tmp_path, capsys, monkeypatch):
    """The JAX launcher's runtime flags, each run and its effect seen:
    --spmd trains the plan's ranks, --ckpt-dir writes a checkpoint root,
    --resume continues a crashed run with its uninterrupted loss,
    --ckpt-every and --keep set the cadence and the retention,
    --fault-plan fires its fault, and --spike-sigma reaches the
    monitor's config."""
    from repro_torch.resilience import (CheckpointManager, CrashInjected,
                                        Fault, FaultPlan)
    args = MLLM_ARGS + ["--device", "cpu"]
    root = str(tmp_path / "ck")
    ck = args + ["--ckpt-dir", root]
    if flag == "spmd":
        # the plan's 2 pipeline ranks, spawned, log the losses of the
        # one-process run under the same plan
        path = tmp_path / "plan.json"
        replay = ttrain.main(args + ["--plan-out", str(path)])
        got = ttrain.main(args + ["--plan", str(path), "--spmd"])
        out = capsys.readouterr().out
        assert "spawning 2 rank processes (gloo" in out
        assert got["params"] == replay["params"]
        np.testing.assert_allclose(got["losses"], replay["losses"],
                                   rtol=LOSS_RTOL)
    elif flag == "ckpt-dir":
        res = ttrain.main(ck)
        assert sorted(os.listdir(root)) == ["LATEST", "events.jsonl",
                                            "step_00000003"]
        assert len(res["losses"]) == 3
    elif flag == "resume":
        want = ttrain.main(args)["losses"]
        plan = str(tmp_path / "crash.json")
        FaultPlan.make([Fault("crash", 2)]).save(plan)
        with pytest.raises(CrashInjected, match="crash injected at step 2"):
            ttrain.main(ck + ["--ckpt-every", "2", "--fault-plan", plan])
        res = ttrain.main(ck + ["--resume"])
        assert res["resilience"]["losses"] == {2: want[2]}
    elif flag in ("ckpt-every", "keep"):
        keep = ["--keep", "2"] if flag == "keep" else []
        ttrain.main(ck + ["--ckpt-every", "1"] + keep)
        assert CheckpointManager(root).steps() == \
            ([2, 3] if keep else [1, 2, 3])
    elif flag == "fault-plan":
        plan = str(tmp_path / "nan.json")
        FaultPlan.make([Fault("nan_grads", 1)]).save(plan)
        res = ttrain.main(args + ["--fault-plan", plan])["resilience"]
        assert res["skipped"] == 1 and sorted(res["losses"]) == [0, 2]
        assert res["fired_faults"] == [{"kind": "nan_grads", "step": 1,
                                        "arg": 0}]
    else:
        from repro_torch import resilience
        seen = []
        real = resilience.MonitorConfig

        def config(**kw):
            seen.append(real(**kw))
            return seen[-1]
        monkeypatch.setattr(resilience, "MonitorConfig", config)
        ttrain.main(args + ["--spike-sigma", "4"])
        assert [c.spike_sigma for c in seen] == [4.0]


def test_lint_gate_refuses_a_corrupted_plan(tmp_path):
    """A plan whose claims contradict themselves is refused before any
    step, with schedlint's findings; --no-lint trains under it."""
    from repro_torch.parallel import MLLMParallelPlan
    args = MLLM_ARGS + ["--device", "cpu", "--steps", "1"]
    good = tmp_path / "good.json"
    ttrain.main(args + ["--plan-out", str(good)])
    plan = MLLMParallelPlan.load(str(good))
    bad = tmp_path / "bad.json"
    json.dump(dict(json.loads(plan.to_json()), schedule=dict(
        json.loads(plan.to_json())["schedule"], bubble_fraction=1.5)),
        bad.open("w"))
    with pytest.raises(SystemExit, match="plan-consistency"):
        ttrain.main(args + ["--plan", str(bad)])
    res = ttrain.main(args + ["--plan", str(bad), "--no-lint"])
    assert np.isfinite(res["losses"]).all()


def test_spmd_refuses_an_indivisible_batch():
    with pytest.raises(SystemExit, match="divisible"):
        ttrain.main(MLLM_ARGS[:8] + ["3"] + MLLM_ARGS[9:]
                    + ["--device", "cpu", "--spmd"])


@pytest.mark.parametrize("argv", [[], MLLM_ARGS[:2] + LM_ARGS[:2]])
def test_exactly_one_mode(argv):
    with pytest.raises(SystemExit, match="exactly one"):
        ttrain.main(argv)


def test_launcher_defaults_to_the_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(LM_ARGS)


@pytest.mark.parametrize("env,cards,want", [
    # one host, a card per rank: NCCL, the card of the local rank
    ({"RANK": "1", "WORLD_SIZE": "4", "LOCAL_RANK": "1",
      "LOCAL_WORLD_SIZE": "4"}, 4, ("nccl", 1, 4, "cuda:1")),
    # two hosts of 4 cards: global rank 6 is host 1's local rank 2
    ({"RANK": "6", "WORLD_SIZE": "8", "LOCAL_RANK": "2",
      "LOCAL_WORLD_SIZE": "4"}, 4, ("nccl", 6, 8, "cuda:2")),
    # two hosts of 1 card, a rank each: NCCL, each on its own cuda:0
    ({"RANK": "1", "WORLD_SIZE": "2", "LOCAL_RANK": "0",
      "LOCAL_WORLD_SIZE": "1"}, 1, ("nccl", 1, 2, "cuda:0")),
    # two ranks sharing one card: gloo through host staging
    ({"RANK": "1", "WORLD_SIZE": "2", "LOCAL_RANK": "1",
      "LOCAL_WORLD_SIZE": "2"}, 1, ("gloo", 1, 2, "cuda:0")),
], ids=["one-host", "two-hosts", "a-card-per-host", "shared-card"])
def test_torchrun_placement(monkeypatch, env, cards, want):
    """Under torchrun the card comes from LOCAL_RANK and NCCL is chosen
    when this host has a card for each of its LOCAL_WORLD_SIZE ranks,
    whatever the world size."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    backend, rank, world, dev = ttrain.torchrun_placement("cuda", env)
    assert (backend, rank, world, str(dev)) == want
    # the same host spawning its own ranks decides the same way
    local = int(env["LOCAL_WORLD_SIZE"])
    sb, sdevs = ttrain.spmd_devices("cuda", local)
    assert sb == backend and sdevs[int(env["LOCAL_RANK"])] == dev
    assert ttrain.torchrun_placement("cpu", env)[0] == "gloo"

"""End-to-end training launcher (the counterpart of
``repro.launch.train``).

    python -m repro_torch.launch.train --arch qwen3-1.7b --reduced \
        --steps 20 --seq 128 --batch 4 [--device cpu] \
        [--ckpt-dir ckpts/run0] [--ckpt-every 50] [--keep 3] [--resume] \
        [--fault-plan faults.json] [--spike-sigma 8]
    python -m repro_torch.launch.train --mllm vlm --reduced --steps 20 \
        [--plan plan.json | --plan-devices 8 --cp-size 1 \
         --microbatches 8] [--plan-out plan.json] [--train-llm] [--spmd] \
        [--no-lint]

Two modes:
  * LM mode (``--arch``): a registered architecture on the synthetic LM
    stream (``data.synthetic.TextLMDataset``).
  * MLLM mode (``--mllm vlm|alm|valm``): the Cornstarch path, frozen
    encoders and LLM with trainable projectors (``--train-llm`` unfreezes
    the LLM, the paper's ft1 fine-tune), on ``MultimodalDataset``
    batches. The parallelisation decision is a typed
    ``MLLMParallelPlan``: loaded with ``--plan`` or searched by
    ``parallelize`` (``--plan-devices``, ``--cp-size``,
    ``--microbatches``), saved with ``--plan-out``, instantiated against
    the model (``plan.apply``) and gated by the schedule lint
    (``analysis.schedlint``: an error finding stops the run before any
    step, ``--no-lint`` skips the gate) before any step runs. Without
    ``--spmd`` each step is ``make_mllm_train_step``'s single-process
    step, as in the JAX launcher's replay mode. With ``--spmd`` the MLLM
    is partitioned into the plan's stages (``models.stages``) and every
    step runs the plan's compiled wave program with one process per
    pipeline rank (``training.steps.make_spmd_train_step``); loss and
    gradients are the per-microbatch sums scaled by 1/M. Under
    ``torchrun`` (``RANK`` and ``WORLD_SIZE`` set) the launcher joins
    that group, each rank on the card of its ``LOCAL_RANK``; otherwise
    it spawns the plan's ranks on this host (a file store in a temporary
    directory, no port) and returns rank 0's result. Ranks with a card
    each talk over NCCL; ranks that share a card, or run on the CPU,
    over gloo.

Both modes run under the fault-tolerant runtime (``resilience``): the
step is health-guarded (NaN/Inf and grad-norm gated, EMA loss-spike
scored), verdicts and faults land in ``<ckpt-dir>/events.jsonl``, and
``--ckpt-dir`` names a ``CheckpointManager`` root of atomic
``step_XXXXXXXX`` checkpoints bundling params, optimizer, health EMA and
data cursor in one manifest, in the JAX launcher's layout (either
launcher resumes the other's checkpoints). ``--resume`` restarts from
``latest()`` bit-exactly: an interrupted and resumed run logs the
losses of an uninterrupted one. ``--resume`` also works across modes: a
replay checkpoint resumes an ``--spmd`` run and the reverse (the
parameters are re-partitioned; optimizer moments and the EMA restart).
``--fault-plan`` replays a deterministic ``FaultPlan`` JSON (NaN grads,
crash, kill-mid-save, device loss) against the run. Under ``--spmd``
the ranks write one checkpoint together, each its own stages' shards,
and each rank restores only its share; ranks on several hosts
(``torchrun``) need ``--ckpt-dir`` on a filesystem they all share.
``--device`` (default ``cuda``) picks where it trains.
"""
from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
import pickle
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Tuple

import torch
import torch.distributed as dist

from repro_torch import bridge
from repro_torch.configs.base import get_config
from repro_torch.data.synthetic import MultimodalDataset, TextLMDataset
from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.optim import optimizer as opt
from repro_torch.training import steps

def _ocfg(args) -> opt.AdamWConfig:
    return opt.AdamWConfig(lr=args.lr, warmup_steps=min(50, args.steps // 10
                                                        or 1),
                           total_steps=args.steps)


def _generator(args, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(args.seed)


def init_lm(cfg, args, device):
    """The LM's initial weights, drawn from ``--seed``."""
    return api.init(cfg, device=device, generator=_generator(args, device))


def init_mllm(mllm, args, device):
    """The MLLM's initial weights (``MLLMParams``), drawn from
    ``--seed``; frozen parts get ``requires_grad=False``."""
    return mllm.init(device=device, generator=_generator(args, device))


def _run_resilient(args, step_fn, params, opt_state, ds_factory,
                   n_params: int, *, frozen_ckpt_paths=None,
                   on_device_loss=None, meta=None, convert_checkpoint=None,
                   group=None, log: bool = True) -> dict:
    """The fault-tolerant loop every mode runs: the guarded ``step_fn``
    (``resilience.make_resilient_train_step``) from ``params`` and
    ``opt_state``, the monitor and its JSONL events, atomic checkpoints,
    rollback and resume.

    ``convert_checkpoint(manager, peek_meta) -> (params, step, cursor)``
    handles a cross-mode resume: when the newest checkpoint's
    ``meta["mode"]`` differs from this run's, it loads the checkpoint's
    parameters under the source layout into this run's (in place), and
    the trainer adopts them with ``opt_state`` (fresh) and a fresh EMA.
    ``group`` makes the ranks of an ``--spmd`` run write one checkpoint
    together; ``log`` is False on every rank but the first."""
    from repro_torch.resilience import (CheckpointManager, CursorStream,
                                        EventLog, FaultInjector, FaultPlan,
                                        HealthMonitor, MonitorConfig,
                                        ResilientTrainer)
    if args.resume and not args.ckpt_dir:
        raise SystemExit("--resume needs --ckpt-dir")
    manager = log_path = None
    if args.ckpt_dir:
        manager = CheckpointManager(args.ckpt_dir, keep=args.keep,
                                    frozen_paths=frozen_ckpt_paths,
                                    group=group)
        if log:
            log_path = os.path.join(args.ckpt_dir, "events.jsonl")
    monitor = HealthMonitor(
        MonitorConfig(spike_sigma=args.spike_sigma), EventLog(log_path))
    injector = None
    if args.fault_plan:
        injector = FaultInjector(FaultPlan.load(args.fault_plan))
        if log:
            print(f"fault plan armed: {len(injector.plan.faults)} fault(s) "
                  f"from {args.fault_plan}")
    resume, adopted, src_mode = args.resume, None, None
    if args.resume and manager is not None \
            and convert_checkpoint is not None:
        peek = manager.peek_meta()
        src_mode = peek.get("mode")
        want = (meta or {}).get("mode")
        if peek and src_mode and want and src_mode != want:
            adopted = convert_checkpoint(manager, peek)
            resume = False  # a like-tree restore cannot span layouts
    trainer = ResilientTrainer(
        step_fn, params, opt_state, CursorStream(ds_factory),
        monitor=monitor, manager=manager, injector=injector,
        ckpt_every=args.ckpt_every, resume=resume,
        meta={"seed": args.seed, **(meta or {})},
        on_device_loss=on_device_loss,
        log_every=args.log_every if log else 0)
    if adopted is not None:
        a_params, a_step, a_cursor = adopted
        trainer.adopt_state(a_params, opt_state, step=a_step,
                            cursor=a_cursor)
        if log:
            print(f"cross-mode resume: converted a {src_mode!r} checkpoint "
                  f"at step {a_step} into this run's layout (optimizer "
                  f"moments and health EMA reset)")
    if args.resume and trainer.step and log:
        print(f"resumed from {manager.latest()} at step {trainer.step}")
    t0 = time.time()
    res = trainer.run(args.steps)
    took = time.time() - t0
    if manager is not None:
        trainer.save_checkpoint()
        if log:
            print(f"saved checkpoint to {manager.latest()}")
    losses = [v for _, v in sorted(res["losses"].items())]
    if log and (res["rollbacks"] or res["skipped"]):
        print(f"resilience: {res['skipped']} skipped step(s), "
              f"{res['rollbacks']} rollback(s), "
              f"{len(res['fired_faults'])} fault(s) fired")
    if log:
        done = max(len(losses), 1)
        print(f"trained {len(losses)} step(s) in {took:.1f}s "
              f"({took / done:.2f}s/step)")
    return {"params": n_params, "first_loss": losses[0],
            "last_loss": losses[-1], "losses": losses, "resilience": res}


def _n_params(model) -> int:
    return sum(p.numel() for p in model.parameters())


def train_lm(args) -> dict:
    dev = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=args.reduced)
    if args.vocab:
        cfg = cfg.replace(vocab_size=args.vocab)
    model = init_lm(cfg, args, dev)
    for p in model.parameters():
        p.requires_grad_(True)
    ocfg = _ocfg(args)
    state = opt.init(ocfg, dict(model.named_parameters()))

    def ds_factory():
        return TextLMDataset(cfg.vocab_size, args.seq, args.batch,
                             seed=args.seed, device=str(dev))

    from repro_torch.resilience import make_resilient_train_step
    return _run_resilient(
        args, make_resilient_train_step(steps.make_loss_fn(cfg), ocfg),
        model, state, ds_factory, _n_params(model),
        meta={"arch": args.arch})


def resolve_plan(mllm, args):
    """The ``MLLMParallelPlan`` this run trains under, loaded from
    ``--plan`` or searched by ``parallelize``, and its executor contract
    (``plan.apply``, which checks it against this MLLM before any step
    runs), gated by the schedule lint unless ``--no-lint``.
    ``--plan-out`` saves it."""
    from repro_torch.parallel import (ClusterSpec, MLLMParallelPlan,
                                      WorkloadShape, parallelize)
    if args.plan:
        plan = MLLMParallelPlan.load(args.plan)
    else:
        # the paper's block size at paper lengths; on short sequences at
        # least ~2 blocks per CP rank, so the balancer has choices
        block = min(128, max(8, mllm.merged_length(args.seq)
                             // (2 * args.cp_size)))
        plan = parallelize(
            mllm, ClusterSpec(num_devices=args.plan_devices,
                              cp_size=args.cp_size),
            WorkloadShape(text_len=args.seq,
                          num_microbatches=args.microbatches,
                          microbatch_size=args.batch,
                          block_size=block))
    mode = "spmd" if args.spmd else "replay"
    executor = plan.apply(mllm, text_len=args.seq, mode=mode)
    if args.lint:
        # a plan whose timeline would race, overflow the activation caps
        # or deadlock must stop here, not N steps into a run; in --spmd
        # mode the compiled wave program itself is linted
        from repro_torch.analysis import (format_findings, gate,
                                          lint_executor_contract, lint_plan)
        found = lint_plan(plan) + lint_executor_contract(executor)
        if gate(found):
            raise SystemExit(format_findings(
                found, header="plan failed the schedule lint "
                              "(--no-lint to bypass):"))
        if found:
            print(format_findings(found, header="plan lint notes:"))
        else:
            print("plan passed the schedule lint")
    if args.plan_out:
        plan.save(args.plan_out)
        print(f"saved plan to {args.plan_out}")
    return plan, executor


def _mllm_ds_factory(args, mllm, device):
    def ds_factory():
        return MultimodalDataset(
            vocab_size=mllm.llm_cfg.vocab_size, text_len=args.seq,
            batch_size=args.batch,
            encoder_dims={n: e.cfg.d_model
                          for n, e in mllm.encoders.items()},
            encoder_tokens={n: e.num_tokens
                            for n, e in mllm.encoders.items()},
            modality_ids={n: e.modality_id
                          for n, e in mllm.encoders.items()},
            seed=args.seed, device=str(device))
    return ds_factory


def _build_mllm(args):
    from repro_torch.models.mllm import build_paper_mllm
    mllm = build_paper_mllm(args.mllm, reduced=args.reduced,
                            text_len=args.seq)
    if args.train_llm:
        # the paper's ft1 fine-tune: frozen encoders, trainable LLM
        mllm.freeze("llm", module=False)
    return mllm


def shrink_plan(mllm, plan, lost: int, args):
    """Graceful degradation on device loss: re-run ``parallelize()``
    over the shrunken ``ClusterSpec`` and return the degraded plan (the
    planner answers the same question for fewer devices). As in the JAX
    launcher, the run itself goes on under the plan it had."""
    from repro_torch.parallel import ClusterSpec, WorkloadShape, parallelize
    # an MLLM plan needs at least one LLM stage plus one stage per
    # encoder; losses below that floor can't be re-planned away
    floor = 1 + len(mllm.encoders)
    devices = max(floor, plan.pp_devices - lost)
    block = min(128, max(8, mllm.merged_length(args.seq)
                         // (2 * max(plan.cp_ranks, 1))))
    degraded = parallelize(
        mllm, ClusterSpec(num_devices=devices, cp_size=plan.cp_ranks),
        WorkloadShape(text_len=args.seq,
                      num_microbatches=args.microbatches,
                      microbatch_size=args.batch, block_size=block))
    print(f"device loss: re-planned {plan.pp_devices} -> "
          f"{degraded.pp_devices} pipeline devices "
          f"(bubble {degraded.schedule.bubble_fraction:.3f})")
    return degraded


def frozen_ckpt_paths(mllm, train_llm: bool) -> set:
    """Checkpoint paths whose shards are written once and hardlinked
    forward (the checkpoint-I/O face of frozen awareness): each
    encoder's module, and the LLM unless it trains."""
    paths = {f"params/encoders/{n}/module" for n in mllm.encoders}
    if not train_llm:
        paths.add("params/llm")
    return paths


def train_mllm(args) -> dict:
    dev = resolve_device(args.device)
    mllm = _build_mllm(args)
    plan, executor = resolve_plan(mllm, args)
    print(plan.describe())
    print(f"executor graph: {len(executor['graph'].stages)} stages, "
          f"simulated bubble "
          f"{executor['schedule']['bubble_fraction']:.3f}")
    if args.spmd:
        return train_mllm_spmd(args, plan, executor)
    from repro_torch.resilience import make_resilient_train_step
    params = init_mllm(mllm, args, dev)
    ocfg = _ocfg(args)
    frozen_mask = mllm.frozen_mask(params)
    _, loss_fn = steps.make_mllm_train_step(mllm, ocfg)
    state = opt.init(ocfg, dict(params.named_parameters()), frozen_mask)

    def convert_checkpoint(manager, peek):
        # an --spmd checkpoint: its stage list, loaded into the stage
        # partition of this run's parameters (which shares them)
        from repro_torch.models.stages import build_mllm_stages
        bundle = build_mllm_stages(mllm, executor, text_len=args.seq)
        want = peek.get("spmd_layout")
        if want and json.loads(want) != bundle.layout_meta:
            raise SystemExit(
                "the newest checkpoint was written under a different "
                "SPMD stage layout than this plan resolves to; resume "
                "with the plan that wrote it (--plan)")
        _, step, src = manager.restore(
            {"params": bridge.params_tree(bundle.partition(params))})
        return (params, int(src.get("step", step)),
                int(src.get("cursor", src.get("step", step))))

    return _run_resilient(
        args, make_resilient_train_step(loss_fn, ocfg, frozen_mask), params,
        state, _mllm_ds_factory(args, mllm, dev), _n_params(params),
        frozen_ckpt_paths=frozen_ckpt_paths(mllm, args.train_llm),
        on_device_loss=lambda lost: shrink_plan(mllm, plan, lost, args),
        meta={"mllm": args.mllm, "plan": plan.to_json(), "mode": "replay"},
        convert_checkpoint=convert_checkpoint)


# ---------------------------------------------------------------------------
# --spmd: one process per pipeline rank
# ---------------------------------------------------------------------------

def spmd_devices(device: str, local_world: int
                 ) -> Tuple[str, List[torch.device]]:
    """(backend, device per local rank) for the ``local_world`` pipeline
    ranks of one host: NCCL with a card per rank where ``device`` is
    ``cuda`` and the host has enough cards; otherwise gloo, the ranks
    sharing the named card (``cuda:N``), the cards round robin, or the
    CPU."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return "gloo", [dev] * local_world
    n = torch.cuda.device_count()
    if dev.index is None and n >= local_world:
        return "nccl", [torch.device("cuda", r) for r in range(local_world)]
    return "gloo", [torch.device("cuda", dev.index if dev.index is not None
                                 else r % n) for r in range(local_world)]


def torchrun_placement(device: str, env=os.environ
                       ) -> Tuple[str, int, int, torch.device]:
    """(backend, rank, world, device) of this process under torchrun:
    ``spmd_devices`` over this host's ``LOCAL_WORLD_SIZE`` ranks, the
    device the ``LOCAL_RANK``-th, so ranks with a card each talk over
    NCCL however many hosts there are. Every host must have the same
    cards, so that all of them pick one backend."""
    rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
    local_rank = int(env.get("LOCAL_RANK", rank))
    local_world = int(env.get("LOCAL_WORLD_SIZE", world))
    backend, devices = spmd_devices(device, local_world)
    return backend, rank, world, devices[local_rank]


def _rank_entry(rank: int, world: int, backend: str, store: str,
                target: Callable, payload: Any, out) -> None:
    try:
        dist.init_process_group(backend, init_method=f"file://{store}",
                                rank=rank, world_size=world)
        try:
            res = target(rank, world, payload)
        finally:
            dist.destroy_process_group()
        # plain pickle: the queue's own would share tensor storage with
        # a process that is about to exit
        out.put((rank, True, pickle.dumps(res)))
    except Exception as e:                   # reported by spawn_ranks
        try:
            exc = pickle.dumps(e)
        except Exception:                    # an unpicklable exception
            exc = None
        out.put((rank, False, (traceback.format_exc(), exc)))


#: seconds spawn_ranks waits for the other ranks' reports after one fails
_REPORT_GRACE = 10.0


def spawn_ranks(world: int, backend: str, target: Callable,
                payload: Any) -> Dict[int, Any]:
    """Run ``target(rank, world, payload)`` in ``world`` spawned
    processes joined in one ``backend`` process group through a file
    store in a temporary directory; returns {rank: result}. If any rank
    fails, the others get a few seconds to report and are then stopped.
    When every rank raised the same exception type (an injected crash,
    an abort), rank 0's exception is raised here, its cause the ranks'
    tracebacks; otherwise ``SystemExit`` carries them (or the exit
    codes)."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    results: Dict[int, Any] = {}
    failed: Dict[int, Tuple[str, Any]] = {}
    with tempfile.TemporaryDirectory(prefix="spmd-") as tmp:
        procs = [ctx.Process(target=_rank_entry,
                             args=(rank, world, backend,
                                   os.path.join(tmp, "store"), target,
                                   payload, out))
                 for rank in range(world)]
        for p in procs:
            p.start()
        deadline = None
        try:
            while len(results) + len(failed) < world:   # drain, then join
                if failed and deadline is None:
                    deadline = time.time() + _REPORT_GRACE
                if deadline is not None and time.time() > deadline:
                    break
                try:
                    rank, ok, res = out.get(timeout=1.0)
                except queue.Empty:
                    for r, p in enumerate(procs):
                        if p.exitcode not in (None, 0) and \
                                r not in failed and r not in results:
                            failed[r] = (f"exited with code {p.exitcode}",
                                         None)
                    continue
                if ok:
                    results[rank] = pickle.loads(res)   # our own ranks
                else:
                    failed[rank] = res
        finally:
            for p in procs:
                p.join(timeout=0 if failed else 60)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
    if failed:
        text = (f"{len(failed)} of {world} rank processes failed (nothing "
                f"falls back to the one-process replay):\n"
                + "\n".join(f"rank {r}:\n{tb}"
                            for r, (tb, _) in sorted(failed.items())))
        excs = {}
        for r, (_, blob) in failed.items():
            try:
                excs[r] = pickle.loads(blob) if blob else None
            except Exception:                # a type that cannot rebuild
                excs[r] = None
        if len(failed) == world and None not in excs.values() and \
                len({type(e) for e in excs.values()}) == 1:
            raise excs[0] from RuntimeError(text)
        raise SystemExit(text)
    return results


def train_mllm_spmd(args, plan, executor) -> dict:
    """Train under the plan's compiled wave program, one process per
    pipeline rank; rank 0's result (this rank's under ``torchrun``)."""
    D = int(executor["schedule"]["num_devices"])
    M = int(plan.schedule.num_microbatches)
    if args.batch % M != 0:
        raise SystemExit(
            f"--spmd needs --batch divisible by the plan's {M} "
            f"microbatches, got --batch {args.batch}")
    payload = {"args": args, "plan": plan.to_json()}
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        backend, rank, world, dev = torchrun_placement(args.device)
        if world != D:
            raise SystemExit(f"--spmd: the plan has {D} pipeline ranks but "
                             f"WORLD_SIZE is {world}")
        payload["devices"] = {rank: dev}
        dist.init_process_group(backend, init_method="env://", rank=rank,
                                world_size=world)
        try:
            return _spmd_rank(rank, world, payload)
        finally:
            dist.destroy_process_group()
    backend, devices = spmd_devices(args.device, D)
    payload["devices"] = devices
    cpus = os.cpu_count() or 1
    if cpus < D:
        raise SystemExit(f"--spmd needs one process per pipeline rank: "
                         f"{D} ranks, but this host has {cpus} CPUs")
    print(f"--spmd: spawning {D} rank processes ({backend}, devices "
          f"{[str(d) for d in devices]})", flush=True)
    return spawn_ranks(D, backend, _spmd_rank, payload)[0]


def _spmd_rank(rank: int, world: int, payload) -> dict:
    """One pipeline rank of ``--spmd``: the whole model drawn from
    ``--seed``, then only the stages this rank hosts kept (the others as
    meta-device skeletons, which give a checkpoint its layout), trained
    under the fault-tolerant loop with the other ranks."""
    from repro_torch.parallel import MLLMParallelPlan
    from repro_torch.resilience import make_resilient_train_step
    args = payload["args"]
    dev = payload["devices"][rank]
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    mllm = _build_mllm(args)
    plan = MLLMParallelPlan.from_json(payload["plan"])
    ex = plan.apply(mllm, text_len=args.seq, mode="spmd")
    bundle = ex["stage_bundle"]
    M = int(plan.schedule.num_microbatches)
    params = init_mllm(mllm, args, dev)
    n_params = _n_params(params)
    stage_params, masks = bundle.hosted_share(
        params, ex["spmd_program"].hosted[rank])
    del params
    skeleton = bundle.partition(mllm.init(device="meta"))
    stages = [sp if sp is not None else skeleton[s]
              for s, sp in enumerate(stage_params)]
    ocfg = _ocfg(args)
    spmd_step = steps.make_spmd_train_step(
        bundle.stage_fns, ex["sim_graph"], ex["schedule"], ocfg,
        microbatch_loss=bundle.microbatch_loss, frozen_mask=masks,
        trainable=list(bundle.trainable), grad_scale=1.0 / M,
        program=ex["spmd_program"])

    def value_and_grad_fn(sp, batch):
        # the schedule's B/W items are the backward pass
        loss, grads = spmd_step.value_and_grad(
            sp, bundle.encode_microbatches(batch, M))
        return (loss, {"ce": loss}), grads

    step_fn = make_resilient_train_step(
        None, ocfg, spmd_step.frozen_mask,
        value_and_grad_fn=value_and_grad_fn,
        global_norm_fn=spmd_step.global_norm,
        named_parameters=spmd_step.named_parameters)
    state = opt.init(ocfg, spmd_step.named_parameters(stages),
                     spmd_step.frozen_mask)

    def convert_checkpoint(manager, peek):
        # a replay checkpoint: the whole-model tree, of which this rank
        # loads the layers of its own stages
        _, step, src = manager.restore(
            {"params": bridge.params_tree(bundle.unpartition(stages))})
        return (stages, int(src.get("step", step)),
                int(src.get("cursor", src.get("step", step))))

    log = rank == 0
    return _run_resilient(
        args, step_fn, stages, state, _mllm_ds_factory(args, mllm, dev),
        n_params,
        on_device_loss=(lambda lost: shrink_plan(mllm, plan, lost, args))
        if log else None,
        meta={"mllm": args.mllm, "plan": plan.to_json(), "mode": "spmd",
              "spmd_layout": json.dumps(bundle.layout_meta)},
        convert_checkpoint=convert_checkpoint, group=dist.group.WORLD,
        log=log)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--mllm", default=None, choices=[None, "vlm", "alm",
                                                     "valm"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--vocab", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="where to train (cuda, cuda:N or cpu)")
    # fault tolerance (resilience)
    ap.add_argument("--ckpt-dir", default=None,
                    help="CheckpointManager root (atomic step_XXXXXXXX "
                    "checkpoints + events.jsonl)")
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="checkpoint cadence in steps (0 = only the "
                    "final checkpoint)")
    ap.add_argument("--keep", type=int, default=3,
                    help="checkpoints retained under --ckpt-dir")
    ap.add_argument("--resume", action="store_true",
                    help="restart from the newest checkpoint under "
                    "--ckpt-dir (bit-exact continuation)")
    ap.add_argument("--fault-plan", default=None,
                    help="FaultPlan JSON to inject deterministically "
                    "(see resilience.faults)")
    ap.add_argument("--spike-sigma", type=float, default=8.0,
                    help="EMA loss-spike z-score that triggers a "
                    "rollback verdict")
    ap.add_argument("--spmd", action="store_true",
                    help="MLLM mode: one process per pipeline rank")
    ap.add_argument("--no-lint", dest="lint", action="store_false",
                    help="skip the schedule lint gate on the plan")
    # MLLM-mode parallelisation plan
    ap.add_argument("--plan", default=None,
                    help="MLLMParallelPlan JSON to train under "
                    "(default: search one via parallelize())")
    ap.add_argument("--plan-out", default=None,
                    help="write the resolved plan JSON here")
    ap.add_argument("--plan-devices", type=int, default=8,
                    help="pipeline device budget for the plan search")
    ap.add_argument("--cp-size", type=int, default=1,
                    help="context-parallel ranks for the plan search")
    ap.add_argument("--microbatches", type=int, default=8)
    ap.add_argument("--train-llm", action="store_true",
                    help="MLLM mode: unfreeze the LLM (ft1 fine-tune)")
    args = ap.parse_args(argv)
    if (args.arch is None) == (args.mllm is None):
        raise SystemExit("pass exactly one of --arch / --mllm")
    res = train_mllm(args) if args.mllm else train_lm(args)
    print(f"done: {res['params']:,} params, "
          f"loss {res['first_loss']:.3f} -> {res['last_loss']:.3f}")
    return res


if __name__ == "__main__":
    main()

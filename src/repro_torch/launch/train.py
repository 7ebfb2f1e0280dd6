"""End-to-end training launcher (the counterpart of
``repro.launch.train``).

    python -m repro_torch.launch.train --arch qwen3-1.7b --reduced \
        --steps 20 --seq 128 --batch 4 [--device cpu]
    python -m repro_torch.launch.train --mllm vlm --reduced --steps 20 \
        [--plan plan.json | --plan-devices 8 --cp-size 1 \
         --microbatches 8] [--plan-out plan.json] [--train-llm] [--spmd] \
        [--no-lint]

Two modes:
  * LM mode (``--arch``): a registered architecture on the synthetic LM
    stream (``data.synthetic.TextLMDataset``), ``make_train_step``.
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

Each step is the plain AdamW step. The JAX launcher runs it under its
fault-tolerant runtime, whose healthy step is this same step (its
``max_grad_norm`` ceiling defaults to infinity). Checkpoints
(``--ckpt-dir``, ``--resume``, ``--ckpt-every``, ``--keep``) and fault
injection (``--fault-plan``, ``--spike-sigma``) are not ported yet and
refuse to run. ``--device`` (default ``cuda``) picks where it trains.
"""
from __future__ import annotations

import argparse
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

from repro_torch.configs.base import get_config
from repro_torch.data.synthetic import MultimodalDataset, TextLMDataset
from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.optim import optimizer as opt
from repro_torch.training import steps

#: flags of the JAX launcher that wait for a module not ported yet
#: (ROADMAP.md queue 1): flag -> the item that brings it
REFUSED_FLAGS = {
    "ckpt_dir": "item 17 (checkpoints)",
    "resume": "item 17 (checkpoints)",
    "ckpt_every": "item 17 (checkpoints)",
    "keep": "item 17 (checkpoints)",
    "fault_plan": "item 18 (the resilience runtime)",
    "spike_sigma": "item 18 (the resilience runtime)",
}


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


def _run(args, step, params, opt_state, ds_factory, n_params: int,
         log: bool = True) -> dict:
    """``args.steps`` steps of ``step`` over the stream; the losses in
    step order."""
    stream = iter(ds_factory())
    losses = []
    t0 = time.time()
    for i in range(args.steps):
        params, opt_state, met = step(params, opt_state, next(stream))
        loss = float(met["loss"])
        losses.append(loss)
        if log and args.log_every and i % args.log_every == 0:
            print(f"step {i:5d} loss {loss:.4f} "
                  f"gnorm {float(met['grad_norm']):.3f}", flush=True)
    took = time.time() - t0
    if log:
        print(f"trained {len(losses)} step(s) in {took:.1f}s "
              f"({took / max(len(losses), 1):.2f}s/step)")
    return {"params": n_params, "first_loss": losses[0],
            "last_loss": losses[-1], "losses": losses}


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

    return _run(args, steps.make_train_step(cfg, ocfg), model, state,
                ds_factory, _n_params(model))


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
    params = init_mllm(mllm, args, dev)
    ocfg = _ocfg(args)
    step, _ = steps.make_mllm_train_step(mllm, ocfg)
    state = opt.init(ocfg, dict(params.named_parameters()),
                     mllm.frozen_mask(params))
    return _run(args, step, params, state, _mllm_ds_factory(args, mllm, dev),
                _n_params(params))


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
    except Exception:                        # reported by spawn_ranks
        out.put((rank, False, traceback.format_exc()))


def spawn_ranks(world: int, backend: str, target: Callable,
                payload: Any) -> Dict[int, Any]:
    """Run ``target(rank, world, payload)`` in ``world`` spawned
    processes joined in one ``backend`` process group through a file
    store in a temporary directory; returns {rank: result}. Raises
    ``SystemExit`` with the failing ranks' tracebacks (or exit codes) if
    any rank fails, after stopping the others."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    results: Dict[int, Any] = {}
    errors: List[str] = []
    with tempfile.TemporaryDirectory(prefix="spmd-") as tmp:
        procs = [ctx.Process(target=_rank_entry,
                             args=(rank, world, backend,
                                   os.path.join(tmp, "store"), target,
                                   payload, out))
                 for rank in range(world)]
        for p in procs:
            p.start()
        try:
            while len(results) < world and not errors:   # drain, then join
                try:
                    rank, ok, res = out.get(timeout=1.0)
                except queue.Empty:
                    errors += [f"rank {r} exited with code {p.exitcode}"
                               for r, p in enumerate(procs)
                               if p.exitcode not in (None, 0)]
                    continue
                if ok:
                    results[rank] = pickle.loads(res)   # our own ranks
                else:
                    errors.append(f"rank {rank}:\n{res}")
        finally:
            for p in procs:
                p.join(timeout=0 if errors else 60)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
    if errors:
        raise SystemExit(f"{len(errors)} of {world} rank processes failed "
                         f"(nothing falls back to the one-process "
                         f"replay):\n" + "\n".join(errors))
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
    ``--seed``, then only the stages this rank hosts kept."""
    from repro_torch.parallel import MLLMParallelPlan
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
    step = steps.make_spmd_train_step(
        bundle.stage_fns, ex["sim_graph"], ex["schedule"], _ocfg(args),
        microbatch_loss=bundle.microbatch_loss, frozen_mask=masks,
        trainable=list(bundle.trainable), grad_scale=1.0 / M,
        program=ex["spmd_program"])

    def batch_step(sp, state, batch):
        return step(sp, state, bundle.encode_microbatches(batch, M))

    return _run(args, batch_step, stage_params, None,
                _mllm_ds_factory(args, mllm, dev), n_params, log=rank == 0)


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
    # the JAX launcher's runtime flags: refused until their modules come
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=None)
    ap.add_argument("--keep", type=int, default=None)
    ap.add_argument("--resume", action="store_true", default=None)
    ap.add_argument("--fault-plan", default=None)
    ap.add_argument("--spike-sigma", type=float, default=None)
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
    for flag, item in REFUSED_FLAGS.items():
        if getattr(args, flag) is not None:
            raise SystemExit(
                f"--{flag.replace('_', '-')} is not ported yet: ROADMAP.md "
                f"queue 1 {item}")
    if (args.arch is None) == (args.mllm is None):
        raise SystemExit("pass exactly one of --arch / --mllm")
    res = train_mllm(args) if args.mllm else train_lm(args)
    print(f"done: {res['params']:,} params, "
          f"loss {res['first_loss']:.3f} -> {res['last_loss']:.3f}")
    return res


if __name__ == "__main__":
    main()

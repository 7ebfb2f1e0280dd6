"""End-to-end training launcher, one process (the counterpart of
``repro.launch.train``).

    python -m repro_torch.launch.train --arch qwen3-1.7b --reduced \
        --steps 20 --seq 128 --batch 4 [--device cpu]
    python -m repro_torch.launch.train --mllm vlm --reduced --steps 20 \
        [--plan plan.json | --plan-devices 8 --cp-size 1 \
         --microbatches 8] [--plan-out plan.json] [--train-llm]

Two modes:
  * LM mode (``--arch``): a registered architecture on the synthetic LM
    stream (``data.synthetic.TextLMDataset``), ``make_train_step``.
  * MLLM mode (``--mllm vlm|alm|valm``): the Cornstarch path, frozen
    encoders and LLM with trainable projectors (``--train-llm`` unfreezes
    the LLM, the paper's ft1 fine-tune), on ``MultimodalDataset``
    batches. The parallelisation decision is a typed
    ``MLLMParallelPlan``: loaded with ``--plan`` or searched by
    ``parallelize`` (``--plan-devices``, ``--cp-size``,
    ``--microbatches``), saved with ``--plan-out``, and instantiated
    against the model (``plan.apply(mode="replay")``) before any step
    runs. As in the JAX launcher's replay mode, each step is
    ``make_mllm_train_step``'s single-process step.

Each step is the plain AdamW step. The JAX launcher runs it under its
fault-tolerant runtime, whose healthy step is this same step (its
``max_grad_norm`` ceiling defaults to infinity). Checkpoints
(``--ckpt-dir``, ``--resume``, ``--ckpt-every``, ``--keep``), fault
injection (``--fault-plan``, ``--spike-sigma``) and the distributed
schedule runner (``--spmd``) are not ported yet and refuse to run; so
does the schedule lint gate, and the launcher says the plan was not
linted. ``--device`` (default ``cuda``) picks where it trains.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.base import get_config
from repro_torch.data.synthetic import MultimodalDataset, TextLMDataset
from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.optim import optimizer as opt
from repro_torch.training import steps

#: flags of the JAX launcher that wait for a module not ported yet
#: (ROADMAP.md queue 1): flag -> the item that brings it
REFUSED_FLAGS = {
    "spmd": "item 16 (the distributed schedule runner)",
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


def _run(args, step, params, opt_state, ds_factory) -> dict:
    """``args.steps`` steps of ``step`` over the stream; the losses in
    step order."""
    stream = iter(ds_factory())
    losses = []
    t0 = time.time()
    for i in range(args.steps):
        params, opt_state, met = step(params, opt_state, next(stream))
        loss = float(met["loss"])
        losses.append(loss)
        if args.log_every and i % args.log_every == 0:
            print(f"step {i:5d} loss {loss:.4f} "
                  f"gnorm {float(met['grad_norm']):.3f}", flush=True)
    took = time.time() - t0
    print(f"trained {len(losses)} step(s) in {took:.1f}s "
          f"({took / max(len(losses), 1):.2f}s/step)")
    n_params = sum(p.numel() for p in params.parameters())
    return {"params": n_params, "first_loss": losses[0],
            "last_loss": losses[-1], "losses": losses}


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
                ds_factory)


def resolve_plan(mllm, args):
    """The ``MLLMParallelPlan`` this run trains under, loaded from
    ``--plan`` or searched by ``parallelize``, and its executor contract
    (``plan.apply``, which checks it against this MLLM before any step
    runs). ``--plan-out`` saves it."""
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
    executor = plan.apply(mllm, text_len=args.seq, mode="replay")
    print("plan not linted: the schedule lint gate is not ported yet "
          "(ROADMAP.md queue 1 item 21)")
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


def train_mllm(args) -> dict:
    from repro_torch.models.mllm import build_paper_mllm
    dev = resolve_device(args.device)
    mllm = build_paper_mllm(args.mllm, reduced=args.reduced,
                            text_len=args.seq)
    if args.train_llm:
        # the paper's ft1 fine-tune: frozen encoders, trainable LLM
        mllm.freeze("llm", module=False)
    plan, executor = resolve_plan(mllm, args)
    print(plan.describe())
    print(f"executor graph: {len(executor['graph'].stages)} stages, "
          f"simulated bubble "
          f"{executor['schedule']['bubble_fraction']:.3f}")
    params = init_mllm(mllm, args, dev)
    ocfg = _ocfg(args)
    step, _ = steps.make_mllm_train_step(mllm, ocfg)
    state = opt.init(ocfg, dict(params.named_parameters()),
                     mllm.frozen_mask(params))
    return _run(args, step, params, state, _mllm_ds_factory(args, mllm, dev))


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
    ap.add_argument("--spmd", action="store_true", default=None)
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

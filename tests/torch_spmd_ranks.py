"""Rank functions of the port's SPMD tests, run by
``torch_cp_ranks.run_ranks`` in spawned gloo processes. They import
torch and the port only; each takes its cases from the payload (numpy
weights and microbatches, graph specs, plan JSON), runs them on this
rank, and returns numpy results (rank 0's hold the gathered outputs and
gradients), which the tests compare with the JAX package in the test
process."""


def _np(tree):
    import torch
    if isinstance(tree, torch.Tensor):
        return tree.detach().numpy()
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_np(v) for v in tree]
    return tree


def graph_of(spec):
    """(graph, sim) of the port for a case's {"stages", "edges",
    "schedule", "microbatches"}."""
    from repro_torch.core import schedule as sch
    stages = [sch.Stage(n, f, b, bwd_w=w) for n, f, b, w in spec["stages"]]
    g = sch.PipelineGraph(stages, spec["edges"]) if spec["edges"] \
        else sch.chain_graph(stages)
    if spec.get("refine"):
        g = sch.refine_chain(g, 2)
    kw = {"virtual_chunks": 2} if spec["schedule"] in ("interleaved",
                                                        "zb-v") else {}
    return g, sch.get_scheduler(spec["schedule"], **kw).simulate(
        g, spec["microbatches"])


def _toy(rank, case):
    import torch
    from repro_torch.core.schedule.memory import validate_schedule_memory
    from repro_torch.parallel import spmd
    g, sim = graph_of(case)
    w = torch.from_numpy(case["w"]).requires_grad_(True)
    mbs = torch.from_numpy(case["mbs"])

    def fn(lp, x):
        return x + torch.tanh(x @ lp["w"])

    res = spmd.run_schedule_spmd(fn, {"w": w}, mbs, g, sim)
    full = spmd.gather_result(res)
    out = {"loss": float(res["loss"]),
           "trace": res["activation_trace"],
           "peaks": res["peak_activations_per_device"],
           "w_peaks": res["peak_w_residuals_per_device"],
           "counts": res["program"].counts()}
    if rank == 0:
        out.update(outputs=_np(full["outputs"]),
                   grads=_np(full["param_grads"]["w"]))
    if case.get("validate"):
        rep = validate_schedule_memory(
            g, case["microbatches"], sim=sim, stage_fn=fn,
            stage_params={"w": w}, microbatches=mbs, executor="spmd")
        out["memory"] = (rep["executor"], rep["simulated_peaks"],
                         rep["executor_peaks"])
    return out


def _stage_bundle(rank, case):
    """The reduced MLLM's stage bundle under a plan: run once by the
    runner, then ``steps`` steps of make_spmd_train_step."""
    import torch
    from repro_torch import bridge
    from repro_torch.models.mllm import build_paper_mllm
    from repro_torch.optim import optimizer as opt
    from repro_torch.parallel import MLLMParallelPlan, spmd
    from repro_torch.training.steps import make_spmd_train_step
    mllm = build_paper_mllm("vlm", reduced=True)
    if case["train_llm"]:
        mllm.freeze("llm", module=False)
    mllm.llm_cfg = mllm.llm_cfg.replace(attn_impl="bam_kernel")
    plan = MLLMParallelPlan.from_json(case["plan"])
    ex = plan.apply(mllm, text_len=case["text_len"], mode="spmd")
    bundle, prog = ex["stage_bundle"], ex["spmd_program"]
    hosted = set(prog.hosted[rank])
    params = bridge.mllm_from_jax_params(case["params"], mllm, device="cpu")
    stages = bundle.partition(params)
    masks = bundle.frozen_masks(stages)
    sp = [st if s in hosted else None for s, st in enumerate(stages)]
    del params, stages
    mbs = torch.from_numpy(case["mbs"])
    res = spmd.run_schedule_spmd(
        bundle.stage_fns, sp, mbs, ex["sim_graph"], ex["schedule"],
        microbatch_loss=bundle.microbatch_loss, program=prog,
        trainable=list(bundle.trainable))
    full = spmd.gather_result(res)
    out = {"loss": float(res["loss"]), "trace": res["activation_trace"],
           "peaks": res["peak_activations_per_device"],
           "frozen_grads": [p.grad is not None for s in hosted
                            for p in sp[s].parameters()]}
    if rank == 0:
        out["outputs"] = _np(full["outputs"])
        out["grads"] = {n: _np(g) for per in full["param_grads"]
                        for n, g in per.items()}
    M = plan.schedule.num_microbatches
    step = make_spmd_train_step(
        bundle.stage_fns, ex["sim_graph"], ex["schedule"],
        opt.AdamWConfig(**case["ocfg"]),
        microbatch_loss=bundle.microbatch_loss, frozen_mask=masks,
        trainable=list(bundle.trainable), grad_scale=1.0 / M,
        program=prog)
    state, losses = None, []
    for mb in case["steps"]:
        sp, state, met = step(sp, state, torch.from_numpy(mb))
        losses.append((float(met["loss"]), float(met["grad_norm"])))
    out["losses"] = losses
    out["after"] = {n: _np(p) for s in hosted
                    for n, p in sp[s].named_parameters()}
    return out


def _wrong_size(rank, case):
    from repro_torch.parallel import spmd
    g, sim = graph_of(case)
    try:
        spmd.build_spmd_runner(lambda lp, x: x, g, sim)
    except ValueError as e:
        return str(e)
    return None


def _pipeline(rank, case):
    """pipeline_forward of the stacked toy stage, and the gradient of
    mean(out**2) in this rank's stage."""
    import torch
    import torch.distributed as dist
    from repro_torch.core.modality_parallel import pipeline_forward
    w = torch.from_numpy(case["w"]).requires_grad_(True)
    mbs = torch.from_numpy(case["mbs"])

    def fn(lp, x):
        return x + torch.tanh(x @ lp["w"])

    out = pipeline_forward(dist.group.WORLD, fn, {"w": w}, mbs,
                           num_stages=case["stages"])
    (g,) = torch.autograd.grad(torch.mean(out ** 2), w)
    return {"out": _np(out), "grad": _np(g[rank]),
            "others_zero": not g[[s for s in range(len(g))
                                  if s != rank]].any().item()}


def _plan_toy(rank, case):
    """The plan form with the toy stage: stage_fn="toy" and None (which
    warns) run the same model; spmd_parity_report on the contract."""
    import warnings
    import torch
    from repro_torch.models.mllm import build_paper_mllm
    from repro_torch.parallel import MLLMParallelPlan, spmd
    mllm = build_paper_mllm("vlm", reduced=True)
    plan = MLLMParallelPlan.from_json(case["plan"])
    mbs = torch.from_numpy(case["mbs"])
    toy = spmd.run_schedule_spmd(plan, mllm, mbs, stage_fn="toy")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        default = spmd.run_schedule_spmd(plan, mllm, mbs)
    report = spmd.spmd_parity_report(plan.apply(mllm, mode="spmd"),
                                    device="cpu")
    return {"toy": float(toy["loss"]), "default": float(default["loss"]),
            "warned": any("TOY" in str(w.message) for w in caught),
            "report": report}


RUNNERS = {"toy": _toy, "bundle": _stage_bundle, "wrong_size": _wrong_size,
           "pipeline": _pipeline, "plan_toy": _plan_toy}


def cases(rank, world, payload):
    """Every case of one spawn, in order: {name: result}."""
    import torch
    torch.manual_seed(0)
    return {name: RUNNERS[case["kind"]](rank, case)
            for name, case in payload.items()}



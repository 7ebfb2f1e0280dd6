"""CPU ranks for the port's context-parallel tests: ``run_ranks`` starts
``world`` processes (spawned, each with one torch thread), joins them in
one gloo process group through a file store under a test's tmp_path
(no port to pick), runs one of this module's rank functions in each, and
returns their results by rank. Ranks import torch and the port only, so
they start without JAX; the tests compare what they return with the JAX
package in the test process."""
import contextlib
import importlib
import multiprocessing as mp
import queue
import traceback
import warnings

import numpy as np

JOIN_TIMEOUT = 120


def run_ranks(world: int, fn: str, payload, store_dir, timeout=JOIN_TIMEOUT):
    """{rank: fn(rank, world, payload)}; raises with the rank's traceback
    if one fails, and if any rank has not finished within ``timeout``.
    ``fn`` names a function of this module, or ``"module:function"``."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    store = f"{store_dir}/gloo_store_{fn.replace(':', '_')}_{world}"
    procs = [ctx.Process(target=_rank_main,
                         args=(rank, world, store, fn, payload, out))
             for rank in range(world)]
    for p in procs:
        p.start()
    results, errors = {}, []
    try:
        while len(results) < world and not errors:   # drain, then join
            try:
                rank, ok, res = out.get(timeout=timeout)
            except queue.Empty:
                raise RuntimeError(f"{fn}: a rank of {world} did not finish "
                                   f"within {timeout} s") from None
            if ok:
                results[rank] = res
            else:                  # the others may wait on it: stop all
                errors.append(f"rank {rank}:\n{res}")
    finally:
        for p in procs:
            p.join(timeout=0 if errors else 30)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    if errors:
        raise RuntimeError("\n".join(errors))
    assert not any(p.is_alive() for p in procs)
    return results


@contextlib.contextmanager
def kept_pairs(model):
    """Forward hooks on every MoE layer's ``mlp`` of ``model``: the
    yielded list gets each call's (kept, routed) counts of (token, k)
    pairs under the capacity rule, from ``moe.router_probs`` and
    ``moe.capacity_slots`` on the layer's input."""
    import torch
    from repro_torch.models import moe
    log = []

    def hook(mlp, args, out):
        h, cfg = args
        with torch.no_grad():
            slot, cap = moe.capacity_slots(moe.router_probs(mlp, h, cfg)[2],
                                           cfg)
        log.append((int((slot < cap).sum()), slot.numel()))
    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, moe.MoEFFN)]
    try:
        yield log
    finally:
        for handle in handles:
            handle.remove()


def _rank_main(rank, world, store, fn, payload, out):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    warnings.simplefilter("ignore", FutureWarning)
    try:
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=world)
        try:
            if ":" in fn:
                module, name = fn.split(":")
                res = getattr(importlib.import_module(module), name)(
                    rank, world, payload)
            else:
                res = globals()[fn](rank, world, payload)
        finally:
            dist.destroy_process_group()
        out.put((rank, True, res))
    except Exception:                        # reported to the test
        out.put((rank, False, traceback.format_exc()))


def _local(x, rank, world, axis=1):
    n = x.shape[axis] // world
    return np.take(x, np.arange(rank * n, (rank + 1) * n), axis=axis)


def attention(rank, world, payload):
    """cp_attention on this rank's slice of global inputs already in plan
    layout, for each (method, impl): the local output and the gradients
    of Σ out·w in the local q, k, v."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import context_parallel as cp
    group = dist.group.WORLD
    arr = {k: torch.from_numpy(_local(payload[k], rank, world))
           for k in ("q", "k", "v", "bits", "pos", "w")}
    res = {}
    for method, impl in payload["cases"]:
        q, k, v = (arr[n].clone().requires_grad_() for n in ("q", "k", "v"))
        out = cp.cp_attention(group, q, k, v, arr["bits"], arr["bits"],
                              arr["pos"], arr["pos"], method=method,
                              impl=impl, softcap=payload["softcap"],
                              window=payload["window"])
        grads = torch.autograd.grad((out * arr["w"]).sum(), (q, k, v))
        res[(method, impl)] = [out.detach().numpy()] + \
            [g.numpy() for g in grads]
    return res


def train(rank, world, payload):
    """3 steps of make_cp_train_step from the same weights per (method,
    impl): [(loss, grad_norm)] per step; plus the message of the
    indivisible-length refusal."""
    import torch
    import torch.distributed as dist
    from repro_torch import bridge
    from repro_torch.configs.base import get_config
    from repro_torch.optim import optimizer as opt
    from repro_torch.training import steps
    group = dist.group.WORLD
    cfg = get_config("qwen3-1.7b", reduced=True)
    ocfg = opt.AdamWConfig(**payload["ocfg"])
    res = {}
    for method, impl in payload["cases"]:
        model = bridge.from_jax_params(payload["params"], cfg, device="cpu")
        model.requires_grad_(True)
        state = opt.init(ocfg, dict(model.named_parameters()))
        step = steps.make_cp_train_step(cfg.replace(attn_impl=impl),
                                        payload["layout"], group, ocfg,
                                        method=method)
        hist = []
        for batch in payload["batches"]:
            tb = {k: torch.from_numpy(x) for k, x in batch.items()}
            model, state, met = step(model, state, tb)
            hist.append((float(met["loss"]), float(met["grad_norm"])))
        res[(method, impl)] = hist
    odd = dict(payload["layout"], perm=np.arange(world * 8 + 1))
    try:
        steps.make_cp_train_step(cfg, odd, group, ocfg)
        res["indivisible"] = None
    except ValueError as e:
        res["indivisible"] = str(e)
    return res


def families(rank, world, payload):
    """One ``make_cp_train_step`` step from the same weights for each
    case of ``test_torch_cp_families`` (a port config, numpy weights, a
    batch, a plan layout and the (method, impl) pairs to run): loss, ce,
    aux_loss, grad_norm, the capacity dispatches' (kept, routed) pair
    counts on this rank, and on rank 0 the parameters after the step as
    the JAX tree; on rank 0 also the port's plain ``make_train_step`` on
    the unpermuted batch. A case marked ``refuse`` returns the
    ``ValueError``'s message."""
    import torch
    import torch.distributed as dist
    from repro_torch import bridge
    from repro_torch.optim import optimizer as opt
    from repro_torch.training import steps
    group = dist.group.WORLD
    ocfg = opt.AdamWConfig(**payload["ocfg"])
    res = {}
    for name, case in payload["cases"].items():
        cfg = case["cfg"]
        tb = {k: torch.from_numpy(x) for k, x in case["batch"].items()}
        if case.get("refuse"):
            try:
                steps.make_cp_train_step(cfg, case["layout"], group, ocfg)
                res[name] = None
            except ValueError as e:
                res[name] = str(e)
            continue

        def fresh():
            model = bridge.from_jax_params(case["params"], cfg, device="cpu")
            model.requires_grad_(True)
            return model, opt.init(ocfg, dict(model.named_parameters()))

        for method, impl in case["runs"]:
            model, state = fresh()
            step = steps.make_cp_train_step(cfg.replace(attn_impl=impl),
                                            case["layout"], group, ocfg,
                                            method=method)
            with kept_pairs(model) as log:
                model, state, met = step(model, state, tb)
            out = {k: float(met[k]) for k in ("loss", "ce", "aux_loss",
                                              "grad_norm")}
            out["drops"] = (sum(k for k, _ in log), sum(n for _, n in log))
            if rank == 0:
                out["params"] = bridge.to_jax_params(model, cfg)
            res[(name, method, impl)] = out
        if rank == 0:
            model, state = fresh()
            _, _, met = steps.make_train_step(cfg, ocfg)(model, state, tb)
            res[(name, "plain")] = (float(met["loss"]),
                                    float(met["grad_norm"]))
    return res

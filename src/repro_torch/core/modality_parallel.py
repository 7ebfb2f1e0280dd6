"""Schedule-driven pipeline execution on one device (the counterpart of
``repro.core.modality_parallel``).

``execute_schedule`` replays a simulated F/B/W item timeline
(``core.schedule``) with real stage computations: F runs the stage's
forward and keeps its autograd graph, B takes the input gradient with
``torch.autograd.grad``, W the weight gradients, in the exact order the
simulator emitted. Every inter-stage activation sits in an instrumented
store filled at F and drained at B, so the store's peak per simulated
device is a measurement that ``core.schedule.memory`` holds against the
simulator's claim. All simulated devices share the one card: their
in-flight activations are all held there at once.

``pipeline_reference`` is the unpipelined oracle; ``stack_stage_params``
and ``normalize_stage_fns`` adapt stage arguments. The distributed
executors of the JAX package (``pipeline_forward`` over a stage mesh
axis, ``ModalityIslands``, ``split_devices``) need several ranks and are
not ported yet (ROADMAP.md queue 1 item 16).
"""
from __future__ import annotations

import inspect
import warnings
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

import torch
from torch import nn

from repro_torch.core.schedule import SCHEDULES
from repro_torch.core.schedule.simulator import item_id


# ---------------------------------------------------------------------------
# Stage arguments
# ---------------------------------------------------------------------------

def stack_stage_params(per_stage_params: Sequence[Mapping[str, Any]]
                       ) -> Dict[str, torch.Tensor]:
    """List of per-stage {name: tensor} dicts of one structure ->
    {name: tensor stacked on a leading stage axis}."""
    keys = list(per_stage_params[0])
    for p in per_stage_params:
        if list(p) != keys:
            raise ValueError(f"stage params differ in structure: "
                             f"{list(p)} vs {keys}")
    return {k: torch.stack([p[k] for p in per_stage_params]) for k in keys}


def _stage_slice(stage_params: Mapping[str, torch.Tensor], s: int):
    return {k: v[s] for k, v in stage_params.items()}


def pipeline_reference(stage_fn: Callable, stage_params, microbatches, *,
                       num_stages: int):
    """Oracle: every microbatch through stages 0..S-1 in turn, no
    pipeline. ``stage_params`` stage-stacked; returns [M, ...]."""
    outs = []
    for x in microbatches:
        for s in range(num_stages):
            x = stage_fn(_stage_slice(stage_params, s), x)
        outs.append(x)
    return torch.stack(outs)


def _accepts_microbatch(fn: Callable) -> bool:
    """Does ``fn`` take ``(stage_params, x, microbatch)``? Two-argument
    stage fns ``fn(stage_params, x)`` are accepted everywhere too."""
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return False
    params = list(sig.parameters.values())
    if any(p.kind == p.VAR_POSITIONAL for p in params):
        return True
    pos = [p for p in params if p.kind in
           (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
    return len(pos) >= 3


def normalize_stage_fns(stage_fn, num_stages: int) -> List[Callable]:
    """A stage-fn argument -> a list of per-stage 3-argument callables
    (``models.stages.StageBundle.stage_fns`` is a list; one callable is
    replicated; 2-argument fns get the microbatch dropped)."""
    if isinstance(stage_fn, (list, tuple)):
        fns = list(stage_fn)
        if len(fns) != num_stages:
            raise ValueError(
                f"got {len(fns)} stage fns for {num_stages} stages")
    else:
        fns = [stage_fn] * num_stages
    return [f if _accepts_microbatch(f)
            else (lambda lp, x, mb, _f=f: _f(lp, x)) for f in fns]


def _named_tensors(lp) -> List[tuple]:
    """(name, tensor) of a stage's parameters that require grad: an
    ``nn.Module``'s named parameters, or a (nested) dict's leaves."""
    if isinstance(lp, nn.Module):
        return [(n, p) for n, p in lp.named_parameters() if p.requires_grad]
    out = []

    def walk(tree, prefix):
        for key, val in tree.items():
            if isinstance(val, Mapping):
                walk(val, f"{prefix}{key}.")
            elif isinstance(val, torch.Tensor) and val.requires_grad:
                out.append((f"{prefix}{key}", val))
    walk(lp, "")
    return out


# ---------------------------------------------------------------------------
# Schedule replay
# ---------------------------------------------------------------------------

def execute_schedule(stage_fn, stage_params, microbatches,
                     graph, sim: Dict[str, Any], *,
                     microbatch_loss: Optional[Callable] = None,
                     trainable: Optional[Sequence[bool]] = None
                     ) -> Dict[str, Any]:
    """Replay a simulated schedule's item timeline with real stage
    computations, instrumenting live activations per simulated device.

    ``stage_fn`` is one callable or a per-stage list, each
    ``fn(lp, x, microbatch) -> y`` (or ``fn(lp, x)``) with x and y of
    one shape (the carrier contract; real MLLM stages come from
    ``models.stages``). ``stage_params`` is a dict of tensors stacked on
    a leading stage axis, or a list of per-stage parameters (each an
    ``nn.Module`` or a dict of tensors); only tensors that require grad
    are differentiated. ``microbatches`` is [M, ...]. ``graph`` is any
    stage DAG in topological order: sources read the microbatch, a
    fan-in stage consumes the sum of its predecessors' outputs, a
    fan-out stage sums the cotangents its successors send back, and the
    loss sums ``microbatch_loss(y)`` (default ``mean(y**2)``) over sink
    outputs. ``sim`` is any ``core.schedule`` simulation (``items`` +
    ``device_of`` + ``num_devices``). ``trainable`` says which stages
    must produce weight gradients (default ``bwd_w > 0``): a frozen
    stage holding a trainable projector has no W cost in the model yet
    gets its gradients glued at B.

    Per item: F detaches its input from the upstream graph (requiring
    grad only when B must return an input gradient, ``bwd_b > 0`` and a
    predecessor exists) and runs the forward with autograd on only when
    B or W will differentiate it. B calls ``torch.autograd.grad`` once
    over the input and, when the stage's W is not a separate item, its
    trainable parameters; a stage whose W item comes later keeps its
    graph (``retain_graph``) in the W-residual store, and W takes the
    weight gradients and so frees the graph. Under non-reentrant
    ``torch.utils.checkpoint`` each of those backward calls recomputes
    the checkpointed forward once. A stage with nothing trainable at or
    above it gets no cotangent: its B only frees memory. Parameters that
    do not require grad never get a gradient, and ``.grad`` is never
    written.

    Returns: outputs [M, ...] (the sinks' y), loss (0-dim tensor),
    param_grads (stacked {name: [S, ...]} with zeros for stages without
    weight work when ``stage_params`` is stacked; else a list of per
    stage {name: grad} over the tensors that require grad, empty for
    stages that are not trainable), peak_activations_per_device,
    peak_w_residuals_per_device, activation_trace (``(item_id, device,
    live after)`` per item) and activation_nbytes.
    """
    S = len(graph.stages)
    preds, succs = graph.preds, graph.succs
    M = int(microbatches.shape[0])
    items = sim["items"]
    device_of = sim["device_of"]
    D = int(sim["num_devices"])
    loss_fn = microbatch_loss or (lambda y: torch.mean(y ** 2))
    has_w_items = any(kind == "W" for _, _, _, kind, _, _ in items)
    fns = normalize_stage_fns(stage_fn, S)
    hetero = isinstance(stage_params, (list, tuple))
    if trainable is None:
        trainable = [graph.stages[s].bwd_w > 0 for s in range(S)]
    trainable = [bool(t) for t in trainable]
    if len(trainable) != S:
        raise ValueError(f"{len(trainable)} trainable flags for {S} stages")

    if hetero:
        if len(stage_params) != S:
            raise ValueError(f"{len(stage_params)} stage params for "
                             f"{S} stages")
        params = list(stage_params)
    else:
        # per-stage leaves sharing the stacked storage
        params = [{k: v[s].detach().requires_grad_(v.requires_grad)
                   for k, v in stage_params.items()} for s in range(S)]
    named = [_named_tensors(p) for p in params]
    grads: List[Dict[str, torch.Tensor]] = [{} for _ in range(S)]
    store: Dict[tuple, tuple] = {}      # (s, m) -> (input, output)
    w_store: Dict[tuple, tuple] = {}    # (s, m) -> (output, cotangent)
    transit: Dict[tuple, Any] = {}      # produced, not yet admitted
    cot: Dict[tuple, Any] = {}          # (s, m) -> output cotangent
    outputs: List[Any] = [None] * M

    def accumulate(d: Dict[tuple, Any], key: tuple, val) -> None:
        # fan-in (or fan-out cotangent) merge, in timeline order
        d[key] = val if key not in d else d[key] + val

    def add_grads(s: int, got) -> None:
        for (name, p), g in zip(named[s], got):
            if g is None:
                g = torch.zeros_like(p)
            grads[s][name] = g if name not in grads[s] \
                else grads[s][name] + g

    def store_count(d: int) -> int:
        # the container's entries, not a parallel counter
        return sum(1 for (s_, _m) in store if device_of[s_] == d)

    peak = [0] * D
    w_peak = [0] * D
    loss = None
    trace: List[tuple] = []
    act_nbytes = 0

    for item in items:
        _start, _end, dev, kind, s, m = item
        st = graph.stages[s]
        need_dx = st.bwd_b > 0 and bool(preds[s])
        defer = trainable[s] and has_w_items and st.bwd_w > 0
        if kind == "F":
            x = transit.pop((s, m)) if preds[s] else microbatches[m]
            x = x.detach().requires_grad_(need_dx)
            with torch.set_grad_enabled(need_dx or trainable[s]):
                y = fns[s](params[s], x, microbatches[m])
            store[(s, m)] = (x, y)
            act_nbytes = max(act_nbytes, x.numel() * x.element_size())
            peak[dev] = max(peak[dev], store_count(dev))
            if not succs[s]:                     # sink: loss + cotangent
                yd = y.detach()
                outputs[m] = yd if outputs[m] is None else outputs[m] + yd
                yg = y.detach().requires_grad_(True)
                with torch.enable_grad():
                    ly = loss_fn(yg)
                    (gy,) = torch.autograd.grad(ly, yg)
                ly = ly.detach()
                loss = ly if loss is None else loss + ly
                accumulate(cot, (s, m), gy)
            else:
                for q in succs[s]:
                    accumulate(transit, (q, m), y.detach())
        elif kind == "B":
            x, y = store.pop((s, m))
            g = cot.pop((s, m), None)
            if g is None and not (st.bwd_b == 0 and st.bwd_w == 0
                                  and not trainable[s]):
                raise KeyError(f"missing cotangent for B({s}, {m})")
            glue = trainable[s] and not defer
            inputs = ([x] if need_dx else []) + \
                ([p for _, p in named[s]] if glue else [])
            if inputs:
                got = torch.autograd.grad(
                    y, inputs, g, retain_graph=defer, allow_unused=True) \
                    if y.requires_grad else [None] * len(inputs)
                if need_dx:
                    dx = got[0] if got[0] is not None \
                        else torch.zeros_like(x)
                    for p in preds[s]:
                        accumulate(cot, (p, m), dx)
                    got = got[1:]
                if glue:
                    add_grads(s, got)
            if defer:
                # W comes later: keep the graph, park the cotangent
                w_store[(s, m)] = (y, g)
                w_peak[dev] = max(w_peak[dev], sum(
                    1 for (s_, _m) in w_store if device_of[s_] == dev))
            del x, y
        else:                                # W
            parked = w_store.pop((s, m), None)
            if parked is not None:           # else: trainable=False
                y, g = parked                # override, W is a no-op
                ps = [p for _, p in named[s]]
                got = torch.autograd.grad(y, ps, g, allow_unused=True) \
                    if ps and y.requires_grad else [None] * len(ps)
                add_grads(s, got)
                del y, g
        trace.append((item_id(item), dev, store_count(dev)))

    if store or w_store or transit:
        raise RuntimeError("schedule left live activations behind "
                           "(incomplete timeline)")
    if any(y is None for y in outputs):
        raise RuntimeError("a microbatch never reached a sink stage")
    for s in range(S):
        if trainable[s]:                     # trained, never reached: 0
            for name, p in named[s]:
                grads[s].setdefault(name, torch.zeros_like(p))
    if hetero:
        param_grads: Any = grads
    else:
        param_grads = {
            k: torch.stack([grads[s].get(k, torch.zeros_like(v[s]))
                            for s in range(S)])
            for k, v in stage_params.items()}
    return {
        "outputs": torch.stack(outputs),
        "loss": loss,
        "param_grads": param_grads,
        "peak_activations_per_device": peak,
        "peak_w_residuals_per_device": w_peak,
        "activation_trace": trace,
        "activation_nbytes": act_nbytes,
    }


# ---------------------------------------------------------------------------
# Deprecated plan readers
# ---------------------------------------------------------------------------

def _is_typed_plan(plan: Any) -> bool:
    from repro_torch.parallel.plan import MLLMParallelPlan
    return isinstance(plan, MLLMParallelPlan)


def _dict_schedule_name(plan: Dict[str, Any]) -> Optional[str]:
    """The schedule name a plan dict carries, if any: an
    ``auto_parallelize`` result keeps it under "schedule", an executor
    contract keeps the sim dict there and the name under
    "schedule_name"."""
    name = plan.get("schedule")
    if not isinstance(name, str):
        name = plan.get("schedule_name")
    return name if isinstance(name, str) else None


def schedule_from_plan(plan: Any) -> str:
    """Deprecated: read ``plan.schedule.name`` off an
    ``MLLMParallelPlan``. Accepts the typed plan, an
    ``auto_parallelize`` result or an executor contract dict, or None
    (classic 1F1B). A dict without a known schedule raises
    ``ValueError``."""
    warnings.warn(
        "schedule_from_plan is deprecated; use "
        "parallel.MLLMParallelPlan and plan.schedule.name",
        DeprecationWarning, stacklevel=2)
    if plan is None:
        return "1f1b"
    if _is_typed_plan(plan):
        return plan.schedule.name
    if isinstance(plan, dict):
        name = _dict_schedule_name(plan)
        if name in SCHEDULES:
            return name
        raise ValueError(
            f"plan carries no recognizable schedule (got {name!r}, "
            f"valid: {SCHEDULES}); pass an MLLMParallelPlan, an "
            "auto_parallelize result, or an executor contract")
    raise ValueError(f"not a plan: {type(plan).__name__!r}")


def virtual_chunks_from_plan(plan: Any) -> int:
    """Deprecated: read ``plan.schedule.virtual_chunks`` off an
    ``MLLMParallelPlan``. Same accepted kinds as ``schedule_from_plan``;
    a known plan dict without the tag gives 1, anything malformed
    raises ``ValueError``."""
    warnings.warn(
        "virtual_chunks_from_plan is deprecated; use "
        "parallel.MLLMParallelPlan and plan.schedule.virtual_chunks",
        DeprecationWarning, stacklevel=2)
    if plan is None:
        return 1
    if _is_typed_plan(plan):
        return plan.schedule.virtual_chunks
    if isinstance(plan, dict):
        v = plan.get("virtual_chunks")
        if isinstance(v, int) and v >= 1:
            return v
        if v is None and _dict_schedule_name(plan) in SCHEDULES:
            return 1
        raise ValueError(f"plan carries no usable virtual_chunks "
                         f"(got {v!r})")
    raise ValueError(f"not a plan: {type(plan).__name__!r}")

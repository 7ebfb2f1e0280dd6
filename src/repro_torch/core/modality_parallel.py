"""Schedule-driven pipeline execution and modality parallelism (the
counterpart of ``repro.core.modality_parallel``).

``execute_schedule`` replays a simulated F/B/W item timeline
(``core.schedule``) with real stage computations in one process: F runs
the stage's forward and keeps its autograd graph, B takes the input
gradient with ``torch.autograd.grad``, W the weight gradients, in the
exact order the simulator emitted. Every inter-stage activation sits in
an instrumented store filled at F and drained at B, so the store's peak
per simulated device is a measurement that ``core.schedule.memory``
holds against the simulator's claim. All simulated devices share one
card. ``parallel.spmd`` runs the same timeline with one process per
pipeline rank.

``pipeline_forward`` is the circular pipeline over the ranks of a
process group, one stage per rank; ``pipeline_reference`` its
unpipelined oracle. ``ModalityIslands`` runs each encoder on its own
device (on one card, its own CUDA stream) and the LLM on the rest, and
``split_devices`` hands out the device lists. ``stack_stage_params`` and
``normalize_stage_fns`` adapt stage arguments.
"""
from __future__ import annotations

import contextlib
import dataclasses
import inspect
import warnings
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

import torch
import torch.distributed as dist
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


# ---------------------------------------------------------------------------
# Circular pipeline over a process group (one stage per rank)
# ---------------------------------------------------------------------------

class _Shift(torch.autograd.Function):
    """One tick's handoff: send ``y`` to the next rank and receive the
    previous rank's output (one ``batch_isend_irecv``). The backward
    sends the received tensor's cotangent back and receives ``y``'s from
    the next rank. ``token``, the previous tick's received tensor, chains
    the ticks in autograd, so every rank runs the backward rounds in
    reverse tick order, the same order on every rank. ``anchors`` (this
    rank's differentiable stage parameters and microbatches) are inputs
    only so that autograd, which skips nodes on no path to what it
    differentiates, runs every round, also one whose rank computed
    nothing at that tick."""

    @staticmethod
    def forward(ctx, y, token, group, send_to, recv_from, *anchors):
        ctx.group, ctx.send_to, ctx.recv_from = group, send_to, recv_from
        ctx.shape, ctx.dtype = token.shape, token.dtype
        ctx.n_anchors = len(anchors)
        got = _p2p(group, None if send_to is None else (send_to, y),
                   recv_from, token)
        return got if got is not None else torch.zeros_like(token)

    @staticmethod
    def backward(ctx, g):
        ref = torch.empty(ctx.shape, dtype=ctx.dtype, device=g.device)
        gy = _p2p(ctx.group,
                  None if ctx.recv_from is None else (ctx.recv_from, g),
                  ctx.send_to, ref)
        return (gy, torch.zeros_like(ref), None, None, None) + \
            (None,) * ctx.n_anchors


class _GatherLast(torch.autograd.Function):
    """``all_gather`` of every rank's output buffer, keeping the last
    rank's. Every rank differentiates the same loss of the replicated
    result, so the backward keeps this rank's own slice; ``token`` ends
    the tick chain."""

    @staticmethod
    def forward(ctx, out_buf, token, group):
        ctx.group = group
        ctx.token_shape = token.shape
        parts = [torch.empty_like(out_buf)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, out_buf.contiguous(), group=group)
        return parts[-1]

    @staticmethod
    def backward(ctx, g):
        rank = dist.get_rank(ctx.group)
        last = dist.get_world_size(ctx.group) - 1
        gin = g if rank == last else torch.zeros_like(g)
        return gin, g.new_zeros(ctx.token_shape), None


def _p2p(group, send, recv_from, like):
    """Send ``send = (rank, tensor)`` and receive one tensor shaped as
    ``like`` from ``recv_from`` (group ranks, either may be None)."""
    ops = []
    if send is not None:
        ops.append(dist.P2POp(dist.isend, send[1].contiguous(),
                              dist.get_global_rank(group, send[0]), group))
    buf = None
    if recv_from is not None:
        buf = torch.empty_like(like)
        ops.append(dist.P2POp(dist.irecv, buf,
                              dist.get_global_rank(group, recv_from), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return buf


def pipeline_forward(group, stage_fn: Callable, stage_params, microbatches,
                     *, num_stages: int):
    """``y_m = stage_{S-1}(... stage_0(x_m))`` for every microbatch, rank
    s of ``group`` running stage s (call on every rank).

    ``stage_fn(lp, x) -> y`` with x and y of one shape; ``stage_params``
    stage-stacked (leading dim S), of which each rank reads its slice;
    ``microbatches`` [M, ...], the same on every rank. Microbatch m
    occupies stage s at tick m + s, over M + S - 1 ticks; after each
    tick but the last one round shifts the outputs one rank on, and the
    last rank's outputs are gathered to every rank (``all_gather``).
    Returns [M, ...] on every rank. Gradients flow back through the
    shifts (each backward round sends the cotangent the other way): a
    loss of the result, the same on every rank, differentiated on every
    rank with respect to the stage parameters or the microbatches (or by
    ``backward()``), differentiates each rank's stage."""
    S = num_stages
    if dist.get_world_size(group) != S:
        raise ValueError(f"pipeline_forward runs one stage per rank: "
                         f"{S} stages, {dist.get_world_size(group)} ranks")
    r = dist.get_rank(group)
    M = int(microbatches.shape[0])
    lp = _stage_slice(stage_params, r)
    anchors = [t for t in list(lp.values()) + [microbatches]
               if isinstance(t, torch.Tensor) and t.requires_grad]
    token = torch.zeros_like(microbatches[0])
    outs: List[Any] = [None] * M
    x = token
    for t in range(M + S - 1):
        m = t - r
        y = None
        if 0 <= m < M:
            y = stage_fn(lp, microbatches[m] if r == 0 else x)
            if r == S - 1:
                outs[m] = y
        if t == M + S - 2:
            break
        send_to = r + 1 if r < S - 1 and 0 <= m < M else None
        recv_from = r - 1 if r > 0 and 0 <= t + 1 - r < M else None
        x = _Shift.apply(y, x, group, send_to, recv_from, *anchors)
    out_buf = torch.stack(outs) if r == S - 1 \
        else torch.zeros_like(microbatches)
    return _GatherLast.apply(out_buf, x, group)


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


def _named_tensors(lp, grad_only: bool = True) -> List[tuple]:
    """(name, tensor) of a stage's parameters that require grad (every
    one without ``grad_only``): an ``nn.Module``'s named parameters, or
    a (nested) dict's leaves."""
    if isinstance(lp, nn.Module):
        return [(n, p) for n, p in lp.named_parameters()
                if p.requires_grad or not grad_only]
    out = []

    def walk(tree, prefix):
        for key, val in tree.items():
            if isinstance(val, Mapping):
                walk(val, f"{prefix}{key}.")
            elif isinstance(val, torch.Tensor) and (val.requires_grad
                                                    or not grad_only):
                out.append((f"{prefix}{key}", val))
    walk(lp, "")
    return out


# ---------------------------------------------------------------------------
# Schedule replay
# ---------------------------------------------------------------------------

class StageItems:
    """The F, B and W items of the stages one process runs, as
    ``execute_schedule`` replays them and each rank of
    ``parallel.spmd``'s runner runs its own: the stage computations, the
    instrumented activation store (filled at F, drained at B), the
    W-residual store, the loss and the weight gradients. Where inputs
    come from and where outputs go (the handoffs) is the caller's.

    ``stage_fn``, ``microbatch_loss`` and ``trainable`` follow
    ``execute_schedule``; ``params`` is a per-stage list (None for the
    stages this process does not run), ``stages`` the stages it runs.
    """

    def __init__(self, graph, stage_fn, params: Sequence[Any],
                 stages: Sequence[int], *,
                 microbatch_loss: Optional[Callable] = None,
                 trainable: Optional[Sequence[bool]] = None,
                 has_w_items: bool = False):
        S = len(graph.stages)
        if trainable is None:
            trainable = [graph.stages[s].bwd_w > 0 for s in range(S)]
        trainable = [bool(t) for t in trainable]
        if len(trainable) != S:
            raise ValueError(f"{len(trainable)} trainable flags for {S} "
                             f"stages")
        self.graph, self.params, self.trainable = graph, params, trainable
        self.fns = normalize_stage_fns(stage_fn, S)
        self.loss_fn = microbatch_loss or (lambda y: torch.mean(y ** 2))
        self.has_w = has_w_items
        self.named = {s: _named_tensors(params[s]) for s in stages}
        self.grads: Dict[int, Dict[str, torch.Tensor]] = \
            {s: {} for s in stages}
        self.store: Dict[tuple, tuple] = {}     # (s, m) -> (input, output)
        self.w_store: Dict[tuple, tuple] = {}   # (s, m) -> (output, cot)
        self.loss = None
        self.act_nbytes = 0

    def _need_dx(self, s: int) -> bool:
        return self.graph.stages[s].bwd_b > 0 and bool(self.graph.preds[s])

    def _defer(self, s: int) -> bool:
        return self.trainable[s] and self.has_w and \
            self.graph.stages[s].bwd_w > 0

    def live(self, device_of, d: int) -> int:
        """Activations held for device ``d``: the store's entries, not a
        parallel counter."""
        return sum(1 for (s, _m) in self.store if device_of[s] == d)

    def w_live(self, device_of, d: int) -> int:
        return sum(1 for (s, _m) in self.w_store if device_of[s] == d)

    def forward(self, s: int, m: int, x, mb):
        """F(s, m) on input ``x``: detaches it from the upstream graph
        (requiring grad only when B must return an input gradient), runs
        the forward with autograd on only when B or W will differentiate
        it, and keeps both in the store. Returns (the output, detached;
        for a sink the gradient of its microbatch loss, else None)."""
        need_dx = self._need_dx(s)
        x = x.detach().requires_grad_(need_dx)
        with torch.set_grad_enabled(need_dx or self.trainable[s]):
            y = self.fns[s](self.params[s], x, mb)
        self.store[(s, m)] = (x, y)
        self.act_nbytes = max(self.act_nbytes, x.numel() * x.element_size())
        if self.graph.succs[s]:
            return y.detach(), None
        yg = y.detach().requires_grad_(True)     # sink: loss + cotangent
        with torch.enable_grad():
            ly = self.loss_fn(yg)
            (gy,) = torch.autograd.grad(ly, yg)
        ly = ly.detach()
        self.loss = ly if self.loss is None else self.loss + ly
        return y.detach(), gy

    def backward(self, s: int, m: int, g):
        """B(s, m) with the output cotangent ``g`` (None where none
        comes: a stage with nothing trainable at or above it). One
        ``torch.autograd.grad`` over the input and, when the stage's W is
        not a separate item, its trainable parameters; a stage whose W
        comes later keeps its graph (``retain_graph``) in the W-residual
        store. Returns the input gradient, or None where B gives none."""
        st = self.graph.stages[s]
        x, y = self.store.pop((s, m))
        if g is None and not (st.bwd_b == 0 and st.bwd_w == 0
                              and not self.trainable[s]):
            raise KeyError(f"missing cotangent for B({s}, {m})")
        need_dx, defer = self._need_dx(s), self._defer(s)
        glue = self.trainable[s] and not defer
        inputs = ([x] if need_dx else []) + \
            ([p for _, p in self.named[s]] if glue else [])
        dx = None
        if inputs:
            got = torch.autograd.grad(
                y, inputs, g, retain_graph=defer, allow_unused=True) \
                if y.requires_grad else [None] * len(inputs)
            if need_dx:
                dx = got[0] if got[0] is not None else torch.zeros_like(x)
                got = got[1:]
            if glue:
                self._add_grads(s, got)
        if defer:
            # W comes later: keep the graph, park the cotangent
            self.w_store[(s, m)] = (y, g)
        return dx

    def weight(self, s: int, m: int) -> None:
        """W(s, m): the weight gradients from the graph B kept (a no-op
        for a stage that the trainable override left without one)."""
        parked = self.w_store.pop((s, m), None)
        if parked is None:
            return
        y, g = parked
        ps = [p for _, p in self.named[s]]
        got = torch.autograd.grad(y, ps, g, allow_unused=True) \
            if ps and y.requires_grad else [None] * len(ps)
        self._add_grads(s, got)

    def _add_grads(self, s: int, got) -> None:
        for (name, p), g in zip(self.named[s], got):
            if g is None:
                g = torch.zeros_like(p)
            self.grads[s][name] = g if name not in self.grads[s] \
                else self.grads[s][name] + g

    def finish(self) -> Dict[int, Dict[str, torch.Tensor]]:
        """{stage: {name: grad}}; a trainable stage never reached gets
        zeros."""
        for s, named in self.named.items():
            if self.trainable[s]:
                for name, p in named:
                    self.grads[s].setdefault(name, torch.zeros_like(p))
        return self.grads


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
    hetero = isinstance(stage_params, (list, tuple))
    if hetero:
        if len(stage_params) != S:
            raise ValueError(f"{len(stage_params)} stage params for "
                             f"{S} stages")
        params = list(stage_params)
    else:
        # per-stage leaves sharing the stacked storage
        params = [{k: v[s].detach().requires_grad_(v.requires_grad)
                   for k, v in stage_params.items()} for s in range(S)]
    run = StageItems(graph, stage_fn, params, range(S),
                     microbatch_loss=microbatch_loss, trainable=trainable,
                     has_w_items=any(kind == "W"
                                     for _, _, _, kind, _, _ in items))
    transit: Dict[tuple, Any] = {}      # produced, not yet admitted
    cot: Dict[tuple, Any] = {}          # (s, m) -> output cotangent
    outputs: List[Any] = [None] * M

    def accumulate(d: Dict[tuple, Any], key: tuple, val) -> None:
        # fan-in (or fan-out cotangent) merge, in timeline order
        d[key] = val if key not in d else d[key] + val

    peak = [0] * D
    w_peak = [0] * D
    trace: List[tuple] = []

    for item in items:
        _start, _end, dev, kind, s, m = item
        if kind == "F":
            x = transit.pop((s, m)) if preds[s] else microbatches[m]
            y, gy = run.forward(s, m, x, microbatches[m])
            peak[dev] = max(peak[dev], run.live(device_of, dev))
            if not succs[s]:                     # sink: loss + cotangent
                outputs[m] = y if outputs[m] is None else outputs[m] + y
                accumulate(cot, (s, m), gy)
            else:
                for q in succs[s]:
                    accumulate(transit, (q, m), y)
        elif kind == "B":
            dx = run.backward(s, m, cot.pop((s, m), None))
            if dx is not None:
                for p in preds[s]:
                    accumulate(cot, (p, m), dx)
            w_peak[dev] = max(w_peak[dev], run.w_live(device_of, dev))
        else:
            run.weight(s, m)
        trace.append((item_id(item), dev, run.live(device_of, dev)))

    if run.store or run.w_store or transit:
        raise RuntimeError("schedule left live activations behind "
                           "(incomplete timeline)")
    if any(y is None for y in outputs):
        raise RuntimeError("a microbatch never reached a sink stage")
    grads = run.finish()
    if hetero:
        param_grads: Any = [grads[s] for s in range(S)]
    else:
        param_grads = {
            k: torch.stack([grads[s].get(k, torch.zeros_like(v[s]))
                            for s in range(S)])
            for k, v in stage_params.items()}
    return {
        "outputs": torch.stack(outputs),
        "loss": run.loss,
        "param_grads": param_grads,
        "peak_activations_per_device": peak,
        "peak_w_residuals_per_device": w_peak,
        "activation_trace": trace,
        "activation_nbytes": run.act_nbytes,
    }


# ---------------------------------------------------------------------------
# Modality islands: encoders on their own devices
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Island:
    name: str
    devices: List[torch.device]      # the island's devices; runs on [0]
    stream: Optional[Any] = None     # its own CUDA stream on a card


class ModalityIslands:
    """Each encoder on its own device list, the LLM on the rest (the
    paper's modality parallelism, Cornstarch §4.1).

    ``run(params, batch)`` starts every encoder island before the LLM
    island needs any of them: there is no edge between encoders in the
    execution graph. On a card each island's encoder runs on its own
    CUDA stream, so the encoders may overlap even where the islands share
    one card; its output then moves to the LLM's device (a device copy)
    and the LLM stream waits for it. Each island's parameters must live
    on its first device, the batch may live anywhere."""

    def __init__(self, mllm, device_split: Dict[str, Sequence[Any]]):
        self.mllm = mllm
        self.islands: Dict[str, Island] = {}
        for name in mllm.encoders:
            devs = [torch.device(d) for d in device_split[name]]
            stream = torch.cuda.Stream(devs[0]) \
                if devs[0].type == "cuda" else None
            self.islands[name] = Island(name, devs, stream)
        self.llm_devices = [torch.device(d) for d in device_split["llm"]]

    def run(self, params, batch):
        """Returns the LLM's ``(logits, aux)`` as ``T.forward`` does."""
        from repro_torch.models import transformer as T
        llm_dev = self.llm_devices[0]
        outs = {}
        for name, isl in sorted(self.islands.items()):
            dev = isl.devices[0]
            enc_params = params.encoders[name]
            where = {p.device for p in enc_params.parameters()}
            if where != {dev}:
                raise ValueError(f"island {name!r} runs on {dev} but its "
                                 f"parameters are on {sorted(map(str, where))}")
            inputs = {k: (v.to(dev) if isinstance(v, torch.Tensor) else v)
                      for k, v in batch.items()}
            ctx = contextlib.nullcontext()
            if isl.stream is not None:
                isl.stream.wait_stream(torch.cuda.current_stream(dev))
                ctx = torch.cuda.stream(isl.stream)
            with ctx:
                outs[name] = self.mllm.encoders[name].forward(enc_params,
                                                             inputs)
        for name, isl in self.islands.items():
            if isl.stream is not None:
                # the cross-island transfer (the paper's encoder -> LLM
                # send) runs once the island's stream has produced it
                torch.cuda.current_stream(isl.devices[0]).wait_stream(
                    isl.stream)
                outs[name].record_stream(
                    torch.cuda.current_stream(isl.devices[0]))
            outs[name] = outs[name].to(llm_dev)
        merged = self.mllm.build_merge(batch["text_tokens"].to(llm_dev),
                                       outs)
        if self.mllm.preprocess_callback:
            merged = self.mllm.preprocess_callback(outs, merged)
        return T.forward(params.llm, self.mllm.llm_cfg, merged)


def split_devices(mllm, devices: Sequence[Any],
                  plan: Any = None) -> Dict[str, list]:
    """Device lists per module (default: one per encoder, the rest to
    the LLM). ``plan`` is an ``MLLMParallelPlan``, a plain {encoder:
    count} dict, or an ``auto_parallelize`` result dict, whose encoder
    stage counts are matched by the "encoder_names" it carries. Encoders
    take their devices in sorted name order; raises ``ValueError`` when
    none is left for the LLM."""
    devices = list(devices)
    if _is_typed_plan(plan):
        plan = plan.stage_counts_by_name()
    elif plan and "encoder_stages" in plan:   # auto_parallelize result
        names = plan.get("encoder_names") or sorted(mllm.encoders)
        plan = dict(zip(names, plan["encoder_stages"]))
    plan = plan or {name: 1 for name in mllm.encoders}
    out: Dict[str, list] = {}
    i = 0
    for name in sorted(mllm.encoders):
        n = plan.get(name, 1)
        out[name] = devices[i:i + n]
        i += n
    out["llm"] = devices[i:]
    if not out["llm"]:
        raise ValueError("no devices left for the LLM")
    return out


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

"""Distributed schedule runner: a simulated F/B/W timeline executed with
one process per pipeline rank over ``torch.distributed`` (the
counterpart of ``repro.parallel.spmd``).

``core.modality_parallel.execute_schedule`` replays a schedule's item
timeline in one process. This module runs the same timeline across
ranks: rank d of the process group is device d of the simulation, holds
only the stages it hosts, and every stage handoff that crosses ranks (a
forward activation, a backward cotangent) travels by point-to-point
``isend``/``irecv``.

Compilation (``compile_spmd_program``, plain Python over the graph and
the timeline, element for element the reference's) turns the timeline
into **waves**: a wave holds at most one work item per rank (a rank
whose next item is not yet ready sits the wave out: the pipeline
bubble), and each wave boundary carries what the wave produced as one or
more comm **rounds**. A round is a partial permutation (distinct
sources, distinct destinations), so in one round each rank sends at most
one tensor and receives at most one, posted together in one
``dist.batch_isend_irecv``. The program is plain data that
``analysis.schedlint.lint_spmd_program`` checks.

Execution (``build_spmd_runner`` / ``run_schedule_spmd``): each rank
walks the waves in order. Where a wave gives it an item it runs it as
``execute_schedule`` does (F keeps the stage's autograd graph, B calls
``torch.autograd.grad`` on the detached stage input, with
``retain_graph`` only when a W follows, W differentiates the kept graph,
frozen parameters are never differentiated); then it takes part in each
of the wave's rounds that names it. Fan-in inputs and fan-out cotangents
are summed in ascending stage order, whatever order they arrived in.
Every handoff has the microbatch's shape and dtype (the stage contract),
known before any ``irecv`` is posted, so no header travels.

Transport: on a NCCL group tensors stay on the device. On gloo (ranks
that share a card, or run on the CPU) a tensor on a card goes through a
pinned host buffer, since gloo's send and recv take CPU tensors. The
loss is summed over ranks; each rank records its store's occupancy per
item, and the records are gathered and reassembled into
``execute_schedule``'s ``activation_trace``, so
``core.schedule.memory.validate_schedule_memory`` reads them unchanged.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.schedule import memory as _memory
from repro_torch.core.schedule.graph import PipelineGraph
from repro_torch.core.schedule.simulator import Item, item_id
from repro_torch.device import resolve_device


# ---------------------------------------------------------------------------
# Compiled program data model
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Transfer:
    """One cross-rank handoff: the value item (kind', src_stage, m) just
    produced, shipped src_dev -> dst_dev for stage ``dst_stage``.
    ``kind`` is "fwd" (activation, F -> consumer F) or "bwd" (cotangent,
    B -> predecessor B)."""
    kind: str
    src_dev: int
    dst_dev: int
    src_stage: int
    dst_stage: int
    microbatch: int


@dataclasses.dataclass
class CommRound:
    """One ``batch_isend_irecv`` at a wave boundary. Sources and
    destinations are distinct within a round (a partial permutation)."""
    kind: str                        # "fwd" | "bwd"
    transfers: List[Transfer]

    @property
    def pairs(self) -> List[Tuple[int, int]]:
        return [(t.src_dev, t.dst_dev) for t in self.transfers]


@dataclasses.dataclass
class Wave:
    """At most one work item per rank, then the boundary's comm rounds.
    ``compute`` maps device -> (item_index, kind, stage, local_chunk,
    microbatch)."""
    compute: Dict[int, Tuple[int, str, int, int, int]]
    rounds: List[CommRound]


@dataclasses.dataclass
class SPMDProgram:
    """A timeline compiled for the distributed runner (plain data, what
    ``schedlint.lint_spmd_program`` validates)."""
    graph: PipelineGraph
    items: List[Item]
    device_of: List[int]
    num_devices: int
    hosted: List[List[int]]          # device -> hosted stages (asc)
    chunk_of: List[int]              # stage -> local chunk slot
    max_chunks: int                  # L: store slots per device
    waves: List[Wave]
    has_w_items: bool

    def counts(self) -> Dict[str, int]:
        return {"waves": len(self.waves),
                "rounds": sum(len(w.rounds) for w in self.waves),
                "items": len(self.items),
                "devices": self.num_devices}


# ---------------------------------------------------------------------------
# Compilation: timeline -> waves + comm rounds
# ---------------------------------------------------------------------------

def compile_spmd_program(graph: PipelineGraph,
                         sim: Dict[str, Any]) -> SPMDProgram:
    """Compile a simulation dict (``items`` + ``device_of`` +
    ``num_devices``) into an :class:`SPMDProgram`.

    Wave placement is the earliest level consistent with (a) one item
    per device per wave and (b) every dependency (producer F for a
    consumer F, consumer B and own F for a producer B, own B for a W)
    sitting in a strictly earlier wave, so its boundary transfer has
    been delivered. Items are walked in timeline order, which the
    simulator makes dependency-respecting; a malformed timeline still
    compiles and is caught by ``lint_spmd_program``. Raises
    ``ValueError`` when a stage with backward work has successors none
    of which produces its cotangent.
    """
    items = list(sim["items"])
    device_of = list(sim["device_of"])
    S = len(graph.stages)
    D = int(sim["num_devices"])
    preds, succs = graph.preds, graph.succs

    hosted = [[s for s in range(S) if device_of[s] == d] for d in range(D)]
    chunk_of = [hosted[device_of[s]].index(s) for s in range(S)]
    L = max(1, max((len(h) for h in hosted), default=1))

    # a stage that needs a cotangent must get one: from being a sink, or
    # from at least one successor that computes input grads
    for s in range(S):
        st = graph.stages[s]
        if st.bwd_b <= 0 and st.bwd_w <= 0:
            continue
        if succs[s] and not any(graph.stages[q].bwd_b > 0
                                for q in succs[s]):
            raise ValueError(
                f"stage {s} has backward work (bwd_b={st.bwd_b}, "
                f"bwd_w={st.bwd_w}) but no successor produces its "
                f"cotangent (all succs have bwd_b == 0)")

    waves: List[Wave] = []
    placed: Dict[Tuple[str, int, int], int] = {}
    last_wave = [-1] * D
    has_w = any(it[3] == "W" for it in items)

    def wave_at(w: int) -> Wave:
        while len(waves) <= w:
            waves.append(Wave(compute={}, rounds=[]))
        return waves[w]

    def add_transfer(w: int, t: Transfer) -> None:
        # greedy packing: the first round of this kind where neither the
        # source nor the destination is taken yet
        for r in wave_at(w).rounds:
            if r.kind != t.kind:
                continue
            if t.src_dev in (x.src_dev for x in r.transfers):
                continue
            if t.dst_dev in (x.dst_dev for x in r.transfers):
                continue
            r.transfers.append(t)
            return
        wave_at(w).rounds.append(CommRound(kind=t.kind, transfers=[t]))

    for i, it in enumerate(items):
        _s0, _e0, dev, kind, s, m = it
        if kind == "F":
            deps = [("F", p, m) for p in preds[s]]
        elif kind == "B":
            deps = [("F", s, m)] + [("B", q, m) for q in succs[s]]
        else:
            deps = [("B", s, m)]
        w = 1 + max([last_wave[dev]]
                    + [placed.get(k, -1) for k in deps])
        wave_at(w).compute[dev] = (i, kind, s, chunk_of[s], m)
        placed[(kind, s, m)] = w
        last_wave[dev] = w
        if kind == "F":
            for q in succs[s]:
                if device_of[q] != dev:
                    add_transfer(w, Transfer("fwd", dev, device_of[q],
                                             s, q, m))
        elif kind == "B" and graph.stages[s].bwd_b > 0:
            for p in preds[s]:
                if device_of[p] != dev:
                    add_transfer(w, Transfer("bwd", dev, device_of[p],
                                             s, p, m))

    return SPMDProgram(graph=graph, items=items, device_of=device_of,
                       num_devices=D, hosted=hosted, chunk_of=chunk_of,
                       max_chunks=L, waves=waves, has_w_items=has_w)


# ---------------------------------------------------------------------------
# Transport
# ---------------------------------------------------------------------------

class Transport:
    """Point-to-point rounds of one rank over a process group, for
    tensors of one shape and dtype on one device. On NCCL the tensors
    are sent from and received into device memory. On gloo a tensor on a
    card is staged through a pinned host buffer (gloo takes CPU tensors);
    ``staged_bytes`` counts the bytes copied between card and host."""

    def __init__(self, group, device: torch.device, shape, dtype):
        self.group = group
        self.backend = str(dist.get_backend(group))
        self.device = torch.device(device)
        if self.backend == "nccl" and self.device.type != "cuda":
            raise ValueError("a NCCL group moves tensors on a card, got "
                             f"device {self.device}")
        self.shape, self.dtype = tuple(shape), dtype
        self.staged = self.backend != "nccl" and self.device.type == "cuda"
        if self.staged:
            self.send_buf = torch.empty(self.shape, dtype=dtype,
                                        pin_memory=True)
            self.recv_buf = torch.empty(self.shape, dtype=dtype,
                                        pin_memory=True)
        self.staged_bytes = 0

    def describe(self) -> str:
        if self.backend == "nccl":
            return "nccl, tensors on the card"
        if self.staged:
            return (f"{self.backend}, tensors on {self.device} staged "
                    f"through pinned host buffers")
        return f"{self.backend}, tensors on the CPU"

    def exchange(self, send: Optional[Tuple[int, torch.Tensor]],
                 recv_from: Optional[int]) -> Optional[torch.Tensor]:
        """One round: send ``send = (dst rank, tensor)`` and receive one
        tensor from ``recv_from`` (group ranks; either may be None), in
        one ``batch_isend_irecv``. Returns the received tensor on this
        rank's device."""
        ops = []
        if send is not None:
            dst, t = send
            if self.staged:
                self.send_buf.copy_(t)          # waits for the card
                self.staged_bytes += t.numel() * t.element_size()
                t = self.send_buf
            ops.append(dist.P2POp(dist.isend, t.contiguous(),
                                  dist.get_global_rank(self.group, dst),
                                  self.group))
        buf = None
        if recv_from is not None:
            buf = self.recv_buf if self.staged else torch.empty(
                self.shape, dtype=self.dtype, device=self.device)
            ops.append(dist.P2POp(dist.irecv, buf,
                                  dist.get_global_rank(self.group,
                                                       recv_from),
                                  self.group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        if buf is not None and self.staged:
            buf = buf.to(self.device, copy=True)
            self.staged_bytes += buf.numel() * buf.element_size()
        return buf


def _group_of(group):
    if not dist.is_available() or not dist.is_initialized():
        raise ValueError("the SPMD runner needs an initialised "
                         "torch.distributed process group, one rank per "
                         "pipeline device")
    return group if group is not None else dist.group.WORLD


# ---------------------------------------------------------------------------
# Stage models and parameters
# ---------------------------------------------------------------------------

def toy_stage_model(num_stages: int, d_model: int, seed: int = 0,
                    device="cuda"):
    """``core.schedule.memory.toy_stage_model``'s residual stage ``x +
    tanh(x W)`` without microbatches, its weights drawn on ``device``
    from a generator seeded ``seed``: (stage_fn, {"w": [S, d, d]}) with
    the weights requiring grad."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    stage_fn, params, _ = _memory.toy_stage_model(
        num_stages, 0, d_model=d_model, generator=gen, device=dev)
    return stage_fn, params


def _stage_views(stage_params, hosted: Sequence[int], S: int) -> list:
    """Per-stage parameters for the hosted stages (None elsewhere): list
    entries pass through, a stage-stacked dict is sliced into leaves
    that share its storage."""
    if isinstance(stage_params, (list, tuple)):
        if len(stage_params) != S:
            raise ValueError(f"{len(stage_params)} stage params for "
                             f"{S} stages")
        out = [None] * S
        for s in hosted:
            if stage_params[s] is None:
                raise ValueError(f"stage {s} is hosted on this rank but "
                                 f"its parameters are None")
            out[s] = stage_params[s]
        return out
    out = [None] * S
    for s in hosted:
        out[s] = {k: v[s].detach().requires_grad_(v.requires_grad)
                  for k, v in stage_params.items()}
    return out


def local_named_parameters(stage_params, hosted: Sequence[int]
                           ) -> Dict[str, torch.Tensor]:
    """{"<stage>:<name>": tensor} over the hosted stages' parameters
    (every one, frozen included): a stage list's modules or dicts, or a
    stage-stacked dict's slices (views of its storage)."""
    from repro_torch.core.modality_parallel import _named_tensors
    out: Dict[str, torch.Tensor] = {}
    for s in hosted:
        if isinstance(stage_params, (list, tuple)):
            items = _named_tensors(stage_params[s], grad_only=False)
        else:
            items = [(k, v[s]) for k, v in stage_params.items()]
        for name, p in items:
            out[f"{s}:{name}"] = p
    return out


# ---------------------------------------------------------------------------
# The runner
# ---------------------------------------------------------------------------

def _rank_rounds(prog: SPMDProgram, rank: int):
    """Per wave: (this rank's compute or None, [(kind, send dst or None,
    the Transfer it receives or None)] for the rounds that name it).
    Raises ``ValueError`` when a round is not a partial permutation."""
    plan = []
    for w, wave in enumerate(prog.waves):
        rounds = []
        for r, rnd in enumerate(wave.rounds):
            sends = [t for t in rnd.transfers if t.src_dev == rank]
            recvs = [t for t in rnd.transfers if t.dst_dev == rank]
            if len(sends) > 1 or len(recvs) > 1 or any(
                    t.src_dev == t.dst_dev for t in rnd.transfers):
                raise ValueError(
                    f"wave {w} round {r} is not a partial permutation "
                    f"at rank {rank}: {rnd.pairs}")
            if sends or recvs:
                rounds.append((rnd.kind,
                               sends[0] if sends else None,
                               recvs[0] if recvs else None))
        plan.append((wave.compute.get(rank), rounds))
    return plan


def build_spmd_runner(stage_fn, graph: PipelineGraph,
                      sim: Dict[str, Any], *,
                      group=None,
                      microbatch_loss: Optional[Callable] = None,
                      program: Optional[SPMDProgram] = None,
                      trainable: Optional[Sequence[bool]] = None,
                      dispatch: str = "rolled") -> Callable:
    """Compile the schedule once and return ``runner(stage_params,
    microbatches) -> result`` for this rank of ``group`` (default: the
    default process group), whose size must be the program's device
    count.

    ``stage_fn``, ``stage_params``, ``microbatches``, ``microbatch_loss``
    and ``trainable`` follow ``execute_schedule``'s contract. A stage
    list may hold None for the stages other ranks host; only this rank's
    stages are read. ``dispatch`` ("rolled" or "switch") is the JAX
    runner's compile-time choice between a rolled loop and an unrolled
    program; it is kept for call parity, and both run this one eager
    wave loop.

    The result holds ``execute_schedule``'s keys: ``outputs`` [M, ...]
    (this rank's sinks' outputs, zeros where another rank's sink holds
    the microbatch), ``loss`` (summed over ranks, on every rank),
    ``param_grads`` (the hosted stages' gradients; a stage list gives
    None for the other stages, a stacked dict zeros),
    ``peak_activations_per_device``, ``peak_w_residuals_per_device``,
    ``activation_trace`` (every rank's records, reassembled by item
    index) and ``activation_nbytes``; plus ``program``, ``rank`` and
    ``staged_bytes`` (card <-> host bytes of this call on this rank).
    ``gather_result`` assembles the whole outputs and gradients on rank
    0."""
    from repro_torch.core.modality_parallel import StageItems
    prog = program if program is not None else \
        compile_spmd_program(graph, sim)
    group = _group_of(group)
    size = dist.get_world_size(group)
    if size != prog.num_devices:
        raise ValueError(
            f"the process group has {size} ranks but the program was "
            f"compiled for {prog.num_devices} devices")
    if dispatch not in ("rolled", "switch"):
        raise ValueError(f"unknown dispatch {dispatch!r}")
    rank = dist.get_rank(group)
    S = len(graph.stages)
    D = prog.num_devices
    device_of = prog.device_of
    preds, succs = graph.preds, graph.succs
    if trainable is None:
        trainable = [graph.stages[s].bwd_w > 0 for s in range(S)]
    if len(trainable) != S:
        raise ValueError(f"{len(trainable)} trainable flags for {S} stages")
    for s in range(S):
        # compile_spmd_program's reachability invariant, extended to the
        # trainable override
        if trainable[s] and succs[s] and not any(
                graph.stages[q].bwd_b > 0 for q in succs[s]):
            raise ValueError(
                f"stage {s} is trainable but no successor produces its "
                f"cotangent (all succs have bwd_b == 0)")
    hosted = prog.hosted[rank]
    rounds_of = _rank_rounds(prog, rank)
    transports: Dict[tuple, Transport] = {}

    def transport_for(mbs) -> Transport:
        key = (tuple(mbs.shape[1:]), mbs.dtype, mbs.device)
        if key not in transports:
            transports[key] = Transport(group, mbs.device, key[0], key[1])
            if rank == 0:
                print(f"spmd runner: {D} ranks, transport "
                      f"{transports[key].describe()}", flush=True)
        return transports[key]

    def put(d, key, src, val):
        d.setdefault(key, {})[src] = val

    def take(d, key):
        # fan-in inputs and fan-out cotangents, summed in ascending stage
        # order whatever order they arrived in
        parts = d.pop(key, None)
        if not parts:
            return None
        vals = [parts[k] for k in sorted(parts)]
        out = vals[0]
        for v in vals[1:]:
            out = out + v
        return out

    def runner(stage_params, microbatches) -> Dict[str, Any]:
        tp = transport_for(microbatches)
        staged0 = tp.staged_bytes
        run = StageItems(graph, stage_fn, _stage_views(stage_params,
                                                        hosted, S),
                         hosted, microbatch_loss=microbatch_loss,
                         trainable=trainable, has_w_items=prog.has_w_items)
        inbox: Dict[tuple, Dict[int, Any]] = {}   # (s, m) -> {pred: x}
        cots: Dict[tuple, Dict[int, Any]] = {}    # (s, m) -> {succ: g}
        outputs = torch.zeros_like(microbatches)
        occ: Dict[int, int] = {}
        peak = w_peak = 0

        for compute, rounds in rounds_of:
            produced: Dict[str, tuple] = {}
            if compute is not None:
                i, kind, s, _c, m = compute
                if kind == "F":
                    x = take(inbox, (s, m)) if preds[s] else microbatches[m]
                    if x is None:
                        raise RuntimeError(f"F({s}, {m}) on rank {rank}: "
                                           f"no input was delivered")
                    y, gy = run.forward(s, m, x, microbatches[m])
                    peak = max(peak, len(run.store))
                    if not succs[s]:                 # sink
                        outputs[m] += y
                        put(cots, (s, m), -1, gy)
                    else:
                        for q in succs[s]:
                            if device_of[q] == rank:
                                put(inbox, (q, m), s, y)
                        produced["fwd"] = (s, m, y)
                elif kind == "B":
                    dx = run.backward(s, m, take(cots, (s, m)))
                    if dx is not None:
                        for p in preds[s]:
                            if device_of[p] == rank:
                                put(cots, (p, m), s, dx)
                        produced["bwd"] = (s, m, dx)
                    w_peak = max(w_peak, len(run.w_store))
                else:
                    run.weight(s, m)
                occ[i] = len(run.store)
            for kind, send, recv in rounds:
                out = None
                if send is not None:
                    have = produced.get(kind)
                    if have is None or have[:2] != (send.src_stage,
                                                    send.microbatch):
                        raise RuntimeError(
                            f"rank {rank}: a {kind} round ships stage "
                            f"{send.src_stage} microbatch "
                            f"{send.microbatch}, which this wave did not "
                            f"produce (a stale send)")
                    out = (send.dst_dev, have[2])
                got = tp.exchange(out, recv.src_dev if recv else None)
                if recv is not None:
                    put(inbox if kind == "fwd" else cots,
                        (recv.dst_stage, recv.microbatch), recv.src_stage,
                        got)

        if run.store or run.w_store or inbox:
            raise RuntimeError(f"rank {rank}: the schedule left live "
                               f"activations behind (incomplete timeline)")
        grads = run.finish()
        loss = run.loss if run.loss is not None else torch.zeros(
            (), dtype=microbatches.dtype, device=microbatches.device)

        # one object collective: the per-item records and the loss
        mine = (occ, peak, w_peak, loss.cpu(), run.act_nbytes)
        every: List[Any] = [None] * D
        dist.all_gather_object(every, mine, group=group)
        occ_all: Dict[int, int] = {}
        for r_occ, *_rest in every:
            occ_all.update(r_occ)
        trace = [(item_id(it), it[2], occ_all[i])
                 for i, it in enumerate(prog.items)]
        total = every[0][3]
        for r in range(1, D):
            total = total + every[r][3]
        if isinstance(stage_params, (list, tuple)):
            param_grads: Any = [grads.get(s) for s in range(S)]
        else:
            param_grads = {
                k: torch.stack([grads[s].get(k, torch.zeros_like(v[s]))
                                if s in grads else torch.zeros_like(v[s])
                                for s in range(S)])
                for k, v in stage_params.items()}
        return {
            "outputs": outputs,
            "loss": total.to(loss.device),
            "param_grads": param_grads,
            "peak_activations_per_device": [r[1] for r in every],
            "peak_w_residuals_per_device": [r[2] for r in every],
            "activation_trace": trace,
            "activation_nbytes": max(r[4] for r in every),
            "program": prog,
            "rank": rank,
            "staged_bytes": tp.staged_bytes - staged0,
        }

    runner.program = prog
    runner.group = group
    runner.rank = rank
    return runner


def gather_result(result: Dict[str, Any], group=None) -> Dict[str, Any]:
    """Assemble a runner result's whole ``outputs`` (summed over ranks)
    and every stage's ``param_grads`` (from the rank hosting it) on rank
    0 of ``group``; returns the assembled copy on rank 0 and ``result``
    unchanged elsewhere. Tensors travel through the host."""
    group = _group_of(group)
    rank = dist.get_rank(group)
    prog = result["program"]
    grads = result["param_grads"]

    def cpu(tree):
        if isinstance(tree, torch.Tensor):
            return tree.detach().cpu()
        if isinstance(tree, dict):
            return {k: cpu(v) for k, v in tree.items()}
        return tree

    if isinstance(grads, list):
        mine = {s: cpu(grads[s]) for s in prog.hosted[rank]}
    else:
        mine = {s: {k: v[s].detach().cpu() for k, v in grads.items()}
                for s in prog.hosted[rank]}
    every: Optional[List[Any]] = [None] * dist.get_world_size(group) \
        if rank == 0 else None
    dist.gather_object((mine, cpu(result["outputs"])), every,
                       dst=dist.get_global_rank(group, 0), group=group)
    if rank != 0:
        return result
    dev = result["outputs"].device
    outputs = every[0][1]
    for _m, out in every[1:]:
        outputs = outputs + out
    per_stage: Dict[int, Any] = {}
    for m_grads, _o in every:
        per_stage.update(m_grads)

    def to_dev(tree):
        if isinstance(tree, torch.Tensor):
            return tree.to(dev)
        if isinstance(tree, dict):
            return {k: to_dev(v) for k, v in tree.items()}
        return tree

    if isinstance(grads, list):
        full: Any = [to_dev(per_stage[s]) for s in range(len(grads))]
    else:
        full = {k: torch.stack([per_stage[s][k]
                                for s in range(len(prog.device_of))]).to(dev)
                for k in grads}
    return dict(result, outputs=outputs.to(dev), param_grads=full)


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------

def _is_typed_plan(obj: Any) -> bool:
    from repro_torch.parallel.plan import MLLMParallelPlan
    return isinstance(obj, MLLMParallelPlan)


def run_schedule_spmd(*args: Any, group=None,
                      microbatch_loss: Optional[Callable] = None,
                      program: Optional[SPMDProgram] = None,
                      stage_fn: Any = None,
                      stage_params: Any = None,
                      trainable: Optional[Sequence[bool]] = None,
                      dispatch: str = "rolled",
                      seed: int = 0) -> Dict[str, Any]:
    """Execute a schedule timeline on the ranks of ``group`` (call on
    every rank).

    * ``run_schedule_spmd(stage_fn, stage_params, microbatches, graph,
      sim)``: explicit stage callables and a simulation dict.
    * ``run_schedule_spmd(plan, mllm, microbatches)``: an
      ``MLLMParallelPlan`` applied to ``mllm`` in SPMD mode; rank d runs
      pipeline device d. ``stage_fn`` selects what runs the timeline:
      real stage callables (``models.stages`` bundle fns, with matching
      ``stage_params``), or the explicit sentinel ``stage_fn="toy"`` for
      the toy residual stage sized to the microbatches' last dim (module
      profiles are cost models, not callables). ``stage_fn=None`` also
      runs the toy model, with a warning, so that a caller cannot verify
      the wrong model by accident.

    Returns ``build_spmd_runner``'s result."""
    if _is_typed_plan(args[0]):
        plan, mllm, microbatches = args
        executor = plan.apply(mllm, mode="spmd")
        graph = executor["sim_graph"]
        sim = executor["schedule"]
        prog = program if program is not None \
            else executor.get("spmd_program")
        if stage_fn is None or stage_fn == "toy":
            if stage_fn is None:
                warnings.warn(
                    "run_schedule_spmd(plan, mllm, ...) got no stage_fn "
                    "and will run the TOY stage model, not the MLLM; pass "
                    "stage_fn=\"toy\" to silence this, or real stage fns "
                    "(models.stages.build_mllm_stages) to execute the "
                    "model", stacklevel=2)
            stage_fn, stage_params = toy_stage_model(
                len(graph.stages), int(microbatches.shape[-1]), seed=seed,
                device=microbatches.device)
    else:
        stage_fn, stage_params, microbatches, graph, sim = args
        prog = program
    runner = build_spmd_runner(stage_fn, graph, sim, group=group,
                               microbatch_loss=microbatch_loss,
                               program=prog, trainable=trainable,
                               dispatch=dispatch)
    return runner(stage_params, microbatches)


def spmd_parity_report(executor: Dict[str, Any], *, d_model: int = 16,
                       seq: int = 4, seed: int = 0, group=None,
                       device="cuda") -> Dict[str, Any]:
    """Run one executor contract's timeline on both executors, the
    distributed runner and the one-process replay (on every rank), with
    the toy residual stage on ``device``, and report the parity: losses,
    the largest gradient difference over all stages, whether the
    measured peaks and activation traces agree, and the program's
    counts. Call on every rank, each with its own card (or
    ``device="cpu"`` on a gloo group); every rank gets the same
    report."""
    from repro_torch.core.modality_parallel import execute_schedule
    dev = resolve_device(device)
    group = _group_of(group)
    graph = executor["sim_graph"]
    sim = executor["schedule"]
    prog = executor.get("spmd_program")
    stage_fn, stage_params = toy_stage_model(len(graph.stages), d_model,
                                             seed=seed, device=dev)
    M = max(int(it[5]) for it in sim["items"]) + 1
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    microbatches = torch.randn((M, 1, seq, d_model), generator=gen,
                               device=dev)
    got = run_schedule_spmd(stage_fn, stage_params, microbatches, graph,
                            sim, group=group, program=prog)
    ref = execute_schedule(stage_fn, stage_params, microbatches, graph, sim)
    rank = got["rank"]
    hosted = got["program"].hosted[rank]
    diff = max((float((got["param_grads"]["w"][s]
                       - ref["param_grads"]["w"][s]).abs().max())
                for s in hosted), default=0.0)
    every: List[Any] = [None] * dist.get_world_size(group)
    dist.all_gather_object(every, diff, group=group)
    return {
        "loss_spmd": float(got["loss"]),
        "loss_replay": float(ref["loss"]),
        "max_grad_diff": max(every),
        "peaks_match": (got["peak_activations_per_device"]
                        == ref["peak_activations_per_device"]),
        "trace_match": got["activation_trace"] == ref["activation_trace"],
        "program": got["program"].counts(),
    }


def reference_dag_loss(stage_fn: Callable, stage_params: Any,
                       microbatches: Any, graph: PipelineGraph, *,
                       microbatch_loss: Optional[Callable] = None
                       ) -> Tuple[Any, Any]:
    """One-process autograd oracle for any stage DAG: the stages
    composed in topological order (sources read the microbatch, fan-in
    sums predecessor outputs, the loss sums over sinks), differentiated
    with ``torch.autograd.grad``. Returns (loss, stage-stacked grads)
    with the gradients of stages without weight work (``bwd_w == 0``)
    zeroed, as the executors never differentiate them."""
    loss_fn = microbatch_loss or (lambda y: torch.mean(y ** 2))
    S = len(graph.stages)
    preds, succs = graph.preds, graph.succs
    leaves = {k: v.detach().requires_grad_(True)
              for k, v in stage_params.items()}
    loss = torch.zeros((), dtype=torch.float32,
                       device=microbatches.device)
    with torch.enable_grad():
        for m in range(microbatches.shape[0]):
            ys: Dict[int, Any] = {}
            for s in range(S):                   # stages are topo-ordered
                lp = {k: v[s] for k, v in leaves.items()}
                x = microbatches[m] if not preds[s] else \
                    sum(ys[p] for p in preds[s])
                ys[s] = stage_fn(lp, x)
            for s in range(S):
                if not succs[s]:
                    loss = loss + loss_fn(ys[s])
        names = list(leaves)
        gs = torch.autograd.grad(loss, [leaves[k] for k in names])
    mask = torch.tensor([graph.stages[s].bwd_w > 0 for s in range(S)],
                        device=microbatches.device)
    grads = {k: torch.where(mask.reshape((S,) + (1,) * (g.ndim - 1)), g,
                            torch.zeros_like(g))
             for k, g in zip(names, gs)}
    return loss.detach(), grads

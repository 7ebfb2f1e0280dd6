"""schedlint: static validation of F/B/W pipeline-schedule timelines
(the counterpart of ``repro.analysis.schedlint``).

The simulator (``core.schedule.simulator``) emits a work-item timeline
of ``(start, end, device, kind, stage, microbatch)`` tuples. This module
checks its invariants before any rank runs, so that a wrong schedule is
a finding and not a deadlock or a race in the distributed runner
(``parallel.spmd``):

* ``fbw-order``        F(s,m) before B(s,m) before W(s,m)
* ``missing-item``     every (stage, microbatch) has its F and B; a
                       split timeline has a W for every trainable pair
* ``handoff-order``    consumer F after producer F; producer B after
                       consumer B
* ``device-overlap``   items on one device never overlap in time; a
                       zero-length item occupies no time
* ``frozen-no-w``      stages with no weight-grad work (bwd_w == 0)
                       emit no W item
* ``activation-cap``   the per-device live-activation walk stays inside
                       ``core.schedule.memory.activation_caps`` and never
                       goes negative
* ``peak-claim``       the claimed ``peak_activations_per_device``
                       matches the timeline it shipped with
* ``send-recv-cycle``  the async-send / blocking-recv lowering of the
                       timeline is acyclic (a cycle is a deadlock);
                       ``lint_spmd_program`` extends it to the emitted
                       wave program: a compute item whose cross-rank
                       input no earlier wave boundary delivers is a recv
                       that never completes
* ``ppermute-program`` the emitted comm rounds are partial permutations
                       (distinct sources, distinct destinations, no
                       self-send) that ship the buffer their source rank
                       produced in that very wave
* ``plan-consistency`` a serialized plan's components agree

Findings anchor on ``core.schedule.simulator.item_id`` strings, the ids
``MemoryModelMismatch``'s timeline diff uses. The findings equal the
reference's on every input but one class: the reference's
``device-overlap`` flags a zero-length item (a frozen stage's empty B)
that starts inside another item on its device; here it occupies no
time.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.schedule.graph import PipelineGraph
from repro_torch.core.schedule.memory import activation_caps
from repro_torch.core.schedule.simulator import Item, item_id

from .findings import Finding, Severity, finding, register_rule

register_rule("fbw-order", "schedlint",
              "F precedes B precedes W per (stage, microbatch)")
register_rule("missing-item", "schedlint",
              "every (stage, microbatch) has exactly one F and one B; "
              "split timelines carry a W per trainable pair")
register_rule("handoff-order", "schedlint",
              "consumer F starts after producer F ends; producer B "
              "starts after consumer B ends")
register_rule("device-overlap", "schedlint",
              "items on one device never overlap in time")
register_rule("frozen-no-w", "schedlint",
              "frozen stages (bwd_w == 0) emit zero W items")
register_rule("activation-cap", "schedlint",
              "per-device live activations stay inside the "
              "depth_from_end cap envelope and never go negative")
register_rule("peak-claim", "schedlint",
              "the simulator's claimed peak_activations_per_device "
              "matches its own timeline")
register_rule("send-recv-cycle", "schedlint",
              "the send/recv lowering of the timeline is acyclic "
              "(no point-to-point deadlock)")
register_rule("ppermute-program", "schedlint",
              "emitted comm rounds are valid partial permutations "
              "shipping the freshly produced buffer")
register_rule("plan-consistency", "schedlint",
              "a serialized plan's schedule/stage/context components "
              "agree with each other")

_EPS = 1e-9


def lint_timeline(graph: PipelineGraph, sim: Dict[str, Any], *,
                  location: str = "timeline") -> List[Finding]:
    """Run every schedlint timeline rule against one simulation dict
    (``items`` + ``device_of`` [+ ``peak_activations_per_device``]).
    ``graph`` must be the graph the items' stage indices refer to."""
    out: List[Finding] = []
    items: Sequence[Item] = sim["items"]
    device_of = list(sim["device_of"])
    S = len(graph.stages)
    loc = location

    def at(it: Item) -> str:
        return f"{loc}:{item_id(it)}"

    # -- index the timeline ------------------------------------------------
    by_key: Dict[Tuple[str, int, int], List[Item]] = defaultdict(list)
    mbs = set()
    for it in items:
        _s0, _e0, dev, kind, s, m = it
        if not (0 <= s < S):
            out.append(finding("missing-item", at(it),
                               f"stage index {s} outside the "
                               f"{S}-stage graph"))
            continue
        if dev != device_of[s]:
            out.append(finding("missing-item", at(it),
                               f"item placed on device {dev} but "
                               f"device_of[{s}] == {device_of[s]}"))
        by_key[(kind, s, m)].append(it)
        mbs.add(m)
    M = max(mbs) + 1 if mbs else 0
    has_w = any(k == "W" for (k, _s, _m) in by_key)

    # -- missing-item / duplicates ----------------------------------------
    for s in range(S):
        trainable_w = graph.stages[s].bwd_w > 0
        for m in range(M):
            for kind, required in (("F", True), ("B", True),
                                   ("W", has_w and trainable_w)):
                n = len(by_key.get((kind, s, m), ()))
                if required and n == 0:
                    out.append(finding(
                        "missing-item", f"{loc}:{kind}(s{s},m{m})",
                        f"no {kind} item for stage {s}, "
                        f"microbatch {m}"))
                elif n > 1:
                    out.append(finding(
                        "missing-item", f"{loc}:{kind}(s{s},m{m})",
                        f"{n} duplicate {kind} items"))

    # -- frozen-no-w -------------------------------------------------------
    for (kind, s, m), its in by_key.items():
        if kind == "W" and graph.stages[s].bwd_w <= 0:
            out.append(finding(
                "frozen-no-w", at(its[0]),
                f"stage {s} has bwd_w == 0 (frozen / no weight work) "
                f"but the timeline schedules a W pass"))

    def one(kind, s, m) -> Optional[Item]:
        its = by_key.get((kind, s, m), ())
        return its[0] if len(its) == 1 else None

    # -- fbw-order ---------------------------------------------------------
    for s in range(S):
        for m in range(M):
            f, b, w = one("F", s, m), one("B", s, m), one("W", s, m)
            if f and b and b[0] < f[1] - _EPS:
                out.append(finding(
                    "fbw-order", at(b),
                    f"B starts at {b[0]:g} before its F ends at "
                    f"{f[1]:g}"))
            if b and w and w[0] < b[1] - _EPS:
                out.append(finding(
                    "fbw-order", at(w),
                    f"W starts at {w[0]:g} before its B ends at "
                    f"{b[1]:g}"))

    # -- handoff-order (cross-stage data dependencies) ---------------------
    for (p, q) in graph.edges:
        for m in range(M):
            fp, fq = one("F", p, m), one("F", q, m)
            if fp and fq and fq[0] < fp[1] - _EPS:
                out.append(finding(
                    "handoff-order", at(fq),
                    f"consumer F(s{q},m{m}) starts at {fq[0]:g} "
                    f"before producer F(s{p},m{m}) ends at {fp[1]:g}"))
            bp, bq = one("B", p, m), one("B", q, m)
            if bp and bq and bp[0] < bq[1] - _EPS:
                out.append(finding(
                    "handoff-order", at(bp),
                    f"producer B(s{p},m{m}) starts at {bp[0]:g} "
                    f"before consumer B(s{q},m{m}) ends at "
                    f"{bq[1]:g}"))

    # -- device-overlap ----------------------------------------------------
    # a zero-length item (a frozen stage's empty B) occupies no time, so
    # it overlaps nothing even where float rounding starts it inside
    # another item
    per_dev: Dict[int, List[Item]] = defaultdict(list)
    for it in items:
        if it[1] - it[0] > _EPS:
            per_dev[it[2]].append(it)
    for dev, its in per_dev.items():
        its = sorted(its, key=lambda it: (it[0], it[1]))
        for a, b in zip(its, its[1:]):
            if b[0] < a[1] - _EPS:
                out.append(finding(
                    "device-overlap", at(b),
                    f"overlaps {item_id(a)} on device {dev} "
                    f"([{a[0]:g},{a[1]:g}] vs [{b[0]:g},{b[1]:g}])"))

    # -- activation-cap / peak-claim ---------------------------------------
    D = max(device_of) + 1 if device_of else 0
    caps = activation_caps(graph, device_of, M or None)
    occ = [0] * D
    peak = [0] * D
    ordered = sorted(items, key=lambda it: (it[0], it[3] != "B"))
    for it in ordered:
        _s0, _e0, dev, kind, s, m = it
        if not (0 <= s < S):
            continue
        d = device_of[s]
        if kind == "F":
            occ[d] += 1
            peak[d] = max(peak[d], occ[d])
            if occ[d] > caps[d]:
                out.append(finding(
                    "activation-cap", at(it),
                    f"live activations on device {d} reach {occ[d]}, "
                    f"over the cap envelope {caps[d]}"))
        elif kind == "B":
            occ[d] -= 1
            if occ[d] < 0:
                out.append(finding(
                    "activation-cap", at(it),
                    f"device {d} frees an activation it never "
                    f"held (occupancy {occ[d]})"))
                occ[d] = 0
    claimed = sim.get("peak_activations_per_device")
    if claimed is not None and list(claimed) != peak:
        out.append(finding(
            "peak-claim", loc,
            f"claimed peak activations {list(claimed)} != the "
            f"timeline's own walk {peak}"))

    out.extend(_check_send_recv_cycle(graph, items, device_of, loc))
    return out


# ---------------------------------------------------------------------------
# send/recv deadlock: rendezvous-lowering cycle check
# ---------------------------------------------------------------------------

def _check_send_recv_cycle(graph: PipelineGraph, items: Sequence[Item],
                           device_of: List[int], loc: str
                           ) -> List[Finding]:
    """Model the timeline as the program a point-to-point lowering
    would run and check it for deadlock.

    The lowering semantics: each cross-stage handoff becomes an async
    send on the producer's device and a blocking recv on the
    consumer's (the zero-bubble runtime's per-node send/recv model).
    A device executes its items in program order; an item's recv
    blocks until the producing item has run. Deadlock therefore
    happens exactly when the union of

    * program-order edges: consecutive items on one device (position
      in start-time order — the order the rank's program executes),
    * data edges: F(p,m) -> F(q,m) per graph edge (p,q);
      B(q,m) -> B(p,m); F(s,m) -> B(s,m); B(s,m) -> W(s,m)

    has a cycle — e.g. device 0 waits for a cotangent device 1 only
    produces after a forward device 0 scheduled later (the classic
    cross-wait). Found by topological sort, reported with the item ids
    on the cycle rather than by hanging an 8-rank job.
    """
    S = len(graph.stages)
    idx_of: Dict[Tuple[str, int, int], int] = {}
    for i, it in enumerate(items):
        _s0, _e0, _d, kind, s, m = it
        if 0 <= s < S:
            idx_of.setdefault((kind, s, m), i)

    n = len(items)
    adj: List[List[int]] = [[] for _ in range(n)]

    # program order + successor-on-device lookup
    per_dev: Dict[int, List[int]] = defaultdict(list)
    for i, it in enumerate(items):
        per_dev[it[2]].append(i)
    for dev, idxs in per_dev.items():
        idxs = sorted(idxs, key=lambda i: (items[i][0], i))
        for a, b in zip(idxs, idxs[1:]):
            adj[a].append(b)

    def data_edge(u_key, v_key):
        u, v = idx_of.get(u_key), idx_of.get(v_key)
        if u is not None and v is not None:
            adj[u].append(v)

    mbs = sorted({it[5] for it in items})
    for m in mbs:
        for (p, q) in graph.edges:
            data_edge(("F", p, m), ("F", q, m))
            data_edge(("B", q, m), ("B", p, m))
        for s in range(S):
            data_edge(("F", s, m), ("B", s, m))
            data_edge(("B", s, m), ("W", s, m))

    # Kahn topological sort; leftovers participate in (or depend on) a
    # cycle — report a concrete cycle found by DFS among them
    indeg = [0] * n
    for u in range(n):
        for v in adj[u]:
            indeg[v] += 1
    queue = [u for u in range(n) if indeg[u] == 0]
    seen = 0
    while queue:
        u = queue.pop()
        seen += 1
        for v in adj[u]:
            indeg[v] -= 1
            if indeg[v] == 0:
                queue.append(v)
    if seen == n:
        return []
    stuck = [u for u in range(n) if indeg[u] > 0]
    cycle = _find_cycle(adj, stuck)
    ids = " -> ".join(item_id(items[i]) for i in cycle)
    return [finding(
        "send-recv-cycle", loc,
        f"send/recv lowering deadlocks; dependency cycle: "
        f"{ids} -> {item_id(items[cycle[0]])}" if cycle else
        f"send/recv lowering deadlocks "
        f"({len(stuck)} items never become runnable)")]


def _find_cycle(adj: List[List[int]], nodes: List[int]) -> List[int]:
    in_cycle = set(nodes)
    color: Dict[int, int] = {}
    stack: List[int] = []

    def dfs(u: int) -> Optional[List[int]]:
        color[u] = 1
        stack.append(u)
        for v in adj[u]:
            if v not in in_cycle:
                continue
            if color.get(v, 0) == 1:
                return stack[stack.index(v):]
            if color.get(v, 0) == 0:
                got = dfs(v)
                if got is not None:
                    return got
        color[u] = 2
        stack.pop()
        return None

    for u in nodes:
        if color.get(u, 0) == 0:
            got = dfs(u)
            if got is not None:
                return got
    return []


# ---------------------------------------------------------------------------
# Emitted SPMD program lint (parallel.spmd's waves and comm rounds)
# ---------------------------------------------------------------------------

def lint_spmd_program(program: Any, *,
                      location: str = "spmd-program") -> List[Finding]:
    """Validate the emitted SPMD program, the waves and comm rounds
    ``parallel.spmd.compile_spmd_program`` produced and the distributed
    runner executes, not the timeline model it came from.

    Three families of checks:

    * each comm round is a legal partial permutation (each rank sends
      at most one tensor and receives at most one in the round's one
      ``batch_isend_irecv``):
      distinct sources, distinct destinations, no self-sends
      (``ppermute-program``);
    * each round ships a FRESH buffer: the executor holds one forward
      send buffer and one cotangent send buffer per device, overwritten
      by every wave, so a round attached to wave w must ship exactly
      what its source device computed in wave w — anything else sends
      stale garbage (``ppermute-program``);
    * delivery-before-use: a compute item consuming a cross-device
      input (consumer F needing a remote predecessor's activation,
      producer B needing a remote successor's cotangent) must have that
      value delivered by a round at a STRICTLY earlier wave boundary.
      In the blocking-recv lowering this is the deadlock condition — a
      recv with no matching earlier send never unblocks
      (``send-recv-cycle``).
    """
    out: List[Finding] = []
    graph = program.graph
    device_of = program.device_of
    preds, succs = graph.preds, graph.succs
    delivered: set = set()              # (kind, dst_stage, src_stage, m)

    def produced(kind: str) -> str:
        return "F" if kind == "fwd" else "B"

    for w, wave in enumerate(program.waves):
        # -- consumers first: wave-w rounds run AFTER wave-w compute --
        for dev, (i, kind, s, _c, m) in sorted(wave.compute.items()):
            it = program.items[i]
            if kind == "F":
                needed = [("fwd", s, p, m) for p in preds[s]
                          if device_of[p] != dev]
            elif kind == "B":
                needed = [("bwd", s, q, m) for q in succs[s]
                          if device_of[q] != dev
                          and graph.stages[q].bwd_b > 0]
            else:
                needed = []
            for key in needed:
                if key not in delivered:
                    knd, dst_s, src_s, mb = key
                    what = "activation" if knd == "fwd" else "cotangent"
                    out.append(finding(
                        "send-recv-cycle",
                        f"{location}:wave{w}:{item_id(it)}",
                        f"blocking recv never satisfied: consumes the "
                        f"{what} of stage {src_s} (microbatch {mb}) "
                        f"from device {device_of[src_s]}, but no "
                        f"earlier wave boundary delivers it to device "
                        f"{dev}"))
        for r, rnd in enumerate(wave.rounds):
            at = f"{location}:wave{w}:round{r}"
            srcs = [t.src_dev for t in rnd.transfers]
            dsts = [t.dst_dev for t in rnd.transfers]
            if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts):
                out.append(finding(
                    "ppermute-program", at,
                    f"round is not a partial permutation: sources "
                    f"{srcs}, destinations {dsts} (duplicates)"))
            for t in rnd.transfers:
                if t.src_dev == t.dst_dev:
                    out.append(finding(
                        "ppermute-program", at,
                        f"self-send on device {t.src_dev} (stage "
                        f"{t.src_stage} -> {t.dst_stage}); local "
                        f"handoffs go through the store, not a send"))
                want = (produced(rnd.kind), t.src_stage, t.microbatch)
                have = wave.compute.get(t.src_dev)
                if have is None or have[1:3] + (have[4],) != want:
                    have_id = item_id(program.items[have[0]]) \
                        if have is not None else "nothing"
                    out.append(finding(
                        "ppermute-program", at,
                        f"stale send buffer: round ships "
                        f"{want[0]}(s{want[1]},m{want[2]})'s output "
                        f"from device {t.src_dev}, whose wave-{w} "
                        f"compute is {have_id}"))
                delivered.add((rnd.kind, t.dst_stage, t.src_stage,
                               t.microbatch))
    return out


# ---------------------------------------------------------------------------
# Plan-level lint (serialized MLLMParallelPlan JSONs)
# ---------------------------------------------------------------------------

def lint_plan(plan: Any, *, location: str = "plan") -> List[Finding]:
    """Consistency checks over a typed ``MLLMParallelPlan`` (no model
    needed): the components a launch script trusts must agree with each
    other before anything is instantiated against real devices."""
    out: List[Finding] = []
    sc, st, cx = plan.schedule, plan.stage, plan.context
    if len(sc.peak_activations_per_device) != sc.num_devices:
        out.append(finding(
            "plan-consistency", location,
            f"schedule claims {sc.num_devices} devices but "
            f"{len(sc.peak_activations_per_device)} peak-activation "
            f"entries"))
    if not (0.0 <= sc.bubble_fraction < 1.0):
        out.append(finding(
            "plan-consistency", location,
            f"bubble_fraction {sc.bubble_fraction} outside [0, 1)"))
    if sc.iteration_time <= 0:
        out.append(finding(
            "plan-consistency", location,
            f"non-positive iteration_time {sc.iteration_time}"))
    if sc.num_devices % st.num_devices != 0:
        out.append(finding(
            "plan-consistency", location,
            f"simulated device count {sc.num_devices} is not a "
            f"multiple of the stage plan's {st.num_devices} pipeline "
            f"ranks"))
    if cx is not None:
        ranks = set(range(cx.num_ranks))
        used = set(cx.assignment)
        if not used <= ranks:
            out.append(finding(
                "plan-consistency", location,
                f"context assignment references ranks "
                f"{sorted(used - ranks)} outside 0..{cx.num_ranks - 1}"))
        elif len(cx.assignment) >= cx.num_ranks and used != ranks:
            out.append(finding(
                "plan-consistency", location,
                f"context assignment leaves ranks "
                f"{sorted(ranks - used)} idle with "
                f"{len(cx.assignment)} blocks to hand out",
                severity=Severity.WARNING))
        if any(l < 0 for l in cx.loads):
            out.append(finding(
                "plan-consistency", location,
                f"negative context loads {list(cx.loads)}"))
    return out


def lint_executor_contract(executor: Dict[str, Any], *,
                           location: str = "executor") -> List[Finding]:
    """Lint the timeline inside an executor contract
    (``MLLMParallelPlan.apply`` / ``build_executor_plan`` output). The
    contract's ``sim_graph`` is the graph the simulation items index
    into (the folded ``graph`` can be coarser for chunked schedules)."""
    graph = executor.get("sim_graph") or executor["graph"]
    sim = executor["schedule"]
    mx = max((it[4] for it in sim["items"]), default=-1)
    if mx >= len(graph.stages):
        return [finding(
            "plan-consistency", location,
            f"executor contract carries no graph matching its "
            f"timeline (stage index {mx} vs {len(graph.stages)} "
            f"stages)")]
    out = lint_timeline(graph, sim, location=location)
    program = executor.get("spmd_program")
    if program is not None:
        # an SPMD-mode contract ships the compiled wave program: lint
        # what will run, not only the model
        out += lint_spmd_program(program,
                                 location=f"{location}:spmd")
    return out

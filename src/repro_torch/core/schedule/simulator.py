"""Generic discrete-event pipeline-schedule simulator over F/B/W items
(the port's own copy of ``repro.core.schedule.simulator``; its float
arithmetic is the reference's, operation for operation, so timelines,
device maps and peaks come out equal).

Work items per (stage s, microbatch m):

    F(s, m)  forward — ready when F(p, m) done for every pred p
    B(s, m)  input-grad backward — ready when F(s, m) done and
             B(q, m) done for every succ q; blocks upstream B
    W(s, m)  weight-grad backward — ready when B(s, m) done; blocks
             ONLY the optimizer step (i.e. the end of the iteration),
             never another stage's compute

With ``split_bw=False`` the classic monolithic backward is modeled: B
runs with duration ``bwd`` (= B + W glued together) and no separate W
items exist — byte-for-byte the legacy 1F1B simulation.

With ``split_bw=True`` the event loop schedules only the F/B critical
path (B with duration ``bwd_b``), then a second phase packs the
deferred W passes (ZB-H1 style) into each device's recorded idle gaps
and tail. Because F/B placements are already fixed, a W can never delay
compute on the critical path — the insertion is exact, not heuristic.
Frozen stages have ``bwd_w == 0`` and contribute no W items at all.

``device_of`` maps stage index -> device index (default: identity, one
stage per device). Passing a many-to-one map simulates interleaved
(virtual-stage) schedules, where one device round-robins between its
chunks.

Activation-memory policy: a stage admits a new forward only while its
in-flight microbatches (forwards issued minus backwards issued) stay
below ``depth_from_end`` — exactly 1F1B's memory cap. ZB-H1 inherits
the same cap (its defining property: zero-bubble gains at 1F1B memory).

Every simulation also returns its full work-item timeline (``items``:
``(start, end, device, kind, stage, microbatch)`` tuples, sorted in a
dependency-respecting execution order), the stage->device map it ran
under (``device_of``), and the measured per-device peak of live
activations (``peak_activations_per_device``). An activation is live
from the execution of F(s, m) until the execution of B(s, m) — the
inter-stage residual the input-grad pass consumes. These three fields
feed the memory-validation harness (``core.schedule.memory``), which
replays the same timeline on the real executor and cross-checks the
peaks against ``depth_from_end``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .graph import PipelineGraph

Item = Tuple[float, float, int, str, int, int]
_KIND_RANK = {"B": 0, "F": 1, "W": 2}


def item_id(item: Item) -> str:
    """Stable human-readable id for one timeline item — the anchor
    shared by the reference's schedlint findings and the
    memory-validation timeline diff (``core.schedule.memory``)."""
    _start, _end, dev, kind, stage, mb = item
    return f"{kind}(s{stage},m{mb})@d{dev}"


def sort_items(items: List[Item]) -> List[Item]:
    """Dependency-respecting total order: by start time; at equal start
    (only possible through zero-duration frozen B passes) B before F
    before W, B chains in reverse stage order (successor's B feeds the
    predecessor's), F chains in forward stage order."""
    def key(it):
        start, _end, _dev, kind, stage, mb = it
        return (start, _KIND_RANK[kind],
                -stage if kind == "B" else stage, mb)
    return sorted(items, key=key)


def peak_live_activations(items: List[Item], num_devices: int
                          ) -> List[int]:
    """Per-device peak number of live activations over an item
    timeline. F(s, m) materializes one activation on its device;
    B(s, m) consumes it (W passes read per-layer weight-grad residuals
    accounted to the W item itself, not this store — the simplification
    the module docstring spells out). Items on one device never overlap
    in time, so the per-device prefix-sum walk is exact."""
    occ = [0] * num_devices
    peak = [0] * num_devices
    for _start, _end, dev, kind, _stage, _mb in items:
        if kind == "F":
            occ[dev] += 1
            peak[dev] = max(peak[dev], occ[dev])
        elif kind == "B":
            occ[dev] -= 1
    return peak


def run_schedule(graph: PipelineGraph, num_microbatches: int, *,
                 device_of: Optional[List[int]] = None,
                 split_bw: bool = False,
                 stage_caps: Optional[List[int]] = None
                 ) -> Dict[str, object]:
    """Greedy earliest-start list scheduling (deterministic). Returns
    iteration time (optimizer-step start: all B AND W complete),
    per-device busy time, bubble fraction, device count.

    ``stage_caps`` overrides the per-stage ``depth_from_end`` in-flight
    bound (clamped to it from above, floored at 1 so the no-deadlock
    guarantee of per-stage caps >= 1 holds). Folded placements need
    tighter caps: per-stage depth caps are exact for one stage per
    device, but their per-device SUM exceeds the 1F1B envelope once a
    device hosts several chunks — ZB-V passes V-shaped caps here to
    keep its 1F1B memory-parity claim honest."""
    S = len(graph.stages)
    M = num_microbatches
    preds, succs = graph.preds, graph.succs
    cap = [graph.depth_from_end(i) for i in range(S)]
    if stage_caps is not None:
        assert len(stage_caps) == S
        cap = [max(1, min(cap[i], int(stage_caps[i]))) for i in range(S)]
    if device_of is None:
        device_of = list(range(S))
    assert len(device_of) == S
    D = max(device_of) + 1

    assert all(0.0 <= st.bwd_w <= st.bwd + 1e-12 for st in graph.stages), \
        "stage bwd_w (weight-grad share) must lie within [0, bwd]"
    b_dur = [st.bwd_b if split_bw else st.bwd for st in graph.stages]

    fwd_done = [[None] * M for _ in range(S)]    # completion times
    bwd_done = [[None] * M for _ in range(S)]
    dev_free = [0.0] * D
    fwd_issued = [0] * S
    bwd_issued = [0] * S
    busy = [0.0] * D
    intervals = [[] for _ in range(D)]           # per-device (start, end)
    items: List[Item] = []
    finish = 0.0                                 # max B completion

    def fwd_ready_at(s, m):
        ts = [fwd_done[p][m] for p in preds[s]]
        if any(t is None for t in ts):
            return None
        return max(ts, default=0.0)

    def bwd_ready_at(s, m):
        if fwd_done[s][m] is None:
            return None
        ts = [bwd_done[q][m] for q in succs[s]]
        if any(t is None for t in ts):
            return None
        return max(ts + [fwd_done[s][m]])

    # -- phase 1: F/B critical path (event loop) ---------------------------
    remaining = 2 * S * M
    guard = 0
    while remaining > 0:
        guard += 1
        if guard > 16 * S * M + 64:
            raise RuntimeError("simulator deadlock")
        # choose the globally earliest-startable item (greedy list sched;
        # backward preferred on ties — the 1F1B policy)
        candidates = []
        for s in range(S):
            d = device_of[s]
            m = bwd_issued[s]
            if m < M:
                r = bwd_ready_at(s, m)
                if r is not None:
                    candidates.append((max(r, dev_free[d]), 0, s, "B", m))
            m = fwd_issued[s]
            if m < M and fwd_issued[s] - bwd_issued[s] < cap[s]:
                r = fwd_ready_at(s, m)
                if r is not None:
                    candidates.append((max(r, dev_free[d]), 1, s, "F", m))
        if not candidates:
            raise RuntimeError("simulator stalled (bad graph?)")
        start, _, s, kind, m = min(candidates)
        d = device_of[s]
        dur = graph.stages[s].fwd if kind == "F" else b_dur[s]
        end = start + dur
        dev_free[d] = end
        busy[d] += dur
        intervals[d].append((start, end))
        items.append((start, end, d, kind, s, m))
        if kind == "F":
            fwd_done[s][m] = end
            fwd_issued[s] += 1
        else:
            bwd_done[s][m] = end
            bwd_issued[s] += 1
            finish = max(finish, end)
        remaining -= 1

    # -- phase 2: pack deferred W passes into idle gaps (ZB-H1) ------------
    if split_bw:
        for d in range(D):
            gaps = []
            prev = 0.0
            for a, b in intervals[d]:            # already time-ordered
                if a > prev + 1e-12:
                    gaps.append([prev, a])
                prev = b
            tail = prev
            ws = sorted((bwd_done[s][m], s, m)
                        for s in range(S)
                        if device_of[s] == d and graph.stages[s].bwd_w > 0
                        for m in range(M))
            for ready, s, m in ws:
                dur = graph.stages[s].bwd_w
                end = None
                for g in gaps:
                    st = max(g[0], ready)
                    if st + dur <= g[1] + 1e-12:
                        end = st + dur
                        g[0] = end               # consume the gap prefix
                        break
                if end is None:                  # append to the tail
                    tail = max(tail, ready) + dur
                    end = tail
                busy[d] += dur
                items.append((end - dur, end, d, "W", s, m))
                finish = max(finish, end)

    items = sort_items(items)
    total = finish
    bubble = 1.0 - (sum(busy) / (D * total)) if total > 0 else 0.0
    return {"iteration_time": float(total),
            "bubble_fraction": float(bubble),
            "per_device_busy": busy,
            "num_devices": D,
            "device_of": list(device_of),
            "items": items,
            "peak_activations_per_device":
                peak_live_activations(items, D)}


def is_chain(graph: PipelineGraph) -> bool:
    """True when the graph is a linear chain 0 -> 1 -> ... -> S-1.
    Edge ORDER is irrelevant — constructors like build_modality_parallel
    append cross-module edges last, so a single-encoder MLLM graph is
    a chain whose edge list is merely unsorted."""
    return sorted(graph.edges) == [(i, i + 1)
                                   for i in range(len(graph.stages) - 1)]


def _interleaved_order(D: int, v: int, M: int):
    """Megatron-LM's interleaved-1F1B per-device item order (schedules.
    py, forward_backward_pipelining_with_interleaving), in simulator
    units: device d owns chunk c's stage ``c*D + d``; forwards walk
    chunks in groups of D microbatches; backwards walk chunks in
    reverse. Requires M % D == 0."""
    total = M * v
    orders = []
    for d in range(D):
        def fitem(k):
            return ("F", (k // D) % v, (k // (D * v)) * D + (k % D))

        def bitem(j):
            return ("B", v - 1 - ((j // D) % v),
                    (j // (D * v)) * D + (j % D))

        warmup = min((D - d - 1) * 2 + (v - 1) * D, total)
        seq = [fitem(k) for k in range(warmup)]
        j = 0
        for k in range(warmup, total):        # steady 1F1B: F then B
            seq.append(fitem(k))
            seq.append(bitem(j))
            j += 1
        seq.extend(bitem(jj) for jj in range(j, total))   # cooldown
        orders.append(seq)
    return orders


def run_interleaved(graph: PipelineGraph, num_microbatches: int,
                    virtual_chunks: int) -> Dict[str, object]:
    """Simulate Megatron's interleaved-1F1B order on a CHAIN graph of
    S = v*D stages folded onto D devices. Unlike the greedy list
    scheduler, each device executes its fixed item sequence (warmup
    forwards in chunk-rotation order, 1F1B steady state, cooldown),
    which is what realizes the ~v-fold fill/drain bubble reduction.
    Caller guarantees: chain graph, S % v == 0, M % D == 0."""
    S = len(graph.stages)
    M = num_microbatches
    v = virtual_chunks
    D = S // v
    preds, succs = graph.preds, graph.succs

    fwd_done = [[None] * M for _ in range(S)]
    bwd_done = [[None] * M for _ in range(S)]
    dev_free = [0.0] * D
    busy = [0.0] * D
    items: List[Item] = []
    finish = 0.0
    orders = _interleaved_order(D, v, M)
    ptr = [0] * D

    def ready_at(d):
        kind, c, m = orders[d][ptr[d]]
        s = c * D + d
        if kind == "F":
            ts = [fwd_done[p][m] for p in preds[s]]
            if any(t is None for t in ts):
                return None
            return max(ts, default=0.0)
        if fwd_done[s][m] is None:
            return None
        ts = [bwd_done[q][m] for q in succs[s]]
        if any(t is None for t in ts):
            return None
        return max(ts + [fwd_done[s][m]])

    remaining = 2 * S * M
    while remaining > 0:
        candidates = []
        for d in range(D):
            if ptr[d] < len(orders[d]):
                r = ready_at(d)
                if r is not None:
                    candidates.append((max(r, dev_free[d]), d))
        if not candidates:
            raise RuntimeError("interleaved schedule deadlock (bad order)")
        start, d = min(candidates)
        kind, c, m = orders[d][ptr[d]]
        s = c * D + d
        dur = graph.stages[s].fwd if kind == "F" else graph.stages[s].bwd
        end = start + dur
        dev_free[d] = end
        busy[d] += dur
        items.append((start, end, d, kind, s, m))
        if kind == "F":
            fwd_done[s][m] = end
        else:
            bwd_done[s][m] = end
            finish = max(finish, end)
        ptr[d] += 1
        remaining -= 1

    items = sort_items(items)
    total = finish
    bubble = 1.0 - (sum(busy) / (D * total)) if total > 0 else 0.0
    return {"iteration_time": float(total),
            "bubble_fraction": float(bubble),
            "per_device_busy": busy,
            "num_devices": D,
            "device_of": [s % D for s in range(S)],
            "items": items,
            "peak_activations_per_device":
                peak_live_activations(items, D)}

"""The four pipeline schedulers behind one interface (the port's own
copy of ``repro.core.schedule.schedulers``).

``Scheduler.simulate(graph, num_microbatches)`` -> dict with
iteration_time / bubble_fraction / per_device_busy / num_devices /
schedule / virtual_chunks, plus the item timeline and per-device peak
activations the simulator instruments (see ``simulator``). Construct
via :func:`get_scheduler` or iterate :data:`SCHEDULES`.
"""
from __future__ import annotations

from typing import Dict

from .graph import PipelineGraph, interleave_devices, v_shape_devices
from .simulator import is_chain, run_interleaved, run_schedule


class Scheduler:
    """One pipeline schedule policy, evaluated by simulation."""
    name = "base"

    def simulate(self, graph: PipelineGraph, num_microbatches: int
                 ) -> Dict[str, object]:
        raise NotImplementedError

    def _tag(self, sim: Dict[str, object],
             virtual_chunks: int = 1) -> Dict[str, object]:
        sim["schedule"] = self.name
        sim["virtual_chunks"] = virtual_chunks
        return sim


class OneFOneB(Scheduler):
    """Classic 1F1B: one stage per device, monolithic backward (W glued
    immediately after B)."""
    name = "1f1b"

    def simulate(self, graph, num_microbatches):
        return self._tag(run_schedule(graph, num_microbatches))


class Interleaved1F1B(Scheduler):
    """Interleaved 1F1B (Megatron virtual stages): device d hosts
    chunks {d, d+D, ...} of the stage chain, shrinking the pipeline
    fill/drain bubble by ~the chunk count at the price of holding more
    in-flight activations per device.

    On a chain whose stage count divides by v and whose microbatch
    count divides by D, this simulates Megatron's exact per-device item
    order (warmup forwards in chunk-rotation groups, 1F1B steady state,
    cooldown) — the ordering that actually realizes the bubble win.
    Otherwise (DAG graphs, ragged counts) it degrades to greedy list
    scheduling over the folded device map."""
    name = "interleaved"

    def __init__(self, virtual_chunks: int = 2):
        assert virtual_chunks >= 1
        self.virtual_chunks = virtual_chunks

    def simulate(self, graph, num_microbatches):
        S = len(graph.stages)
        v = self.virtual_chunks
        if v > 1 and S % v == 0 and is_chain(graph) and \
                num_microbatches % (S // v) == 0:
            return self._tag(run_interleaved(graph, num_microbatches, v),
                             virtual_chunks=v)
        dev = interleave_devices(graph, v)
        return self._tag(run_schedule(graph, num_microbatches,
                                      device_of=dev), virtual_chunks=v)


class ZBH1(Scheduler):
    """ZB-H1-style zero-bubble schedule: backward splits into B
    (input-grad, critical path) and W (weight-grad, deferred); W passes
    fill bubbles under the same activation-memory cap as 1F1B. Frozen
    stages have no W at all, so on frozen-heavy MLLMs the B passes
    shorten (bwd_b <= bwd) while trainable stages soak their W into the
    drain phase.

    Like the offline schedule constructors in the zero-bubble papers,
    this picks the better of the two valid executions it knows: the
    split/deferred placement, and the glued one (W immediately after B,
    = 1F1B). Greedy list scheduling is not monotone in task durations,
    so on rare graphs splitting B can reorder the F/B path for the
    worse; the fallback guarantees ZB-H1 is never scheduled worse than
    1F1B."""
    name = "zb-h1"

    def simulate(self, graph, num_microbatches):
        if not any(st.bwd_w > 0 for st in graph.stages):
            # nothing to defer: split and glued are byte-identical
            return self._tag(run_schedule(graph, num_microbatches))
        split = run_schedule(graph, num_microbatches, split_bw=True)
        glued = run_schedule(graph, num_microbatches)
        best = split if split["iteration_time"] <= \
            glued["iteration_time"] else glued
        return self._tag(best)


class ZBV(Scheduler):
    """ZB-V zero-bubble schedule (Qi et al. 2023, the V placement): the
    stage chain is cut into 2p chunk-stages folded onto p devices in a
    V — device i hosts chunks i and 2p-1-i, so the forward walks down
    the device column and back up. The LAST chunk sits on device 0,
    which therefore starts its backward as soon as its own forward ramp
    finishes (no drain wait), and the deferred W passes fill BOTH ramps
    of the V. Backward is B/W-split as in ZB-H1; frozen chunks have no
    W at all, so on frozen-heavy MLLM chains the ramp-filling headroom
    concentrates exactly on the trainable (usually LLM) chunks —
    Cornstarch's frozen-aware costs compose with the V for free.

    Like ZBH1 this picks the better of the split and glued placements
    on the same V device map (greedy list scheduling is not monotone in
    task durations), so zb-v is never scheduled worse than its own
    glued execution. On non-chain (modality-parallel DAG) graphs or odd
    stage counts the exact V map is undefined; the scheduler degrades
    to the round-robin two-chunk fold. ``virtual_chunks=1`` is the
    degenerate one-chunk-per-device placement, i.e. ZB-H1.
    """
    name = "zb-v"

    def __init__(self, virtual_chunks: int = 2):
        assert virtual_chunks in (1, 2), \
            "zb-v places exactly two chunks per device (or the v=1 " \
            "degenerate)"
        self.virtual_chunks = virtual_chunks

    def simulate(self, graph, num_microbatches):
        S = len(graph.stages)
        dev, caps = None, None
        v = self.virtual_chunks
        if v == 2 and S >= 2:
            if S % 2 == 0 and is_chain(graph):
                dev = v_shape_devices(S)
                # 1F1B memory parity: the deepest 1F1B device holds one
                # coarse activation per pipeline rank = 2p chunk-stage
                # activations per device. The depth_from_end caps of
                # device i's two chunks sum to (2p-i) + (i+1) = 2p+1 —
                # one chunk over the envelope — so shave the down-chunk
                # (the one with slack) by one: 2p-i-1 down, i+1 up.
                # Every cap stays >= 1 (bottom device's down-chunk gets
                # p), preserving the no-deadlock guarantee
                p = S // 2
                caps = [2 * p - dev[s] - 1 if s < p else dev[s] + 1
                        for s in range(S)]
            else:
                dev = interleave_devices(graph, 2)
        split = run_schedule(graph, num_microbatches, device_of=dev,
                             split_bw=True, stage_caps=caps) \
            if any(st.bwd_w > 0 for st in graph.stages) else None
        glued = run_schedule(graph, num_microbatches, device_of=dev,
                             stage_caps=caps)
        best = glued if split is None or glued["iteration_time"] < \
            split["iteration_time"] else split
        return self._tag(best, virtual_chunks=v if dev is not None else 1)


SCHEDULES = ("1f1b", "interleaved", "zb-h1", "zb-v")


def get_scheduler(name: str, **kwargs) -> Scheduler:
    """Factory: '1f1b' | 'interleaved' | 'zb-h1' | 'zb-v' (kwargs
    forwarded, e.g. virtual_chunks for interleaved/zb-v)."""
    registry = {"1f1b": OneFOneB, "interleaved": Interleaved1F1B,
                "zb-h1": ZBH1, "zb-v": ZBV}
    try:
        cls = registry[name]
    except KeyError:
        raise ValueError(
            f"unknown schedule {name!r}; pick from {SCHEDULES}") from None
    return cls(**kwargs)


def simulate(graph: PipelineGraph, num_microbatches: int,
             schedule: str = "1f1b", **kwargs) -> Dict[str, object]:
    """One-shot convenience wrapper around get_scheduler(...).simulate."""
    return get_scheduler(schedule, **kwargs).simulate(graph,
                                                      num_microbatches)

"""Simulator-vs-executor validation of the activation-memory model (the
counterpart of ``repro.core.schedule.memory``).

The discrete-event simulator (``simulator.run_schedule``) admits a
forward only while the stage's in-flight microbatches stay below
``depth_from_end`` and reports the per-device peak of live activations
its timeline reaches (``peak_activations_per_device``). This module
checks that model against measurement: ``execute_schedule``
(``core.modality_parallel``) replays the same item timeline with real
forwards and real B/W passes, holding every inter-stage activation in an
explicit store filled at F and drained at B, and reports the store's
peak per device.

``validate_schedule_memory`` raises :class:`MemoryModelMismatch` when
the measured peak differs from the simulated one on any device (they
must match exactly: both count the same unit off the same timeline), or
when a measured peak exceeds the ``depth_from_end`` cap envelope
(``activation_caps``). The unit is one inter-stage activation; deferred
W passes park their operands in a separate W-residual store, reported
and not capped.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .graph import PipelineGraph
from .schedulers import get_scheduler
from .simulator import item_id


class MemoryModelMismatch(AssertionError):
    """The simulator's activation-memory claim diverged from the
    executor's measurement (or breached its own cap).
    ``first_divergence`` is ``(item_id, simulated_live, replayed_live,
    simulated_bytes, replayed_bytes)`` for the first item where they
    disagree, or None when the timelines agree item for item and only
    the summary claim is wrong."""

    def __init__(self, message: str,
                 first_divergence: Optional[Tuple] = None):
        super().__init__(message)
        self.first_divergence = first_divergence


def simulated_activation_trace(graph: PipelineGraph,
                               sim: Dict[str, object]) -> List[tuple]:
    """The simulator-side per-item activation walk, in replay order:
    ``(item_id, device, live_after)`` per item, +1 at F and -1 at B on
    the stage's device (the model ``execute_schedule`` measures)."""
    device_of = list(sim["device_of"])  # type: ignore[arg-type]
    occ: Dict[int, int] = {}
    trace: List[tuple] = []
    for item in sim["items"]:           # type: ignore[union-attr]
        _s0, _e0, dev, kind, s, _m = item
        d = device_of[s]
        if kind == "F":
            occ[d] = occ.get(d, 0) + 1
        elif kind == "B":
            occ[d] = occ.get(d, 0) - 1
        trace.append((item_id(item), dev, occ.get(dev, 0)))
    return trace


def diff_activation_traces(sim_trace: Sequence[tuple],
                           exe_trace: Sequence[tuple],
                           nbytes: int) -> Optional[Tuple]:
    """First item where the simulated walk and the replayed measurement
    disagree, as ``(item_id, sim_live, exe_live, sim_bytes,
    exe_bytes)``; None when they agree item for item."""
    for (sid, _sd, sc), (eid, _ed, ec) in zip(sim_trace, exe_trace):
        if sid != eid or sc != ec:
            return (sid if sid == eid else f"{sid} vs {eid}",
                    sc, ec, sc * nbytes, ec * nbytes)
    if len(sim_trace) != len(exe_trace):
        longer = sim_trace if len(sim_trace) > len(exe_trace) \
            else exe_trace
        extra = longer[min(len(sim_trace), len(exe_trace))]
        return (extra[0], len(sim_trace), len(exe_trace), -1, -1)
    return None


def activation_caps(graph: PipelineGraph,
                    device_of: Optional[Sequence[int]] = None,
                    num_microbatches: Optional[int] = None) -> List[int]:
    """Per-device in-flight activation cap: the sum over hosted stages
    of ``depth_from_end``, each bounded by the microbatch count. One
    stage per device when ``device_of`` is None."""
    S = len(graph.stages)
    if device_of is None:
        device_of = list(range(S))
    D = max(device_of) + 1
    caps = [0] * D
    for s in range(S):
        d = graph.depth_from_end(s)
        if num_microbatches is not None:
            d = min(d, num_microbatches)
        caps[device_of[s]] += d
    return caps


def toy_stage_model(num_stages: int, num_microbatches: int, *,
                    d_model: int = 16, batch: int = 1, seq: int = 4,
                    generator: Optional[torch.Generator] = None,
                    device="cpu"):
    """A residual stage ``x + tanh(x W)`` with one [d, d] weight per
    stage, stacked {"w": [S, d, d]} (f32, requires grad), and
    microbatches [M, batch, seq, d] drawn from ``generator``: enough to
    exercise real forwards, real input-grad and weight-grad passes and
    real activation buffers."""
    gen = generator or torch.Generator(device=device).manual_seed(0)
    w = torch.randn((num_stages, d_model, d_model), generator=gen,
                    device=device) * 0.1
    mbs = torch.randn((num_microbatches, batch, seq, d_model),
                      generator=gen, device=device)

    def stage_fn(lp, x):
        return x + torch.tanh(x @ lp["w"])

    return stage_fn, {"w": w.requires_grad_(True)}, mbs


def validate_schedule_memory(graph: PipelineGraph, num_microbatches: int,
                             schedule: str = "1f1b", *,
                             virtual_chunks: Optional[int] = None,
                             d_model: int = 16, batch: int = 1,
                             seq: int = 4,
                             generator: Optional[torch.Generator] = None,
                             stage_fn=None, stage_params=None,
                             microbatches=None,
                             sim: Optional[Dict[str, object]] = None,
                             executor: str = "replay",
                             group=None,
                             claim_sim: Optional[Dict[str, object]] = None
                             ) -> Dict[str, object]:
    """Simulate ``schedule`` on ``graph``, replay the timeline on the
    real executor, and cross-check the activation-memory claims.

    Without a model, ``toy_stage_model`` is built from ``generator``
    (default: a CPU generator seeded 0). A precomputed ``sim`` skips the
    scheduler call; ``claim_sim`` lets the claimed timeline differ from
    the executed one. ``executor`` is ``"replay"`` (``execute_schedule``
    in this process) or ``"spmd"`` (``parallel.spmd.run_schedule_spmd``
    on the ranks of ``group``, default the default process group, one
    rank per simulated device; call it on every rank, each with the same
    model and microbatches, and each checks the reassembled trace).
    Raises :class:`MemoryModelMismatch` on any divergence; returns the
    comparison report otherwise."""
    from repro_torch.core.modality_parallel import execute_schedule

    if executor not in ("replay", "spmd"):
        raise ValueError(f"unknown executor {executor!r}; pick "
                         f"'replay' or 'spmd'")
    if sim is None:
        kwargs = {"virtual_chunks": virtual_chunks} \
            if virtual_chunks is not None else {}
        sim = get_scheduler(schedule, **kwargs).simulate(graph,
                                                         num_microbatches)
    if stage_fn is None:
        stage_fn, stage_params, microbatches = toy_stage_model(
            len(graph.stages), num_microbatches, d_model=d_model,
            batch=batch, seq=seq, generator=generator)

    if executor == "spmd":
        from repro_torch.parallel.spmd import run_schedule_spmd
        measured = run_schedule_spmd(stage_fn, stage_params, microbatches,
                                     graph, sim, group=group)
    else:
        measured = execute_schedule(stage_fn, stage_params, microbatches,
                                    graph, sim)
    claimed = sim if claim_sim is None else claim_sim
    sim_peaks = claimed["peak_activations_per_device"]
    exe_peaks = measured["peak_activations_per_device"]
    caps = activation_caps(graph, sim["device_of"], num_microbatches)
    report = {
        "schedule": sim["schedule"],
        "virtual_chunks": sim["virtual_chunks"],
        "num_devices": sim["num_devices"],
        "executor": executor,
        "simulated_peaks": list(sim_peaks),
        "executor_peaks": list(exe_peaks),
        "caps": caps,
        "peak_w_residuals": measured["peak_w_residuals_per_device"],
        "loss": float(measured["loss"]),
    }
    if list(sim_peaks) != list(exe_peaks):
        div = diff_activation_traces(
            simulated_activation_trace(graph, claimed),
            measured["activation_trace"],
            int(measured.get("activation_nbytes", 0)))
        if div is None:
            detail = ("the item timelines agree item for item: the "
                      "summary claim itself is inconsistent with the "
                      "timeline it shipped with")
        else:
            iid, sc, ec, sb, eb = div
            detail = (f"first diverging item {iid}: simulated "
                      f"{sc} live activations ({sb} bytes) vs "
                      f"replayed {ec} ({eb} bytes)")
        raise MemoryModelMismatch(
            f"simulator peak activations {sim_peaks} != executor "
            f"measurement {exe_peaks} for schedule "
            f"{sim['schedule']!r}; {detail} ({report})",
            first_divergence=div)
    over = [d for d in range(sim["num_devices"])
            if exe_peaks[d] > caps[d]]
    if over:
        raise MemoryModelMismatch(
            f"measured peaks exceed depth_from_end caps on devices "
            f"{over}: peaks={exe_peaks} caps={caps} for schedule "
            f"{sim['schedule']!r} ({report})")
    return report

"""The port's schedlint (``repro_torch.analysis``) against the reference's
``repro.analysis.schedlint``, on the CPU.

Findings are compared as sorted (rule, severity, location) triples on:
clean timelines of the four schedules on a chain and on a fan-in graph;
the golden plan (``lint_plan``) and its executor contracts in replay and
SPMD mode (``lint_executor_contract``); one corrupted input per rule;
corrupted SPMD programs (a self-send, a duplicate destination, a stale
send, an undelivered input). The one input class on which the port
differs on purpose, a zero-length item inside another item on its
device (the reference's ``device-overlap`` flags it), is named in
``test_zero_length_item_is_the_one_difference``.
"""
import copy
import dataclasses
import pathlib

import pytest

from repro.analysis import findings as jfind
from repro.analysis import schedlint as jlint
from repro.core import schedule as jsch
from repro import parallel as jpar
from repro.models.mllm import build_paper_mllm as jbuild
from repro.parallel import spmd as jspmd
from repro_torch.analysis import findings as tfind
from repro_torch.analysis import schedlint as tlint
from repro_torch.core import schedule as tsch
from repro_torch import parallel as tpar
from repro_torch.models.mllm import build_paper_mllm as tbuild
from repro_torch.parallel import spmd as tspmd

GOLDEN = pathlib.Path(__file__).parent / "data" / "paper_mllm_8rank_plan.json"
SCHEDULES = ("1f1b", "interleaved", "zb-h1", "zb-v")
M = 6

#: name -> ((module, fwd, bwd, bwd_w) per stage, edges or None)
GRAPHS = {
    "chain": ([("s", 1.0, 2.0, 1.0)] * 4, None),
    "frozen-head": ([("enc", 1.0, 0.0, 0.0), ("llm", 1.0, 2.0, 1.0)], None),
    "fan-in": ([("enc0", 1.0, 1.0, 0.0), ("enc1", 1.2, 1.2, 0.0),
                ("llm", 1.0, 2.0, 1.0), ("llm", 1.0, 2.0, 1.0)],
               [(0, 2), (1, 2), (2, 3)]),
}


def graphs(name):
    stages, edges = GRAPHS[name]
    out = []
    for pkg in (jsch, tsch):
        st = [pkg.Stage(n, f, b, bwd_w=w) for n, f, b, w in stages]
        out.append(pkg.PipelineGraph(st, list(edges)) if edges
                   else pkg.chain_graph(st))
    return out


def sim_of(name, schedule="zb-h1"):
    """(reference graph, port graph, the port's simulation): the two
    packages' simulations are equal (tests/test_torch_schedule.py)."""
    jg, tg = graphs(name)
    kw = {"virtual_chunks": 2} if schedule in ("interleaved", "zb-v") \
        else {}
    return jg, tg, tsch.get_scheduler(schedule, **kw).simulate(tg, M)


def triples(found):
    return sorted((f.rule, str(f.severity), f.location) for f in found)


def both(jg, tg, sim):
    """(port triples, reference triples) of lint_timeline on one sim."""
    return (triples(tlint.lint_timeline(tg, copy.deepcopy(sim))),
            triples(jlint.lint_timeline(jg, copy.deepcopy(sim))))


def replace_item(items, match, **changes):
    out, done = [], False
    for it in items:
        if not done and it[3:] == match:
            d = dict(zip(("start", "end", "dev", "kind", "s", "m"), it))
            d.update(changes)
            it = (d["start"], d["end"], d["dev"], d["kind"], d["s"], d["m"])
            done = True
        out.append(it)
    assert done, match
    return out


# ---------------------------------------------------------------------------
# The findings spine
# ---------------------------------------------------------------------------

def test_findings_api_matches_reference():
    for mod in (tfind, jfind):
        with pytest.raises(KeyError, match="unregistered"):
            mod.finding("no-such-rule", "x", "y")
        with pytest.raises(KeyError, match="unknown rule"):
            mod.filter_findings([], ["no-such-rule"])
    schedlint_rules = {n for n, r in jfind.RULES.items()
                       if r.family == "schedlint"}
    assert set(tfind.RULES) == schedlint_rules
    err = tfind.finding("fbw-order", "a", "m")
    warn = tfind.finding("plan-consistency", "b", "m",
                         severity=tfind.Severity.WARNING)
    note = tfind.finding("plan-consistency", "c", "m",
                         severity=tfind.Severity.INFO)
    assert tfind.gate([err]) and not tfind.gate([warn, note])
    assert tfind.gate([warn], strict=True) and not tfind.gate([note], True)
    assert tfind.filter_findings([err, warn], ["fbw-order"]) == [err]
    jerr = jfind.finding("fbw-order", "a", "m")
    assert str(err) == str(jerr)
    assert tfind.format_findings([err], header="h") == \
        jfind.format_findings([jerr], header="h")


# ---------------------------------------------------------------------------
# Clean inputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("name", ["chain", "fan-in"])
def test_clean_timelines_equal_reference(name, schedule):
    jg, tg, sim = sim_of(name, schedule)
    got, want = both(jg, tg, sim)
    assert got == want == []


def test_golden_plan_and_contracts_equal_reference():
    jplan = jpar.MLLMParallelPlan.load(str(GOLDEN))
    tplan = tpar.MLLMParallelPlan.load(str(GOLDEN))
    assert triples(tlint.lint_plan(tplan)) == \
        triples(jlint.lint_plan(jplan)) == []
    jm = jbuild("vlm", reduced=True, text_len=jplan.text_len)
    tm = tbuild("vlm", reduced=True, text_len=tplan.text_len)
    for mode in ("replay", "spmd"):
        got = tlint.lint_executor_contract(tplan.apply(tm, mode=mode))
        want = jlint.lint_executor_contract(jplan.apply(jm, mode=mode))
        assert triples(got) == triples(want) == [], mode


# ---------------------------------------------------------------------------
# One corrupted input per rule
# ---------------------------------------------------------------------------

def _b_before_f(sim):
    f = next(it for it in sim["items"] if it[3:] == ("F", 1, 0))
    sim["items"] = replace_item(sim["items"], ("B", 1, 0),
                                start=f[0] - 2.0, end=f[0] - 1.0)


def _dropped_b(sim):
    sim["items"] = [it for it in sim["items"] if it[3:] != ("B", 0, 2)]


def _early_consumer(sim):
    p = next(it for it in sim["items"] if it[3:] == ("F", 0, 1))
    q = next(it for it in sim["items"] if it[3:] == ("F", 1, 1))
    sim["items"] = replace_item(sim["items"], ("F", 1, 1),
                                start=p[1] - 0.5, end=p[1] - 0.5 + q[1] - q[0])


def _overlap(sim):
    a = next(it for it in sim["items"] if it[3:] == ("F", 0, 0))
    sim["items"] = replace_item(sim["items"], ("F", 0, 1),
                                start=a[0] + 0.25 * (a[1] - a[0]))


def _w_on_frozen(sim):
    t = max(it[1] for it in sim["items"])
    sim["items"] = list(sim["items"]) + [(t, t + 1.0, 0, "W", 0, 0)]


def _doctored_claim(sim):
    sim["peak_activations_per_device"] = [
        p + 1 for p in sim["peak_activations_per_device"]]


def _gpipe(sim):
    items, t = [], 0.0
    for m in range(M):                               # every F first
        items += [(float(m), m + 1.0, 0, "F", 0, m),
                  (m + 1.0, m + 2.0, 1, "F", 1, m)]
    t = M + 2.0
    for m in range(M):                               # then every B
        items += [(t, t + 1.0, 1, "B", 1, m), (t + 1.0, t + 2.0, 0, "B", 0, m)]
        t += 2.0
    sim.clear()
    sim.update(items=items, device_of=[0, 1])


def _cross_wait(sim):
    sim.clear()
    sim.update(device_of=[0, 1], items=[
        (0.0, 1.0, 0, "F", 0, 0), (1.0, 2.0, 0, "B", 0, 0),
        (2.0, 3.0, 0, "F", 0, 1), (1.0, 2.0, 1, "F", 1, 0),
        (3.0, 4.0, 1, "F", 1, 1), (4.0, 5.0, 1, "B", 1, 1),
        (5.0, 6.0, 1, "B", 1, 0), (6.0, 7.0, 0, "B", 0, 1)])


#: rule -> (graph, schedule, corruption)
CORRUPTIONS = {
    "fbw-order": ("chain", "1f1b", _b_before_f),
    "missing-item": ("chain", "zb-h1", _dropped_b),
    "handoff-order": ("chain", "1f1b", _early_consumer),
    "device-overlap": ("chain", "1f1b", _overlap),
    "frozen-no-w": ("frozen-head", "zb-h1", _w_on_frozen),
    "activation-cap": ("frozen-head", "1f1b", _gpipe),
    "peak-claim": ("fan-in", "zb-h1", _doctored_claim),
    "send-recv-cycle": ("frozen-head", "1f1b", _cross_wait),
}


@pytest.mark.parametrize("rule", sorted(CORRUPTIONS))
def test_corrupted_timeline_trips_its_rule_as_reference(rule):
    name, schedule, corrupt = CORRUPTIONS[rule]
    jg, tg, sim = sim_of(name, schedule)
    corrupt(sim)
    got, want = both(jg, tg, sim)
    assert got == want
    assert rule in {r for r, _s, _l in got}


def test_doctored_plan_trips_plan_consistency_as_reference():
    jplan = jpar.MLLMParallelPlan.load(str(GOLDEN))
    tplan = tpar.MLLMParallelPlan.load(str(GOLDEN))

    def doctor(plan, **sched):
        return dataclasses.replace(
            plan, schedule=dataclasses.replace(plan.schedule, **sched))

    for sched in ({"bubble_fraction": 1.5}, {"iteration_time": 0.0},
                  {"peak_activations_per_device": (1,)}):
        got = triples(tlint.lint_plan(doctor(tplan, **sched)))
        want = triples(jlint.lint_plan(doctor(jplan, **sched)))
        assert got == want and got and got[0][0] == "plan-consistency"
    for pkg_plan, lint in ((tplan, tlint), (jplan, jlint)):
        cx = pkg_plan.context
        bad = dataclasses.replace(pkg_plan, context=dataclasses.replace(
            cx, assignment=cx.assignment[:-1] + (cx.num_ranks + 3,)))
        assert [r for r, _s, _l in triples(lint.lint_plan(bad))] == \
            ["plan-consistency"]
    # a contract whose graph does not match its timeline
    jg, tg, sim = sim_of("chain")
    jsmall, tsmall = (pkg.chain_graph([pkg.Stage("s", 1.0, 2.0)])
                      for pkg in (jsch, tsch))
    assert triples(tlint.lint_executor_contract(
        {"graph": tsmall, "schedule": sim})) == triples(
        jlint.lint_executor_contract({"graph": jsmall, "schedule": sim}))


# ---------------------------------------------------------------------------
# Emitted SPMD programs
# ---------------------------------------------------------------------------

def programs(schedule="zb-h1"):
    jg, tg = graphs("chain")
    kw = {"virtual_chunks": 2} if schedule in ("interleaved", "zb-v") \
        else {}
    sim = tsch.get_scheduler(schedule, **kw).simulate(tg, M)
    return (tspmd.compile_spmd_program(tg, copy.deepcopy(sim)),
            jspmd.compile_spmd_program(jg, copy.deepcopy(sim)))


def first_round(prog, kind):
    for w, wave in enumerate(prog.waves):
        for rnd in wave.rounds:
            if rnd.kind == kind:
                return w, rnd
    raise AssertionError(kind)


def _late(prog):                 # the consumer waits for an earlier wave
    w, rnd = first_round(prog, "fwd")
    prog.waves[w].rounds.remove(rnd)
    prog.waves[w + 1].rounds.append(rnd)


def _early(prog):                # ships what the wave before computed
    w, rnd = first_round(prog, "bwd")
    prog.waves[w].rounds.remove(rnd)
    prog.waves[w - 1].rounds.append(rnd)


def _duplicate_destination(prog, pkg):
    _w, rnd = first_round(prog, "fwd")
    t = rnd.transfers[0]
    rnd.transfers.append(dataclasses.replace(t, src_dev=t.src_dev + 1))


def _self_send(prog):
    _w, rnd = first_round(prog, "fwd")
    rnd.transfers[0].dst_dev = rnd.transfers[0].src_dev


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_compiled_programs_lint_clean_as_reference(schedule):
    tprog, jprog = programs(schedule)
    assert triples(tlint.lint_spmd_program(tprog)) == \
        triples(jlint.lint_spmd_program(jprog)) == []


@pytest.mark.parametrize("corrupt,rule", [
    ("late", "send-recv-cycle"), ("early", "ppermute-program"),
    ("duplicate", "ppermute-program"), ("self", "ppermute-program")])
def test_corrupted_program_trips_its_rule_as_reference(corrupt, rule):
    tprog, jprog = programs()
    for prog, pkg in ((tprog, tspmd), (jprog, jspmd)):
        {"late": _late, "early": _early, "self": _self_send,
         "duplicate": lambda p: _duplicate_destination(p, pkg)}[corrupt](
            prog)
    got = triples(tlint.lint_spmd_program(tprog))
    assert got == triples(jlint.lint_spmd_program(jprog))
    assert rule in {r for r, _s, _l in got}
    # the contract form lints the program under its own location
    jg, tg, sim = sim_of("chain")
    found = tlint.lint_executor_contract(
        {"sim_graph": tg, "schedule": sim, "spmd_program": tprog})
    assert [f for f in found if f.location.startswith("executor:spmd")]
    assert triples(found) == triples(jlint.lint_executor_contract(
        {"sim_graph": jg, "schedule": sim, "spmd_program": jprog}))


# ---------------------------------------------------------------------------
# The one deliberate difference
# ---------------------------------------------------------------------------

def test_zero_length_item_is_the_one_difference():
    """A frozen stage's zero-length B that starts inside another item
    on its device: the reference's device-overlap flags it (float
    rounding puts such items there, ROADMAP.md queue 3); here a
    zero-length item occupies no time, and every other rule agrees."""
    jg, tg = graphs("frozen-head")
    items = [(0.0, 1.0, 0, "F", 0, 0), (1.0, 2.0, 1, "F", 1, 0),
             (2.0, 4.0, 1, "B", 1, 0), (3.5, 4.5, 0, "F", 0, 1),
             (4.0, 4.0, 0, "B", 0, 0), (4.5, 5.5, 1, "F", 1, 1),
             (5.5, 7.5, 1, "B", 1, 1), (7.5, 7.5, 0, "B", 0, 1)]
    sim = {"items": items, "device_of": [0, 1]}
    got, want = both(jg, tg, sim)
    assert want == [("device-overlap", "error", "timeline:B(s0,m0)@d0")]
    assert got == []
    # a real overlap is still found
    bad = {"items": items + [(4.2, 4.3, 0, "W", 1, 0)], "device_of": [0, 1]}
    assert "device-overlap" in {r for r, _s, _l in both(jg, tg, bad)[0]}

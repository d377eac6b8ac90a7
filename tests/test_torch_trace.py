"""The serving loop's spans and counters (``runtime/trace.py``), on the
CPU.

* A drain through the captured tick gives the same completions, tokens,
  drops and engine state with a ``Tracer`` on the loop as without one;
  with none, the loop reads no tracer clock.
* With one on: every ``serve_loop.*`` span of a tick and every
  ``static_tick.*`` span of its program, each child's total inside its
  parent's, and the counters against the drain's own record.
* Every completed request's stamps in order: submitted, admitted (the
  launch of its first tick with a slot), done.
* Under a profiler each span is an ``xlb::`` range; a tick that raised
  leaves no span open; the sanitized tick times its verdict.
* ``launch/serve.py --trace`` prints the table and the requests' queue
  wait.
"""

import re

import numpy as np
import pytest
import torch

from repro_torch.configs import XLB_SERVICE_MODEL as CFG
from repro_torch.core import interpose
from repro_torch.core.routing_table import (POLICY_LEAST_REQUEST, POLICY_RR,
                                            Cluster, Rule, ServiceConfig,
                                            build_state)
from repro_torch.launch import serve
from repro_torch.models import model
from repro_torch.runtime import trace
from repro_torch.runtime.serve_loop import Request, ServeLoop

I, C, R, MAX_LEN = 4, 2, 8, 5
LOOP_SPANS = {"serve_loop.tick", "serve_loop.control", "serve_loop.fault",
              "serve_loop.release", "serve_loop.ingress", "serve_loop.step",
              "serve_loop.download", "serve_loop.complete",
              "serve_loop.requeue"}
COUNTERS = {f"serve_loop.{k}" for k in ("taken", "held", "first_holds",
                                        "dropped", "released", "completed")}


@pytest.fixture(scope="module")
def params():
    return model.init_params(CFG, torch.Generator().manual_seed(0),
                             dtype=torch.float32, device="cpu")


def _loop(params, tracer=None):
    routing, _ = build_state(
        [ServiceConfig("a", [Rule(0, None, "pa")]),
         ServiceConfig("b", [Rule(0, None, "pb")])],
        [Cluster("pa", [0, 1], POLICY_RR),
         Cluster("pb", [2, 3], POLICY_LEAST_REQUEST)], "cpu")
    eng = interpose.Engine(CFG, I, C, MAX_LEN, eos=-1, device="cpu")
    loop = ServeLoop(eng, params, routing, admit_batch=R,
                     dtype=torch.float32)
    loop.tracer = tracer
    rng = np.random.RandomState(7)
    for i in range(24):           # more than the 8 slots: holds and backoff
        loop.submit(Request(req_id=i, service=int(rng.randint(2)),
                            headers={"path": f"/p/{rng.randint(5)}"},
                            prompt_token=int(rng.randint(3, CFG.vocab))))
    return loop


@pytest.fixture(scope="module")
def drains(params):
    """The same drain without a tracer and with one: (loop, report)."""
    out = {}
    for on in (False, True):
        loop = _loop(params, trace.Tracer() if on else None)
        out[on] = loop, loop.drain(max_ticks=200)
    return out


def test_a_drain_is_the_same_with_the_tracer_on_and_off(drains):
    (off, r0), (on, r1) = drains[False], drains[True]
    assert len(r0.done) == 24 and r0.held_first > 0
    assert [r.req_id for r in r1.done] == [r.req_id for r in r0.done]
    assert [r.tokens for r in r1.done] == [r.tokens for r in r0.done]
    assert [(r.admit_tick, r.done_tick, r.retries) for r in r1.done] == \
        [(r.admit_tick, r.done_tick, r.retries) for r in r0.done]
    assert (len(r1.dropped), r1.queued, r1.inflight, r1.held_first) == \
        (len(r0.dropped), r0.queued, r0.inflight, r0.held_first)
    assert on.ticks == off.ticks
    for part in ("pool", "routing", "metrics"):
        a, b = getattr(off.state, part), getattr(on.state, part)
        for f in a._fields:
            assert torch.equal(getattr(a, f), getattr(b, f)), (part, f)


def test_without_a_tracer_the_loop_reads_no_tracer_clock(params,
                                                         monkeypatch):
    def refuse():
        raise AssertionError("a tracer clock read with no tracer set")

    monkeypatch.setattr(trace, "_now", refuse)
    loop = _loop(params)
    assert loop.serve_step.tracer is None
    for _ in range(3):
        loop.tick()


def test_every_span_and_counter_is_kept_and_children_fit_inside(drains):
    loop, rep = drains[True]
    got = loop.tracer.totals()
    spans, counters = got["spans"], got["counters"]
    ticks = loop.ticks
    assert LOOP_SPANS <= set(spans)
    assert {"static_tick.gate", "static_tick.adopt", "static_tick.draws",
            "static_tick.stage", "static_tick.replay"} <= set(spans)
    assert "static_tick.capture" not in spans     # no graph on the CPU
    for name in LOOP_SPANS:
        assert spans[name][0] == ticks, name
    for name in ("static_tick.draws", "static_tick.stage"):   # arrivals
        assert 0 < spans[name][0] < ticks
    for name, (count, ns) in spans.items():
        kids = [k for k in spans if trace.parent(k) == name]
        assert sum(spans[k][1] for k in kids) <= ns, name
        assert ns >= 0 and count > 0
    assert set(counters) == COUNTERS
    assert counters["serve_loop.completed"] == len(rep.done) == 24
    assert counters["serve_loop.first_holds"] == rep.held_first
    assert counters["serve_loop.dropped"] == len(rep.dropped)
    # every row taken is admitted once or held; every held row but a drop
    # comes back from backoff
    assert counters["serve_loop.taken"] == \
        24 + counters["serve_loop.held"]
    assert counters["serve_loop.released"] == \
        counters["serve_loop.held"] - counters["serve_loop.dropped"]
    assert counters["serve_loop.held"] == \
        sum(r.retries for r in rep.done + rep.dropped)


def test_completed_requests_stamp_submit_admit_done_in_order(drains):
    for on in (False, True):
        _, rep = drains[on]
        for r in rep.done:
            assert 0 < r.t_submit <= r.t_admit <= r.t_done, r.req_id
            assert r.submit_tick <= r.admit_tick <= r.done_tick


def test_reset_forgets_the_sums_and_totals_are_a_copy():
    tr = trace.Tracer()
    tr.root(trace.TICK)
    tr.open("serve_loop.control")
    tr.next("serve_loop.fault")
    tr.close()
    tr.count("serve_loop.taken", 3)
    got = tr.totals()
    tr.reset()                         # mid-tick: the open tick closes
    tr.close()
    assert set(got["spans"]) == {"serve_loop.control", "serve_loop.fault"}
    assert got["counters"] == {"serve_loop.taken": 3}
    assert set(tr.totals()["spans"]) == {trace.TICK}
    assert tr.totals()["counters"] == {}


def test_a_tick_that_raised_leaves_no_span_open():
    tr = trace.Tracer()
    tr.root(trace.TICK)
    tr.open("serve_loop.step")
    tr.open("static_tick.replay")      # the tick raised here
    tr.root(trace.TICK)
    tr.close()
    assert tr._open == []
    assert set(tr.totals()["spans"]) == {trace.TICK}


def test_parents_follow_the_names():
    assert trace.parent(trace.TICK) is None
    assert trace.parent("serve_loop.requeue") == trace.TICK
    assert trace.parent("static_tick.stage") == "serve_loop.step"


def test_under_a_profiler_each_span_is_a_range(params):
    from torch.profiler import ProfilerActivity, profile
    loop = _loop(params, trace.Tracer())
    loop.tick()                         # outside the profiler: no ranges
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        loop.tick()
    loop.tick()
    names = {e.name for e in prof.events()}
    assert {trace.RANGE + n for n in LOOP_SPANS} <= names
    assert {"xlb::static_tick.gate", "xlb::static_tick.replay"} <= names
    assert loop.tracer.totals()["spans"][trace.TICK][0] == 3


def test_the_sanitized_tick_times_its_verdict(params, monkeypatch):
    monkeypatch.setenv("XLB_SANITIZE", "1")
    loop = _loop(params, trace.Tracer())
    assert loop.serve_step.sanitize
    for _ in range(3):
        loop.tick()
    spans = loop.tracer.totals()["spans"]
    assert spans["static_tick.verdict"][0] == 3
    assert loop.serve_step.verdict_reads == 3


def test_table_puts_each_span_under_its_parent():
    totals = {"spans": {trace.TICK: (2, 4_000_000),
                        "serve_loop.step": (2, 3_000_000),
                        "static_tick.replay": (2, 2_000_000),
                        "serve_loop.ingress": (2, 500_000)},
              "counters": {"serve_loop.held": 3}}
    lines = trace.table(totals, 2).splitlines()
    rows = [ln.split() for ln in lines[1:5]]
    assert [r[0] for r in rows] == [trace.TICK, "serve_loop.step",
                                    "static_tick.replay",
                                    "serve_loop.ingress"]
    assert lines[2].startswith("  serve_loop.step")
    assert lines[3].startswith("    static_tick.replay")
    assert [float(r[2]) for r in rows] == [2.0, 1.5, 1.0, 0.25]
    assert float(rows[1][3]) == 75.0
    assert lines[-1].split()[:3] == ["serve_loop.held", "3", "1.5000"]


def test_serve_launcher_prints_the_trace_table(capsys):
    serve.main(["--device", "cpu", "--instances", "2", "--slots", "2",
                "--requests", "6", "--max-len", "5", "--trace"])
    out = capsys.readouterr().out
    assert "6 requests" in out
    lines = out.splitlines()
    head = next(i for i, ln in enumerate(lines)
                if ln.startswith("host spans over "))
    ticks = int(lines[head].split()[3])
    assert lines[head + 1].split() == ["span", "calls", "ms", "a", "tick",
                                       "%", "of", "tick"]
    rows = {ln.split()[0]: ln.split() for ln in lines[head + 2:]}
    assert int(rows[trace.TICK][1]) == ticks
    assert float(rows[trace.TICK][3]) == 100.0
    assert LOOP_SPANS | {"static_tick.replay"} <= set(rows)
    assert int(rows["serve_loop.completed"][1]) == 6
    wait = next(ln for ln in lines if ln.startswith("queue wait "))
    p50, p99 = (float(w) for w in re.findall(r"p\d+ ([\d.]+) ms", wait))
    assert 0 <= p50 <= p99

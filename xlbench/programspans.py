"""The program's own spans and counters over one run of a cell: the run
``run.py`` makes, with a ``repro_torch.runtime.trace.Tracer`` on the
loop (reset at the window's start, read at its end, before any profiled
slice).  Not part of a benchmark run:

    python3 xlbench/programspans.py --workload <cell> --seed <n>
        --seconds <s> [--trace 0|1]

The last line of standard output is one JSON object: ``result``, the
run's result as ``run.py`` makes it, and ``program``: host ms a tick of
each program span over the window, each counter a tick, the captured
tick's first calls split (warm-up, sync, capture), the window tick's p50
and the readings named in ``READINGS``; with ``--trace 1`` also the
profiled slice's idle gaps labelled by the benchmark span and split by
the innermost program spans they overlap (``idle_gaps``), and
``checks``: the program's spans against the benchmark's own numbers.
The same run without the tracer is ``run.py``'s.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import json
import os
import statistics
import sys
import time
import types
from pathlib import Path

T0 = time.perf_counter()

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

#: a program span's profiler range prefix (``runtime/trace.py::RANGE``)
PROGRAM = "xlb::"
#: the captured tick's host work before its program is launched
PRELAUNCH = ("static_tick.gate", "static_tick.adopt", "static_tick.draws",
             "static_tick.stage")


def span_ms(t, *names) -> float | None:
    """Host ms a window tick of the program spans ``names``, summed."""
    spans = t.program["spans"] if t.program else {}
    if not t.window_ticks or not any(n in spans for n in names):
        return None
    return sum(spans[n][1] for n in names if n in spans) / 1e6 \
        / t.window_ticks


def queue_wait_p99(t) -> float | None:
    if not t.queue_wait_ms:
        return None
    from xlbench.run import percentile
    return percentile(t.queue_wait_ms, 99)


#: readings over the window: name -> read(t)
READINGS = {
    "complete_loop_ms_per_tick.mesh":
        lambda t: span_ms(t, "serve_loop.complete"),
    "requeue_ms_per_tick.mesh": lambda t: span_ms(t, "serve_loop.requeue"),
    "prelaunch_ms_per_tick": lambda t: span_ms(t, *PRELAUNCH),
    "prelaunch_ms_per_tick.mesh": lambda t: span_ms(t, *PRELAUNCH),
    "queue_wait_p99_ms.open": queue_wait_p99,
}


def events(prof) -> tuple[list, list]:
    """``harness.events`` with the program's ranges: (device operations,
    host ranges), the benchmark's named without their prefix, the
    program's with ``xlb::``; neither's device-side shadow is an
    operation."""
    from torch.autograd import DeviceType
    dev, host = [], []
    for e in prof.events():
        rng = (e.time_range.start / 1e6, e.time_range.end / 1e6)
        ranged = e.name.startswith(("xlbench::", PROGRAM))
        if e.device_type == DeviceType.CUDA:
            if not ranged:
                dev.append((e.name, *rng))
        elif e.name.startswith("xlbench::"):
            host.append((e.name[len("xlbench::"):], *rng))
        elif ranged:
            host.append((e.name, *rng))
    return dev, host


def _holding(by: dict, starts: dict, name: str, t: float):
    """The start of ``name``'s span that holds ``t``, or None."""
    i = bisect.bisect_right(starts[name], t) - 1
    if i >= 0 and by[name][i][1] >= t:
        return by[name][i][0]
    return None


def _overlapping(by: dict, starts: dict, name: str, a: float, b: float):
    """``name``'s spans that overlap (a, b), as (start, end)."""
    i = bisect.bisect_left(starts[name], b) - 1
    out = []
    while i >= 0 and by[name][i][1] > a:      # one name's spans are disjoint
        out.append(by[name][i])
        i -= 1
    return out


def _split(spans: list, a: float, b: float) -> collections.Counter:
    """(a, b) split by the innermost of ``spans`` ((start, end, name))
    over each part: the one that started last of those open (program spans
    nest); parts under none go to ``""``."""
    cuts = sorted({a, b} | {t for s, e, _ in spans for t in (s, e)
                            if a < t < b})
    out = collections.Counter()
    for x, y in zip(cuts, cuts[1:]):
        mid = (x + y) / 2
        open_ = [(s, n) for s, e, n in spans if s <= mid <= e]
        out[max(open_)[1] if open_ else ""] += y - x
    return out


def idle_gaps(device, host) -> dict:
    """``devicetrace.idle_gaps`` with the program's spans: each gap under
    the benchmark's label (the innermost benchmark span at its middle),
    split by the innermost program span over each part of it, by length
    of overlap (``bookkeeping/serve_loop.requeue``); a part under no
    program span keeps the bare label.  Summed by the part before ``/``,
    the labels give ``devicetrace.idle_gaps``."""
    from xlbench import devicetrace
    busy = devicetrace.merged((s, e) for _, s, e in device)
    names = set(devicetrace.SPAN_ORDER) | {n for n, *_ in host
                                           if n.startswith(PROGRAM)}
    # spans of one name never overlap: each name's starts, sorted
    by = {n: sorted((s, e) for m, s, e in host if m == n) for n in names}
    starts = {n: [s for s, _ in v] for n, v in by.items()}
    program = [n for n in names if n.startswith(PROGRAM)]
    out = collections.Counter()
    for (_, a), (b, _) in zip(busy, busy[1:]):
        mid = (a + b) / 2
        label = "other"
        for name in devicetrace.SPAN_ORDER:
            if _holding(by, starts, name, mid) is not None:
                label = devicetrace.LABELS.get(name, name)
                break
        spans = [(s, e, n[len(PROGRAM):]) for n in program
                 for s, e in _overlapping(by, starts, n, a, b)]
        for inner, sec in _split(spans, a, b).items():
            out[label + "/" + inner if inner else label] += sec
    return dict(out)


def by_prefix(gaps: dict) -> dict:
    """Nested labels summed by the benchmark's label."""
    out = collections.Counter()
    for k, v in gaps.items():
        out[k.split("/", 1)[0]] += v
    return dict(out)


def execute(workload: str, seed: int, seconds: float, trace: bool,
            **kw) -> tuple[dict, dict]:
    """``run.execute`` of ``workload`` with the program's tracer on the
    loop; (the run's result, the program's readings)."""
    from repro_torch.runtime.trace import Tracer
    from xlbench import harness
    from xlbench import run as bench_run
    made = []

    class ProgramRun(harness.Run):
        def _instrument(self):
            super()._instrument()
            self.tracer = self.loop.tracer = Tracer()
            self.program = None
            made.append(self)

        def window(self):
            self.tracer.reset()
            self.held0, self.attempts0 = self.held, self.attempts
            super().window()
            if self.program is None:            # no profiled slice
                self._snapshot()

        def _profile(self, ticks):
            self._snapshot()
            super()._profile(ticks)

        def _snapshot(self):
            self.program = self.tracer.totals()
            self.bench_held = self.held - self.held0
            self.bench_attempts = self.attempts - self.attempts0
            g = self.tick_obj.graphs
            self.graph_split = {"setup_s": g.setup_s, "warmup_s": g.warmup_s,
                                "sync_s": g.sync_s, "capture_s": g.capture_s,
                                "graphs": len(g)}

    saved = harness.Run, harness.events
    harness.Run, harness.events = ProgramRun, events
    try:
        out = bench_run.execute(workload, seed, seconds, trace, **kw)
    finally:
        harness.Run, harness.events = saved
    return out, readings(made[0], out)


def readings(run, out: dict) -> dict:
    """What the program's tracer and request stamps show over the
    window, beside the benchmark's own numbers."""
    ticks = run.window_ticks
    waits = [1e3 * (r.t_admit - r.t_submit) for r in run.requests.values()
             if r.done_tick >= 0 and run.t_w0 <= r.t_done <= run.t_w1]
    t = types.SimpleNamespace(window_ticks=ticks, program=run.program,
                              queue_wait_ms=waits)
    spans, counters = run.program["spans"], run.program["counters"]
    ends = run.tick_ends
    tick_ms = [1e3 * (b - a) for a, b in zip([run.t_w0] + ends[:-1], ends)]
    prog = {
        "window_ticks": ticks,
        "window_tick_p50_ms": statistics.median(tick_ms) if tick_ms
        else None,
        "spans_ms_per_tick": {k: ns / 1e6 / max(ticks, 1)
                              for k, (_, ns) in spans.items()},
        "span_calls": {k: c for k, (c, _) in spans.items()},
        "counters_per_tick": {k: v / max(ticks, 1)
                              for k, v in counters.items()},
        "counters": counters,
        "held_by_the_benchmark": run.bench_held,
        "attempts_by_the_benchmark": run.bench_attempts,
        "queue_wait_ms": ({"p50": statistics.median(waits),
                           "p99": queue_wait_p99(t), "max": max(waits),
                           "n": len(waits)} if waits else None),
        "graphs": run.graph_split,
        "readings": {k: f(t) for k, f in READINGS.items()},
    }
    if run.profile is not None:
        gaps = idle_gaps(run.profile.device, run.profile.host)
        prog["idle_gaps"] = dict(sorted(gaps.items(), key=lambda kv: -kv[1]))
        prog["checks"] = checks(prog, out["metrics"], gaps)
    return prog


def checks(prog: dict, metrics: dict, gaps: dict) -> dict:
    """The program's spans against the benchmark's numbers of the same
    run: each a (left, right, holds) triple."""
    ms = prog["spans_ms_per_tick"]

    def metric(name):
        for k in (name + ".mesh", name):
            if k in metrics:
                return metrics[k]["value"]
        return None

    out = {}
    host = metric("host_ms_per_tick")
    parts = sum(ms.get(f"serve_loop.{k}", 0.0) for k in
                ("complete", "requeue", "ingress", "release"))
    if host is not None:
        out["loop_parts_within_host_ms"] = (parts, host, parts <= host)
    ingress = metric("ingress_ms_per_tick")
    if ingress and "serve_loop.ingress" in ms:
        p = ms["serve_loop.ingress"]
        out["ingress_within_10pct"] = (p, ingress,
                                       abs(p - ingress) <= 0.1 * ingress)
    call = metric("tick_call_ms")
    pre = prog["readings"]["prelaunch_ms_per_tick"]
    if call is not None and pre is not None:
        out["prelaunch_below_tick_call"] = (pre, call, pre < call)
    book = sum(v for k, v in gaps.items()
               if k.split("/", 1)[0] == "bookkeeping")
    # under one of the tick's phases (the captured tick's inside
    # ``serve_loop.step``), not under the tick's own span alone
    named = sum(v for k, v in gaps.items()
                if k.startswith("bookkeeping/")
                and k != "bookkeeping/serve_loop.tick")
    if book:
        out["bookkeeping_under_loop_spans"] = (named, book,
                                               named >= 0.9 * book)
    out["held_equal"] = (prog["counters"].get("serve_loop.held", 0),
                         prog["held_by_the_benchmark"],
                         prog["counters"].get("serve_loop.held", 0)
                         == prog["held_by_the_benchmark"])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" /
                                             "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    import torch
    if not torch.cuda.is_available():
        print("xlbench: programspans needs a CUDA device", file=sys.stderr)
        return 2
    out, prog = execute(args.workload, args.seed, args.seconds,
                        bool(args.trace), t0=T0)
    for line in out.pop("_notes"):
        print(f"xlbench: {line}", file=sys.stderr)
    print(json.dumps({"result": out, "program": prog}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

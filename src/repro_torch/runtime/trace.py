"""Spans and counters of the serving path on the host clock.

A ``Tracer`` is off unless a caller sets one on ``ServeLoop.tracer``
(the loop hands it to its captured tick, ``runtime/graphs.py::
StaticTick``); with none set, each instrumented point costs one ``is
None`` test.  With one set, a span is a start and an end stamp on
``time.perf_counter_ns()``: the phases of a tick are contiguous, so one
clock read closes a phase and opens the next (``next``).  Per span name
the tracer keeps the count and the total ns, per counter a running sum;
all of it stays in memory until ``totals()`` reads it, and ``reset()``
starts over (the start of a measured stretch).

A span's parent is fixed by its name (``parent``): ``serve_loop.tick``
holds every other ``serve_loop.*`` span, ``serve_loop.step`` (the call of
the tick's program) every ``static_tick.*`` span.  No span runs inside a
captured body, and nothing here reads the device.  While a profiler is
recording (checked once a tick), each span also opens a profiler range
named ``xlb::<span>``, so that a profile holds the program's phases on
the clock of the device's operations.  A request's stamps
(``Request.t_submit``, ``t_admit``, ``t_done``) carry its own spans,
keyed by its ``req_id``.
"""

from __future__ import annotations

import collections
import time

import torch

#: the prefix of a span's profiler range
RANGE = "xlb::"
#: the outermost span of a tick
TICK = "serve_loop.tick"

_now = time.perf_counter_ns


def parent(name: str) -> str | None:
    """The span that holds ``name`` (None for the tick's own)."""
    if name == TICK:
        return None
    if name.startswith("static_tick."):
        return "serve_loop.step"
    return TICK


class Tracer:
    """Count and total ns a span name, and running sums a counter."""

    def __init__(self):
        self.spans: dict[str, list] = {}          # name -> [count, ns]
        self.counters: collections.Counter = collections.Counter()
        self._open: list = []           # (name, start ns, profiler range)
        self._ranges = False            # a profiler is recording

    def root(self, name: str) -> None:
        """Open a tick's outermost span.  The spans a raising tick left
        open are dropped uncounted."""
        while self._open:
            _, _, rng = self._open.pop()
            if rng is not None:
                rng.__exit__(None, None, None)
        self._ranges = torch._C._autograd._profiler_enabled()
        self._push(name, _now())

    def open(self, name: str) -> None:
        """Open ``name`` inside the innermost open span."""
        self._push(name, _now())

    def next(self, name: str) -> None:
        """Close the innermost span and open ``name`` in its place, both
        at one clock read."""
        t = _now()
        last, t0, rng = self._open[-1]
        if rng is None:                 # (no profiler: the common case)
            self._open[-1] = (name, t, None)
            self._add(last, t - t0)
            return
        self._pop(t)
        self._push(name, t)

    def close(self) -> None:
        """Close the innermost open span."""
        self._pop(_now())

    def count(self, name: str, n: int) -> None:
        self.counters[name] += n

    def _push(self, name: str, t: int) -> None:
        rng = None
        if self._ranges:
            rng = torch.profiler.record_function(RANGE + name)
            rng.__enter__()
        self._open.append((name, t, rng))

    def _pop(self, t: int) -> None:
        name, t0, rng = self._open.pop()
        if rng is not None:
            rng.__exit__(None, None, None)
        self._add(name, t - t0)

    def _add(self, name: str, ns: int) -> None:
        s = self.spans.get(name)
        if s is None:
            self.spans[name] = [1, ns]
        else:
            s[0] += 1
            s[1] += ns

    def totals(self) -> dict:
        """A copy of what was kept: ``spans`` name -> (count, total ns),
        ``counters`` name -> sum."""
        return {"spans": {k: (c, ns) for k, (c, ns) in self.spans.items()},
                "counters": dict(self.counters)}

    def reset(self) -> None:
        """Forget the sums (the spans open now still close into them)."""
        self.spans.clear()
        self.counters.clear()


def table(totals: dict, ticks: int) -> str:
    """Host ms a tick of each span (each under its parent, in order of
    time) and each counter a tick, over ``ticks`` ticks."""
    spans, ticks = totals["spans"], max(ticks, 1)
    lines = [f"{'span':<28} {'calls':>8} {'ms a tick':>10} {'% of tick':>9}"]
    whole = spans.get(TICK, (0, 0))[1] or 1

    def walk(name: str, depth: int) -> None:
        count, ns = spans[name]
        lines.append(f"{'  ' * depth + name:<28} {count:>8} "
                     f"{ns / 1e6 / ticks:>10.4f} {100 * ns / whole:>9.2f}")
        for child in sorted((k for k in spans if parent(k) == name),
                            key=lambda k: -spans[k][1]):
            walk(child, depth + 1)

    tops = [k for k in spans if parent(k) not in spans]
    for name in sorted(tops, key=lambda k: -spans[k][1]):
        walk(name, 0)
    if totals["counters"]:
        lines.append(f"{'counter':<28} {'total':>8} {'a tick':>10}")
    for name, n in sorted(totals["counters"].items()):
        lines.append(f"{name:<28} {n:>8} {n / ticks:>10.4f}")
    return "\n".join(lines)

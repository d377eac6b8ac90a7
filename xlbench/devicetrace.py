"""Reductions of a profiled slice: the device's busy time (the union of
its operations' intervals), each kernel's device time, and the idle gaps
between operations labelled by the benchmark span the host was in."""

from __future__ import annotations

import bisect
import collections
import re

#: host spans, innermost first: the label an idle gap takes
SPAN_ORDER = ("ingress", "tick_call", "download", "loop_tick", "traffic",
              "tick")
LABELS = {"loop_tick": "bookkeeping", "tick": "between ticks"}


def short_name(event: str) -> str:
    """A kernel's name without return type, namespaces and parameters,
    its template arguments cut to 48 characters."""
    name = event.replace("(anonymous namespace)::", "").removeprefix("void ")
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0:
            cut = i
            break
    base, _, args = name[:cut].partition("<")
    args = re.sub(r"\b\w+::", "", args)
    return base.split("::")[-1] + ("<" + args[:48] if args else "")


def merged(intervals) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_s(device) -> float:
    return sum(e - s for s, e in merged((s, e) for _, s, e in device))


def kernel_s(device, keys) -> tuple[float, int]:
    """(device seconds, launches) of the operations whose name holds one
    of ``keys``."""
    hit = [(s, e) for n, s, e in device if any(k in n for k in keys)]
    return sum(e - s for s, e in hit), len(hit)


def by_name(device) -> dict:
    out = collections.Counter()
    for n, s, e in device:
        out[short_name(n)] += e - s
    return dict(out)


def idle_gaps(device, host) -> dict:
    """Seconds of device idle between its first and last operation, by the
    innermost benchmark span open on the host at the gap's middle."""
    busy = merged((s, e) for _, s, e in device)
    # spans of one name never overlap: each name's starts, sorted
    by = {n: sorted((s, e) for m, s, e in host if m == n) for n in SPAN_ORDER}
    starts = {n: [s for s, _ in v] for n, v in by.items()}
    out = collections.Counter()
    for (_, a), (b, _) in zip(busy, busy[1:]):
        mid = (a + b) / 2
        label = "other"
        for name in SPAN_ORDER:
            i = bisect.bisect_right(starts[name], mid) - 1
            if i >= 0 and by[name][i][1] >= mid:
                label = LABELS.get(name, name)
                break
        out[label] += b - a
    return dict(out)

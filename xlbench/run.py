"""Run one cell of the benchmark of ``repro_torch`` on this machine's GPU:

    python3 xlbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

(or ``python3 -m xlbench.run ...``) from the root of a checkout.  The
cell, its configuration and its traffic are found by name through
``BENCHMARK.json``.  The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``: each number compared, with its limit (also the last lines of
standard error).  Exits non-zero, printing no result, without a CUDA
device (or fewer than the cell asks for), where the program cannot be
imported, or where JAX or the JAX package is loaded once the window has
closed.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()        # the process's start, for setup_s

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

#: top-level module names that must not be loaded in a run's process
FOREIGN = ("jax", "jaxlib", "flax", "repro")
#: device operations and idle gaps a traced result lists
BREAKDOWN_TOP = 10


def foreign_modules(modules) -> list:
    """The loaded modules whose top-level name, compared whole, is JAX's
    or the JAX package's (``repro_torch`` is not ``repro``)."""
    return sorted({m for m in modules if m.split(".", 1)[0] in FOREIGN})


def reported(bench: dict, cell: dict, trace: bool) -> list:
    """The metric entries the cell reports: its end-to-end metrics, or
    (traced) the per-layer metrics listed for it, or, where a metric
    lists no cells, reported wherever the metric it moves is."""
    name = cell["name"]
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    if not trace:
        return e2e
    moves = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (name in m["workloads"] if "workloads" in m
                else m["moves"] in moves)]


def percentile(xs: list, q: float) -> float:
    """The q-th percentile, linear between order statistics."""
    xs = sorted(xs)
    if len(xs) == 1:
        return xs[0]
    k = (len(xs) - 1) * q / 100
    i = int(k)
    j = min(i + 1, len(xs) - 1)
    return xs[i] + (xs[j] - xs[i]) * (k - i)


def end_to_end(run) -> dict:
    """The window's user requests: completed and failed ones, and the
    latencies of those completed, from the host clock; the device ms of
    each window tick's replay, from CUDA events (none on the CPU)."""
    lat, failed = run.traffic.ended_between(run.t_w0, run.t_w1)
    w0 = run.setup_ticks
    return {"completed": len(lat), "failed": failed,
            "latency_ms": [1e3 * x for x in lat],
            "seconds": run.t_w1 - run.t_w0,
            "replay_ms": run.replay_ms[w0:w0 + run.window_ticks]}


def trace_data(run, works: list, e2e: dict):
    """What a per-layer metric's ``read(t)`` gets from a traced run."""
    first, last = run.profile.ticks
    return types.SimpleNamespace(
        window_ticks=run.window_ticks, window_s=run.t_w1 - run.t_w0,
        completed=e2e["completed"],
        spans=dict(run.spans.total), attempts=run.attempts, held=run.held,
        slice_ticks=last - first, slice_wall_s=run.profile.wall_s,
        device=run.profile.device, host=run.profile.host,
        works=works[first:last], m=run.m, lay=run.lay, sizes=run.sizes,
        R=run.cfg["serve_loop"]["admit_batch"], I=run.I, C=run.C,
        tile=run.tile)


def execute(workload: str, seed: int, seconds: float, trace: bool,
            device: str = "cuda", t0: float | None = None,
            bench: dict | None = None, cfg: dict | None = None,
            spec: dict | None = None) -> dict:
    """One run of ``workload``, judged; the result object (without the
    process-level checks of ``main``).  ``bench``, ``cfg`` and ``spec``
    stand in for ``BENCHMARK.json``, the cell's configuration file and
    its traffic file (the tests' small cells)."""
    import torch

    from xlbench import check, deploy, devicetrace, harness
    from xlbench.metrics import reader
    bench = bench if bench is not None else deploy.load_benchmark()
    cell, centry = deploy.find_cell(bench, workload)
    cfg = cfg if cfg is not None else deploy.read_config(centry)
    spec = spec if spec is not None else deploy.read_traffic(cell["traffic"])
    run = harness.Run(cell, cfg, spec, seed, seconds, trace, device,
                      T0 if t0 is None else t0)
    run.setup()
    run.window()
    dev = run.device
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    got = run.collect()
    t_check = time.perf_counter()
    correct, checks, works = check.judge(run, got)
    run.check_s = time.perf_counter() - t_check
    e2e = end_to_end(run)
    metrics = {}
    values = {"req_per_s": e2e["completed"] / e2e["seconds"],
              "setup_s": run.setup_s}
    if e2e["replay_ms"] and e2e["completed"]:
        values["device_ms_per_req"] = sum(e2e["replay_ms"]) / e2e["completed"]
    if e2e["latency_ms"]:
        values["latency_p50_ms"] = statistics.median(e2e["latency_ms"])
        values["latency_p99_ms"] = percentile(e2e["latency_ms"], 99)
    t = trace_data(run, works, e2e) if trace else None
    for m in reported(bench, run.cell, trace):
        v = reader(m["name"])(t) if trace else values.get(m["name"])
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct),
           "attempted": e2e["completed"] + e2e["failed"],
           "failed": e2e["failed"], "metrics": metrics,
           "device": device_info}
    if trace:
        busy = devicetrace.busy_s(t.device)
        device_info.update(busy_s=busy, window_s=t.slice_wall_s)
        ops = sorted(devicetrace.by_name(t.device).items(),
                     key=lambda kv: -kv[1])[:BREAKDOWN_TOP]
        gaps = sorted(devicetrace.idle_gaps(t.device, t.host).items(),
                      key=lambda kv: -kv[1])[:BREAKDOWN_TOP]
        out["breakdown"] = {"device_ops": [list(x) for x in ops],
                            "idle_gaps": [list(x) for x in gaps]}
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in checks.items()}
    out["_notes"] = notes(run, e2e)
    return out


def notes(run, e2e: dict) -> list:
    """Lines for standard error: what the run did beyond its metrics."""
    lat = e2e["latency_ms"]
    lines = [f"cell {run.cell['name']} seed {run.seed}: {run.n_ticks} ticks "
             f"({run.setup_ticks} in set-up), window {e2e['seconds']:.4f} s, "
             f"{e2e['completed']} user requests completed, "
             f"{e2e['failed']} failed; "
             f"graphs {run.graphs} (capture {run.graphs_setup_s:.3f} s); "
             f"admission tile {run.tile}; the check took "
             f"{run.check_s:.3f} s"]
    if lat:
        lines.append(f"latency ms: p50 {statistics.median(lat):.4f} "
                     f"p99 {percentile(lat, 99):.4f} max {max(lat):.4f} "
                     f"over {len(lat)}")
    ends = run.tick_ends
    if ends:
        ticks = np.diff([run.t_w0] + ends) * 1e3
        q = np.percentile(ticks, [50, 99])
        lines.append(f"window ticks ms: p50 {q[0]:.4f} p99 {q[1]:.4f} max "
                     f"{ticks.max():.4f}; main thread on a CPU "
                     f"{100 * run.cpu_s / e2e['seconds']:.2f} %, the process "
                     f"{100 * run.process_cpu_s / e2e['seconds']:.2f} % of "
                     f"the window; host probe {run.probe_ms:.4f} ms")
        fifths = np.array_split(ticks, 5)
        lines.append("window ms a tick by fifths: " + " ".join(
            f"{f.mean():.4f}" for f in fifths if len(f)))
    replays = e2e["replay_ms"]
    if replays:
        lines.append(f"replays by CUDA events in the window: "
                     f"{len(replays)}, {sum(replays):.4f} ms, p50 "
                     f"{statistics.median(replays):.6f} ms a tick, "
                     f"{sum(replays) / max(e2e['completed'], 1):.6f} ms a "
                     "user request")
    gcs = run.gc_clock
    lines.append("collector in the window (gen 0/1/2): passes "
                 f"{gcs.count}, s {[round(x, 6) for x in gcs.total]}, "
                 f"longest ms {[round(1e3 * x, 4) for x in gcs.longest]}")
    late = [s for due, s in getattr(run.traffic, "lateness", ())
            if run.t_w0 <= due <= run.t_w1]
    if late:
        lines.append(f"open loop: {len(late)} arrivals due in the window, "
                     f"the generator late by {1e3 * statistics.mean(late):.4f}"
                     f" ms on average, {1e3 * max(late):.4f} ms at most")
    if run.profile is not None:
        p = run.profile
        lines.append(f"profiled slice: ticks {p.ticks}, wall "
                     f"{p.wall_s:.6f} s, launches counted {p.counted}, "
                     f"seen {p.seen}")
        w0 = run.setup_ticks
        lines.append("device work a tick, window / slice: " + "; ".join(
            f"{k} {a:.4f} / {b:.4f}" for k, a, b in zip(
                ("rows admitted", "ticks with arrivals %", "active slots"),
                tick_work(run, w0, w0 + run.window_ticks),
                tick_work(run, *p.ticks))))
    return lines


def tick_work(run, first: int, last: int) -> tuple:
    """What sets the device's work a tick over ticks [first, last): rows
    admitted, the share of ticks with an admission, and active slots (the
    traced run's slice against its window, which the device metrics that
    take busy time from the slice and the tick from the window assume
    alike)."""
    ticks = range(first, last)
    rows = [len(run.batches.get(t, ())) for t in ticks]
    return (statistics.mean(rows), 100 * statistics.mean(
        [r > 0 for r in rows]), statistics.mean(run.active[first:last]))


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30, check=True).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not readable"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every build and kernel cache of the program at a fixed path inside
    # the checkout (the kernels' nvcc build is ``build/repro_torch``)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" /
                                             "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    from xlbench import deploy
    cell, _ = deploy.find_cell(deploy.load_benchmark(), args.workload)
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"xlbench: the cell needs {cell['chips']} CUDA device(s); "
              f"this machine has {n}", file=sys.stderr)
        return 2
    out = execute(args.workload, args.seed, args.seconds, bool(args.trace))
    bad = foreign_modules(sys.modules)
    if bad:
        print(f"xlbench: loaded in this process: {bad}", file=sys.stderr)
        return 3
    for line in out.pop("_notes"):
        print(f"xlbench: {line}", file=sys.stderr)
    print(f"xlbench: card {card_line()}", file=sys.stderr)
    for k, c in out["checks"].items():
        print(f"xlbench: check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

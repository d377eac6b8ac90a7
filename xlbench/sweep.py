"""The sweep that fixes an open-loop cell's offered rate: the cell's
traffic at each of a few rates, in one process, each for a window after
its warm-up, with the backlog (requests submitted and not yet finished)
read at the window's start, middle and end.  A rate is sustained where
the backlog does not grow over the window's second half and the window
completes at least ``SUSTAINED`` of the offered rate.  Not part of a
benchmark run:

    python3 xlbench/sweep.py --workload <cell> --seconds 20 --rates 40 50 60
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

#: the least share of the offered rate completed at a sustained rate
SUSTAINED = 0.98
ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def sweep_rate(workload: str, rate: float, seconds: float, seed: int,
               device="cuda") -> dict:
    from xlbench import deploy, harness
    from xlbench.run import percentile
    bench = deploy.load_benchmark()
    cell, centry = deploy.find_cell(bench, workload)
    spec = dict(deploy.read_traffic(cell["traffic"]), rate_per_s=rate)
    run = harness.Run(cell, deploy.read_config(centry), spec, seed, seconds,
                      False, device)
    run.setup()
    loop = run.loop

    def backlog():
        return loop.submitted - len(loop.done) - len(loop.dropped)

    marks = [backlog()]
    t0 = time.perf_counter()
    for part in (0.5, 1.0):
        while time.perf_counter() - t0 < part * seconds:
            run.step()
        marks.append(backlog())
    t1 = time.perf_counter()
    lat = [1e3 * x for x in run.traffic.ended_between(t0, t1)[0]]
    done_per_s = len(lat) / (t1 - t0)
    return {"rate": rate, "completed_per_s": done_per_s,
            "p50_ms": statistics.median(lat) if lat else None,
            "p99_ms": percentile(lat, 99) if lat else None,
            "backlog_start_mid_end": marks,
            "ms_per_tick": 1e3 * (t1 - t0) / (loop.ticks - run.setup_ticks),
            "held_first": loop.held_first, "dropped": len(loop.dropped),
            "sustained": marks[2] <= marks[1] + run.I * run.C // 8
            and done_per_s >= SUSTAINED * rate}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    from xlbench.harness import release
    for rate in args.rates:
        print(json.dumps(sweep_rate(args.workload, rate, args.seconds,
                                    args.seed)), flush=True)
        release()
    return 0


if __name__ == "__main__":
    sys.exit(main())

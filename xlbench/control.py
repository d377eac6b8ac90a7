"""The control of ``correct``: the readings that the token gap's limit is
set from.  For each seed, one run of the cell as the benchmark runs it
(a short window), then on the same sample of served calls the gap of the
program's tokens and the gap of the tokens that the reference computed
one precision lower (TF32 products where the configuration states
float32 with TF32 off) puts first.  The program's gaps over a dozen seeds
give the limit's lower reading, the control's over three or more its
upper one (PERF.md).  Not part of a benchmark run:

    python3 xlbench/control.py --workload <cell> --seconds 2 --seeds 1 2 3

prints one JSON line a seed, in one process (the kernels build once).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def readings(workload: str, seed: int, seconds: float, device="cuda",
             bench=None, cfg=None, spec=None) -> dict:
    """One run's checks, and the control's token gap on its sample."""
    from xlbench import check, deploy, harness
    bench = bench if bench is not None else deploy.load_benchmark()
    cell, centry = deploy.find_cell(bench, workload)
    cfg = cfg if cfg is not None else deploy.read_config(centry)
    spec = spec if spec is not None else deploy.read_traffic(cell["traffic"])
    run = harness.Run(cell, cfg, spec, seed, seconds, False, device)
    run.setup()
    run.window()
    got = run.collect()
    correct, checks, _ = check.judge(run, got)
    calls = [(run.requests[r].prompt_token, list(run.requests[r].tokens))
             for r in check.token_sample(run)]
    control = check.token_gaps(run.m, run.params, calls, run.device,
                               tf32_argmax=True)
    return {"seed": seed, "correct": correct,
            "checks": {k: v for k, (v, _) in checks.items()},
            "control_token_gap": control, "calls": len(calls),
            "positions": sum(len(t) for _, t in calls)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    from xlbench.harness import release
    for seed in args.seeds:
        t = time.perf_counter()
        r = readings(args.workload, seed, args.seconds)
        r["s"] = time.perf_counter() - t
        print(json.dumps(r), flush=True)
        release()
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Device and call time of the admission kernel at the serving shape:
B2 (``ops.admit_commit``) and B3 (``ops.admit``), R = 256 requests over a
64 x 16 pool and the six policies, with the inputs ``chip_smoke.py``
builds.

    python3 tools/admit_timing.py [--src DIR] [--reps N]

``--src`` names the ``src`` directory of the port to time (default: this
checkout's), so that two checkouts can be timed in turns on one card with
the same inputs (A, B, B, A).  Needs one CUDA device; prints the card's
name and power limit, then one JSON line: per wrapper the device ms per
call (profiler, the sum over the kernels of one call) and the call ms
(CUDA events over back-to-back calls, host time included).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--reps", type=int, default=200)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("admit_timing: torch finds no CUDA device", file=sys.stderr)
        return 1
    src = Path(args.src).resolve()
    sys.path.insert(0, str(src))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as CS
    from repro_torch.core import balancer as B
    from repro_torch.core import routing_table as RT
    from repro_torch.kernels import ops

    gpu = CS.gpu_line()
    print(gpu)
    dev = torch.device("cuda")
    routing0, _ = CS.routing_config(RT, "cpu")
    routing, reqs, pool, rnd, gum = CS.admit_inputs(
        torch, RT, routing0, CS.ADMIT_R, CS.I_LANES, CS.SLOTS,
        seed=CS.ADMIT_R, dev=dev)
    batch = B.RequestBatch(*reqs)
    pstate = B.PoolState(*pool)
    free = pool[5] == 0
    calls = {"admit_commit": lambda: ops.admit_commit(batch, routing, pstate,
                                                      rnd, gum),
             "admit": lambda: ops.admit(batch, routing, free, rnd, gum)}
    out = {"src": str(src), "gpu": gpu}
    for name, call in calls.items():
        out[name] = {
            "ms": CS.kernel_ms(torch, call, "admit_kernel", reps=args.reps),
            "call_ms": CS.cuda_ms(torch, call, reps=args.reps, warm=20)}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

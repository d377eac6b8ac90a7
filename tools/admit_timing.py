#!/usr/bin/env python3
"""Device and call time of the serving datapath's kernels, with the inputs
``chip_smoke.py`` builds:

- ``--kernel admit`` (default): the admission kernel at the serving shape,
  B2 (``ops.admit_commit``) and B3 (``ops.admit``), R = 256 requests over
  a 64 x 16 pool and the six policies;
- ``--kernel complete``: the completion kernel B1 (``ops.complete``) over
  the 64 x 16 pool with warm EWMAs;
- ``--kernel relay``: the relay kernel B5 (``ops.relay_slots``) at each of
  ``chip_smoke.RELAY_SHAPES``;
- ``--kernel route``: the route kernel B4 (``ops.route_match``) at R = 256
  and 4096 over the serving routing state.

    python3 tools/admit_timing.py [--kernel admit|complete|relay|route]
                                  [--src DIR] [--reps N]

``--src`` names the ``src`` directory of the port to time (default: this
checkout's), so that two checkouts can be timed in turns on one card with
the same inputs (A, B, B, A).  Needs one CUDA device; prints the card's
name and power limit, then one JSON line: per wrapper (and shape) the
device ms per call (profiler, the sum over the kernels of one call) and
the call ms (CUDA events over back-to-back calls, host time included).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def admit_calls(torch, CS, dev):
    from repro_torch.core import balancer as B
    from repro_torch.core import routing_table as RT
    from repro_torch.kernels import ops
    routing0, _ = CS.routing_config(RT, "cpu")
    routing, reqs, pool, rnd, gum = CS.admit_inputs(
        torch, RT, routing0, CS.ADMIT_R, CS.I_LANES, CS.SLOTS,
        seed=CS.ADMIT_R, dev=dev)
    batch = B.RequestBatch(*reqs)
    pstate = B.PoolState(*pool)
    free = pool[5] == 0
    return {"admit_commit": (lambda: ops.admit_commit(batch, routing, pstate,
                                                      rnd, gum),
                             "admit_kernel"),
            "admit": (lambda: ops.admit(batch, routing, free, rnd, gum),
                      "admit_kernel")}


def complete_calls(torch, CS, dev):
    from repro_torch.core import balancer as B
    from repro_torch.core import routing_table as RT
    from repro_torch.kernels import ops
    args = CS.complete_inputs(torch, RT, dev)
    pstate = B.PoolState(*args[:6])
    return {"complete": (lambda: ops.complete(pstate, *args[6:], eos=1,
                                              max_len=CS.MAX_LEN),
                         "complete_kernel")}


def relay_calls(torch, CS, dev):
    from repro_torch.kernels import ops
    calls = {}
    for N, nd in CS.RELAY_SHAPES:
        idx = CS.relay_inputs(torch, N, nd, dev)
        calls[f"relay_slots[N={N},n_dest={nd}]"] = (
            lambda idx=idx, nd=nd: ops.relay_slots(idx, nd), "relay_kernel")
    return calls


def route_calls(torch, CS, dev):
    from repro_torch.core import routing_table as RT
    from repro_torch.kernels import ops
    routing0, _ = CS.routing_config(RT, "cpu")
    calls = {}
    for R in (CS.ADMIT_R, 4096):
        routing, reqs, _, _, _ = CS.admit_inputs(
            torch, RT, routing0, R, CS.I_LANES, CS.SLOTS, seed=R + 1,
            dev=dev)
        calls[f"route_match[R={R}]"] = (
            lambda svc=reqs[1], feats=reqs[2], routing=routing:
            ops.route_match(svc, feats, routing), "route_kernel")
    return calls


KERNELS = {"admit": admit_calls, "complete": complete_calls,
           "relay": relay_calls, "route": route_calls}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel", choices=sorted(KERNELS), default="admit")
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

    gpu = CS.gpu_line()
    print(gpu)
    calls = KERNELS[args.kernel](torch, CS, torch.device("cuda"))
    out = {"src": str(src), "gpu": gpu, "kernel": args.kernel}
    for name, (call, key) in calls.items():
        out[name] = {
            "ms": CS.kernel_ms(torch, call, key, reps=args.reps),
            "call_ms": CS.cuda_ms(torch, call, reps=args.reps, warm=20)}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

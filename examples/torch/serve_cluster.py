"""Serve a microservice application graph (bookinfo) behind XLB, on the
PyTorch port.

One engine per service; requests fan out along the call graph.  All three
architectures run through the same Balancer protocol + ControlPlane-built
routing (``repro_torch.workload.hops``): the comparison below is the
paper's Fig. 11 in miniature with no per-engine glue.

Run:  PYTHONPATH=src python examples/torch/serve_cluster.py [--device cpu]
"""

import argparse

from repro_torch.configs import BOOKINFO
from repro_torch.workload import hops


def main(argv=None) -> dict:
    """Runs the example and returns what it prints: ``rows``, one
    ``run_graph`` result a mode (istio, cilium, xlb), and ``lines``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--requests", type=int, default=8)
    args = ap.parse_args(argv)
    lines = [f"topology: {BOOKINFO.name}: " + " -> ".join(BOOKINFO.chain())]
    print(lines[0])
    rows = {}
    for mode in ("istio", "cilium", "xlb"):
        r = hops.run_graph(mode, BOOKINFO, n_requests=args.requests,
                           tokens_per_req=2, device=args.device)
        rows[mode] = r
        lines.append(f"{mode:7s}: {r['completed']} done  "
                     f"{r['req_per_s']:8.1f} req/s  avg {r['avg_ms']:7.2f} ms")
        print(lines[-1])
    return {"rows": rows, "lines": lines}


if __name__ == "__main__":
    main()

"""Quickstart on the PyTorch port: the XLB in-graph L7 load balancer.

Builds a canary-routing config (the paper's §5.1 example: one virtual IP,
v2-cookie users go to the canary pool) through the ControlPlane, builds
the serving engine, pushes requests through it, then commits a *delta
refresh* transaction (grow the stable pool + shift a weight): one splice
into the live tables and a single version bump.

Run:  PYTHONPATH=src python examples/torch/quickstart.py [--device cpu]
(the card by default: admission and completion launch their kernels,
the decode its attention kernel).
"""

import argparse

import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.core.balancer import make_balancer
from repro_torch.core.control import ControlPlane
from repro_torch.core.routing_table import (POLICY_LEAST_REQUEST, POLICY_RR,
                                            Cluster, Rule, ServiceConfig)
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.runtime.serve_loop import Request, ServeLoop


def main(argv=None) -> dict:
    """Runs the example and returns what it prints: ``completed`` (the
    first drain), ``requests``, ``no_route``, ``overflow``,
    ``completed_after`` (the drain after the transaction),
    ``routing_version``, ``cp_version`` and ``lines``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    lines = []

    def say(line):
        print(line)
        lines.append(line)

    # 1. the application: a tiny LM standing in for a microservice fleet
    cfg = smoke_config(get_config("xlb-service-model"))
    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           torch.float32, device)

    # 2. control plane: Envoy-style config → RoutingState tables, owned by
    # a ControlPlane (names, slot allocation, transactions)
    cp = ControlPlane(
        services=[ServiceConfig("frontend", rules=[
            Rule(field=2, value="v2", cluster="canary"),      # version
            Rule(field=2, value=None, cluster="stable"),      # wildcard
        ])],
        clusters=[
            Cluster("canary", endpoints=[0], policy=POLICY_RR),
            Cluster("stable", endpoints=[1, 2, 3],
                    policy=POLICY_LEAST_REQUEST),
        ])

    # 3. data plane: 4 instance lanes × 4 slots, admission + decode a tick
    engine = make_balancer("xlb", cfg, n_instances=4, slots=4, max_len=12,
                           device=device)
    loop = ServeLoop(engine, params, cp)       # attaches the loop to cp

    for i in range(8):
        loop.submit(Request(req_id=i, service=0,
                            headers={"path": "/checkout",
                                     "version": "v2" if i % 4 == 0
                                     else "v1"},
                            prompt_token=3 + i))
    rep = loop.drain()
    completed = len(rep.done)
    say(f"completed {completed} requests "
        f"(queued={rep.queued} inflight={rep.inflight})")
    for r in sorted(rep.done, key=lambda r: r.req_id)[:4]:
        say(f"  req {r.req_id} ({r.headers['version']}): tokens={r.tokens}")

    m = loop.state.metrics
    requests, no_route, overflow = (int(m.requests.sum()),
                                    int(m.no_route_match), int(m.overflow))
    say(f"traffic metrics: requests = {requests}  no_route = {no_route}  "
        f"overflow = {overflow}")

    # 4. delta refresh: one transaction grows the stable pool and
    # re-weights the canary while the datapath keeps serving — the same
    # table shapes, spliced in place, one version bump for the batch.
    with cp.transaction():
        cp.add_endpoint("stable", instance=3)
        cp.set_weight("canary", instance=0, weight=2.0)
    loop.submit(Request(req_id=100, service=0, headers={"version": "v1"},
                        prompt_token=9))
    rep = loop.drain()
    routing_version = int(loop.routing.version)
    say(f"after delta refresh: completed {len(rep.done)} total, "
        f"routing version = {routing_version} "
        f"(control plane commit #{cp.version})")
    return {"completed": completed, "requests": requests,
            "no_route": no_route, "overflow": overflow,
            "completed_after": len(rep.done),
            "routing_version": routing_version, "cp_version": cp.version,
            "lines": lines}


if __name__ == "__main__":
    main()

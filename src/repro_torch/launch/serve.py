"""Serving launcher: ``python -m repro_torch.launch.serve --arch
xlb-service-model|minitron-4b|mamba2-2.7b [--smoke] --engine
xlb|istio|cilium --policy least_request --instances 4 --slots 4
--requests 32 --max-len 24 [--shards M] [--device cuda|cpu]``.

Boots the chosen engine (XLB or one of the sidecar baselines) with the
chosen architecture at full width, or at the reference's reduced config
with ``--smoke`` (the config the reference serves), random weights from a
generator seeded with 0 on the device; one service routed to one cluster
over the instances under the chosen policy, built by a ``ControlPlane``
that the loop attaches to; and drives a synthetic request stream through
the continuous-batching loop.  ``--shards M`` shards the XLB engine's
admission batch and pool over an M-way shard mesh, all shards on the one
device.  Runs on the card unless ``--device cpu`` is given.  An
encoder-decoder arch is refused as the reference refuses it; an arch
whose family the port does not have yet raises ``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import (ASSIGNED_ARCHS, ENCDEC_ARCHS, get_config,
                                  smoke_config)
from repro_torch.core.balancer import ENGINE_KINDS, make_balancer
from repro_torch.core.control import ControlPlane
from repro_torch.core.routing_table import (POLICY_NAMES, Cluster, Rule,
                                            ServiceConfig)
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_shard_mesh
from repro_torch.models import model as M
from repro_torch.runtime.serve_loop import Request, ServeLoop


def arch_config(arch: str, smoke: bool):
    """The config ``serve`` runs for ``arch``: full width, or the
    reference's reduced config with ``smoke``."""
    if arch in ENCDEC_ARCHS:
        raise SystemExit("enc-dec serving needs prompt frames; use the "
                         "dry-run decode cells for whisper")
    try:
        cfg = get_config(arch)
    except KeyError:
        raise NotImplementedError(
            f"{arch}: its config and family are not ported yet (ROADMAP.md "
            "item 12); serve takes xlb-service-model, minitron-4b and "
            "mamba2-2.7b") from None
    return smoke_config(cfg) if smoke else cfg


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlb-service-model",
                    choices=ASSIGNED_ARCHS + ["xlb-service-model"])
    ap.add_argument("--smoke", action="store_true",
                    help="the reference's reduced config of the arch")
    ap.add_argument("--engine", default="xlb", choices=ENGINE_KINDS)
    ap.add_argument("--instances", type=int, default=4)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--max-len", type=int, default=24)
    ap.add_argument("--policy", default="least_request",
                    choices=sorted(POLICY_NAMES),
                    help="load-balancing policy of the serving cluster")
    ap.add_argument("--shards", type=int, default=1,
                    help="shard the admission batch + pool over an M-way "
                    "shard mesh (xlb engine only), every shard on --device")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    cfg = arch_config(args.arch, args.smoke)
    kw = {}
    if args.shards > 1:
        if args.engine != "xlb":
            raise SystemExit("--shards needs the in-graph engine "
                             "(--engine xlb); the sidecar baselines route "
                             "on the host")
        if args.instances % args.shards:
            raise SystemExit(f"--instances {args.instances} must divide "
                             f"over --shards {args.shards}")
        kw = dict(shards=args.shards,
                  shard_mesh=make_shard_mesh(args.shards,
                                             device=args.device))
    device = resolve_device(args.device)
    params = M.init_params(cfg, torch.Generator(device).manual_seed(0),
                           dtype=torch.float32, device=device)
    cp = ControlPlane(
        [ServiceConfig("svc", rules=[Rule(0, None, "pool")])],
        [Cluster("pool", endpoints=list(range(args.instances)),
                 policy=POLICY_NAMES[args.policy])])
    eng = make_balancer(args.engine, cfg, args.instances, args.slots,
                        args.max_len, device=device, **kw)
    loop = ServeLoop(eng, params, cp, admit_batch=8, dtype=torch.float32)

    t0 = time.perf_counter()
    for i in range(args.requests):
        loop.submit(Request(req_id=i, service=0,
                            headers={"path": f"/api/{i % 4}"},
                            prompt_token=3 + i % (cfg.vocab - 3)))
    rep = loop.drain()
    wall = time.perf_counter() - t0
    lat = [r.t_done - r.t_submit for r in rep.done] or [float("nan")]
    shards = f", {args.shards} shards" if args.shards > 1 else ""
    print(f"{cfg.name} [{args.engine}, {device}{shards}]: {len(rep.done)} "
          f"requests in {wall:.2f}s ({len(rep.done)/wall:.1f} req/s), avg "
          "latency "
          f"{1e3*np.mean(lat):.1f} ms, p99 "
          f"{1e3*np.percentile(lat, 99):.1f} ms")
    if rep.queued or rep.inflight or rep.dropped:
        print(f"drain left: queued={rep.queued} inflight={rep.inflight} "
              f"dropped={len(rep.dropped)}")
    m = loop.state.metrics
    print(f"metrics: tx={int(m.tx_bytes.sum())}B rx={int(m.rx_bytes.sum())}B "
          f"no_route={int(m.no_route_match)} overflow={int(m.overflow)}")
    return len(rep.done)


if __name__ == "__main__":
    main()

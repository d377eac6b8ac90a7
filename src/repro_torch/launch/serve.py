"""Serving launcher: ``python -m repro_torch.launch.serve --arch
xlb-service-model|minitron-4b|mamba2-2.7b|granite-20b|internlm2-20b|
yi-34b|chameleon-34b|arctic-480b|deepseek-v2-236b|jamba-v0.1-52b
[--smoke] --engine xlb|istio|cilium --policy
least_request --instances 4 --slots 4 --requests 32 --max-len 24
[--shards M] [--device cuda|cpu] [--trace]``, or one rank a shard:
``torchrun --nproc-per-node M -m repro_torch.launch.serve --shards M``.

Boots the chosen engine (XLB or one of the sidecar baselines) with the
chosen architecture at full width, or at the reference's reduced config
with ``--smoke`` (the config the reference serves), random weights from a
generator seeded with 0 on the device; one service routed to one cluster
over the instances under the chosen policy, built by a ``ControlPlane``
that the loop attaches to; and drives a synthetic request stream through
the continuous-batching loop.  ``--shards M`` shards the XLB engine's
admission batch and pool over an M-way shard mesh: all shards on the one
device in this process, or, under ``torchrun`` (``WORLD_SIZE`` = M in the
environment) or a process group the caller initialised, one rank a shard
(``launch/mesh.py::RankShardMesh``).  The ranks join over NCCL where each
has a card of its own, else over ``gloo`` (``--device cpu``, or ranks
sharing a card); every rank runs the same loop over the same requests and
rank 0 prints the report.  Runs on the card unless ``--device cpu`` is
given.  An
encoder-decoder arch (whisper) is refused as the reference refuses it.
The serving weights are f32, so the 20-34 B dense archs and the moe and
hybrid ones fit one card only with ``--smoke`` (granite-20b alone is
about 113 GB in f32).  ``--trace`` keeps the loop's spans and counters
(``runtime/trace.py``) and prints, after the drain, host ms a tick of
each span, each counter a tick, the requests' queue wait (``t_admit -
t_submit``) p50 and p99, the XLB engine's weights with bf16 planes (the
nine-product decode) and their bytes, and the captured tick's first calls
split into warm-up, sync and capture seconds.
"""

from __future__ import annotations

import argparse
import os
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
from repro_torch.launch.mesh import init_shard_group, make_shard_mesh
from repro_torch.models import model as M
from repro_torch.runtime.serve_loop import Request, ServeLoop
from repro_torch.runtime.trace import Tracer, table


def arch_config(arch: str, smoke: bool):
    """The config ``serve`` runs for ``arch``: full width, or the
    reference's reduced config with ``smoke``."""
    if arch in ENCDEC_ARCHS:
        raise SystemExit("enc-dec serving needs prompt frames; use the "
                         "dry-run decode cells for whisper")
    cfg = get_config(arch)
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
    ap.add_argument("--trace", action="store_true",
                    help="time the loop's phases and print them after the "
                    "drain")
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
        device, owned = _rank_device(args.shards, args.device)
        kw = dict(shards=args.shards,
                  shard_mesh=make_shard_mesh(args.shards, device=device))
    else:
        device, owned = resolve_device(args.device), False
    try:
        return _serve(args, cfg, device, kw)
    finally:
        if owned:
            import torch.distributed as dist
            dist.destroy_process_group()


def _rank_device(shards: int, device: str) -> tuple[torch.device, bool]:
    """The device of this process's shards and whether this call
    initialised the process group.  One rank a shard under a process group
    of ``shards`` ranks: the caller's, or, under ``torchrun``
    (``WORLD_SIZE`` in the environment), one initialised here (NCCL when
    every local rank has a card of its own, else ``gloo``).  A rank takes
    card ``LOCAL_RANK`` (else its rank) modulo the cards there are.
    Without either, every shard runs in this process on ``device``."""
    import torch.distributed as dist
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if dist.is_initialized():
        if dist.get_world_size() != shards:     # not a group of the shards
            return resolve_device(device), False
        owned, rank = False, dist.get_rank()
    elif world == 1:
        return resolve_device(device), False
    elif world != shards:
        raise SystemExit(f"--shards {shards} under torchrun with {world} "
                         "ranks: one rank a shard")
    else:
        owned, rank = True, int(os.environ.get("RANK", "0"))
    if device == "cuda":
        resolve_device(device)                   # raises without a GPU
        n = torch.cuda.device_count()
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                      str(rank))) % n)
        torch.cuda.set_device(dev)
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
        backend = "nccl" if local_world <= n else "gloo"
    else:
        dev, backend = torch.device("cpu"), "gloo"
    if owned:
        init_shard_group(backend)
    return dev, owned


def _serve(args, cfg, device, kw) -> int:
    import torch.distributed as dist
    rank0 = not dist.is_initialized() or dist.get_rank() == 0
    params = M.init_params(cfg, torch.Generator(device).manual_seed(0),
                           dtype=torch.float32, device=device)
    cp = ControlPlane(
        [ServiceConfig("svc", rules=[Rule(0, None, "pool")])],
        [Cluster("pool", endpoints=list(range(args.instances)),
                 policy=POLICY_NAMES[args.policy])])
    eng = make_balancer(args.engine, cfg, args.instances, args.slots,
                        args.max_len, device=device, **kw)
    loop = ServeLoop(eng, params, cp, admit_batch=8, dtype=torch.float32)
    if args.trace:
        loop.tracer = Tracer()

    t0 = time.perf_counter()
    for i in range(args.requests):
        loop.submit(Request(req_id=i, service=0,
                            headers={"path": f"/api/{i % 4}"},
                            prompt_token=3 + i % (cfg.vocab - 3)))
    rep = loop.drain()
    wall = time.perf_counter() - t0
    lat = [r.t_done - r.t_submit for r in rep.done] or [float("nan")]
    if not rank0:
        return len(rep.done)
    shards = f", {args.shards} shards" if args.shards > 1 else ""
    if dist.is_initialized() and args.shards > 1:
        shards += f" on {dist.get_world_size()} ranks"
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
    if loop.tracer is not None:
        print(f"host spans over {loop.ticks} ticks:")
        print(table(loop.tracer.totals(), loop.ticks))
        wait = [r.t_admit - r.t_submit for r in rep.done] or [float("nan")]
        print(f"queue wait (submit to the launch of the admitting tick): "
              f"p50 {1e3*np.percentile(wait, 50):.3f} ms, p99 "
              f"{1e3*np.percentile(wait, 99):.3f} ms")
        if hasattr(eng, "plane_weights"):
            print(f"weights with bf16 planes (the nine-product decode): "
                  f"{eng.plane_weights}, {eng.plane_bytes} B")
        g = getattr(loop.serve_step, "graphs", None)
        if g is not None and len(g):
            print(f"captured programs {len(g)}: set-up {g.setup_s:.4f} s = "
                  f"warm-up {g.warmup_s:.4f} + sync {g.sync_s:.4f} + "
                  f"capture {g.capture_s:.4f}")
    return len(rep.done)


if __name__ == "__main__":
    main()

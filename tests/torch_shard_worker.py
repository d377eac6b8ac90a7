"""One rank of ``tests/test_torch_shard_ranks.py``'s ``gloo`` runs: ``python
tests/torch_shard_worker.py RANK WORLD DIR``.

It joins a ``gloo`` group of WORLD ranks through a ``FileStore`` in DIR
(``launch/mesh.py::init_shard_group``: a lost collective fails after 120
s), builds the rank shard mesh (``make_shard_mesh``), reads the inputs the
test wrote there (``inputs.pkl``: numpy arrays, no JAX) and writes what
this rank's shard gave to ``rank{RANK}.pkl``.

Every scenario is a function of a shard mesh, so the test runs the same
functions in its own process over the one-process ``ShardMesh`` and holds
the two meshes equal bit for bit.  Each returns what this process holds:
the per-row outputs of its rows of the batch, its slice of the pool, and
the replicated tables.
"""

import pickle
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import convert
from repro_torch.configs import XLB_SERVICE_MODEL as CFG
from repro_torch.core import control as TCtl
from repro_torch.core import interpose as TI
from repro_torch.core import relay as TRelay
from repro_torch.core.balancer import PoolState, RequestBatch, make_balancer
from repro_torch.core.routing_table import POLICY_RR
from repro_torch.kernels import ops, shard_admit
from repro_torch.launch import mesh as MS
from repro_torch.models import model as TM
from repro_torch.runtime import serve_loop as TS
from repro_torch.runtime import transport as TT

CPU = torch.device("cpu")
AXIS = "shard"


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else x


def _held_pool(mesh, arrays):
    """This process's instances of a whole-pool (I, ...) array: shard m
    owns rows [m·I/M, (m+1)·I/M)."""
    M, held = mesh.shape[AXIS], mesh.held
    x = torch.from_numpy(np.array(arrays))
    n = x.shape[0] // M
    return x[held[0] * n:(held[-1] + 1) * n]


def _record(res) -> dict:
    out = {}
    for f in res._fields:
        v = getattr(res, f)
        if f == "pool":
            out.update({f"pool.{g}": _np(getattr(v, g)) for g in v._fields})
        else:
            out[f] = _np(v)
    return out


def admit_case(mesh, case: dict) -> dict:
    """``ops.admit_commit_sharded`` on this process's rows of the case's
    batch and its slice of the pool; ``live`` as this process reads it
    from its own rows."""
    rows = lambda a, fill=0: shard_admit.held_rows(        # noqa: E731
        torch.from_numpy(np.array(a)), mesh, AXIS, fill)
    reqs = RequestBatch(req_id=rows(case["req_id"], -1),
                        svc=rows(case["svc"]), features=rows(case["features"]),
                        token=rows(case["token"]),
                        msg_bytes=rows(case["msg_bytes"]))
    pool = PoolState(*(_held_pool(mesh, case["pool"][f])
                       for f in PoolState._fields))
    live = shard_admit.live_shards(reqs.req_id, len(mesh.held))
    res = ops.admit_commit_sharded(
        reqs, convert.routing_from_numpy(case["state"], CPU), pool,
        rows(case["rnd"]), rows(case["gumbel"]), mesh=mesh, axis=AXIS,
        live=live)
    return {**_record(res), "live": live}


def complete_case(mesh, case: dict) -> dict:
    pool = PoolState(*(_held_pool(mesh, case["pool"][f])
                       for f in PoolState._fields))
    t = lambda k: torch.from_numpy(np.array(case[k]))     # noqa: E731
    res = ops.complete_sharded(pool, _held_pool(mesh, case["nxt"]),
                               t("load"), t("rx"), t("ewl"), t("ewt"),
                               mesh=mesh, axis=AXIS, eos=1, max_len=8)
    return _record(res)


def sharded_apply_case(mesh, case: dict) -> dict:
    """``relay.sharded_apply`` with this process's shards' rows, and with
    a per-source quota of 1."""
    M, held = mesh.shape[AXIS], mesh.held
    sl = slice(held[0], held[-1] + 1)
    per = lambda a: torch.from_numpy(                       # noqa: E731
        np.array(a)).reshape(M, -1, *np.shape(a)[1:])[sl]
    x, idx, w, scale = (per(case[k]) for k in ("x", "idx", "w", "scale"))
    out, meta = TRelay.sharded_apply(
        x, idx, w, case["E"], case["C"], mesh, AXIS,
        lambda p, pool: pool * p[:, None, :], scale)
    _, tight = TRelay.sharded_apply(x, idx, None, case["E"], 1, mesh, AXIS,
                                    lambda p, pool: pool, scale)
    return {"out": _np(out), "load": _np(meta.load), "ok": _np(meta.ok),
            "overflow": float(meta.overflow_frac),
            "tight_ok": _np(tight.ok), "tight_load": _np(tight.load)}


# --------------------------------------------------------------------------- #
# serving scenarios
# --------------------------------------------------------------------------- #


class Replay:
    """Draws handed out in order: the reference engine's, recorded by the
    test (every rank replays the whole batch's draws and takes its rows)."""

    def __init__(self, draws):
        self.draws = list(draws)

    def __call__(self, n):
        rnd, gum = self.draws.pop(0)
        assert rnd.shape[0] == n, (rnd.shape, n)
        return torch.from_numpy(rnd), torch.from_numpy(gum)


def drain_record(loop, mod, n_requests: int = 48) -> dict:
    """Submit the drain's traffic, drain, and summarise what is left:
    the report, the replicated routing and metrics, this process's pool."""
    rng = np.random.RandomState(3)
    for i in range(n_requests):
        hdr = {"path": f"/p/{rng.randint(6)}", "user": f"u{rng.randint(9)}"}
        loop.submit(mod.Request(req_id=i, service=int(rng.randint(6)),
                                headers=hdr,
                                prompt_token=int(rng.randint(3, 500))))
    rep = loop.drain(max_ticks=400)
    a = lambda x: np.asarray(x).tolist()                    # noqa: E731
    return {"report": ([(r.req_id, r.tokens, r.retries, r.submit_tick,
                         r.admit_tick, r.done_tick) for r in rep.done],
                       [r.req_id for r in rep.dropped], rep.queued,
                       rep.inflight, rep.held_first),
            "ticks": loop.ticks,
            "routing": {f: a(getattr(loop.routing, f))
                        for f in loop.routing._fields},
            "metrics": {f: a(getattr(loop.state.metrics, f))
                        for f in loop.state.metrics._fields},
            "pool": {f: a(getattr(loop.state.pool, f))
                     for f in loop.state.pool._fields}}


def drain(mesh, inp: dict, draws=None) -> dict:
    """48 requests through ``ServeLoop`` over ``Engine(shards=M)`` on
    ``mesh`` (4 lanes x 4 slots, admit 8, max_len 6, eos -1): with the
    reference's draws replayed, or (``draws`` None) with the engine's own
    generator, then also the host's loop state and the engine's next
    draw, which must be the same on every rank."""
    M = mesh.shape[AXIS]
    eng = TI.Engine(CFG, 4, 4, 6, eos=-1, device="cpu", shards=M,
                    shard_mesh=mesh)
    if draws is not None:
        eng.draws = Replay(draws)
    params = convert.params_from_jax(inp["weights"], CPU)
    loop = TS.ServeLoop(eng, params,
                        convert.routing_from_numpy(inp["drain_routing"], CPU),
                        admit_batch=8, dtype=torch.float32)
    rec = drain_record(loop, TS)
    if draws is None:
        rnd, gum = eng.draws(8)
        rec["host"] = {"queue": [r.req_id for r in loop.queue],
                       "waiting": [(t, r.req_id) for t, _, r in
                                   loop._waiting],
                       "inflight": sorted(loop.inflight),
                       "submitted": loop.submitted,
                       "next_draw": (rnd.tolist(), gum.numpy().tobytes())}
    return rec


def _params():
    return TM.init_params(CFG, torch.Generator().manual_seed(0),
                          torch.float32, "cpu")


def _sharded_engine(mesh):
    return make_balancer("xlb", CFG, 2, 2, 8, device="cpu",
                         shards=mesh.shape[AXIS], shard_mesh=mesh)


def transaction(mesh) -> dict:
    """One transaction mid-serve on a sharded loop over a two-endpoint
    round-robin cluster (twin of ``test_torch_shard.py``'s): the routing
    version before and after, the drained slot's flag, and, per tick after
    the commit, whether this process's pool slice holds a new request on
    the drained endpoint or holds one at all."""
    cp = TCtl.ControlPlane(
        [TCtl.ServiceConfig("svc", rules=[TCtl.Rule(0, None, "pool")])],
        [TCtl.Cluster("pool", endpoints=[0, 1], policy=POLICY_RR)])
    loop = TS.ServeLoop(_sharded_engine(mesh), _params(), cp, admit_batch=4)
    for i in range(4):
        loop.submit(TS.Request(req_id=i, service=0, headers={},
                               prompt_token=3 + i))
    loop.tick()
    v0 = int(loop.routing.version)
    with cp.transaction():
        cp.drain_endpoint("pool", 1)
        cp.set_weight("pool", 0, 2.0)
    slot = cp.endpoint_slot("pool", 1)
    rec = {"v0": v0, "v1": int(loop.routing.version),
           "cp_version": cp.version,
           "drained": int(loop.routing.ep_drained[slot]),
           "on_drained": [], "new": []}
    for i in range(4, 10):
        loop.submit(TS.Request(req_id=i, service=0, headers={},
                               prompt_token=3 + i))
    for _ in range(30):
        loop.tick()
        p = loop.state.pool
        rec["on_drained"].append(bool(((p.endpoint == slot) & (p.req_id >= 4)
                                       & p.active).any()))
        rec["new"].append(bool(((p.req_id >= 4) & p.active).any()))
    rec["done"] = sorted(r.req_id for r in loop.done)
    rec["routing"] = {f: np.asarray(getattr(loop.routing, f)).tolist()
                      for f in loop.routing._fields}
    return rec


def crash_rejoin(mesh) -> dict:
    """A sharded loop attached through the lossy plan transport holds load
    on an endpoint the operator drains (its lane 1 stalled), then crashes;
    the lease expiry unpins the drain, and the restarted incarnation
    resyncs once and serves again (twin of ``test_torch_shard.py``'s).
    Returns every fact that test asserts, in order."""
    cp = TCtl.ControlPlane(
        [TCtl.ServiceConfig("svc", rules=[TCtl.Rule(0, None, "pool")])],
        [TCtl.Cluster("pool", endpoints=[0, 1], policy=POLICY_RR)],
        lease_epochs=2)
    hub = TT.Transport(cp, TT.LossyChannel(seed=5))
    rc = hub.consumer("ingress-0")
    eng = _sharded_engine(mesh)
    params = _params()
    loop = TS.ServeLoop(eng, params, rc, admit_batch=4,
                        fault=TS.FaultInjector([TS.Fault(instance=1,
                                                         kind="stall")]))
    t = [0]

    def pump(n, lp=None):
        for _ in range(n):
            hub.pump(t[0])
            if lp is not None:
                lp.tick()
            t[0] += 1

    facts = []
    for i in range(6):
        loop.submit(TS.Request(req_id=200 + i, service=0, headers={},
                               prompt_token=3 + i))
    pump(4, loop)
    cp.drain_endpoint("pool", 1)
    pump(3, loop)
    slot1 = cp.endpoint_slot("pool", 1)
    facts.append(("versions", rc.version, cp.version))
    facts.append(("drained", int(loop.routing.ep_drained[slot1])))
    proxy = hub.publisher.nodes["ingress-0"].proxy
    facts.append(("pinned load", int(proxy.routing.ep_load[slot1])))
    cp.reap()
    facts.append(("held", len(cp.cluster_members("pool")), cp.version))
    rc.crash()
    for _ in range(4):
        cp.advance_epoch()
        pump(1)
    facts.append(("lease", cp.lease_live(proxy)))
    cp.reap()
    facts.append(("reaped", len(cp.cluster_members("pool")), cp.version))
    cp.set_weight("pool", 0, 2.0)
    facts.append(("weight", cp.version))
    pump(4)
    facts.append(("acked", hub.publisher.nodes["ingress-0"].acked))
    rc.restart()
    loop2 = TS.ServeLoop(eng, params, rc, admit_batch=4)
    pump(12, loop2)
    facts.append(("resync", rc.resyncs, rc.version, cp.version))
    TT.assert_converged(cp, [rc])
    for i in range(4):
        loop2.submit(TS.Request(req_id=300 + i, service=0, headers={},
                                prompt_token=3))
    pump(20, loop2)
    facts.append(("served", len(loop2.done)))
    facts.append(("done", [(r.req_id, r.tokens, r.done_tick)
                           for r in loop.done + loop2.done]))
    return {"facts": facts}


def int32_psum(mesh) -> list:
    """Every shard's (2**31 - 1, -5), summed over the mesh in int32."""
    x = torch.tensor([[2**31 - 1, -5]], dtype=torch.int32)
    return mesh.psum(x.expand(len(mesh.held), 2)).tolist()


def run(mesh, inp: dict) -> dict:
    M = mesh.shape[AXIS]
    out = {"admit": {k: admit_case(mesh, c)
                     for k, c in inp["admit"].items()},
           "complete": {k: complete_case(mesh, c)
                        for k, c in inp["complete"].items()},
           "int32_psum": int32_psum(mesh),
           "drain_replay": drain(mesh, inp, inp["draws"]),
           "drain_own": drain(mesh, inp)}
    if M == 4:
        out["sharded_apply"] = sharded_apply_case(mesh, inp["sharded_apply"])
    if M == 2:
        out["transaction"] = transaction(mesh)
        out["crash_rejoin"] = crash_rejoin(mesh)
    return out


def main(rank: int, world: int, where: Path) -> None:
    MS.init_shard_group("gloo", rank=rank, world_size=world,
                        store=dist.FileStore(str(where / "store"), world))
    try:
        mesh = MS.make_shard_mesh(world, AXIS, device="cpu")
        assert isinstance(mesh, MS.RankShardMesh) and mesh.held == (rank,)
        inp = pickle.loads((where / "inputs.pkl").read_bytes())
        out = run(mesh, inp)
        (where / f"rank{rank}.pkl").write_bytes(pickle.dumps(out))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3]))

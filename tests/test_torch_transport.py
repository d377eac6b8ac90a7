"""The port's plan transport (``runtime/transport.py``) against the JAX
reference, on the CPU.

Every case runs the same script on both packages and compares what it
left behind: channel fates and ``stats()``, consumer histories and
counters, publisher stats, convergence reports, the replicas' routing
tables, and the ``ValueError`` text of a refused payload.

* ``LossyChannel``: seeded drop / duplicate / delay-reorder and
  partition windows.
* ``RemoteConsumer``: out-of-order plans held then chained, duplicates
  and stale versions as no-ops, corrupt plans refused whole, a snapshot
  resync that keeps surviving endpoints' live load.
* ``Transport``: a journal gap costs one resync, a contiguous suffix
  ships as plans, a crash and restart rejoin with one resync, a
  lease-dead node gets nothing until it rejoins, capped retry backoff,
  heartbeats carry load votes to the reaper, and the reference's chaos
  schedule converges and replays.
* A ``ServeLoop`` attached through a ``RemoteConsumer`` (the reference's
  chaos leg at a small pool): histories, channel stats and the chaos
  row equal under ``json.dumps``.

Tolerance: exact.
"""

import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.xlb_microbench import XLB_SERVICE_MODEL as JCFG
from repro.core import control as JCtl
from repro.core import interpose as JI
from repro.core import routing_table as JR
from repro.models import model as JM
from repro.runtime import serve_loop as JS
from repro.runtime import transport as JT
from repro import workload as JW
from repro_torch import convert, workload as TW
from repro_torch.configs import XLB_SERVICE_MODEL as TCFG
from repro_torch.core import control as TCtl
from repro_torch.core import interpose as TI
from repro_torch.runtime import serve_loop as TS
from repro_torch.runtime import transport as TT

CPU = torch.device("cpu")
REF = types.SimpleNamespace(ctl=JCtl, tr=JT, arr=jnp.asarray)
PORT = types.SimpleNamespace(ctl=TCtl, tr=TT, arr=torch.from_numpy)


def _np(x):
    return np.asarray(x).tolist()


def _cp(p, **kw):
    c = p.ctl
    return c.ControlPlane(
        [c.ServiceConfig("front", rules=[c.Rule(0, "v2", "canary"),
                                         c.Rule(0, None, "stable")])],
        [c.Cluster("canary", endpoints=[0, 1], policy=JR.POLICY_RR),
         c.Cluster("stable", endpoints=[2, 3, 4],
                   policy=JR.POLICY_LEAST_REQUEST)], **kw)


def _routing(r):
    return {f: _np(getattr(r, f)) for f in r._fields}


def _consumer(rc):
    return {"history": list(rc.history), "version": rc.version,
            "counters": (rc.resyncs, rc.stale, rc.held, rc.rejected,
                         rc.crashes, rc.incarnation),
            "routing": _routing(rc.routing)}


def _both(fn):
    """Run ``fn`` on the reference and the port; the summaries must be
    equal.  Returns the port's."""
    ref, port = fn(REF), fn(PORT)
    assert port == ref
    return port


def _raises(fn):
    """``fn``'s ValueError text on both packages, which must agree."""
    def run(p):
        with pytest.raises(ValueError) as e:
            fn(p)
        return str(e.value)
    return _both(run)


# --------------------------------------------------------------------------- #
# LossyChannel
# --------------------------------------------------------------------------- #

CHANNELS = {
    "reliable": dict(delay_min=1),
    "lossy": dict(seed=7, p_drop=0.4, p_dup=0.3, delay_min=1, delay_max=4),
    "instant": dict(seed=3, p_drop=0.2, delay_min=0),
    "partition": dict(seed=5, p_dup=0.2, delay_min=1, delay_max=2,
                      faults=((2, 5, "a"), (8, 11, None))),
}


@pytest.mark.parametrize("name", list(CHANNELS))
def test_channel_fates_match_reference(name):
    def run(p):
        kw = dict(CHANNELS[name])
        kw["faults"] = tuple(p.tr.ChannelFault(*f)
                             for f in kw.get("faults", ()))
        ch = p.tr.LossyChannel(**kw)
        got = []
        for t in range(40):
            for dst in ("a", "b"):
                ch.send(dst, {"n": t, "dst": dst}, t)
            got.append([(d, m["n"]) for d in ("a", "b")
                        for m in ch.recv(d, t)])
        return got, ch.stats()

    got, stats = _both(run)
    assert stats["delivered"] == sum(len(g) for g in got)
    if name != "reliable":
        assert stats["delivered"] != stats["sent"]


def test_channel_rejects_bad_delay_bounds():
    assert "delay_max" in _raises(
        lambda p: p.tr.LossyChannel(delay_min=3, delay_max=1))
    assert "delay_min" in _raises(lambda p: p.tr.LossyChannel(delay_min=-1))


# --------------------------------------------------------------------------- #
# snapshots
# --------------------------------------------------------------------------- #


def test_snapshot_state_and_plan_match_reference():
    def run(p):
        cp = _cp(p)
        cp.add_endpoint("canary", instance=9)
        snap = cp.packed_snapshot()
        st = p.tr.snapshot_state(snap)
        plan = p.tr.snapshot_plan(snap, st)
        return (_routing(st), [_np(a) for a in plan.config], _np(plan.ep_src),
                _np(plan.ep_dst), plan.base_version, plan.version)

    out = _both(run)
    assert out[-2:] == (-1, 1)


@pytest.mark.parametrize("bad", ["missing", "version", "shape", "dtype",
                                 "not_dict"])
def test_snapshot_validation_matches_reference(bad):
    def run(p):
        snap = _cp(p).packed_snapshot()
        if bad == "missing":
            del snap["maglev_table"]
        elif bad == "version":
            snap["version"] = -1
        elif bad == "shape":
            snap["ep_weight"] = snap["ep_weight"][:3]
        elif bad == "dtype":
            snap["ep_instance"] = snap["ep_instance"].astype(np.float64)
        else:
            snap = list(snap.items())
        p.tr.snapshot_state(snap)

    _raises(run)


# --------------------------------------------------------------------------- #
# RemoteConsumer protocol
# --------------------------------------------------------------------------- #


def _out_of_order(p):
    cp = _cp(p)
    ch = p.tr.LossyChannel(delay_min=0)
    rc = p.tr.RemoteConsumer("n0", ch, snapshot=cp.packed_snapshot())
    cp.set_weight("canary", instance=0, weight=2.0)
    cp.set_weight("canary", instance=1, weight=3.0)
    p1, p2 = cp.journal[-2], cp.journal[-1]
    ch.send("n0", {"kind": "plan", **p2}, 0)
    rc.pump(0)
    held = (rc.held, rc.version)
    ch.send("n0", {"kind": "plan", **p1}, 1)
    rc.pump(1)
    return held, _consumer(rc)


def _duplicates(p):
    cp = _cp(p)
    ch = p.tr.LossyChannel(delay_min=0)
    rc = p.tr.RemoteConsumer("n0", ch, snapshot=cp.packed_snapshot())
    cp.set_weight("canary", instance=0, weight=2.0)
    wire = {"kind": "plan", **cp.journal[-1]}
    for t in range(3):
        ch.send("n0", wire, t)
        rc.pump(t)
    return _consumer(rc)


def _corrupt(p):
    cp = _cp(p)
    ch = p.tr.LossyChannel(delay_min=0)
    rc = p.tr.RemoteConsumer("n0", ch, snapshot=cp.packed_snapshot())
    cp.set_weight("canary", instance=0, weight=2.0)
    wire = {"kind": "plan", **cp.journal[-1]}
    wire["ep_weight"] = np.asarray(wire["ep_weight"])[:3]
    ch.send("n0", wire, 0)
    unversioned = {"kind": "plan", **cp.journal[-1], "version": -1,
                   "base_version": -1}
    ch.send("n0", unversioned, 0)
    rc.pump(0)
    return _consumer(rc)


def _resync_keeps_load(p):
    cp = _cp(p)
    ch = p.tr.LossyChannel(delay_min=0)
    rc = p.tr.RemoteConsumer("n0", ch, snapshot=cp.packed_snapshot())
    slot = cp.endpoint_slot("stable", 3)
    load = np.asarray(rc.routing.ep_load).copy()
    load[slot] = 7
    rc.sink.routing = rc.routing._replace(ep_load=p.arr(load))
    cp.add_endpoint("canary", instance=9)
    cp.set_weight("stable", instance=2, weight=1.5)
    ch.send("n0", {"kind": "snapshot", **cp.packed_snapshot()}, 0)
    rc.pump(0)
    return _consumer(rc), cp.endpoint_slot("stable", 3)


@pytest.mark.parametrize("script", [_out_of_order, _duplicates, _corrupt,
                                    _resync_keeps_load],
                         ids=lambda f: f.__name__.strip("_"))
def test_consumer_protocol_matches_reference(script):
    out = _both(script)
    if script is _resync_keeps_load:
        rc, slot = out
        assert rc["counters"][0] == 1 and rc["routing"]["ep_load"][slot] == 7
    if script is _corrupt:
        assert out["counters"][3] == 2 and out["version"] == 0


# --------------------------------------------------------------------------- #
# Transport end to end
# --------------------------------------------------------------------------- #


def _settle(hub, rcs, t0, budget=60):
    t = t0
    for _ in range(budget):
        hub.pump(t)
        for rc in rcs:
            rc.pump(t)
        t += 1
        if hub.report()["converged"]:
            return t
    raise AssertionError("transport did not settle: "
                         + "; ".join(hub.report()["issues"]))


def _summary(hub, ch=None):
    return {"report": hub.report(),
            "publisher": hub.publisher.stats(),
            "consumers": [_consumer(rc) for rc in hub.consumers],
            "channel": (ch or hub.channel).stats()}


def _journal_gap(p):
    cp = _cp(p, journal_limit=2)
    hub = p.tr.Transport(cp, p.tr.LossyChannel(delay_min=0))
    rc = hub.consumer("n0")
    for i in range(5):
        cp.set_weight("stable", instance=2, weight=1.0 + 0.1 * (i + 1))
    _settle(hub, [rc], 0)
    return _summary(hub)


def _suffix_as_plans(p):
    cp = _cp(p, journal_limit=16)
    hub = p.tr.Transport(cp, p.tr.LossyChannel(delay_min=0))
    rc = hub.consumer("n0")
    for i in range(4):
        cp.set_weight("stable", instance=2, weight=1.0 + 0.1 * (i + 1))
    _settle(hub, [rc], 0)
    return _summary(hub)


def _crash_restart(p):
    cp = _cp(p)
    hub = p.tr.Transport(cp, p.tr.LossyChannel(delay_min=1))
    rc = hub.consumer("n0")
    cp.set_weight("canary", instance=0, weight=2.0)
    t = _settle(hub, [rc], 0)
    rc.crash()
    cp.set_weight("canary", instance=1, weight=3.0)
    cp.add_endpoint("stable", instance=8)
    for dt in range(4):
        hub.pump(t + dt)
    rc.restart()
    _settle(hub, [rc], t + 4)
    return _summary(hub)


def _lease_gating(p):
    cp = _cp(p, lease_epochs=2)
    hub = p.tr.Transport(cp, p.tr.LossyChannel(delay_min=1))
    rc = hub.consumer("n0")
    cp.set_weight("canary", instance=0, weight=2.0)
    t = _settle(hub, [rc], 0)
    rc.crash()
    hub.pump(t)
    for _ in range(4):
        cp.advance_epoch()
    cp.set_weight("canary", instance=1, weight=3.0)
    dead = dict(hub.publisher.stats()["n0"])
    for dt in range(1, 7):
        hub.pump(t + dt)
    still = dict(hub.publisher.stats()["n0"])
    rc.restart()
    _settle(hub, [rc], t + 6)
    return dead == still, _summary(hub)


def _retry_backoff(p):
    cp = _cp(p)
    hub = p.tr.Transport(cp, p.tr.LossyChannel(p_drop=1.0), retry_base=1,
                         retry_cap=8, seed=5)
    hub.consumer("n0", boot=False)
    ticks, last = [], -1
    for t in range(200):
        hub.pump(t)
        s = hub.publisher.stats()["n0"]["snap_sends"]
        if s != last:
            ticks.append(t)
            last = s
    return ticks


def _load_votes(p):
    cp = _cp(p)
    hub = p.tr.Transport(cp, p.tr.LossyChannel(delay_min=1))
    rc = hub.consumer("n0")
    slot = cp.endpoint_slot("stable", 4)
    load = np.asarray(rc.routing.ep_load).copy()
    load[slot] = 3
    rc.sink.routing = rc.routing._replace(ep_load=p.arr(load))
    for t in range(3):
        hub.pump(t)
        rc.pump(t)
    vote = int(hub.publisher.nodes["n0"].proxy.routing.ep_load[slot])
    cp.drain_endpoint("stable", instance=4)
    pinned = cp.drain_reason("stable", 4)
    load[slot] = 0
    rc.sink.routing = rc.routing._replace(ep_load=p.arr(load.copy()))
    for t in range(3, 8):
        hub.pump(t)
        rc.pump(t)
    cp.set_weight("canary", instance=0, weight=1.1)
    return vote, pinned, cp.drain_reason("stable", 4), \
        cp.cluster_members("stable"), _summary(hub)


def _chaos(p, seed=11):
    cp = _cp(p, lease_epochs=3, journal_limit=8)
    ch = p.tr.LossyChannel(seed=seed, p_drop=0.25, p_dup=0.15, delay_min=1,
                           delay_max=3,
                           faults=(p.tr.ChannelFault(10, 22, dst="n1"),))
    hub = p.tr.Transport(cp, ch, seed=seed)
    rcs = [hub.consumer("n0"), hub.consumer("n1")]
    for t in range(70):
        if t in (4, 14, 24, 34, 44):
            cp.set_weight("stable", instance=2, weight=1.0 + 0.01 * t)
        if t % 5 == 0:
            cp.advance_epoch()
        if t == 18:
            rcs[0].crash()
        if t == 30:
            rcs[0].restart()
        hub.pump(t)
        for rc in rcs:
            rc.pump(t)
    _settle(hub, rcs, 70, budget=80)
    hub.assert_converged()
    return _summary(hub)


@pytest.mark.parametrize("script", [_journal_gap, _suffix_as_plans,
                                    _crash_restart, _lease_gating,
                                    _retry_backoff, _load_votes, _chaos],
                         ids=lambda f: f.__name__.strip("_"))
def test_transport_matches_reference(script):
    out = _both(script)
    if script is _journal_gap:
        assert out["consumers"][0]["counters"][0] == 1
    if script is _suffix_as_plans:
        assert out["publisher"]["n0"]["snap_sends"] == 0
    if script is _lease_gating:
        assert out[0] and out[1]["consumers"][0]["counters"][0] == 1
    if script is _retry_backoff:
        gaps = [b - a for a, b in zip(out, out[1:])]
        assert all(1 <= g <= 16 for g in gaps) and gaps[-1] >= 8
    if script is _load_votes:
        assert out[:3] == (3, "operator", None)
    if script is _chaos:
        ch = out["channel"]
        assert out["report"]["converged"] and out["report"]["head"] == 5
        assert ch["dropped"] and ch["duped"] and ch["partitioned"]


def test_convergence_report_flags_match_reference():
    def run(p):
        cp = _cp(p)
        hub = p.tr.Transport(cp, p.tr.LossyChannel(delay_min=0))
        rc = hub.consumer("n0")
        cp.set_weight("canary", instance=0, weight=2.0)
        behind = p.tr.convergence_report(cp, [rc])
        forged = p.tr.RemoteConsumer("n1", p.tr.LossyChannel(),
                                     snapshot=cp.packed_snapshot())
        forged.history = [(0, "plan", 0, 1), (1, "plan", 3, 4)]
        gap = p.tr.convergence_report(cp, [forged])
        _settle(hub, [rc], 0)
        with pytest.raises(AssertionError) as e:
            p.tr.assert_converged(cp, [forged])
        return behind, gap, p.tr.convergence_report(cp, [rc]), str(e.value)

    behind, gap, settled, _ = _both(run)
    assert not behind["converged"] and settled["converged"]
    assert any("lost bump" in s for s in gap["issues"])


# --------------------------------------------------------------------------- #
# ServeLoop attached through a RemoteConsumer: the chaos leg
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def weights():
    jp = JM.init_params(JCFG, jax.random.PRNGKey(0), jnp.float32)
    return jp, convert.params_from_jax(jax.tree.map(np.asarray, jp), CPU)


class ReplayDraws:
    """The reference engine's draws, replayed and handed to the port."""

    def __init__(self):
        self.key = jax.random.PRNGKey(0)

    def __call__(self, n):
        self.key, sub = jax.random.split(self.key)
        kr, kw, _ = jax.random.split(sub, 3)
        rnd = jax.random.randint(kr, (n,), 0, 1 << 30, dtype=jnp.int32)
        gum = jax.random.gumbel(kw, (n, JR.MAX_EPS_PER_CLUSTER), jnp.float32)
        return torch.from_numpy(np.array(rnd)), torch.from_numpy(np.array(gum))


def _serve_chaos(weights, port: bool, n_inst=4, seed=23, total=170):
    """The reference's chaos leg through ``ServeLoop`` (instead of its
    benchmark's service wrapper): a lossy channel with a partition of the
    serving consumer, a replica crashed and restarted, the operator
    schedule, a slow instance, Poisson arrivals; then a flush."""
    jp, tp = weights
    ctl, tr, sl, wl = (TCtl, TT, TS, TW) if port else (JCtl, JT, JS, JW)
    cp = ctl.ControlPlane(
        [ctl.ServiceConfig("svc", rules=[ctl.Rule(0, None, "pool")])],
        [ctl.Cluster("pool", endpoints=list(range(n_inst)),
                     policy=JR.POLICY_WEIGHTED)], lease_epochs=3)
    chan = tr.LossyChannel(seed=seed, p_drop=0.15, p_dup=0.10, delay_min=1,
                           delay_max=4,
                           faults=[tr.ChannelFault(22, 58, dst="ingress-0")])
    hub = tr.Transport(cp, chan, retry_base=1, retry_cap=8, seed=seed + 1)
    rc = hub.consumer("ingress-0")
    sick = n_inst - 1
    inj = sl.FaultInjector([sl.Fault(sick, "slow", factor=8, start=20,
                                     end=78)])
    if port:
        eng = TI.Engine(TCFG, n_inst, 4, 3, eos=-1, device="cpu")
        eng.draws = ReplayDraws()
        loop = TS.ServeLoop(eng, tp, rc, admit_batch=8, fault=inj)
    else:
        loop = JS.ServeLoop(JI.Engine(JCFG, n_inst, 4, 3, eos=-1), jp, rc,
                            admit_batch=8, fault=inj)
    replica = hub.consumer("replica-1")
    work = wl.Workload(wl.PoissonArrivals(rate=1.0, seed=seed),
                       n_requests=130, vocab=JCFG.vocab)
    ops = [wl.Op(6, "canary", args={"instance": 1, "pct": 40.0}),
           wl.Op(24, "drain", args={"instance": sick}),
           wl.Op(40, "set_weight", args={"instance": 0, "weight": 1.4}),
           wl.Op(72, "canary", args={"instance": 2, "pct": 50.0}),
           wl.Op(88, "undrain", args={"instance": sick, "weight": 1.0})]
    driver = wl.ScenarioDriver([cp], ops, max_instances=n_inst)
    rid = 0
    for t in range(total):
        driver.apply(t)
        if (t + 1) % 6 == 0:
            cp.advance_epoch()
        if t == 44:
            replica.crash()
        if t == 76:
            replica.restart()
        hub.pump(t)
        for r in work.wave(t, rid):
            loop.submit(sl.Request(req_id=r, service=0, headers={},
                                   prompt_token=3 + r % (JCFG.vocab - 3)))
            rid += 1
        loop.tick()
        replica.pump(t)
    flush = 0
    while flush < 120:
        t = total + flush
        hub.pump(t)
        loop.tick()
        replica.pump(t)
        flush += 1
        if not (loop.queue or loop._waiting or loop.inflight) \
                and hub.report()["converged"]:
            break
    rep = hub.assert_converged()
    done = {r.req_id: r for r in loop.done}

    def p99(lo, hi):
        return wl.percentiles([r.done_tick - r.submit_tick
                               for r in done.values()
                               if lo <= r.done_tick < hi])["p99"]

    healthy, recovered = p99(4, 20), p99(110, total + flush)
    cs, pub = chan.stats(), hub.publisher.stats()
    row = wl.chaos_row(
        "chaos", "xlb", seed=seed, n_requests=rid, completed=len(done),
        dropped=len(loop.dropped), ticks=total, flush_ticks=flush,
        versions=cp.version, consumers=len(hub.consumers),
        resyncs=sum(c.resyncs for c in hub.consumers),
        crashes=sum(c.crashes for c in hub.consumers),
        converged=bool(rep["converged"]), healthy_p99_ticks=healthy,
        chaos_p99_ticks=p99(20, 110), recovered_p99_ticks=recovered,
        recovery_ratio=recovered / healthy if healthy else float("nan"),
        msgs_sent=cs["sent"], msgs_dropped=cs["dropped"],
        msgs_duped=cs["duped"], msgs_delivered=cs["delivered"],
        msgs_partitioned=cs["partitioned"],
        stale=sum(c.stale for c in hub.consumers),
        held=sum(c.held for c in hub.consumers),
        rejected=sum(c.rejected for c in hub.consumers),
        plan_sends=sum(s["plan_sends"] for s in pub.values()),
        snap_sends=sum(s["snap_sends"] for s in pub.values()),
        ops=len(ops), txns=driver.txns, rate=1.0)
    return {"row": json.dumps(row), "log": driver.log,
            "histories": [list(c.history) for c in hub.consumers],
            "channel": cs, "publisher": pub,
            "latency": {k: v.tolist()
                        for k, v in loop.latency_samples().items()},
            "resyncs": replica.resyncs}


def test_serve_loop_through_remote_consumer_matches_reference(weights):
    ref, port = _serve_chaos(weights, False), _serve_chaos(weights, True)
    assert port == ref
    row = json.loads(port["row"])
    assert row["converged"] and row["completed"] == row["n_requests"] == 130
    assert row["crashes"] == 1 and port["resyncs"] == 1
    assert row["msgs_partitioned"] > 0 and row["txns"] == 5

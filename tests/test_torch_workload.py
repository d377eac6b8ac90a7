"""The port's workload subsystem (``workload/``) and ``scale_fleet``
(``runtime/elastic.py``) against the JAX reference, on the CPU.

* Arrival processes, service-time laws and ``Workload``'s waves,
  features and request batches: the same keyed draws.
* ``ServiceTimeShaper`` on numpy and tensor pools: the same holds tick
  by tick.
* The live-ops ops (canary, blue-green, rolling restart, scale,
  add_endpoint) and ``scale_fleet``: the same journals, commit logs,
  driver logs, transaction counts and refusals.
* ``percentiles``, ``scenario_row``, ``chaos_row`` and their validators:
  rows equal under ``json.dumps``, the same ``ValueError`` text for a
  malformed row.

Tolerance: exact.
"""

import json
import types

import numpy as np
import pytest
import torch

from repro import workload as JW
from repro.core import control as JCtl
from repro.core import routing_table as JR
from repro.runtime import elastic as JE
from repro_torch import workload as TW
from repro_torch.core import control as TCtl
from repro_torch.core.balancer import PoolState
from repro_torch.runtime import elastic as TE

REF = types.SimpleNamespace(w=JW, ctl=JCtl, el=JE)
PORT = types.SimpleNamespace(w=TW, ctl=TCtl, el=TE)


def _both(fn):
    ref, port = fn(REF), fn(PORT)
    assert port == ref
    return port


def _raises(fn, exc=ValueError):
    def run(p):
        with pytest.raises(exc) as e:
            fn(p)
        return str(e.value)
    return _both(run)


# --------------------------------------------------------------------------- #
# generators
# --------------------------------------------------------------------------- #

ARRIVALS = [("PoissonArrivals", dict(rate=3.0, seed=1)),
            ("PoissonArrivals", dict(rate=2.0, seed=3, scale=8.0)),
            ("BurstyArrivals", dict(rate=5.0, seed=0, on_ticks=4,
                                    off_ticks=4)),
            ("BurstyArrivals", dict(rate=4.0, seed=21, on_ticks=3,
                                    off_ticks=2, off_rate=0.5, phase=1)),
            ("DiurnalArrivals", dict(rate=1.0, peak=9.0, period=64,
                                     seed=4))]


@pytest.mark.parametrize("name,kw", ARRIVALS,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(ARRIVALS)])
def test_arrivals_match_reference(name, kw):
    out = _both(lambda p: (
        [getattr(p.w, name)(**kw).arrivals(t) for t in range(200)],
        [getattr(p.w, name)(**kw).rate_at(t) for t in range(200)]))
    assert sum(out[0]) > 0


LAWS = [("LognormalServiceTimes", dict(seed=4, median=3.0, sigma=0.8,
                                       floor=1, cap=20)),
        ("ParetoServiceTimes", dict(seed=4, xm=2.0, alpha=1.5, floor=1,
                                    cap=50)),
        ("FixedServiceTimes", dict(floor=3))]


@pytest.mark.parametrize("name,kw", LAWS, ids=[n for n, _ in LAWS])
def test_service_time_laws_match_reference(name, kw):
    ts = _both(lambda p: [getattr(p.w, name)(**kw).ticks(r, hop)
                          for hop in (0, 1) for r in range(200)])
    assert min(ts) >= kw["floor"]


def test_workload_waves_features_and_batches_match_reference():
    def run(p):
        wl = p.w.Workload(p.w.PoissonArrivals(rate=2.5, seed=11),
                          n_requests=40, seed=5, vocab=512)
        rid, waves, batches = 0, [], []
        for t in range(30):
            ids = wl.wave(t, rid)
            rid += len(ids)
            waves.append(ids)
            b = wl.request_batch(ids, pad_to=8)
            batches.append([np.asarray(x).tolist() for x in b])
        return waves, batches, rid

    waves, batches, n = _both(run)
    assert n == 40
    b = TW.Workload(TW.PoissonArrivals()).request_batch([1, 2], pad_to=4)
    assert all(isinstance(x, torch.Tensor) and x.device.type == "cpu"
               for x in b)
    assert TW.Workload(TW.PoissonArrivals()).shaper(2) is None
    assert TW.Workload(TW.PoissonArrivals(),
                       service=TW.FixedServiceTimes()).shaper(2) is None


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_shaper_matches_reference(kind):
    """Random pools for 30 ticks: the same slots held on each tick; every
    held slot had length > 0 and a request with extra ticks left."""
    law = dict(seed=9, median=6.0, sigma=0.5, cap=16)
    jsh = JW.ServiceTimeShaper(JW.LognormalServiceTimes(**law), base_ticks=2)
    tsh = TW.ServiceTimeShaper(TW.LognormalServiceTimes(**law), base_ticks=2)
    rng = np.random.RandomState(2)
    held = 0
    for t in range(30):
        req = rng.randint(-1, 12, (4, 3)).astype(np.int32)
        act = rng.rand(4, 3) < 0.8
        ln = rng.randint(0, 3, (4, 3)).astype(np.int32)
        jp = types.SimpleNamespace(req_id=req, active=act, length=ln.copy())
        want = jsh.apply(jp, t).length
        if kind == "numpy":
            tp = types.SimpleNamespace(req_id=req, active=act,
                                       length=ln.copy())
            got = tsh.apply(tp, t).length
        else:
            z = torch.zeros((4, 3), dtype=torch.int32)
            tp = PoolState(torch.from_numpy(req), z, z, torch.from_numpy(ln),
                           z, torch.from_numpy(act))
            out = tsh.apply(tp, t)
            got = out.length.numpy()
            assert (out is tp) == bool((got == ln).all())
        np.testing.assert_array_equal(got, want, err_msg=f"tick {t}")
        held += int((want != ln).sum())
    assert tsh._rem == jsh._rem and held > 0


# --------------------------------------------------------------------------- #
# scenarios and elastic scaling
# --------------------------------------------------------------------------- #


def _cp(p, n=3, policy=JR.POLICY_WEIGHTED):
    c = p.ctl
    return c.ControlPlane(
        [c.ServiceConfig("svc", rules=[c.Rule(0, None, "pool")])],
        [c.Cluster("pool", endpoints=list(range(n)), policy=policy)])


def _cp_state(cp):
    return {"version": cp.version, "journal": [
        {k: np.asarray(v).tolist() for k, v in e.items()} for e in cp.journal],
        "log": list(cp.last_commit_log),
        "members": cp.cluster_members("pool"),
        "weights": [cp.endpoint_weight("pool", i)
                    for _, i in cp.cluster_members("pool")],
        "drains": [cp.drain_reason("pool", i)
                   for _, i in cp.cluster_members("pool")]}


SCENARIOS = {
    "canary": (3, [(2, "canary", {"instance": 0, "pct": 80.0})], 4),
    "blue_green": (2, [(0, "add_endpoint", {"instance": 2, "weight": 0.0}),
                       (3, "blue_green", {"blue": [0, 1], "green": [2]})], 4),
    "rolling": (3, "rolling", 9),
    "scale": (2, [(1, "scale", {"target": 4}), (3, "scale", {"target": 1}),
                  (5, "scale", {"target": 3}),
                  (6, "set_weight", {"instance": 0, "weight": 2.0})], 7),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scenario_driver_matches_reference(name):
    n, ops, ticks = SCENARIOS[name]

    def run(p):
        cp = _cp(p, n)
        if ops == "rolling":
            sched = p.w.rolling_restart([0, 1], start=2, dwell=3)
        else:
            sched = [p.w.Op(t, op, args=a) for t, op, a in ops]
        drv = p.w.ScenarioDriver([cp], sched, max_instances=4)
        states = []
        for t in range(ticks):
            ran = drv.apply(t)
            states.append(([o.op for o in ran], _cp_state(cp)))
        return states, drv.txns, drv.log, drv.done()

    states, txns, log, done = _both(run)
    assert done and txns > 0


def test_scenario_refusals_match_reference():
    assert "max_instances" in _raises(lambda p: p.w.ScenarioDriver(
        [_cp(p)], [p.w.Op(0, "scale", args={"target": 2})]).apply(0))
    assert "unknown scenario op" in _raises(lambda p: p.w.ScenarioDriver(
        [_cp(p)], [p.w.Op(0, "explode")]).apply(0))

    def draining_canary(p):
        cp = _cp(p)
        holder = _Holder(cp)             # the control plane holds it weakly
        cp.attach(holder)
        p.w.ScenarioDriver([cp], [p.w.Op(0, "drain", args={"instance": 0}),
                                  p.w.Op(1, "canary", args={
                                      "instance": 0, "pct": 50.0})]).apply(1)
    assert "draining" in _raises(draining_canary)


class _Holder:
    """A consumer that keeps one in-flight request on every endpoint, so
    drained rows are not reaped."""

    def __init__(self, cp):
        snap = cp.snapshot()
        self.routing = snap._replace(
            ep_load=np.ones_like(np.asarray(snap.ep_load)))

    def apply_refresh(self, plan):
        pass


def test_scale_fleet_matches_reference():
    def run(p):
        cp = _cp(p, 2)
        out = [p.el.scale_fleet(cp, "pool", 4, max_instances=4),
               p.el.scale_fleet(cp, "pool", 1, max_instances=4),
               p.el.scale_fleet(cp, "pool", 3, max_instances=4)]
        held = _cp(p, 2, policy=JR.POLICY_RR)
        holder = _Holder(held)
        held.attach(holder)
        out += [p.el.scale_fleet(held, "pool", 1, max_instances=4),
                p.el.scale_fleet(held, "pool", 2, max_instances=4)]
        return out, _cp_state(cp), _cp_state(held)

    acts, _, _ = _both(run)
    assert acts[0] == [("add", 2), ("add", 3)]
    assert acts[3:] == [[("drain", 1)], [("undrain", 1)]]
    for target in (0, 9):
        assert "outside" in _raises(lambda p: p.el.scale_fleet(
            _cp(p, 2), "pool", target, max_instances=4))


# --------------------------------------------------------------------------- #
# SLO rows
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("samples", [[], list(range(1, 101)), [3, 3, 4],
                                     [7.5]])
def test_percentiles_match_reference(samples):
    out = _both(lambda p: json.dumps(p.w.percentiles(samples)))
    assert '"n": %d' % len(samples) in out


def _row(p, **kw):
    return p.w.scenario_row("chain", "xlb", depth=3, seed=11,
                            arrivals="poisson", n_requests=10, completed=10,
                            dropped=0, ticks=12, samples=[3, 3, 4], ops=1,
                            txns=1, rate=2.0, per_hop_p99_ticks=[1.0, 2.0],
                            **kw)


CHAOS = dict(n_requests=130, completed=130, dropped=0, ticks=170,
             flush_ticks=9, versions=5, consumers=2, resyncs=1, crashes=1,
             converged=True, healthy_p99_ticks=2.0, chaos_p99_ticks=9.5,
             recovered_p99_ticks=float("nan"),
             recovery_ratio=float("nan"), msgs_sent=400, msgs_dropped=50,
             msgs_duped=26, msgs_delivered=370, msgs_partitioned=12)


def test_rows_match_reference_under_json():
    out = _both(lambda p: (json.dumps(_row(p)), json.dumps(
        p.w.chaos_row("chaos", "xlb", seed=23, **CHAOS))))
    assert '"bench": "scenario"' in out[0] and "NaN" in out[1]


BAD_ROWS = [("bench", "perf"), ("completed", 20), ("p99_ticks", 1.0),
            ("depth", True), ("surprise", 1), ("seed", None)]


@pytest.mark.parametrize("field,value", BAD_ROWS,
                         ids=[f for f, _ in BAD_ROWS])
def test_row_validation_matches_reference(field, value):
    def run(p):
        row = dict(_row(p))
        if value is None:
            del row[field]
        else:
            row[field] = value
        p.w.validate_scenario_row(row)

    _raises(run)


@pytest.mark.parametrize("field,value", [("msgs_delivered", 999),
                                         ("resyncs", -1),
                                         ("converged", 1)])
def test_chaos_row_validation_matches_reference(field, value):
    _raises(lambda p: p.w.chaos_row("chaos", "xlb", seed=23,
                                    **dict(CHAOS, **{field: value})))


def test_format_slo_table_matches_reference():
    """The same rows give the same Markdown string: a complete chain row,
    one whose completions fall short of its requests (a drop and a
    request still queued), and a row without samples (NaN percentiles)."""
    def run(p):
        rows = [_row(p),
                p.w.scenario_row("canary", "istio", depth=1, seed=3,
                                 arrivals="bursty", n_requests=40,
                                 completed=37, dropped=1, ticks=90,
                                 samples=[2, 5, 5, 9, 30], ops=2, txns=2,
                                 rate=4.5),
                p.w.scenario_row("idle", "cilium", depth=2, seed=0,
                                 arrivals="poisson", n_requests=0,
                                 completed=0, dropped=0, ticks=1,
                                 samples=[], ops=0, txns=0, rate=0.0)]
        return p.w.slo.format_slo_table(rows)

    out = _both(run)
    assert "| 37/40 |" in out and "nan" in out and len(out.splitlines()) == 5

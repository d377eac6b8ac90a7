"""The port's sidecar baselines (``core/sidecar.py``) against the JAX
reference on the CPU, at the full width of ``xlb-service-model``.

* ``HostRouter`` picks under every policy, drains included, with the same
  ``RandomState`` seed on both sides (the random and weighted host picks
  draw from it).
* Multi-tick ``IstioEngine`` / ``CiliumEngine`` runs with ``eos=-1``
  (completion depends only on length): pool, load counters, rr cursors,
  affinity cache, metrics and health EWMAs after every tick.
* The engine-level contract of the reference's end-to-end tests, on the
  port: the sidecars emit every request, all three engines agree token by
  token, and every engine kind constructs.
* A ``ServeLoop`` drain under each sidecar against the reference's.

Tolerance: bit-exact on every integer and both f32 EWMAs; tokens equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.xlb_microbench import XLB_SERVICE_MODEL as JCFG
from repro.core import routing_table as JR
from repro.core import sidecar as JSide
from repro.core.balancer import RequestBatch as JBatch
from repro.models import model as JM
from repro.runtime import serve_loop as JS
from repro_torch import convert
from repro_torch.configs import XLB_SERVICE_MODEL as TCFG
from repro_torch.core import sidecar
from repro_torch.core.balancer import (ENGINE_KINDS, Balancer, RequestBatch,
                                       make_balancer)
from repro_torch.core.routing_table import (POLICY_RR, Cluster, Rule,
                                            ServiceConfig, build_state)
from repro_torch.models import model as TM
from repro_torch.runtime import serve_loop as TS

I, C, R, MAX_LEN = 4, 4, 8, 6
CPU = torch.device("cpu")
ROUTER_FIELDS = ("ep_load", "rr_cursor", "aff_key", "aff_ep",
                 "ep_inflight_ewma", "ep_tput_ewma")


@pytest.fixture(scope="module")
def weights():
    jp = JM.init_params(JCFG, jax.random.PRNGKey(0), jnp.float32)
    return jp, convert.params_from_jax(jax.tree.map(np.asarray, jp), CPU)


def _routing(policies, seed=0, drained=()):
    """One service per policy, each to its own 3-endpoint cluster over the
    instance lanes (a "v2" rule to it, else a wildcard to the next
    policy's cluster); random loads; drain bits after the build."""
    n = len(policies)
    services = [JR.ServiceConfig(f"s{i}", [JR.Rule(0, "v2", f"c{i}"),
                                           JR.Rule(1, None, f"c{(i + 1) % n}")])
                for i in range(n)]
    clusters = [JR.Cluster(f"c{i}", [(i + k) % I for k in range(3)],
                           policy=p, weights=[1.0, 3.0, 0.5])
                for i, p in enumerate(policies)]
    st, _ = JR.build_state(services, clusters)
    arrs = {f: np.array(getattr(st, f)) for f in st._fields}
    arrs["ep_load"][:] = np.random.RandomState(seed).randint(0, 3, 512)
    for e in drained:
        arrs["ep_drained"][e] = 1
    return (JR.RoutingState(*[jnp.asarray(arrs[f]) for f in st._fields]),
            convert.routing_from_numpy(arrs, CPU))


def _features(rng, n):
    feats = rng.randint(0, 50, (n, JR.N_FEATURES)).astype(np.int32)
    feats[:, 0] = np.where(rng.rand(n) < 0.5, JR.fnv1a("v2"), 3)
    return feats


# --------------------------------------------------------------------------- #
# HostRouter
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("drain", [False, True])
def test_host_router_matches_reference(drain):
    """80 requests over six clusters, one per policy, with repeated flows;
    with ``drain`` one endpoint of each cluster and then all of cluster 1
    drain, which must leave them without traffic."""
    drained = (0, 4, 8, 12, 16, 20) if drain else ()
    jst, tst = _routing(list(range(6)), seed=3, drained=drained)
    jr, tr = JSide.HostRouter(jst), sidecar.HostRouter(tst)
    rng = np.random.RandomState(5)
    feats = _features(rng, 80)
    feats[40:] = feats[rng.randint(0, 40, 40)]        # affinity hits
    svc = rng.randint(0, 6, 80)
    picks = []
    for r in range(80):
        if drain and r == 40:
            for h in (jr, tr):
                h.t.ep_drained[[3, 5]] = 1            # cluster 1 fully
        cl = tr.match(int(svc[r]), feats[r])
        assert cl == jr.match(int(svc[r]), feats[r])
        if cl < 0:
            continue
        got, want = tr.select(cl, feats[r]), jr.select(cl, feats[r])
        assert got == want, (r, cl)
        picks.append(got[0])
        if r % 7 == 0:
            tr.release(got[0])
            jr.release(want[0])
    for f in ROUTER_FIELDS:
        np.testing.assert_array_equal(getattr(tr.t, f),
                                      np.asarray(getattr(jr.t, f)), f)
    assert len(set(picks)) > 8
    if drain:
        assert not set(picks) & set(drained)
        assert tr.select(1) == (-1, -1)


@pytest.mark.parametrize("policy", range(6))
def test_host_router_skips_drained_endpoint(policy):
    services = [ServiceConfig("s", rules=[Rule(0, None, "pool")])]
    clusters = [Cluster("pool", endpoints=[0, 1, 2], policy=policy,
                        weights=[1.0, 9.0, 1.0])]
    st, ids = build_state(services, clusters, CPU)
    st = st._replace(ep_drained=st.ep_drained.index_fill(
        0, torch.tensor([1]), 1))
    hr = sidecar.HostRouter(st)
    feats = np.arange(8, dtype=np.int32)
    picks = [hr.select(ids["clusters"]["pool"], feats + k)[0]
             for k in range(24)]
    assert all(p in (0, 2) for p in picks)
    assert int(hr.t.ep_load[1]) == 0
    hr.t.ep_drained[[0, 2]] = 1
    assert hr.select(ids["clusters"]["pool"]) == (-1, -1)


# --------------------------------------------------------------------------- #
# engines against the reference, tick by tick
# --------------------------------------------------------------------------- #


def _ticks(n_ticks, n_svc, seed=0):
    rng = np.random.RandomState(seed)
    out, rid0 = [], 0
    for t in range(n_ticks):
        n = 0 if t in (2, 5) else rng.randint(3, R + 1)
        rid = np.full(R, -1, np.int32)
        rid[:n] = np.arange(rid0, rid0 + n)
        rid0 += n
        svc = rng.randint(0, n_svc, R).astype(np.int32)
        tok = rng.randint(0, JCFG.vocab, R).astype(np.int32)
        nbytes = rng.randint(1, 400, R).astype(np.int32)
        out.append((rid, svc, _features(rng, R), tok, nbytes))
    return out


@pytest.mark.parametrize("mode", ["istio", "cilium"])
def test_sidecar_engine_ticks_match_reference(weights, mode):
    jp, tp = weights
    jroute, troute = _routing(list(range(6)), drained=(1,))
    jeng = JSide.SidecarEngine(JCFG, I, C, MAX_LEN, mode=mode, eos=-1)
    teng = make_balancer(mode, TCFG, I, C, MAX_LEN, eos=-1, device="cpu")
    assert teng.mode == mode
    js = jeng.init_state(jroute, dtype=jnp.float32)
    ts = teng.init_state(troute, dtype=torch.float32)
    jstep, tstep = jeng.make_jitted(donate=False), teng.make_jitted()
    for tick, cols in enumerate(_ticks(9, 6)):
        js, jout = jstep(jp, js, JBatch(*map(jnp.asarray, cols)))
        ts, tout = tstep(tp, ts, RequestBatch(*map(torch.from_numpy, cols)))
        for name in ts.pool._fields:
            np.testing.assert_array_equal(
                getattr(ts.pool, name), getattr(js.pool, name),
                err_msg=f"tick {tick}: pool {name}")
        for name in ROUTER_FIELDS:
            np.testing.assert_array_equal(
                getattr(ts.router.t, name), getattr(js.router.t, name),
                err_msg=f"tick {tick}: router {name}")
        for name in ts.metrics._fields:
            np.testing.assert_array_equal(
                getattr(ts.metrics, name), getattr(js.metrics, name),
                err_msg=f"tick {tick}: metrics {name}")
        for name in ("emitted", "done", "req_id", "active"):
            np.testing.assert_array_equal(tout[name], jout[name],
                                          err_msg=f"tick {tick}: {name}")
    assert int(ts.metrics.overflow) > 0                 # the pool filled up
    assert float(ts.router.t.ep_tput_ewma.sum()) > 0    # completions seen


# --------------------------------------------------------------------------- #
# the reference's end-to-end contract, on the port
# --------------------------------------------------------------------------- #

E2E_I, E2E_C, E2E_LEN, NREQ = 2, 3, 24, 4


@pytest.fixture(scope="module")
def e2e():
    params = TM.init_params(TCFG, torch.Generator().manual_seed(7),
                            torch.float32, CPU)
    routing, _ = build_state(
        [ServiceConfig("svc", rules=[Rule(0, None, "pool")])],
        [Cluster("pool", endpoints=list(range(E2E_I)), policy=POLICY_RR)],
        CPU)
    return params, routing


def _reqs(n, pad_to=8):
    rid = torch.full((pad_to,), -1, dtype=torch.int32)
    rid[:n] = torch.arange(n)
    tok = torch.zeros((pad_to,), dtype=torch.int32)
    tok[:n] = 3 + torch.arange(n) % (TCFG.vocab - 3)
    z = torch.zeros((pad_to,), dtype=torch.int32)
    return RequestBatch(rid, z, torch.zeros((pad_to, 8), dtype=torch.int32),
                        tok, torch.full((pad_to,), 100, dtype=torch.int32))


def _drain(params, routing, kind, steps):
    """One loop for every engine: admit on step 0, then pure decode."""
    eng = make_balancer(kind, TCFG, E2E_I, E2E_C, E2E_LEN, device="cpu")
    assert isinstance(eng, Balancer)
    state = eng.init_state(routing, dtype=torch.float32)
    serve = eng.make_jitted(donate=False)
    reqs, streams = _reqs(NREQ), {}
    for _ in range(steps):
        state, out = serve(params, state, reqs)
        reqs = _reqs(0)
        emitted = np.asarray(out["emitted"])
        pool_req = np.asarray(state.pool.req_id)
        act = np.asarray(state.pool.active)
        for i, s in zip(*np.nonzero((pool_req >= 0) & act)):
            streams.setdefault(int(pool_req[i, s]), []).append(
                int(emitted[i, s]))
    return streams, state


def test_sidecars_emit_all_requests(e2e):
    params, routing = e2e
    for kind in ("istio", "cilium"):
        streams, state = _drain(params, routing, kind, steps=10)
        assert set(streams) == set(range(NREQ)), kind
        assert int(state.metrics.requests.sum()) == NREQ
        assert int(state.metrics.no_route_match) == 0
        assert int(state.metrics.rx_bytes.sum()) > 0


def test_xlb_matches_sidecars_tokenwise(e2e):
    params, routing = e2e
    xlb, istio, cilium = (_drain(params, routing, k, steps=10)[0]
                          for k in ("xlb", "istio", "cilium"))
    for r in range(NREQ):
        n = min(len(xlb[r]), len(istio[r]), len(cilium[r]))
        assert n >= 3
        assert xlb[r][:n] == istio[r][:n] == cilium[r][:n], r


def test_every_engine_kind_constructs():
    assert ENGINE_KINDS == ("xlb", "istio", "cilium")
    for kind in ENGINE_KINDS:
        eng = make_balancer(kind, TCFG, E2E_I, E2E_C, E2E_LEN, device="cpu")
        assert isinstance(eng, Balancer), kind
        assert eng.device == CPU
    with pytest.raises(ValueError):
        make_balancer("envoy", TCFG, E2E_I, E2E_C, E2E_LEN, device="cpu")


# --------------------------------------------------------------------------- #
# ServeLoop drains against the reference
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("mode", ["istio", "cilium"])
def test_serve_loop_drain_matches_reference(weights, mode):
    jp, tp = weights
    jroute, troute = _routing(list(range(6)), seed=1)
    jloop = JS.ServeLoop(JSide.SidecarEngine(JCFG, I, C, MAX_LEN, mode=mode,
                                             eos=-1),
                         jp, jroute, admit_batch=R, dtype=jnp.float32)
    tloop = TS.ServeLoop(make_balancer(mode, TCFG, I, C, MAX_LEN, eos=-1,
                                       device="cpu"),
                         tp, troute, admit_batch=R, dtype=torch.float32)
    rng = np.random.RandomState(3)
    for i in range(40):
        hdr = {"path": "v2" if rng.rand() < 0.5 else f"/p/{i}",
               "user": f"u{rng.randint(9)}"}
        svc, tok = int(rng.randint(6)), int(rng.randint(3, 500))
        for loop, mod in ((jloop, JS), (tloop, TS)):
            loop.submit(mod.Request(req_id=i, service=svc, headers=dict(hdr),
                                    prompt_token=tok))
    jrep, trep = jloop.drain(max_ticks=400), tloop.drain(max_ticks=400)
    assert len(trep.done) == len(jrep.done) == 40
    assert (len(trep.dropped), trep.queued, trep.inflight, trep.held_first) \
        == (len(jrep.dropped), jrep.queued, jrep.inflight, jrep.held_first)
    assert trep.held_first > 0
    assert [r.req_id for r in trep.done] == [r.req_id for r in jrep.done]
    assert [r.tokens for r in trep.done] == [r.tokens for r in jrep.done]
    jl, tl = jloop.latency_samples(), tloop.latency_samples()
    for k in jl:
        np.testing.assert_array_equal(tl[k], jl[k], err_msg=k)
    for name in tloop.state.metrics._fields:
        np.testing.assert_array_equal(getattr(tloop.state.metrics, name),
                                      getattr(jloop.state.metrics, name),
                                      err_msg=name)
    np.testing.assert_array_equal(tloop.routing.ep_load,
                                  troute.ep_load.numpy())
    assert tloop.ticks == jloop.ticks

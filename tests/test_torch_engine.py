"""The port's serving engine and serve loop against the JAX reference, on
the CPU, at the full width of ``xlb-service-model``.

* Engine level: several ticks of ``serve_step`` on both engines with
  ``eos=-1`` (completion depends only on length), one cluster per policy.
  The test replays the reference engine's key stream (split → randint /
  gumbel, advancing only on ticks with arrivals) and feeds those draws to
  the port through its ``draws`` hook.  Pool, routing counters, affinity
  cache, metrics and EWMAs must match bit-exactly on every tick.
* ServeLoop level: one drain per package over the same submissions, with
  rr, least-request, maglev and affinity clusters (policies without
  draws); the drain report, latency samples, metrics and the accounting
  identity must match.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.xlb_microbench import XLB_SERVICE_MODEL as JCFG
from repro.core import interpose as JI
from repro.core import routing_table as JR
from repro.core.balancer import RequestBatch as JBatch
from repro.models import model as JM
from repro.runtime import serve_loop as JS
from repro_torch import convert
from repro_torch.configs import XLB_SERVICE_MODEL as TCFG
from repro_torch.core import interpose as TI
from repro_torch.core.balancer import RequestBatch
from repro_torch.runtime import serve_loop as TS

I, C, R, MAX_LEN = 4, 4, 8, 6
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def weights():
    jp = JM.init_params(JCFG, jax.random.PRNGKey(0), jnp.float32)
    return jp, convert.params_from_jax(jax.tree.map(np.asarray, jp), CPU)


def _routing(policies, seed=0):
    """One service per policy, each to its own 3-endpoint cluster spread
    over the instance lanes; random loads."""
    services = [JR.ServiceConfig(f"s{i}", [JR.Rule(0, None, f"c{i}")])
                for i in range(len(policies))]
    clusters = [JR.Cluster(f"c{i}", [(i + k) % I for k in range(3)],
                           policy=p, weights=[1.0, 3.0, 0.5])
                for i, p in enumerate(policies)]
    st, _ = JR.build_state(services, clusters)
    arrs = {f: np.array(getattr(st, f)) for f in st._fields}
    arrs["ep_load"][:] = np.random.RandomState(seed).randint(0, 3, 512)
    return (JR.RoutingState(*[jnp.asarray(arrs[f]) for f in st._fields]),
            convert.routing_from_numpy(arrs, CPU))


class ReplayDraws:
    """The reference engine's draws (interpose.py Engine.admit), replayed
    outside its program and handed to the port."""

    def __init__(self):
        self.key = jax.random.PRNGKey(0)

    def __call__(self, n):
        self.key, sub = jax.random.split(self.key)
        kr, kw, _ = jax.random.split(sub, 3)
        rnd = jax.random.randint(kr, (n,), 0, 1 << 30, dtype=jnp.int32)
        gum = jax.random.gumbel(kw, (n, JR.MAX_EPS_PER_CLUSTER), jnp.float32)
        return torch.from_numpy(np.array(rnd)), torch.from_numpy(np.array(gum))


def _ticks(n_ticks, n_svc, seed=0):
    """Per tick: an admission batch (some ticks all padding)."""
    rng = np.random.RandomState(seed)
    out, rid0 = [], 0
    for t in range(n_ticks):
        n = 0 if t in (2, 5) else rng.randint(3, R + 1)
        rid = np.full(R, -1, np.int32)
        rid[:n] = np.arange(rid0, rid0 + n)
        rid0 += n
        svc = rng.randint(0, n_svc, R).astype(np.int32)
        feats = rng.randint(0, 50, (R, JR.N_FEATURES)).astype(np.int32)
        tok = rng.randint(0, JCFG.vocab, R).astype(np.int32)
        nbytes = rng.randint(1, 400, R).astype(np.int32)
        out.append((rid, svc, feats, tok, nbytes))
    return out


def _assert_state_equal(ts, js, tick):
    for name in ("req_id", "endpoint", "svc", "length", "token", "active"):
        np.testing.assert_array_equal(
            getattr(ts.pool, name).numpy(), np.asarray(getattr(js.pool, name)),
            err_msg=f"tick {tick}: pool {name}")
    for name in ("ep_load", "rr_cursor", "aff_key", "aff_ep",
                 "ep_inflight_ewma", "ep_tput_ewma"):
        np.testing.assert_array_equal(
            getattr(ts.routing, name).numpy(),
            np.asarray(getattr(js.routing, name)),
            err_msg=f"tick {tick}: routing {name}")
    for name in ts.metrics._fields:
        np.testing.assert_array_equal(
            getattr(ts.metrics, name).numpy(),
            np.asarray(getattr(js.metrics, name)),
            err_msg=f"tick {tick}: metrics {name}")


def test_engine_ticks_match_reference_all_policies(weights):
    jp, tp = weights
    policies = list(range(6))
    jroute, troute = _routing(policies)
    jeng = JI.Engine(JCFG, I, C, MAX_LEN, eos=-1)
    teng = TI.Engine(TCFG, I, C, MAX_LEN, eos=-1, device="cpu")
    teng.draws = ReplayDraws()
    js = jeng.init_state(jroute, dtype=jnp.float32)
    ts = teng.init_state(troute, dtype=torch.float32)
    jstep, tstep = jeng.make_jitted(donate=False), teng.make_jitted()
    admitted = 0
    for tick, (rid, svc, feats, tok, nb) in enumerate(_ticks(9, 6)):
        js, jout = jstep(jp, js, JBatch(*map(jnp.asarray,
                                             (rid, svc, feats, tok, nb))))
        ts, tout = tstep(tp, ts, RequestBatch(*map(torch.from_numpy,
                                                   (rid, svc, feats, tok,
                                                    nb))))
        _assert_state_equal(ts, js, tick)
        for name in ("emitted", "done", "req_id", "active"):
            np.testing.assert_array_equal(tout[name].numpy(),
                                          np.asarray(jout[name]),
                                          err_msg=f"tick {tick}: out {name}")
        admitted = max(admitted, int(tout["active"]))
    assert admitted > 0
    assert int(ts.metrics.overflow) > 0              # the pool filled up
    assert float(ts.routing.ep_tput_ewma.sum()) > 0  # completions seen


def test_serve_loop_drain_matches_reference(weights):
    jp, tp = weights
    pols = [JR.POLICY_RR, JR.POLICY_LEAST_REQUEST, JR.POLICY_MAGLEV,
            JR.POLICY_AFFINITY]
    jroute, troute = _routing(pols, seed=1)
    jloop = JS.ServeLoop(JI.Engine(JCFG, I, C, MAX_LEN, eos=-1), jp, jroute,
                         admit_batch=R, dtype=jnp.float32)
    tloop = TS.ServeLoop(TI.Engine(TCFG, I, C, MAX_LEN, eos=-1,
                                   device="cpu"), tp, troute,
                         admit_batch=R, dtype=torch.float32)
    rng = np.random.RandomState(3)
    for i in range(40):
        hdr = {"path": f"/p/{rng.randint(6)}", "user": f"u{rng.randint(9)}"}
        svc, tok = int(rng.randint(len(pols))), int(rng.randint(3, 500))
        for loop, mod in ((jloop, JS), (tloop, TS)):
            loop.submit(mod.Request(req_id=i, service=svc, headers=dict(hdr),
                                    prompt_token=tok))
    jrep, trep = jloop.drain(max_ticks=400), tloop.drain(max_ticks=400)
    for rep, loop in ((jrep, jloop), (trep, tloop)):
        assert loop.submitted == (len(rep.done) + len(rep.dropped)
                                  + rep.queued + rep.inflight)
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
        np.testing.assert_array_equal(
            getattr(tloop.state.metrics, name).numpy(),
            np.asarray(getattr(jloop.state.metrics, name)), err_msg=name)
    # every admitted request released its load: the counters are back
    np.testing.assert_array_equal(tloop.routing.ep_load.numpy(),
                                  troute.ep_load.numpy())
    assert tloop.ticks == jloop.ticks

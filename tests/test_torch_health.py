"""The port's health daemon and fault injector (``core/health.py``,
``runtime/serve_loop.py``) against the JAX reference, on the CPU.

* The breaker unit cases of the reference's health tests, on the same
  EWMA stubs: each epoch's actions, the audit trail, breaker states,
  commit counts and the control plane's commit logs and weights equal.
* ``latency_estimate``, ``Fault.holds``, ``FaultInjector.apply`` on numpy
  and tensor pools (out-of-window faults inert; the same pool object
  back when nothing is held).
* The live closed loop through ``ServeLoop`` + ``Engine``: a faulted
  instance's EWMAs (from the completion kernel's plain version) trip its
  breaker and the half-open probe re-admits it; eject and re-admit
  ticks, commits, versions, weights and the EWMAs at every epoch equal
  the reference's.
* ``ServeLoop`` drains with faults for xlb and cilium under rr,
  least-request, maglev and affinity: ``DrainReport``, latency samples
  and the loop identity equal the reference's.  Under POLICY_RANDOM (a
  reference red in its drain test) every admission is held against
  ``ref.admit_ref`` with the engine's draws fed to it.

Tolerance: bit-exact (integers and the f32 EWMAs and latency estimates).
"""

import types
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.xlb_microbench import XLB_SERVICE_MODEL as JCFG
from repro.core import control as JCtl
from repro.core import health as JH
from repro.core import interpose as JI
from repro.core import routing_table as JR
from repro.core import sidecar as JSide
from repro.kernels import ref
from repro.models import model as JM
from repro.runtime import serve_loop as JS
from repro_torch import convert
from repro_torch.configs import XLB_SERVICE_MODEL as TCFG
from repro_torch.core import control as TCtl
from repro_torch.core import health as TH
from repro_torch.core import interpose as TI
from repro_torch.core.balancer import make_balancer
from repro_torch.kernels import ops
from repro_torch.runtime import serve_loop as TS

CPU = torch.device("cpu")


class _Pool(NamedTuple):
    length: object
    active: object


def _cps(n=4, policy=JR.POLICY_RR):
    return [m.ControlPlane(
        [m.ServiceConfig("svc", rules=[m.Rule(0, None, "pool")])],
        [m.Cluster("pool", endpoints=list(range(n)), policy=policy)])
        for m in (JCtl, TCtl)]


def _obs(cp, lat, tput=None):
    """An EWMA stub encoding latency ``lat[i]`` for instance i of "pool"
    (inflight = lat · tput, Little's law), as numpy."""
    infl = np.zeros((JR.MAX_ENDPOINTS,), np.float32)
    tp = np.zeros((JR.MAX_ENDPOINTS,), np.float32)
    for inst, l in lat.items():
        slot = cp.endpoint_slot("pool", inst)
        t = 1.0 if tput is None else tput.get(inst, 1.0)
        tp[slot] = t
        infl[slot] = l * max(t, 1.0 / 64.0)
    return types.SimpleNamespace(ep_inflight_ewma=infl, ep_tput_ewma=tp)


CFG = dict(k_eject=3.0, k_recover=2.0, trip_after=2, cooldown=3,
           recover_after=2, probe_patience=4, max_eject_frac=0.5,
           probe_weight=0.1)
SICK = {0: 4, 1: 4, 2: 4, 3: 40}
WELL = {0: 4, 1: 4, 2: 4, 3: 4}
BAND = {0: 4, 1: 4, 2: 4, 3: 10}        # 2.5x the median: neither
GRADED = dict(graded_weights=True, graded_alpha=1.0, graded_deadband=0.01,
              graded_floor=0.25)
# name: (policy, n, config, operator pre-ops, epochs of (lat, tput),
#        the first action expected)
BREAKER_CASES = {
    "outlier": (JR.POLICY_RR, 4, CFG, [], [SICK] * 3, ("eject", "pool", 3)),
    "hysteresis": (JR.POLICY_RR, 4, CFG, [], [BAND] * 6 + [SICK]
                   + [BAND] * 4, None),
    "max_frac": (JR.POLICY_RR, 4, dict(CFG, max_eject_frac=0.25), [],
                 [{0: 4, 1: 4, 2: 30, 3: 40}] * 3, ("eject", "pool", 3)),
    "uniformly_sick": (JR.POLICY_RR, 4, CFG, [],
                       [{i: 400 for i in range(4)}] * 8, None),
    "half_open_recovers": (JR.POLICY_RR, 4, CFG, [("pool", 3, 2.5)],
                           [SICK] * 5 + [WELL] * 2, ("eject", "pool", 3)),
    "half_open_reejects": (JR.POLICY_RR, 4, CFG, [], [SICK] * 9,
                           ("eject", "pool", 3)),
    "probe_patience": (JR.POLICY_RR, 4, CFG, [], [SICK] * 5 + [BAND] * 4,
                       ("eject", "pool", 3)),
    "stalled_probe": (JR.POLICY_RR, 4, CFG, [],
                      [SICK] * 5 + [(WELL, {3: 0.01})] * 3,
                      ("eject", "pool", 3)),
    "graded_monotone": (JR.POLICY_WEIGHTED, 3, GRADED, [],
                        [{0: 1.0, 1: 2.0, 2: 4.0}], ("weight", "pool", 2)),
    "graded_converges": (JR.POLICY_WEIGHTED, 3,
                         dict(k_eject=20.0, graded_weights=True,
                              graded_alpha=0.5, graded_deadband=0.02,
                              graded_floor=0.1), [],
                         [{0: 1.0, 1: 1.0, 2: 8.0}] * 22,
                         ("weight", "pool", 2)),
    "graded_skips_rr": (JR.POLICY_RR, 4, dict(graded_weights=True), [],
                        [{0: 1.0, 1: 1.0, 2: 2.0, 3: 2.0}, {}], None),
    "graded_vs_breaker": (JR.POLICY_WEIGHTED, 3,
                          dict(GRADED, trip_after=1), [],
                          [{0: 1.0, 1: 1.0, 2: 50.0}] * 2,
                          ("eject", "pool", 2)),
}


def _epoch_obs(cp, e):
    lat, tput = e if isinstance(e, tuple) else (e, None)
    return _obs(cp, lat, tput)


@pytest.mark.parametrize("case", list(BREAKER_CASES))
def test_breaker_matches_reference(case):
    policy, n, cfg, pre, epochs, first = BREAKER_CASES[case]
    cps = _cps(n, policy)
    for cp in cps:
        for cl, inst, w in pre:
            cp.set_weight(cl, inst, w)
    pols = [m.HealthPolicy(cp, m.HealthConfig(**cfg), clusters=["pool"])
            for m, cp in zip((JH, TH), cps)]
    acts = [[], []]
    for e in epochs:
        for k, (pol, cp) in enumerate(zip(pols, cps)):
            acts[k].append(pol.epoch(_epoch_obs(cp, e)))
        assert acts[1][-1] == acts[0][-1]
        for i in range(n):
            assert pols[1].state_of("pool", i) == pols[0].state_of("pool", i)
            assert cps[1].endpoint_weight("pool", i) == \
                cps[0].endpoint_weight("pool", i)
            assert cps[1].drain_reason("pool", i) == \
                cps[0].drain_reason("pool", i)
        assert cps[1].last_commit_log == cps[0].last_commit_log
        assert cps[1].version == cps[0].version
    assert pols[1].events == pols[0].events
    assert (pols[1].commits, pols[1].epochs) == \
        (pols[0].commits, pols[0].epochs)
    np.testing.assert_array_equal(cps[1].snapshot().ep_drained.numpy(),
                                  np.asarray(cps[0].snapshot().ep_drained))
    flat = [a for ep in acts[1] for a in ep]
    assert (flat[0][:3] if flat else None) == first


def test_epoch_reads_tensors_as_numpy():
    """The same EWMAs as CPU tensors or as numpy give the same epochs."""
    cps = _cps()[1], _cps()[1]
    pols = [TH.HealthPolicy(cp, TH.HealthConfig(**CFG)) for cp in cps]
    for _ in range(6):
        obs = _obs(cps[0], SICK)
        a = pols[0].epoch(obs)
        b = pols[1].epoch(types.SimpleNamespace(
            ep_inflight_ewma=torch.from_numpy(obs.ep_inflight_ewma),
            ep_tput_ewma=torch.from_numpy(obs.ep_tput_ewma)))
        assert a == b
    assert pols[0].events == pols[1].events and pols[0].commits == 3


def test_latency_estimate_matches_reference():
    rng = np.random.RandomState(0)
    infl = np.concatenate([rng.rand(200) * 20, [4.0, 8.0, 0.0, 0.01]])
    tput = np.concatenate([rng.rand(200) * 1.5, [1.0, 0.0, 0.0, 0.0]])
    tput[::7] = 0.0
    want = JH.latency_estimate(infl, tput)
    got = TH.latency_estimate(infl, tput)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert got[-3] == np.float32(8.0 * 64) and got[-1] == 0.0


# --------------------------------------------------------------------------- #
# the fault injector
# --------------------------------------------------------------------------- #

FAULTS = [dict(instance=0, kind="slow", factor=4, start=10, end=30),
          dict(instance=1, kind="stall", start=5, end=None),
          dict(instance=2, kind="flap", start=0, period=3),
          dict(instance=3, kind="slow", factor=2, start=3, end=9)]


def test_fault_schedules_match_reference():
    for f in FAULTS:
        jf, tf = JS.Fault(**f), TS.Fault(**f)
        assert [tf.holds(t) for t in range(60)] == \
            [jf.holds(t) for t in range(60)]
    jinj = JS.FaultInjector([JS.Fault(**f) for f in FAULTS])
    tinj = TS.FaultInjector([TS.Fault(**f) for f in FAULTS])
    assert [tinj.active(t) for t in range(60)] == \
        [jinj.active(t) for t in range(60)]
    assert tinj.clear_tick() is jinj.clear_tick() is None
    assert TS.FaultInjector([TS.Fault(**FAULTS[0])]).clear_tick() == 30
    with pytest.raises(ValueError, match="unknown fault kind"):
        TS.Fault(0, "melt").holds(0)


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_fault_apply_matches_reference(kind):
    """Random pools over 40 ticks, faults on lanes 0-3 and two outside the
    window (lane 9 of a 6-lane pool, lane -3): held lanes' active slots
    lose one step of progress, floored at 0."""
    rng = np.random.RandomState(1)
    faults = FAULTS + [dict(instance=9, kind="stall"),
                       dict(instance=-3, kind="stall")]
    jinj = JS.FaultInjector([JS.Fault(**f) for f in faults])
    tinj = TS.FaultInjector([TS.Fault(**f) for f in faults])
    for t in range(40):
        ln = rng.randint(0, 4, (6, 3)).astype(np.int32)
        act = rng.rand(6, 3) < 0.7
        if kind == "numpy":
            jpool, tpool = _Pool(ln.copy(), act.copy()), \
                _Pool(ln.copy(), act.copy())
            want = np.asarray(jinj.apply(jpool, t).length)
            out = tinj.apply(tpool, t)
            assert out is tpool
            np.testing.assert_array_equal(out.length, want)
        else:
            jpool = _Pool(jnp.asarray(ln), jnp.asarray(act))
            tpool = _Pool(torch.from_numpy(ln), torch.from_numpy(act))
            want = np.asarray(jinj.apply(jpool, t).length)
            out = tinj.apply(tpool, t)
            np.testing.assert_array_equal(out.length.numpy(), want)
            assert out.length.dtype == torch.int32
            held = [i for i in tinj.active(t) if 0 <= i < 6]
            assert (out is tpool) == (not held)
    inert = TS.FaultInjector([TS.Fault(9, "flap", period=2),
                              TS.Fault(-3, "stall")])
    pool = _Pool(torch.ones((2, 2), dtype=torch.int32),
                 torch.ones((2, 2), dtype=torch.bool))
    assert inert.apply(pool, 0) is pool


# --------------------------------------------------------------------------- #
# the live closed loop
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def weights():
    jp = JM.init_params(JCFG, jax.random.PRNGKey(7), jnp.float32)
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


LOOP_CASES = {
    # name: (instance lanes, fault, cluster policy, health config); stall
    # is the reference's own closed-loop case (probes during the fault
    # re-eject), slow sizes the cooldown so the one probe lands after it
    "stall": (2, dict(instance=1, kind="stall", start=10, end=60),
              JR.POLICY_LEAST_REQUEST,
              dict(trip_after=2, cooldown=4, recover_after=2,
                   probe_patience=6, probe_weight=0.25)),
    "slow": (2, dict(instance=1, kind="slow", factor=10, start=10, end=60),
             JR.POLICY_LEAST_REQUEST,
             dict(trip_after=2, cooldown=12, recover_after=2,
                  probe_patience=10)),
    "graded": (3, dict(instance=2, kind="slow", factor=4, start=10, end=60),
               JR.POLICY_WEIGHTED,
               dict(k_eject=12.0, trip_after=8, cooldown=12,
                    graded_weights=True)),
}


@pytest.mark.parametrize("case", list(LOOP_CASES))
def test_closed_loop_through_live_engine_matches_reference(weights, case):
    """The reference's closed loop on both packages: a faulted instance is
    ejected (or demoted) and re-admitted by the daemon alone; the EWMAs
    the completion kernel builds are bit-exact at every epoch."""
    I, fault, policy, hcfg = LOOP_CASES[case]
    jp, tp = weights
    C, max_len = 4, 3
    cps = [m.ControlPlane(
        [m.ServiceConfig("svc", rules=[m.Rule(0, None, "pool")])],
        [m.Cluster("pool", endpoints=list(range(I)), policy=policy)])
        for m in (JCtl, TCtl)]
    teng = TI.Engine(TCFG, I, C, max_len, eos=-1, device="cpu")
    teng.draws = ReplayDraws()
    loops = [JS.ServeLoop(JI.Engine(JCFG, I, C, max_len, eos=-1), jp, cps[0],
                          admit_batch=2, max_retries=16, backoff_cap=4,
                          fault=JS.FaultInjector([JS.Fault(**fault)])),
             TS.ServeLoop(teng, tp, cps[1], admit_batch=2, max_retries=16,
                          backoff_cap=4,
                          fault=TS.FaultInjector([TS.Fault(**fault)]))]
    pols = [m.HealthPolicy(cp, m.HealthConfig(**hcfg), clusters=["pool"])
            for m, cp in zip((JH, TH), cps)]
    sick = fault["instance"]
    marks = [[None, None], [None, None]]
    for t in range(120):
        for k, (loop, mod) in enumerate(zip(loops, (JS, TS))):
            loop.submit(mod.Request(req_id=t, service=0, headers={},
                                    prompt_token=3 + t % 5))
            loop.tick()
        if t % 4 != 3:
            continue
        for k, (loop, pol) in enumerate(zip(loops, pols)):
            pol.epoch(loop.routing)
            st = pol.state_of("pool", sick)
            if st == "open" and marks[k][0] is None:
                marks[k][0] = t
            if marks[k][0] is not None and marks[k][1] is None \
                    and st == "closed":
                marks[k][1] = t
        for f in ("ep_inflight_ewma", "ep_tput_ewma", "ep_load"):
            np.testing.assert_array_equal(
                getattr(loops[1].routing, f).numpy(),
                np.asarray(getattr(loops[0].routing, f)),
                err_msg=f"tick {t}: {f}")
        assert pols[1].events == pols[0].events, t
    assert marks[1] == marks[0]
    assert (pols[1].commits, cps[1].version) == \
        (pols[0].commits, cps[0].version)
    assert cps[1].version == pols[1].commits > 0
    for i in range(I):
        assert cps[1].endpoint_weight("pool", i) == \
            cps[0].endpoint_weight("pool", i)
    assert pols[1].state_of("pool", sick) == "closed"
    assert cps[1].drain_reason("pool", sick) is None
    if case == "graded":
        assert marks[1] == [None, None]       # demoted, never ejected
        assert any(e[1] == "weight" and e[3] == sick for e in pols[1].events)
    else:
        assert 10 < marks[1][0] < 60 < marks[1][1]
        assert cps[1].endpoint_weight("pool", sick) == 1.0


# --------------------------------------------------------------------------- #
# ServeLoop drains with faults
# --------------------------------------------------------------------------- #

I, C, R, MAX_LEN = 4, 4, 8, 6
DRAIN_FAULTS = [dict(instance=1, kind="stall", start=3, end=12),
                dict(instance=2, kind="slow", factor=3, start=0, end=30),
                dict(instance=3, kind="flap", start=5, period=2, end=25),
                dict(instance=7, kind="stall")]       # outside the window


def _drain_routing(policies):
    services = [JR.ServiceConfig(f"s{i}", [JR.Rule(0, None, f"c{i}")])
                for i in range(len(policies))]
    clusters = [JR.Cluster(f"c{i}", [(i + k) % I for k in range(3)],
                           policy=p, weights=[1.0, 3.0, 0.5])
                for i, p in enumerate(policies)]
    st, _ = JR.build_state(services, clusters)
    arrs = {f: np.array(getattr(st, f)) for f in st._fields}
    arrs["ep_drained"][1] = 1
    return (JR.RoutingState(*[jnp.asarray(arrs[f]) for f in st._fields]),
            convert.routing_from_numpy(arrs, CPU))


def _submit_all(loops, n_svc, n=40):
    rng = np.random.RandomState(3)
    for i in range(n):
        hdr = {"path": f"/p/{rng.randint(6)}", "user": f"u{rng.randint(9)}"}
        svc, tok = int(rng.randint(n_svc)), int(rng.randint(3, 500))
        for loop, mod in loops:
            loop.submit(mod.Request(req_id=i, service=svc, headers=dict(hdr),
                                    prompt_token=tok))


@pytest.mark.parametrize("mode", ["xlb", "cilium"])
def test_serve_loop_drain_with_faults_matches_reference(weights, mode):
    jp, tp = weights
    pols = [JR.POLICY_RR, JR.POLICY_LEAST_REQUEST, JR.POLICY_MAGLEV,
            JR.POLICY_AFFINITY]
    jroute, troute = _drain_routing(pols)
    if mode == "xlb":
        jeng = JI.Engine(JCFG, I, C, MAX_LEN, eos=-1)
    else:
        jeng = JSide.SidecarEngine(JCFG, I, C, MAX_LEN, mode=mode, eos=-1)
    teng = make_balancer(mode, TCFG, I, C, MAX_LEN, eos=-1, device="cpu")
    jloop = JS.ServeLoop(jeng, jp, jroute, admit_batch=R, dtype=jnp.float32,
                         fault=JS.FaultInjector(
                             [JS.Fault(**f) for f in DRAIN_FAULTS]))
    tloop = TS.ServeLoop(teng, tp, troute, admit_batch=R,
                         dtype=torch.float32, fault=TS.FaultInjector(
                             [TS.Fault(**f) for f in DRAIN_FAULTS]))
    _submit_all([(jloop, JS), (tloop, TS)], len(pols))
    jrep, trep = jloop.drain(max_ticks=600), tloop.drain(max_ticks=600)
    for rep, loop in ((jrep, jloop), (trep, tloop)):
        assert loop.submitted == (len(rep.done) + len(rep.dropped)
                                  + rep.queued + rep.inflight)
    assert len(trep.done) == len(jrep.done) == 40
    assert (len(trep.dropped), trep.queued, trep.inflight, trep.held_first) \
        == (len(jrep.dropped), jrep.queued, jrep.inflight, jrep.held_first)
    assert [r.req_id for r in trep.done] == [r.req_id for r in jrep.done]
    jl, tl = jloop.latency_samples(), tloop.latency_samples()
    for k in jl:
        np.testing.assert_array_equal(tl[k], jl[k], err_msg=k)
    assert tloop.ticks == jloop.ticks
    # the faults did hold work back: a slower drain than without them
    assert int(tl["admit_to_done"].max()) > MAX_LEN


def test_random_policy_drain_with_faults_against_admit_ref(weights,
                                                           monkeypatch):
    """POLICY_RANDOM with a drained endpoint: every admission of the
    drain, held against the sequential oracle with the same draws."""
    _, tp = weights
    _, troute = _drain_routing([JR.POLICY_RANDOM, JR.POLICY_RR])
    teng = TI.Engine(TCFG, I, C, MAX_LEN, eos=-1, device="cpu")
    tloop = TS.ServeLoop(teng, tp, troute, admit_batch=R,
                         dtype=torch.float32, fault=TS.FaultInjector(
                             [TS.Fault(**f) for f in DRAIN_FAULTS]))
    seen = []
    real = ops.admit_commit

    def record(reqs, routing, pool, rnd, gumbel, **tuning):
        out = real(reqs, routing, pool, rnd, gumbel, **tuning)
        # the tick's inputs are its static buffers, which the next tick
        # overwrites: keep copies
        keep = lambda t: type(t)(*[x.clone() for x in t])  # noqa: E731
        seen.append((keep(reqs), keep(routing), keep(pool), rnd.clone(),
                     gumbel.clone(), out))
        return out

    monkeypatch.setattr(ops, "admit_commit", record)
    _submit_all([(tloop, TS)], 2)
    rep = tloop.drain(max_ticks=600)
    assert len(rep.done) == 40 and not rep.dropped
    assert len(seen) > 5
    fields = ("cluster", "endpoint", "instance", "slot", "ok", "ep_load",
              "rr_cursor", "svc_requests", "svc_tx_bytes", "no_route",
              "held", "aff_key", "aff_ep")
    picks = 0
    for reqs, routing, pool, rnd, gumbel, out in seen:
        want = ref.admit_ref(reqs.req_id.numpy(), reqs.svc.numpy(),
                             reqs.features.numpy(), reqs.msg_bytes.numpy(),
                             types.SimpleNamespace(**{
                                 f: getattr(routing, f).numpy()
                                 for f in routing._fields}),
                             (~pool.active).numpy(), rnd.numpy(),
                             gumbel.numpy())
        for f in fields:
            np.testing.assert_array_equal(getattr(out, f).numpy(),
                                          np.asarray(getattr(want, f)),
                                          err_msg=f)
        ep = out.endpoint.numpy()
        assert not np.any(ep == 1)                 # the drained endpoint
        picks += int((out.ok.numpy() > 0).sum())
    assert picks >= 40

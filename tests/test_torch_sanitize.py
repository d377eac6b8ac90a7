"""The port's ``XLB_SANITIZE`` laws (``analysis/invariants.py``) against
the JAX reference's, on the CPU.

* ``guard``: on the same lawful ctx both packages pass; on a ctx that
  breaks one law (one case per device law) the reference's checkify
  error and the port's ``AssertionError`` carry the same
  ``XLB_SANITIZE[<scope>/<law>]: <doc>`` text.
* ``assert_host``: the loop law raises the same text on both.
* A ``ServeLoop`` drain with ``XLB_SANITIZE=1`` (every admit and
  complete guard and the loop law) gives the reference's unsanitized
  drain report; a planted off-by-one load in the admission kernel's
  output raises on the tick that made it.
* With the variable unset the guards add no op to the tick.
* Each device law planted inside the captured tick's body (a kernel
  output altered on both packages): the port's sanitized ``StaticTick``
  raises the reference's ``jit(checkify(serve_step))`` text on the same
  tick, and leaves ``routing``, ``pool`` and ``metrics`` as they were
  before that tick, equal to the reference's caller state.  The
  deferred verdicts raise in the eager guards' order; a ``ServeLoop``
  built under the sanitizer keeps its tick count and state on a raising
  captured tick.

Tolerance: exact (integers and message text).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.analysis import invariants as JInv
from repro.configs.xlb_microbench import XLB_SERVICE_MODEL as JCFG
from repro.core import control as JCtl
from repro.core import interpose as JI
from repro.core.balancer import RequestBatch as JBatch
from repro.core.routing_table import POLICY_RR as J_RR
from repro.kernels import ops as JOps
from repro.models import model as JM
from repro.runtime import serve_loop as JS
from repro_torch import convert
from repro_torch.analysis import invariants as TInv
from repro_torch.configs import XLB_SERVICE_MODEL as TCFG
from repro_torch.core import control as TCtl
from repro_torch.core import interpose as TI
from repro_torch.core.balancer import RequestBatch
from repro_torch.kernels import ops
from repro_torch.runtime import graphs
from repro_torch.runtime import serve_loop as TS
from test_torch_engine import (C, MAX_LEN, ReplayDraws, _assert_state_equal,
                               _routing, _ticks)
from test_torch_engine import I as LANES

CPU = torch.device("cpu")

ADMIT_OK = dict(
    load_before=[0, 0, 0, 0], load_after=[1, 1, 0, 0], ok=[1, 1, 0, 0],
    held=0, endpoint=[0, 1, -1, -1], instance=[0, 1, -1, -1],
    slot=[0, 0, -1, -1], req_id=[5, 6, 7, -1],
    pool_req_id=[[5, -1], [6, -1]], pool_active=[[True, False],
                                                 [True, False]])
COMPLETE_OK = dict(
    load_before=[2, 1, 0], load_after=[1, 1, 0], done_cnt=[1, 0, 0],
    done=[[True, False], [False, False]],
    active_after=[[False, True], [False, False]],
    req_id_after=[[-1, 3], [-1, -1]])

# one case per device law: the ctx change that breaks exactly that law
VIOLATIONS = [
    ("admit", "load-delta-conservation", {"load_after": [2, 1, 0, 0]}),
    ("admit", "load-nonnegative", {"load_after": [2, 1, 0, -1]}),
    ("admit", "held-accounting", {"held": 1}),
    ("admit", "admit-commit-visible", {"pool_req_id": [[5, -1], [9, -1]]}),
    ("complete", "release-conservation", {"load_after": [1, 1, 1]}),
    ("complete", "load-nonnegative", {"load_before": [2, 1, 0],
                                      "load_after": [1, 2, -1]}),
    ("complete", "done-frees-slot", {"active_after": [[True, True],
                                                      [False, False]]}),
]


def _ctx(scope, **change):
    """The same ctx as jax arrays and as torch tensors (int32 or bool)."""
    base = dict(ADMIT_OK if scope == "admit" else COMPLETE_OK, **change)
    arrs = {k: np.asarray(v) for k, v in base.items()}
    arrs = {k: a if a.dtype == bool else a.astype(np.int32)
            for k, a in arrs.items()}
    return ({k: jnp.asarray(a) for k, a in arrs.items()},
            {k: torch.from_numpy(a) for k, a in arrs.items()})


@pytest.mark.parametrize("scope", ["admit", "complete"])
def test_guard_passes_on_lawful_ctx(scope):
    j, t = _ctx(scope)
    JInv.guard(scope, j)
    TInv.guard(scope, t)


@pytest.mark.parametrize("scope,law,change", VIOLATIONS,
                         ids=[f"{s}/{l}" for s, l, _ in VIOLATIONS])
def test_guard_names_the_violated_law_as_the_reference(scope, law, change):
    from jax._src.checkify import JaxRuntimeError
    j, t = _ctx(scope, **change)
    doc = next(l.doc for l in TInv.laws(scope) if l.name == law)
    text = f"XLB_SANITIZE[{scope}/{law}]: {doc}"
    with pytest.raises(JaxRuntimeError) as jerr:
        JInv.guard(scope, j)
    with pytest.raises(AssertionError) as terr:
        TInv.guard(scope, t)
    assert str(terr.value) == text
    assert text in str(jerr.value)


def test_law_registries_match_the_reference():
    assert [(l.name, l.scope, l.doc, l.requires, l.traced)
            for l in TInv.LAWS] == \
        [(l.name, l.scope, l.doc, l.requires, l.traced) for l in JInv.LAWS]


@pytest.mark.parametrize("ctx", [
    dict(submitted=5, done=2, dropped=0, queued=1, inflight=1),
    dict(submitted=4, done=2, dropped=0, queued=1, inflight=1)])
def test_assert_host_loop_law_matches_reference(ctx):
    errs = []
    for mod in (JInv, TInv):
        try:
            mod.assert_host("loop", ctx)
            errs.append(None)
        except AssertionError as e:
            errs.append(str(e))
    assert errs[0] == errs[1]
    assert (errs[1] is None) == (ctx["submitted"] == 4)
    if errs[1] is not None:
        assert "queue-conservation" in errs[1]


# --------------------------------------------------------------------------- #
# a sanitized ServeLoop drain
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def weights():
    jp = JM.init_params(JCFG, jax.random.PRNGKey(7), jnp.float32)
    return jp, convert.params_from_jax(jax.tree.map(np.asarray, jp), CPU)


def _loops(weights, n_req=6):
    jp, tp = weights
    loops = []
    for ctl, eng, mod, params in (
            (JCtl, JI.Engine(JCFG, 2, 2, 8, eos=-1), JS, jp),
            (TCtl, TI.Engine(TCFG, 2, 2, 8, eos=-1, device="cpu"), TS, tp)):
        cp = ctl.ControlPlane()
        cp.add_cluster("c", policy=J_RR, endpoints=[0, 1])
        cp.add_service("s", rules=[ctl.Rule(0, None, "c")])
        loop = mod.ServeLoop(eng, params, cp, admit_batch=4)
        for r in range(n_req):
            loop.submit(mod.Request(req_id=r, service=0, headers={},
                                    prompt_token=2 + r))
        loops.append(loop)
    return loops


def test_sanitized_serve_loop_drain_matches_reference(weights, monkeypatch):
    jloop, tloop = _loops(weights)
    jrep = jloop.drain(max_ticks=200)
    calls = []
    guard = ops.guard
    monkeypatch.setattr(ops, "guard",
                        lambda s, c: (calls.append(s), guard(s, c)))
    monkeypatch.setenv("XLB_SANITIZE", "1")
    trep = tloop.drain(max_ticks=200)
    assert len(trep.done) == len(jrep.done) == 6
    assert [r.req_id for r in trep.done] == [r.req_id for r in jrep.done]
    assert (len(trep.dropped), trep.queued, trep.inflight, trep.held_first) \
        == (len(jrep.dropped), jrep.queued, jrep.inflight, jrep.held_first)
    jl, tl = jloop.latency_samples(), tloop.latency_samples()
    for k in jl:
        np.testing.assert_array_equal(tl[k], jl[k], err_msg=k)
    assert tloop.ticks == jloop.ticks
    assert calls.count("complete") == tloop.ticks
    assert calls.count("admit") > 0


def test_sanitized_loop_raises_on_the_tick_of_a_planted_leak(weights,
                                                             monkeypatch):
    _, tloop = _loops(weights)
    real = ops._rm.admit_commit

    def leaky(*a, **k):
        res = real(*a, **k)
        return res._replace(ep_load=res.ep_load + 1)

    monkeypatch.setattr(ops._rm, "admit_commit", leaky)
    monkeypatch.setenv("XLB_SANITIZE", "1")
    with pytest.raises(AssertionError,
                       match=r"XLB_SANITIZE\[admit/load-delta-conservation\]"):
        tloop.tick()
    assert tloop.ticks == 0


def test_sanitized_loop_keeps_its_state_on_a_raising_captured_tick(
        weights, monkeypatch):
    """A loop built under XLB_SANITIZE=1 ticks through the sanitizing
    captured tick; a leak planted after two lawful ticks raises on the
    third, and the loop's tick count, routing, pool and metrics are what
    they were before it."""
    monkeypatch.setenv("XLB_SANITIZE", "1")
    _, tloop = _loops(weights)
    assert isinstance(tloop.serve_step, graphs.StaticTick)
    assert tloop.serve_step.sanitize
    tloop.tick()
    tloop.tick()
    assert tloop.serve_step.verdict_reads == 2
    before = _fields(tloop.state)
    real = ops._rm.admit_commit

    def leaky(*a, **k):
        res = real(*a, **k)
        return res._replace(ep_load=res.ep_load + 1)

    monkeypatch.setattr(ops._rm, "admit_commit", leaky)
    with pytest.raises(AssertionError,
                       match=r"XLB_SANITIZE\[admit/load-delta-conservation\]"):
        tloop.tick()
    assert tloop.ticks == 2
    after = _fields(tloop.state)
    for k, v in before.items():
        assert torch.equal(after[k], v), k


def test_sanitizer_unset_adds_no_op_to_the_tick(weights, monkeypatch):
    """The same two ticks with the variable unset run the same ATen ops
    as with the guards stubbed out; set, they run more.  The counts are
    of the eager tick; the captured tick, unset, runs no guard either."""

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    def ops_of_two_ticks(eager=True):
        _, tloop = _loops(weights)
        if eager:
            tloop.serve_step = tloop.balancer.eager_step
        with Count() as c:
            tloop.tick()
            tloop.tick()
        return c.n

    monkeypatch.delenv("XLB_SANITIZE", raising=False)
    plain = ops_of_two_ticks()
    monkeypatch.setattr(ops, "guard", lambda *a: pytest.fail("guard ran"))
    assert ops_of_two_ticks() == plain
    ops_of_two_ticks(eager=False)
    monkeypatch.undo()
    monkeypatch.setenv("XLB_SANITIZE", "1")
    assert ops_of_two_ticks() > plain


# --------------------------------------------------------------------------- #
# laws planted inside the sanitized captured tick
# --------------------------------------------------------------------------- #


def _shift(x, xp):
    """A load moved from the last endpoint to the first, past zero: the
    sum is kept, the last counter reads -1."""
    d = np.zeros(x.shape, np.int32)
    d[0], d[-1] = 1, -1
    return x + (x[-1] + 1) * xp.asarray(d)


# per law of VIOLATIONS: the kernel output each package's wrapper gets
# altered, as {field: f(fields, xp)}; the fields are named as in
# AdmitCommitResult / CompleteResult (the reference's pool.* likewise)
PLANTS = {
    ("admit", "load-delta-conservation"):
        {"ep_load": lambda f, xp: f["ep_load"] + 1},
    ("admit", "load-nonnegative"):
        {"ep_load": lambda f, xp: _shift(f["ep_load"], xp)},
    ("admit", "held-accounting"):
        {"held": lambda f, xp: f["held"] + 1},
    ("admit", "admit-commit-visible"):
        {"pool_req_id": lambda f, xp: xp.where(
            f["pool_req_id"] >= 0, f["pool_req_id"] + 1000,
            f["pool_req_id"])},
    ("complete", "release-conservation"):
        {"ep_load": lambda f, xp: f["ep_load"] + 1},
    ("complete", "load-nonnegative"):
        {"ep_load": lambda f, xp: _shift(f["ep_load"], xp)},
    ("complete", "done-frees-slot"):
        {"active": lambda f, xp: f["active"] | f["done"]},
}


def _plant_port(monkeypatch, scope, change):
    mod, name = (ops._rm, "admit_commit") if scope == "admit" \
        else (ops._cp, "complete")
    real = getattr(mod, name)

    def planted(*a, **k):
        res = real(*a, **k)
        fields = res._asdict()
        return res._replace(**{f: fn(fields, torch)
                               for f, fn in change.items()})

    monkeypatch.setattr(mod, name, planted)


def _plant_reference(monkeypatch, scope, change):
    name = "_admit_commit" if scope == "admit" else "_complete"
    real = getattr(JOps, name)

    def planted(*a, **k):
        res = real(*a, **k)
        fields = dict(res._asdict(), **{f"pool_{g}": getattr(res.pool, g)
                                        for g in res.pool._fields})
        if scope == "complete":
            fields["active"] = res.pool.active
        new = {f: fn(fields, jnp) for f, fn in change.items()}
        pool = {g: new.pop(f"pool_{g}") for g in res.pool._fields
                if f"pool_{g}" in new}
        if "active" in new:
            pool["active"] = new.pop("active")
        return res._replace(pool=res.pool._replace(**pool), **new)

    monkeypatch.setattr(JOps, name, planted)


def _fields(state):
    return {f"{n}.{g}": getattr(getattr(state, n), g).clone()
            for n in ("routing", "pool", "metrics")
            for g in getattr(state, n)._fields}


@pytest.mark.parametrize("scope,law,change", VIOLATIONS,
                         ids=[f"{s}/{l}" for s, l, _ in VIOLATIONS])
def test_planted_law_raises_from_the_captured_tick_as_the_reference(
        weights, monkeypatch, scope, law, change):
    """The law broken inside both ticks' bodies from the start: both
    raise on the first tick that breaks it, with the same text; the
    port's state is what it was before that tick, field by field, and
    equal to the reference's caller state, which its checkified program
    (not donated) left as it was."""
    from jax._src.checkify import JaxRuntimeError
    jp, tp = weights
    monkeypatch.setenv("XLB_SANITIZE", "1")
    _plant_port(monkeypatch, scope, PLANTS[scope, law])
    _plant_reference(monkeypatch, scope, PLANTS[scope, law])
    jroute, troute = _routing(list(range(6)))
    jeng = JI.Engine(JCFG, LANES, C, MAX_LEN, eos=-1)
    teng = TI.Engine(TCFG, LANES, C, MAX_LEN, eos=-1, device="cpu")
    teng.draws = ReplayDraws()
    jstep, tick = jeng.make_jitted(donate=False), teng.make_jitted()
    assert isinstance(tick, graphs.StaticTick) and tick.sanitize
    js = jeng.init_state(jroute, dtype=jnp.float32)
    ts = teng.init_state(troute, dtype=torch.float32)
    doc = next(l.doc for l in TInv.laws(scope) if l.name == law)
    text = f"XLB_SANITIZE[{scope}/{law}]: {doc}"
    for t, batch in enumerate(_ticks(12, 6)):
        before = _fields(tick.state) if tick.state is not None \
            else _fields(ts)
        try:
            jnext, _ = jstep(jp, js, JBatch(*map(jnp.asarray, batch)))
        except JaxRuntimeError as e:
            jerr = str(e)
        else:
            jerr = None
        with pytest.raises(AssertionError) if jerr else \
                contextlib.nullcontext() as terr:
            ts, _ = tick(tp, ts, RequestBatch(*map(torch.from_numpy,
                                                   batch)))
        if jerr is None:
            js = jnext
            continue
        assert text in jerr and str(terr.value) == text, (jerr, terr)
        after = _fields(tick.state)
        for k, v in before.items():
            assert torch.equal(after[k], v), f"tick {t}: {k} changed"
        _assert_state_equal(tick.state, js, t)
        assert tick.verdict_reads == t + 1
        return
    pytest.fail(f"{scope}/{law}: no tick raised")


def test_raise_first_keeps_the_guards_order():
    """Deferred guards raise as eager ones would: the first guard call's
    violated law before a later call's, the first law within a call."""
    j_ok, t_ok = _ctx("admit")
    _, t_bad = _ctx("complete", **VIOLATIONS[4][2])
    _, t_two = _ctx("admit", load_after=[2, 1, 0, -1], held=1)
    with TInv.deferred() as sink:
        TInv.guard("admit", t_ok)
        TInv.guard("complete", t_bad)
        TInv.guard("admit", t_two)
    assert [s for s, *_ in sink] == ["admit", "complete", "admit"]
    verdicts = torch.cat([v for *_, v in sink]).tolist()
    recorded = [(s, laws) for s, laws, _ in sink]
    with pytest.raises(AssertionError) as err:
        TInv.raise_first(verdicts, recorded)
    assert "[complete/release-conservation]" in str(err.value)
    with pytest.raises(AssertionError) as err:
        TInv.raise_first(verdicts, recorded[2:] + recorded[:2])
    assert "[admit/load-delta-conservation]" in str(err.value)
    TInv.raise_first(verdicts[:4], recorded[:1])
    with pytest.raises(ValueError, match="verdicts"):
        TInv.raise_first(verdicts[:3], recorded[:1])

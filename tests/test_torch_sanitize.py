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

Tolerance: exact (integers and message text).
"""

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
from repro.core.routing_table import POLICY_RR as J_RR
from repro.models import model as JM
from repro.runtime import serve_loop as JS
from repro_torch import convert
from repro_torch.analysis import invariants as TInv
from repro_torch.configs import XLB_SERVICE_MODEL as TCFG
from repro_torch.core import control as TCtl
from repro_torch.core import interpose as TI
from repro_torch.kernels import ops
from repro_torch.runtime import serve_loop as TS

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


def test_sanitizer_unset_adds_no_op_to_the_tick(weights, monkeypatch):
    """The same two ticks with the variable unset run the same ATen ops
    as with the guards stubbed out; set, they run more.  The counts are
    of the eager tick, the one ``make_jitted`` returns under the
    sanitizer; its captured tick runs no guard either."""

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

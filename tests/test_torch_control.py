"""The port's control plane (``core/control.py``, ``core/delta.py``,
``analysis/invariants.py``) and its ``apply_refresh`` seam against the JAX
reference, on the CPU.

* The same operations on a reference ``ControlPlane`` and on the port's
  (the cases of ``tests/test_control_plane.py``): equal packed plans in
  every journal entry (value and dtype), commit logs, ids, versions,
  snapshots, raised errors, and the routing state of an attached consumer
  on each side.
* ``apply_plan`` on warm states (loads, EWMAs, cursors, affinity
  entries) and ``remap_endpoints``: bit-exact, versioned and not.
* Mutated wire payloads: both ``unpack_plan``s raise the same message.
* The raw slot-index deltas of ``core/delta.py``: bit-exact.
* ``ServeLoop`` attached to a ``ControlPlane``, a transaction committed
  mid-drain (a loaded endpoint drained, one removed by swap-with-last, one
  added), for the XLB engine and the Cilium sidecar with ``eos=-1``: the
  drain report, the versions tick by tick and the tick at which the
  drained endpoint is reaped are identical.

Tolerance: bit-exact everywhere (integers and f32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import invariants as JInv
from repro.configs.xlb_microbench import XLB_SERVICE_MODEL as JCFG
from repro.core import control as JC
from repro.core import delta as JD
from repro.core import interpose as JI
from repro.core import routing_table as JR
from repro.core import sidecar as JSide
from repro.models import model as JM
from repro.runtime import serve_loop as JS
from repro_torch import convert
from repro_torch.analysis import invariants as TInv
from repro_torch.configs import XLB_SERVICE_MODEL as TCFG
from repro_torch.core import control as TC
from repro_torch.core import delta as TD
from repro_torch.core import routing_table as TR
from repro_torch.core.balancer import make_balancer
from repro_torch.launch import serve
from repro_torch.runtime import serve_loop as TS

CPU = torch.device("cpu")


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _assert_same(got, want, what):
    """Equal in value and dtype (arrays) or equal (anything else)."""
    if isinstance(want, (np.ndarray, jax.Array, torch.Tensor)):
        g, w = _np(got), _np(want)
        assert g.dtype == w.dtype, (what, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=what)
    else:
        assert got == want, (what, got, want)


def _assert_routing_equal(trouting, jrouting, what):
    for f in JR.RoutingState._fields:
        _assert_same(getattr(trouting, f), getattr(jrouting, f),
                     f"{what}: {f}")


# --------------------------------------------------------------------------- #
# the two control planes under the same operations
# --------------------------------------------------------------------------- #


class JConsumer:
    def __init__(self, cp):
        self.routing = cp.snapshot()
        cp.attach(self)

    def apply_refresh(self, plan):
        self.routing = JC.apply_plan(self.routing, plan)

    def set_load(self, slot, n):
        self.routing = self.routing._replace(
            ep_load=self.routing.ep_load.at[slot].set(n))


class TConsumer:
    def __init__(self, cp):
        self.routing = cp.snapshot()
        cp.attach(self)

    def apply_refresh(self, plan):
        self.routing = TC.apply_plan(self.routing, plan)

    def set_load(self, slot, n):
        load = self.routing.ep_load.clone()
        load[slot] = n
        self.routing = self.routing._replace(ep_load=load)


SIDES = {"ref": (JC, JR, JConsumer), "port": (TC, TR, TConsumer)}


def _config(RT):
    services = [
        RT.ServiceConfig("front", rules=[RT.Rule(0, "v2", "canary"),
                                         RT.Rule(0, None, "stable")]),
        RT.ServiceConfig("payments", rules=[RT.Rule(1, "gold",
                                                    "gold-pool")]),
    ]
    clusters = [
        RT.Cluster("canary", endpoints=[0, 1], policy=RT.POLICY_RR),
        RT.Cluster("stable", endpoints=[2, 3, 4],
                   policy=RT.POLICY_LEAST_REQUEST),
        RT.Cluster("gold-pool", endpoints=[5], policy=RT.POLICY_RANDOM),
        RT.Cluster("hash", endpoints=[6, 7, 8, 9],
                   policy=RT.POLICY_MAGLEV),
    ]
    return services, clusters


def _attempt(errors, fn, *a, **k):
    """Run ``fn``; record what it raised (type and message) instead."""
    try:
        return fn(*a, **k)
    except (KeyError, RuntimeError, ValueError) as e:
        errors.append((type(e).__name__, str(e)))
        return None


def _case_transaction(cp, RT, cons, errors):
    with cp.transaction():
        cp.add_endpoint("stable", instance=9)
        cp.set_policy("canary", RT.POLICY_WEIGHTED)
        cp.set_weight("canary", instance=0, weight=3.0)
        cp.upsert_rule("payments", 1, "silver", "stable")
    with cp.transaction():
        pass                                   # empty: no bump
    with cp.transaction():
        cp.remove_endpoint("stable", instance=9)


def _case_drain_reap(cp, RT, cons, errors):
    c = cons(cp)
    slot = cp.endpoint_slot("stable", 3)
    c.set_load(slot, 2)
    cp.drain_endpoint("stable", 3)             # loaded: not reaped
    cp.reap()
    c.set_load(slot, 0)
    cp.reap()                                  # reaped now
    cp.drain_endpoint("stable", 4)             # idle: same commit
    cp.drain_endpoint("hash", 7)               # maglev row rebuilds


def _case_swap_with_last(cp, RT, cons, errors):
    c = cons(cp)
    c.set_load(cp.endpoint_slot("hash", 8), 5)
    c.set_load(cp.endpoint_slot("hash", 9), 1)
    cp.remove_endpoint("hash", 7)              # mid-window: 9 moves down
    cp.add_endpoint("hash", instance=11)       # reuses the vacated slot
    c.set_load(cp.endpoint_slot("hash", 9), 1)
    cp.drain_endpoint("hash", 9)
    cp.remove_endpoint("hash", 6)              # the drain bit moves too


def _case_window_reuse(cp, RT, cons, errors):
    cons(cp)
    with cp.transaction():
        cp.add_endpoint("canary", instance=9)  # window full: relocates
    cp.add_cluster("c", endpoints=[5, 6])      # first fit: the old extent
    for k in range(5):
        cp.add_endpoint("c", instance=20 + k)  # relocates twice


def _case_rules(cp, RT, cons, errors):
    cons(cp)
    cp.upsert_rule("front", 0, "v2", "stable")     # replace in place
    cp.upsert_rule("front", 3, "eu", "gold-pool")  # append, relocate
    cp.upsert_rule("front", 4, None, "hash")
    cp.remove_rule("front", 3, "eu")               # top-down, compacts
    _attempt(errors, cp.remove_rule, "front", 3, "eu")


def _case_add_service_cluster(cp, RT, cons, errors):
    cons(cp)
    with cp.transaction():
        cp.add_cluster("new-pool", policy=RT.POLICY_RR, endpoints=[6, 7],
                       weights=[1.0, 2.5])
        cp.add_service("checkout", rules=[RT.Rule(2, None, "new-pool")])
    _attempt(errors, cp.add_service, "checkout")
    _attempt(errors, cp.add_cluster, "new-pool")


def _case_remove_and_reuse(cp, RT, cons, errors):
    c = cons(cp)
    _attempt(errors, cp.remove_cluster, "canary")  # still referenced
    cp.remove_rule("front", 0, "v2")
    with cp.transaction():
        cp.remove_cluster("canary")
    cp.add_cluster("blue", endpoints=[7, 8])       # id + extent reused
    with cp.transaction():
        cp.remove_service("front")
    cp.add_service("storefront", rules=[RT.Rule(0, None, "stable")])
    cp.remove_rule("payments", 1, "gold")
    c.set_load(cp.endpoint_slot("gold-pool", 5), 3)
    cp.drain_endpoint("gold-pool", 5)              # stays pending
    cp.remove_cluster("gold-pool")                 # drops the drain
    cp.reap()


def _case_abort_and_nesting(cp, RT, cons, errors):
    c = cons(cp)

    def aborted():
        with cp.transaction():
            cp.add_endpoint("stable", instance=9)
            cp.remove_endpoint("stable", instance=999)

    def nested():
        with cp.transaction():
            with cp.transaction():
                pass

    _attempt(errors, aborted)
    _attempt(errors, nested)
    _attempt(errors, cp.drain_endpoint, "stable", 2, reason="bored")
    c.set_load(cp.endpoint_slot("stable", 2), 1)
    cp.drain_endpoint("stable", 2)


def _case_leases(cp, RT, cons, errors):
    keep, ghost = cons(cp), cons(cp)
    slot = cp.endpoint_slot("stable", 3)
    ghost.set_load(slot, 7)
    keep.set_load(slot, 1)
    cp.drain_endpoint("stable", 3)
    for _ in range(3):
        cp.advance_epoch()
        cp.heartbeat(keep)
    errors.append(("lease", cp.lease_live(keep), cp.lease_live(ghost)))
    cp.reap()                                  # keep's vote holds
    keep.set_load(slot, 0)
    cp.reap()                                  # ghost's lease expired
    lost = cons(cp)
    lost.set_load(cp.endpoint_slot("stable", 4), 2)
    del lost                                   # abandoned: no vote
    cp.drain_endpoint("stable", 4)


def _case_weights_and_health(cp, RT, cons, errors):
    c = cons(cp)
    slot = cp.endpoint_slot("stable", 3)
    c.set_load(slot, 1)
    cp.drain_endpoint("stable", 3)
    cp.set_weight("stable", 3, 2.5)            # cancels the drain
    c.set_load(slot, 0)
    cp.reap()
    cp.drain_endpoint("stable", 2, reason="health")
    cp.reap()                                  # never reaped
    cp.set_weight("stable", 2, 2.0)            # staged; the bit stays up
    errors.append(("reason", cp.drain_reason("stable", 2),
                   cp.endpoint_weight("stable", 2),
                   cp.cluster_policy("stable"),
                   cp.cluster_members("stable")))
    cp.undrain_endpoint("stable", 2, weight=1.5)
    cp.drain_endpoint("stable", 4)             # operator, idle: reaped


CASES = {f.__name__[6:]: f for f in (
    _case_transaction, _case_drain_reap, _case_swap_with_last,
    _case_window_reuse, _case_rules, _case_add_service_cluster,
    _case_remove_and_reuse, _case_abort_and_nesting, _case_leases,
    _case_weights_and_health)}


def _run_case(side, case):
    mod, RT, cons = SIDES[side]
    services, clusters = _config(RT)
    cp = mod.ControlPlane(services, clusters, lease_epochs=2,
                          journal_limit=8)
    watcher = cons(cp)                         # sees every commit
    errors = []
    CASES[case](cp, RT, cons, errors)
    return cp, watcher, errors


@pytest.mark.parametrize("case", sorted(CASES))
def test_control_plane_matches_reference(case):
    jcp, jw, jerr = _run_case("ref", case)
    tcp, tw, terr = _run_case("port", case)
    assert terr == jerr
    assert tcp.version == jcp.version > 0
    assert tcp.ids == jcp.ids
    assert tcp.last_commit_log == jcp.last_commit_log
    assert tcp.epoch == jcp.epoch
    assert len(tcp.journal) == len(jcp.journal)
    for n, (tp, jp) in enumerate(zip(tcp.journal, jcp.journal)):
        assert tp.keys() == jp.keys()
        for k in jp:
            _assert_same(tp[k], jp[k], f"journal[{n}].{k}")
    for k, v in TC.pack_plan(tcp.last_plan).items():
        _assert_same(v, JC.pack_plan(jcp.last_plan)[k], f"last_plan.{k}")
    _assert_routing_equal(tcp.snapshot(), jcp.snapshot(), "snapshot")
    jsnap, tsnap = jcp.packed_snapshot(), tcp.packed_snapshot()
    for k in jsnap:
        _assert_same(tsnap[k], jsnap[k], f"packed_snapshot.{k}")
    _assert_routing_equal(tw.routing, jw.routing, "consumer")
    assert tcp.cluster_names() == jcp.cluster_names()


def test_build_matches_build_state():
    """The initial build is ``build_state``'s, bit for bit, and the
    snapshot lies on the CPU."""
    services, clusters = _config(TR)
    cp = TC.ControlPlane(services, clusters)
    st, ids = TR.build_state(services, clusters, CPU)
    _assert_routing_equal(cp.snapshot(), st, "build")
    assert cp.ids == ids


# --------------------------------------------------------------------------- #
# apply_plan and remap_endpoints on warm states
# --------------------------------------------------------------------------- #


def _warm(jcp, seed):
    """A warm live state (numpy) on the reference's current config."""
    rng = np.random.RandomState(seed)
    st = {f: np.array(getattr(jcp.snapshot(), f))
          for f in JR.RoutingState._fields}
    E, A = st["ep_load"].shape[0], st["aff_key"].shape[0]
    st["ep_load"][:] = rng.randint(0, 9, E)
    st["ep_inflight_ewma"][:] = rng.rand(E).astype(np.float32) * 4
    st["ep_tput_ewma"][:] = rng.rand(E).astype(np.float32)
    st["rr_cursor"][:] = rng.randint(0, 100, st["rr_cursor"].shape[0])
    hit = rng.rand(A) < 0.5
    st["aff_key"][:] = np.where(hit, rng.randint(0, 1 << 30, A), -1)
    st["aff_ep"][:] = np.where(hit, rng.randint(0, 12, A), -1)
    st["version"] = np.asarray(3, np.int32)
    return st


def _mid_drain_plan():
    """A reference plan that drains a loaded endpoint, removes one by
    swap-with-last and adds one, over a warm consumer."""
    services, clusters = _config(JR)
    jcp = JC.ControlPlane(services, clusters)
    c = JConsumer(jcp)
    c.set_load(jcp.endpoint_slot("stable", 3), 4)
    with jcp.transaction():
        jcp.drain_endpoint("stable", 3)
        jcp.remove_endpoint("hash", 7)
        jcp.add_endpoint("canary", instance=12)   # relocates the window
        jcp.set_weight("hash", 9, 0.25)
    return jcp


@pytest.mark.parametrize("versioned", [True, False])
def test_apply_plan_matches_reference(versioned):
    jcp = _mid_drain_plan()
    plan = jcp.last_plan
    if not versioned:
        plan = plan._replace(base_version=-1, version=-1)
    tplan = TC.unpack_plan(JC.pack_plan(plan))
    for seed in range(3):
        st = _warm(jcp, seed)
        jlive = JR.RoutingState(*[jnp.asarray(st[f])
                                  for f in JR.RoutingState._fields])
        tlive = convert.routing_from_numpy(st, CPU)
        want = JC.apply_plan(jlive, plan)
        got = TC.apply_plan(tlive, tplan)
        _assert_routing_equal(got, want, f"seed {seed}")
        assert int(got.version) == (1 if versioned else 4)
        assert int((got.aff_ep >= 0).sum()) < int((tlive.aff_ep >= 0).sum())


def test_remap_endpoints_matches_reference():
    plan = _mid_drain_plan().last_plan
    tplan = TC.unpack_plan(JC.pack_plan(plan))
    rng = np.random.RandomState(4)
    ep = rng.randint(-2, 20, (16, 8)).astype(np.int32)
    ep[0, :3] = (600, 511, -1)                    # past E clamps
    want = JC.remap_endpoints(plan, jnp.asarray(ep))
    got = TC.remap_endpoints(tplan, torch.from_numpy(ep))
    _assert_same(got, want, "endpoint")
    assert int((got == -1).sum()) > int((torch.from_numpy(ep) == -1).sum())


# --------------------------------------------------------------------------- #
# wire payloads
# --------------------------------------------------------------------------- #


def _mutate(wire, case):
    w = {k: (np.array(v).copy() if isinstance(v, np.ndarray) else v)
         for k, v in wire.items()}
    if case == "field_bounds":
        w["cluster_ep_count"][0] = JR.MAX_EPS_PER_CLUSTER + 7
    elif case == "window_overlap":
        w["cluster_ep_start"][1] = w["cluster_ep_start"][0]
    elif case == "broken_permutation":
        w["ep_src"][0], w["ep_dst"][1] = 1, 5
    elif case == "version_regression":
        w["base_version"] = w["version"]
    elif case == "rule_cluster":
        w["rule_cluster"][0] = 10_000
    elif case == "missing_field":
        del w["ep_dst"]
    elif case == "shape":
        w["ep_weight"] = w["ep_weight"][:-1]
    elif case == "dtype":
        w["ep_drained"] = w["ep_drained"].astype(np.float32)
    elif case == "float_field":
        w["ep_weight"] = w["ep_weight"].astype(np.int32)
    elif case == "scalar":
        w["version"] = 1.5
    elif case == "negative_scalar":
        w["base_version"] = -4
    elif case == "not_a_dict":
        return list(w.items())
    return w


LAW_MUTATIONS = ("field_bounds", "window_overlap", "broken_permutation",
                 "version_regression", "rule_cluster")
MUTATIONS = ("field_bounds", "window_overlap", "broken_permutation",
             "version_regression", "rule_cluster", "missing_field", "shape",
             "dtype", "float_field", "scalar", "negative_scalar",
             "not_a_dict")


@pytest.mark.parametrize("case", MUTATIONS)
def test_unpack_plan_mutations_raise_reference_message(case):
    jcp = JC.ControlPlane()
    jcp.add_cluster("a", endpoints=[0, 1, 2])
    jcp.add_cluster("b", endpoints=[3, 4])
    wire = dict(jcp.journal[-1])
    assert TInv.check_plan_wire(wire) == []
    bad = _mutate(wire, case)
    with pytest.raises(ValueError) as want:
        JC.unpack_plan(bad)
    with pytest.raises(ValueError) as got:
        TC.unpack_plan(bad)
    assert str(got.value) == str(want.value)
    if case in LAW_MUTATIONS:               # the law that names it
        assert TInv.check_plan_wire(bad) == JInv.check_plan_wire(bad) != []


def test_unpack_plan_round_trip_is_bit_exact():
    jcp = _mid_drain_plan()
    wire = JC.pack_plan(jcp.last_plan)
    back = TC.pack_plan(TC.unpack_plan(wire))
    assert back.keys() == wire.keys()
    for k in wire:
        _assert_same(back[k], wire[k], k)


# --------------------------------------------------------------------------- #
# core/delta.py
# --------------------------------------------------------------------------- #


def test_deltas_match_reference():
    services, clusters = _config(JR)
    jst, _ = JR.build_state(services, clusters)
    arrs = {f: np.array(getattr(jst, f)) for f in jst._fields}
    arrs["ep_load"][:] = np.arange(512) % 7
    arrs["ep_inflight_ewma"][:] = (np.arange(512) % 5) / 4
    jst = JR.RoutingState(*[jnp.asarray(arrs[f]) for f in jst._fields])
    tst = convert.routing_from_numpy(arrs, CPU)
    steps = [
        ("add_endpoint", (1, 20, 13, 2.5)),
        ("add_endpoint", (1, 600, 14)),           # dropped write
        ("add_endpoint", (2, -1, 15, 0.5)),       # counts from the end
        ("remove_endpoint", (1, 1)),              # mid-window swap
        ("remove_endpoint", (3, 9)),              # offset clamps
        ("remove_endpoint", (40, 0)),             # empty: a no-op bump
        ("add_rule", (0, 30, 2, 77, 3)),
        ("remove_rule", (0, 0)),
        ("remove_rule", (9, 0)),                  # empty chain
        ("set_policy", (2, 4)),
        ("set_weight", (3, 7.5)),
        ("set_drained", (4, True)),
        ("set_drained", (4, False)),
    ]
    for n, (name, args) in enumerate(steps):
        jst = getattr(JD, name)(jst, *args)
        tst = getattr(TD, name)(tst, *args)
        _assert_routing_equal(tst, jst, f"step {n} {name}")
    assert int(tst.version) == len(steps)


# --------------------------------------------------------------------------- #
# ServeLoop attached to a ControlPlane, a commit mid-drain
# --------------------------------------------------------------------------- #

I, C, MAX_LEN, N_REQ = 4, 4, 6, 28


@pytest.fixture(scope="module")
def weights():
    jp = JM.init_params(JCFG, jax.random.PRNGKey(0), jnp.float32)
    return jp, convert.params_from_jax(jax.tree.map(np.asarray, jp), CPU)


def _pool_cp(mod, RT):
    return mod.ControlPlane(
        [RT.ServiceConfig("svc", rules=[RT.Rule(0, None, "pool")])],
        [RT.Cluster("pool", endpoints=[0, 1, 2],
                    policy=RT.POLICY_LEAST_REQUEST)])


def _mid_drain_run(loop, cp, mod):
    """Submit N_REQ requests over the first ticks; at tick 2 drain the
    loaded instance 1, remove instance 0 (slot 2 moves to slot 0) and add
    instance 3, in one transaction; then reap every tick until idle.
    Returns (report, versions per tick, the tick instance 1 was reaped,
    the load on its slot right after the commit)."""
    versions, reaped, load_at_commit = [], -1, None
    for t in range(200):
        for i in range(8 * t, min(8 * t + 8, N_REQ)):
            loop.submit(mod.Request(req_id=i, service=0,
                                    headers={"path": f"/p/{i % 5}"},
                                    prompt_token=3 + i % 200))
        if t == 2:
            slot = cp.endpoint_slot("pool", 1)
            with cp.transaction():
                cp.drain_endpoint("pool", 1)
                cp.remove_endpoint("pool", 0)
                cp.add_endpoint("pool", instance=3)
            load_at_commit = int(np.asarray(loop.routing.ep_load)[
                cp.endpoint_slot("pool", 1)])
            assert cp.endpoint_slot("pool", 1) == slot
        if t > 2:
            cp.reap()
            if reaped < 0 and cp.endpoint_slot("pool", 1) < 0:
                reaped = t
        versions.append(int(np.asarray(loop.routing.version)))
        if 8 * t >= N_REQ and not (loop.queue or loop._waiting
                                   or loop.inflight):
            break
        loop.tick()
    return loop.drain(max_ticks=50), versions, reaped, load_at_commit


@pytest.mark.parametrize("kind", ["xlb", "cilium"])
def test_serve_loop_mid_drain_commit_matches_reference(weights, kind):
    jp, tp = weights
    jcp, tcp = _pool_cp(JC, JR), _pool_cp(TC, TR)
    if kind == "xlb":
        jeng = JI.Engine(JCFG, I, C, MAX_LEN, eos=-1)
    else:
        jeng = JSide.SidecarEngine(JCFG, I, C, MAX_LEN, mode=kind, eos=-1)
    teng = make_balancer(kind, TCFG, I, C, MAX_LEN, eos=-1, device="cpu")
    jloop = JS.ServeLoop(jeng, jp, jcp, admit_batch=8, dtype=jnp.float32)
    tloop = TS.ServeLoop(teng, tp, tcp, admit_batch=8, dtype=torch.float32)
    assert tloop.cp is tcp and tcp.lease_live(tloop)
    jrep, jver, jreap, jload = _mid_drain_run(jloop, jcp, JS)
    trep, tver, treap, tload = _mid_drain_run(tloop, tcp, TS)
    assert jload > 0 and tload == jload          # drained while loaded
    assert tver == jver and max(tver) >= 2       # one bump per commit
    assert jreap > 2 and treap == jreap
    assert len(trep.done) == len(jrep.done) == N_REQ
    assert (len(trep.dropped), trep.queued, trep.inflight, trep.held_first) \
        == (len(jrep.dropped), jrep.queued, jrep.inflight, jrep.held_first)
    assert [r.req_id for r in trep.done] == [r.req_id for r in jrep.done]
    assert [r.tokens for r in trep.done] == [r.tokens for r in jrep.done]
    jl, tl = jloop.latency_samples(), tloop.latency_samples()
    for k in jl:
        np.testing.assert_array_equal(tl[k], jl[k], err_msg=k)
    _assert_routing_equal(
        TR.RoutingState(*[torch.as_tensor(np.asarray(a))
                          for a in tloop.routing]),
        jloop.routing, "routing after the drain")
    assert not np.asarray(tloop.routing.ep_load).any()
    assert tcp.last_commit_log == jcp.last_commit_log
    # the drained instance took no admission after the commit: its only
    # completions are the connections it held at the commit
    slot3 = tcp.endpoint_slot("pool", 3)
    assert slot3 >= 0 and int(np.asarray(tloop.routing.ep_instance)[slot3]) \
        == 3


def test_launcher_serves_through_a_control_plane():
    assert serve.main(["--device", "cpu", "--instances", "2", "--slots",
                       "2", "--requests", "4", "--max-len", "6"]) == 4

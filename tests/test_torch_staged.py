"""The port's staged admission chain, on the CPU, against the JAX reference
on the same numpy inputs: ``router.match_cluster``, the route kernel's
plain version (``ops.route_match``) against the Pallas kernel and its
oracle, ``policies.select``/``release`` over all six policies, and
``request_map``.

``select`` is fed the reference's own draws: the key split as in
``repro/core/policies.py`` (``kr, kw, _ = split(key, 3)``), ``rnd`` from
``randint(kr, (B,), 0, 2**30)`` and the Gumbel noise from
``gumbel(kw, (B, 64))``.

Tolerance: bit-exact on every output (integers; the weighted policy's f32
scores are computed by the same operations on both sides)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import policies as JP
from repro.core import request_map as JQ
from repro.core import router as JRo
from repro.core import routing_table as JR
from repro.kernels import ops as jops
from repro.kernels import ref
from repro_torch import convert
from repro_torch.core import policies, request_map, router
from repro_torch.kernels import ops

CPU = torch.device("cpu")
WE = JR.MAX_EPS_PER_CLUSTER
# the reference functions compiled once per shape (eager dispatch of each
# jnp operation costs far more at these sizes)
j_match = jax.jit(JRo.match_cluster)
j_select = jax.jit(JP.select)
j_release = jax.jit(JP.release)
j_alloc = jax.jit(JQ.allocate_slots)
j_scatter = jax.jit(JQ.scatter_to_pool)
j_gather = jax.jit(JQ.gather_responses)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _pair(services, clusters, seed=0, drained=(), load_hi=7):
    """The same routing state on both sides, built by the reference; loads
    from numpy; drain bits raised after the build."""
    st, ids = JR.build_state(services, clusters)
    arrs = {f: np.array(getattr(st, f)) for f in st._fields}
    arrs["ep_load"] = np.random.RandomState(seed).randint(
        0, load_hi, arrs["ep_load"].shape).astype(np.int32)
    for e in drained:
        arrs["ep_drained"][e] = 1
    jst = JR.RoutingState(*[jnp.asarray(arrs[f]) for f in st._fields])
    return jst, convert.routing_from_numpy(arrs, CPU), ids


def _six_policies():
    """One service per policy to its own cluster, with a wildcard fallback
    (svc1 has none, so its misses are NO_ROUTE), an empty cluster and a
    cluster that gets fully drained."""
    services, clusters = [], []
    for i in range(6):
        rules = [JR.Rule(0, "v2", f"a{i}")]
        if i != 1:
            rules.append(JR.Rule(1, None, f"b{i}"))
        services.append(JR.ServiceConfig(f"svc{i}", rules))
        a_eps = [(3 * i + k) % 8 for k in range(3 + i % 3)]
        clusters += [JR.Cluster(f"a{i}", a_eps, policy=i,
                                weights=[1.0, 6.0, 0.25, 3.0, 2.0][:len(a_eps)]),
                     JR.Cluster(f"b{i}", [(5 * i + k) % 8 for k in range(2)],
                                policy=(i + 1) % 6, weights=[2.0, 0.5])]
    services += [JR.ServiceConfig("to_empty", [JR.Rule(0, None, "empty")]),
                 JR.ServiceConfig("to_dead", [JR.Rule(0, None, "dead")])]
    clusters += [JR.Cluster("empty", [], policy=0),
                 JR.Cluster("dead", [1, 2], policy=2)]
    return services, clusters


def _six_state(seed):
    services, clusters = _six_policies()
    st, ids = JR.build_state(services, clusters)
    cs = np.asarray(st.cluster_ep_start)
    cl = ids["clusters"]
    drained = [int(cs[cl[n]]) + 1 for n in ("a0", "a2", "a4", "a3")]
    drained += [int(cs[cl["dead"]]), int(cs[cl["dead"]]) + 1]
    return _pair(services, clusters, seed=seed, drained=drained)


def _requests(B, n_svc, seed, dup=0.3):
    """svc and features from numpy: half the rows carry the "v2" header,
    ``dup`` of them repeat an earlier row's flow (affinity contention)."""
    rng = np.random.RandomState(seed)
    svc = rng.randint(0, n_svc, B).astype(np.int32)
    feats = rng.randint(0, 40, (B, JR.N_FEATURES)).astype(np.int32)
    feats[:, 0] = np.where(rng.rand(B) < 0.5, JR.fnv1a("v2"), 7)
    for r in range(1, B):
        if rng.rand() < dup:
            src = rng.randint(0, r)
            feats[r], svc[r] = feats[src], svc[src]
    return svc, feats


def _draws(key, B):
    kr, kw, _ = jax.random.split(key, 3)
    rnd = jax.random.randint(kr, (B,), 0, 1 << 30)
    gum = jax.random.gumbel(kw, (B, WE))
    return _t(rnd), _t(gum)


def _assert_routing(tst, jst, fields=("ep_load", "rr_cursor", "aff_key",
                                      "aff_ep"), msg=""):
    for f in fields:
        np.testing.assert_array_equal(getattr(tst, f).numpy(),
                                      np.asarray(getattr(jst, f)),
                                      err_msg=f"{msg}{f}")


# --------------------------------------------------------------------------- #
# match + route kernel
# --------------------------------------------------------------------------- #


def test_match_cluster_matches_reference():
    jst, tst, _ = _six_state(seed=1)
    svc, feats = _requests(96, 8, seed=2)
    svc[:6] = [-1, -9, -70, 64, 65, 1000]      # ids outside the table
    feats[6:12, 0] = 0                        # field-0 misses
    want = np.asarray(j_match(jst, jnp.asarray(svc), jnp.asarray(feats)))
    got = router.match_cluster(tst, _t(svc), _t(feats))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == -1).any() and len(set(want.tolist())) > 8


def _route_state(empty: bool, load_hi: int):
    """The reference kernel tests' routing state (four services over an
    "a" and a "b" least-request cluster each, seeded loads below
    ``load_hi``: a low bound makes tied minima common); ``empty`` points
    svc3's fallback at a cluster with no endpoints."""
    services = [JR.ServiceConfig(f"svc{i}", [
        JR.Rule(0, "v2", f"cl{i}a"),
        JR.Rule(1, None, "none" if empty and i == 3 else f"cl{i}b")])
        for i in range(4)]
    clusters, eid = [], 0
    for i in range(4):
        clusters += [JR.Cluster(f"cl{i}a", [eid, eid + 1],
                                policy=JR.POLICY_LEAST_REQUEST),
                     JR.Cluster(f"cl{i}b", [eid + 2, eid + 3, eid + 4],
                                policy=JR.POLICY_LEAST_REQUEST)]
        eid += 5
    if empty:
        clusters.append(JR.Cluster("none", [], policy=0))
    return _pair(services, clusters, seed=9, load_hi=load_hi)


@pytest.mark.parametrize("R,empty,load_hi", [(256, False, 7),
                                             (512, True, 2)])
def test_route_match_matches_pallas_and_oracle(R, empty, load_hi):
    """Cluster and endpoint against the Pallas kernel and its oracle; with
    ``load_hi`` 2 most windows hold tied minima, and the first one wins."""
    jst, tst, _ = _route_state(empty, load_hi)
    rng = np.random.RandomState(R)
    svc = rng.randint(0, 4, R).astype(np.int32)
    svc[rng.rand(R) < 0.05] = 70              # clamps to the last service
    svc[rng.rand(R) < 0.05] = -3              # clamps to service 0
    feats = np.zeros((R, 8), np.int32)
    feats[:, 0] = np.where(rng.rand(R) < 0.5, JR.fnv1a("v2"), JR.fnv1a("v9"))
    cluster, ep = ops.route_match(_t(svc), _t(feats), tst)
    assert cluster.dtype == ep.dtype == torch.int32
    jc, je = jops.route_match(jnp.asarray(svc), jnp.asarray(feats), jst)
    np.testing.assert_array_equal(cluster.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ep.numpy(), np.asarray(je))
    # the oracle indexes svc as a gather (a negative id wraps), so it
    # agrees with the kernels on the non-negative ids
    rc, re_ = ref.route_match_ref(jnp.asarray(svc), jnp.asarray(feats), jst)
    pos = svc >= 0
    np.testing.assert_array_equal(cluster.numpy()[pos], np.asarray(rc)[pos])
    np.testing.assert_array_equal(ep.numpy()[pos], np.asarray(re_)[pos])
    if empty:
        assert ((cluster.numpy() >= 0) & (ep.numpy() == -1)).any()


def test_route_match_applies_no_drain_mask():
    """The building block is the load-only scan: a drained endpoint with
    the least load is still chosen (unlike admission)."""
    services = [JR.ServiceConfig("s", [JR.Rule(0, None, "p")])]
    clusters = [JR.Cluster("p", [0, 1, 2], policy=JR.POLICY_LEAST_REQUEST)]
    jst, tst, _ = _pair(services, clusters, drained=[1])
    tst = tst._replace(ep_load=torch.tensor([5, 0, 3] + [0] * 509,
                                            dtype=torch.int32))
    z = torch.zeros((4,), dtype=torch.int32)
    cluster, ep = ops.route_match(z, torch.zeros((4, 8), dtype=torch.int32),
                                  tst)
    assert cluster.tolist() == [0] * 4 and ep.tolist() == [1] * 4


# --------------------------------------------------------------------------- #
# policies.select / release
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("B,seed", [(64, 0), (37, 1)])
def test_select_matches_reference_all_policies(B, seed):
    """Three batches in a row through both chains (the affinity cache
    learns in the first and hits in the later ones), with NO_ROUTE rows,
    drained endpoints, an empty and a fully drained cluster, and cluster
    ids past the table."""
    jst, tst, ids = _six_state(seed)
    key = jax.random.PRNGKey(seed)
    seen = set()
    for batch in range(3):
        svc, feats = _requests(B, 8, seed=10 * seed + batch)
        jcl = j_match(jst, jnp.asarray(svc), jnp.asarray(feats))
        cl = np.array(jcl)
        cl[:2] = [70, -5]                     # past the table / negative
        key, sub = jax.random.split(key)
        jsel, jst = j_select(jst, jnp.asarray(cl), sub, jnp.asarray(feats))
        rnd, gum = _draws(sub, B)
        tsel, tst = policies.select(tst, _t(cl), rnd, gum, _t(feats))
        for f in ("endpoint", "instance"):
            np.testing.assert_array_equal(getattr(tsel, f).numpy(),
                                          np.asarray(getattr(jsel, f)),
                                          err_msg=f"batch {batch}: {f}")
        _assert_routing(tst, jst, msg=f"batch {batch}: ")
        seen |= set(np.asarray(tst.cluster_policy)[
            np.clip(cl[np.asarray(jsel.endpoint) >= 0], 0, 63)].tolist())
    assert seen == set(range(6))
    assert (np.asarray(jst.aff_key) >= 0).any()


@pytest.mark.parametrize("policy", [JR.POLICY_RR, JR.POLICY_LEAST_REQUEST])
def test_select_no_route_mix_matches_reference(policy):
    """NO_ROUTE rows interleaved with cluster-0 traffic rank in the
    sentinel bucket, so cluster 0's arrival ranks are untouched."""
    jst, tst, _ = _pair([JR.ServiceConfig("s", [JR.Rule(0, "v2", "c")])],
                        [JR.Cluster("c", [0, 1, 2], policy=policy)],
                        load_hi=1)
    R = 24
    feats = np.zeros((R, 8), np.int32)
    feats[::2, 0] = JR.fnv1a("v2")
    svc = np.zeros((R,), np.int32)
    jcl = j_match(jst, jnp.asarray(svc), jnp.asarray(feats))
    key = jax.random.PRNGKey(0)
    jsel, jst2 = j_select(jst, jcl, key)
    tcl = router.match_cluster(tst, _t(svc), _t(feats))
    tsel, tst2 = policies.select(tst, tcl, *_draws(key, R))
    np.testing.assert_array_equal(tsel.endpoint.numpy(),
                                  np.asarray(jsel.endpoint))
    _assert_routing(tst2, jst2)
    assert (tsel.endpoint.numpy()[1::2] == -1).all()


def test_select_drained_and_fully_drained_clusters():
    services = [JR.ServiceConfig("s", [JR.Rule(0, None, "pool")])]
    for policy in range(6):
        clusters = [JR.Cluster("pool", [0, 1, 2], policy=policy,
                               weights=[1.0, 9.0, 1.0])]
        jst, tst, _ = _pair(services, clusters, drained=[1], load_hi=1)
        cl = torch.zeros((24,), dtype=torch.int32)
        sel, st2 = policies.select(tst, cl, *_draws(jax.random.PRNGKey(4),
                                                    24))
        eps = sel.endpoint.numpy()
        assert (eps != 1).all() and (eps >= 0).all(), policy
        assert int(st2.ep_load[1]) == 0 and int(st2.ep_load[:3].sum()) == 24
        dead = tst._replace(ep_drained=tst.ep_drained.index_fill(
            0, torch.tensor([0, 2]), 1))
        sel, st3 = policies.select(dead, cl, *_draws(jax.random.PRNGKey(5),
                                                     24))
        assert (sel.endpoint == -1).all() and (sel.instance == -1).all()
        assert torch.equal(st3.ep_load, dead.ep_load)


def test_draws_from_a_generator():
    g = torch.Generator().manual_seed(3)
    rnd, gum = policies.draws(g, 16)
    assert rnd.dtype == torch.int32 and rnd.shape == (16,)
    assert int(rnd.min()) >= 0 and int(rnd.max()) < 1 << 30
    assert gum.shape == (16, WE) and bool(torch.isfinite(gum).all())


def test_release_matches_reference():
    jst, tst, _ = _six_state(seed=3)
    rng = np.random.RandomState(4)
    ep = rng.randint(-2, 520, 40).astype(np.int32)   # -1, -2 and >= E skip
    done = rng.rand(40) < 0.7
    want = j_release(jst, jnp.asarray(ep), jnp.asarray(done))
    got = policies.release(tst, _t(ep), _t(done))
    _assert_routing(got, want, fields=("ep_load",))


# --------------------------------------------------------------------------- #
# request_map
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("I,C,R", [(2, 3, 5), (8, 4, 48), (64, 16, 256)])
def test_request_map_matches_reference(I, C, R):
    rng = np.random.RandomState(I * C)
    free = rng.rand(I, C) < 0.6
    inst = rng.randint(-1, I, R).astype(np.int32)
    ja = j_alloc(jnp.asarray(inst), jnp.asarray(free))
    ta = request_map.allocate_slots(_t(inst), _t(free))
    for f in ("instance", "slot", "ok"):
        np.testing.assert_array_equal(getattr(ta, f).numpy(),
                                      np.asarray(getattr(ja, f)), err_msg=f)
    assert (~ta.ok.numpy() & (inst >= 0)).any()      # some rows held
    pool = rng.randint(0, 99, (I, C, 2)).astype(np.int32)
    vals = rng.randint(100, 999, (R, 2)).astype(np.int32)
    jpool = j_scatter(jnp.asarray(pool), ja, jnp.asarray(vals))
    tpool = request_map.scatter_to_pool(_t(pool), ta, _t(vals))
    np.testing.assert_array_equal(tpool.numpy(), np.asarray(jpool))
    np.testing.assert_array_equal(
        request_map.gather_responses(tpool, ta, fill=-7).numpy(),
        np.asarray(j_gather(jpool, ja, fill=-7)))


def test_slot_allocation_and_response_order():
    free = torch.tensor([[True, False, True], [True, True, True]])
    a = request_map.allocate_slots(torch.tensor([0, 0, 0, 1, -1]), free)
    assert a.ok.tolist() == [True, True, False, True, False]
    assert a.slot.tolist()[:2] == [0, 2]
    pool = request_map.scatter_to_pool(torch.zeros((2, 3), dtype=torch.int32),
                                       a, torch.tensor([10, 20, 30, 40, 50]))
    back = request_map.gather_responses(pool, a, fill=-7)
    assert back.tolist() == [10, 20, -7, 40, -7]


def test_staged_chain_matches_reference():
    """match → select → allocate_slots → scatter_to_pool, the chain the
    chip smoke times against the fused kernel, on one batch."""
    jst, tst, _ = _six_state(seed=5)
    I, C, B = 8, 4, 64
    svc, feats = _requests(B, 8, seed=6)
    free = np.random.RandomState(7).rand(I, C) < 0.5
    key = jax.random.PRNGKey(8)
    jcl = j_match(jst, jnp.asarray(svc), jnp.asarray(feats))
    jsel, jst = j_select(jst, jcl, key, jnp.asarray(feats))
    ja = j_alloc(jsel.instance, jnp.asarray(free))
    jpool = j_scatter(jnp.full((I, C), -1, jnp.int32), ja,
                               jnp.arange(B, dtype=jnp.int32))
    tcl = router.match_cluster(tst, _t(svc), _t(feats))
    tsel, tst = policies.select(tst, tcl, *_draws(key, B), _t(feats))
    ta = request_map.allocate_slots(tsel.instance, _t(free))
    tpool = request_map.scatter_to_pool(
        torch.full((I, C), -1, dtype=torch.int32), ta,
        torch.arange(B, dtype=torch.int32))
    np.testing.assert_array_equal(tcl.numpy(), np.asarray(jcl))
    np.testing.assert_array_equal(ta.slot.numpy(), np.asarray(ja.slot))
    np.testing.assert_array_equal(tpool.numpy(), np.asarray(jpool))
    _assert_routing(tst, jst)
    assert int(ta.ok.sum()) > 0

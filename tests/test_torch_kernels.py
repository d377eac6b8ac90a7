"""The port's datapath kernels (plain PyTorch path, on the CPU) against the
JAX reference on the same inputs: ``admit`` / ``admit_commit`` against the
sequential oracles of ``repro.kernels.ref`` across all six policies and the
edge cases, ``complete`` against ``complete_ref``, and one case of each
through the reference ``repro.kernels.ops`` wrappers (Pallas interpreter).

Tolerance: every integer output and both f32 EWMAs bit-exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import routing_table as JR
from repro.core.balancer import PoolState as JPool
from repro.core.balancer import RequestBatch as JBatch
from repro.kernels import ops as jops
from repro.kernels import ref
from repro_torch import convert
from repro_torch.core import routing_table as TR
from repro_torch.core.balancer import PoolState, RequestBatch
from repro_torch.core.policy_defs import flow_hash
from repro_torch.kernels import _build, ops, route_match

WE = JR.MAX_EPS_PER_CLUSTER
CPU = torch.device("cpu")


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _state_pair(services, clusters, seed, drained=(), load_hi=7):
    """The same routing state on both sides: built by the reference, loads
    drawn with numpy, drain bits raised after the build (so the Maglev
    table still claims the drained offsets)."""
    st, ids = JR.build_state(services, clusters)
    arrs = {f: np.array(getattr(st, f)) for f in st._fields}
    rng = np.random.RandomState(seed)
    arrs["ep_load"] = rng.randint(0, load_hi, arrs["ep_load"].shape
                                  ).astype(np.int32)
    for e in drained:
        arrs["ep_drained"][e] = 1
    jst = JR.RoutingState(*[jnp.asarray(arrs[f]) for f in st._fields])
    return arrs, jst, convert.routing_from_numpy(arrs, CPU), ids


def _six_policy_config():
    """Seven services over one cluster per policy ("a" clusters), wildcard
    fallbacks ("b" clusters, never affinity), drained endpoints and one
    fully drained cluster.  svc1 has no fallback → field-0 misses are
    NO_ROUTE."""
    services, clusters = [], []
    for i in range(6):
        rules = [JR.Rule(0, "v2", f"cl{i}a")]
        if i != 1:
            rules.append(JR.Rule(1, None, f"cl{i}b"))
        services.append(JR.ServiceConfig(f"svc{i}", rules))
        a_eps = [(i * 3 + k) % 8 for k in range(3 + i % 3)]
        b_eps = [(i * 5 + k) % 8 for k in range(2 + i % 2)]
        clusters += [
            JR.Cluster(f"cl{i}a", a_eps, policy=i,
                       weights=[1.0, 6.0, 0.25, 3.0, 2.0][:len(a_eps)]),
            JR.Cluster(f"cl{i}b", b_eps, policy=(i + 1) % 5,
                       weights=[2.0, 0.5, 1.0][:len(b_eps)])]
    services.append(JR.ServiceConfig("svc6", [JR.Rule(2, None, "dead")]))
    clusters.append(JR.Cluster("dead", [1, 2], policy=0))
    return services, clusters


def _drained_eps(services, clusters):
    """One endpoint drained in the rr, least-request and maglev "a"
    clusters, and every endpoint of "dead"."""
    st, ids = JR.build_state(services, clusters)
    cs = np.asarray(st.cluster_ep_start)
    cc = np.asarray(st.cluster_ep_count)
    out = []
    for name in ("cl0a", "cl2a", "cl4a"):
        out.append(int(cs[ids["clusters"][name]]) + 1)
    d = ids["clusters"]["dead"]
    out += list(range(int(cs[d]), int(cs[d] + cc[d])))
    return out


def _batch(R, seed, n_svc=7, dup_p=0.25, rogue=True):
    """Requests: 60% match field 0, small-range feature columns plus
    duplicated rows (affinity contention within a batch), 15% padding,
    optionally rogue service ids."""
    rng = np.random.RandomState(seed)
    svc = rng.randint(0, n_svc, R).astype(np.int32)
    feats = rng.randint(0, 40, (R, JR.N_FEATURES)).astype(np.int32)
    feats[:, 0] = np.where(rng.rand(R) < 0.6, JR.fnv1a("v2"),
                           JR.fnv1a("v9"))
    for r in range(1, R):
        if rng.rand() < dup_p:
            src = rng.randint(0, r)
            feats[r], svc[r] = feats[src], svc[src]
    if rogue:
        svc[rng.rand(R) < 0.04] = -3           # clips to service 0
    rid = np.where(rng.rand(R) < 0.85, np.arange(R), -1).astype(np.int32)
    msgb = rng.randint(1, 500, R).astype(np.int32)
    rnd = rng.randint(0, 1 << 30, R).astype(np.int32)
    gum = rng.gumbel(size=(R, WE)).astype(np.float32)
    tok = rng.randint(0, 97, R).astype(np.int32)
    return rid, svc, feats, msgb, rnd, gum, tok


def _pool(I, C, seed, active_p=0.5):
    rng = np.random.RandomState(seed)
    act = rng.rand(I, C) < active_p
    return (np.where(act, rng.randint(1000, 2000, (I, C)), -1).astype(np.int32),
            np.where(act, rng.randint(0, 8, (I, C)), -1).astype(np.int32),
            rng.randint(0, 4, (I, C)).astype(np.int32),
            rng.randint(0, 9, (I, C)).astype(np.int32),
            rng.randint(0, 97, (I, C)).astype(np.int32), act)


def _assert_fields(got, want, names):
    for name in names:
        np.testing.assert_array_equal(np.asarray(getattr(got, name)),
                                      np.asarray(getattr(want, name)),
                                      err_msg=f"field {name!r}")


ADMIT_FIELDS = route_match.AdmitResult._fields
COMMIT_FIELDS = route_match.AdmitCommitResult._fields


@pytest.mark.parametrize("R", [300, 64])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_admit_matches_oracle_all_policies(R, seed):
    """All six policies, drains and a fully drained cluster, NO_ROUTE,
    held rows (small pool), padding, rogue svc ids, an integer free mask
    (cells > 1 still mean one slot), duplicated flows contending for
    affinity slots; R=300 is ragged over two 256-row tiles."""
    services, clusters = _six_policy_config()
    _, jst, tst, _ = _state_pair(services, clusters, seed + 10,
                                 drained=_drained_eps(services, clusters))
    rid, svc, feats, msgb, rnd, gum, _ = _batch(R, seed)
    rng = np.random.RandomState(seed + 20)
    free = (rng.rand(8, 4) < 0.6) * rng.randint(1, 4, (8, 4))
    got = ops.admit(RequestBatch(_t(rid), _t(svc), _t(feats),
                                 torch.zeros(R, dtype=torch.int32),
                                 _t(msgb)), tst, _t(free), _t(rnd), _t(gum))
    want = ref.admit_ref(rid, svc, feats, msgb, jst, free, rnd, gum)
    _assert_fields(got, want, ADMIT_FIELDS)
    assert int(got.no_route) > 0 and int(got.held) > 0
    assert int(got.ok.sum()) > 0
    cl = np.asarray(got.cluster)
    assert len(set(np.asarray(tst.cluster_policy)[cl[cl >= 0]])) == 6


@pytest.mark.parametrize("seed", [0, 1])
def test_admit_commit_matches_oracle_all_policies(seed):
    """The pool write-back on top of the same sweep: every field of the
    committed pool, and pre-existing connections untouched."""
    services, clusters = _six_policy_config()
    _, jst, tst, _ = _state_pair(services, clusters, seed + 30,
                                 drained=_drained_eps(services, clusters))
    R = 300
    rid, svc, feats, msgb, rnd, gum, tok = _batch(R, seed + 5)
    pool = _pool(8, 6, seed + 40)
    tpool = convert.pool_from_numpy(dict(zip(PoolState._fields, pool)), CPU)
    assert tpool.active.dtype == torch.bool
    got = ops.admit_commit(
        RequestBatch(_t(rid), _t(svc), _t(feats), _t(tok), _t(msgb)), tst,
        tpool, _t(rnd), _t(gum))
    want = ref.admit_commit_ref(rid, svc, feats, msgb, tok, jst, *pool, rnd,
                                gum)
    _assert_fields(got, want, ADMIT_FIELDS)
    for name in ("req_id", "endpoint", "svc", "length", "token"):
        np.testing.assert_array_equal(np.asarray(getattr(got.pool, name)),
                                      getattr(want, f"pool_{name}"),
                                      err_msg=f"pool field {name!r}")
    np.testing.assert_array_equal(np.asarray(got.pool.active),
                                  want.pool_active > 0)
    assert int(got.held) > 0 and int(got.ok.sum()) > 0
    pre = pool[5]
    np.testing.assert_array_equal(np.asarray(got.pool.req_id)[pre],
                                  pool[0][pre])


def test_admit_result_independent_of_tile_size():
    """The plain path at two tile sizes gives equal results (the CUDA
    kernel's tile is fixed at 256 rows)."""
    services, clusters = _six_policy_config()
    _, _, tst, _ = _state_pair(services, clusters, 3,
                               drained=_drained_eps(services, clusters))
    R = 200
    rid, svc, feats, msgb, rnd, gum, tok = _batch(R, 9)
    pool = [_t(p) for p in _pool(8, 8, 4)]
    args = (_t(rid), _t(svc), _t(feats), _t(msgb), _t(tok), tst, *pool,
            _t(rnd), _t(gum))
    a = route_match.admit_commit(*args, block_r=256)
    b = route_match.admit_commit(*args, block_r=32)
    _assert_fields(a, b, COMMIT_FIELDS)
    assert int(a.ok.sum()) > 0


def test_admit_empty_batch_passes_state_through():
    services, clusters = _six_policy_config()
    _, jst, tst, _ = _state_pair(services, clusters, 4)
    z = torch.zeros((0,), dtype=torch.int32)
    pool = [_t(p) for p in _pool(8, 4, 14)]
    reqs = RequestBatch(z, z, torch.zeros((0, 8), dtype=torch.int32), z, z)
    gum = torch.zeros((0, WE))
    got = ops.admit_commit(reqs, tst, PoolState(*pool), z, gum)
    want = ref.admit_ref(np.zeros(0, np.int32), np.zeros(0, np.int32),
                         np.zeros((0, 8), np.int32), np.zeros(0, np.int32),
                         jst, np.ones((8, 4), bool), np.zeros(0, np.int32),
                         np.zeros((0, WE), np.float32))
    _assert_fields(got, want, ADMIT_FIELDS)
    assert got.pool.req_id is pool[0]
    assert ops.LAUNCHES == {"admit": 0, "admit_commit": 0, "complete": 0,
                            "route_match": 0, "relay_slots": 0,
                            "decode_attention": 0, "flash_attention": 0,
                            "ssd_scan": 0, "dense_x9": 0}


def test_admit_integer_free_mask_and_rogue_svc():
    """A free-mask cell > 1 is one slot, and svc >= MAX_SERVICES routes
    (clipped) but is dropped from the per-service metrics."""
    services = [JR.ServiceConfig(f"s{i}", [JR.Rule(0, None, "pool")])
                for i in range(JR.MAX_SERVICES)]
    clusters = [JR.Cluster("pool", [0], policy=JR.POLICY_RR)]
    _, jst, tst, _ = _state_pair(services, clusters, 0, load_hi=1)
    R = 4
    rid = np.arange(R, dtype=np.int32)
    svc = np.array([0, JR.MAX_SERVICES + 3, 0, 0], np.int32)
    z = np.zeros(R, np.int32)
    feats = np.zeros((R, 8), np.int32)
    gum = np.zeros((R, WE), np.float32)
    free = np.array([[0, 2, 0, 3]], np.int32)
    got = ops.admit(RequestBatch(_t(rid), _t(svc), _t(feats), _t(z),
                                 _t(z + 7)), tst, _t(free), _t(z), _t(gum))
    want = ref.admit_ref(rid, svc, feats, z + 7, jst, free, z, gum)
    _assert_fields(got, want, ADMIT_FIELDS)
    assert list(np.asarray(got.slot)[:2]) == [1, 3]
    assert int(got.svc_requests.sum()) == 1


def test_admit_affinity_sticks_across_batches():
    """Batch 2 sees the affinity cache batch 1 wrote; both batches match
    the oracle chained over the same state."""
    services = [JR.ServiceConfig("s", [JR.Rule(1, None, "af")])]
    clusters = [JR.Cluster("af", [0, 1, 2, 3], policy=JR.POLICY_AFFINITY)]
    arrs, jst, tst, _ = _state_pair(services, clusters, 5)
    R = 48
    rid, _, feats, msgb, rnd, gum, _ = _batch(R, 3, n_svc=1, rogue=False)
    svc = np.zeros(R, np.int32)
    free = np.ones((4, 16), np.int32)
    reqs = RequestBatch(_t(rid), _t(svc), _t(feats), _t(svc), _t(msgb))
    j, t = jst, tst
    outs = []
    for _ in range(2):
        got = ops.admit(reqs, t, _t(free), _t(rnd), _t(gum))
        want = ref.admit_ref(rid, svc, feats, msgb, j, free, rnd, gum)
        _assert_fields(got, want, ADMIT_FIELDS)
        t = t._replace(ep_load=got.ep_load, rr_cursor=got.rr_cursor,
                       aff_key=got.aff_key, aff_ep=got.aff_ep,
                       maglev_table=torch.full_like(t.maglev_table, -1))
        j = j._replace(ep_load=jnp.asarray(want.ep_load),
                       rr_cursor=jnp.asarray(want.rr_cursor),
                       aff_key=jnp.asarray(want.aff_key),
                       aff_ep=jnp.asarray(want.aff_ep),
                       maglev_table=jnp.full_like(j.maglev_table, -1))
        outs.append(np.asarray(got.endpoint))
    keys = np.asarray(flow_hash(feats))
    cached = (np.asarray(t.aff_key)[keys % JR.AFFINITY_SLOTS] == keys) \
        & (rid >= 0)
    assert cached.sum() > 0
    np.testing.assert_array_equal(outs[0][cached], outs[1][cached])


def test_admit_commit_matches_reference_ops_odd_rule_fields():
    """Through the reference ``ops.admit_commit`` (Pallas interpreter):
    rule fields outside [0, 8) follow the reference gather — -1 reads the
    last column, 9 and -9 read the fill value INT_MIN, which a rule value
    of INT_MIN matches."""
    int_min = -2**31
    services = [
        JR.ServiceConfig("a", [JR.Rule(0, "v2", "lr"), JR.Rule(1, None,
                                                               "rr")]),
        JR.ServiceConfig("b", [JR.Rule(0, "x", "mg"), JR.Rule(1, None,
                                                              "wt")])]
    clusters = [JR.Cluster("lr", [0, 1, 2], policy=JR.POLICY_LEAST_REQUEST),
                JR.Cluster("rr", [3, 4], policy=JR.POLICY_RR),
                JR.Cluster("mg", [5, 6, 7], policy=JR.POLICY_MAGLEV),
                JR.Cluster("wt", [0, 7], policy=JR.POLICY_WEIGHTED,
                           weights=[1.0, 4.0])]
    st, _ = JR.build_state(services, clusters)
    arrs = {f: np.array(getattr(st, f)) for f in st._fields}
    arrs["rule_field"][:4] = [-1, 1, 9, 1]     # rule 0 reads column 7
    arrs["rule_value"][0] = JR.fnv1a("v2")
    arrs["rule_field"][2], arrs["rule_value"][2] = -9, int_min
    arrs["ep_load"][:8] = np.arange(8) % 3
    jst = JR.RoutingState(*[jnp.asarray(arrs[f]) for f in st._fields])
    tst = convert.routing_from_numpy(arrs, CPU)
    R = 40
    rid, svc, feats, msgb, rnd, gum, tok = _batch(R, 21, n_svc=2,
                                                  rogue=False)
    feats[::2, 7] = JR.fnv1a("v2")
    pool = _pool(8, 4, 22)
    got = ops.admit_commit(
        RequestBatch(_t(rid), _t(svc), _t(feats), _t(tok), _t(msgb)), tst,
        PoolState(*[_t(p) for p in pool]), _t(rnd), _t(gum))
    want = jops.admit_commit(
        JBatch(*[jnp.asarray(a) for a in (rid, svc, feats, tok, msgb)]),
        jst, JPool(*[jnp.asarray(p) for p in pool]), jnp.asarray(rnd),
        jnp.asarray(gum))
    _assert_fields(got, want, ADMIT_FIELDS)
    _assert_fields(got.pool, want.pool, JPool._fields)
    cl = np.asarray(got.cluster)
    assert {0, 1, 2} <= set(cl[cl >= 0].tolist())


# --------------------------------------------------------------------------- #
# completion
# --------------------------------------------------------------------------- #


def _complete_case(I, C, seed, eos=1, active_p=0.6, case="random"):
    """The reference's case shape: ~25% EOS lanes, lengths near the
    budget, plus out-of-range endpoint and service ids on some active
    slots and warm EWMAs.  ``case`` takes it to an edge of the completion
    kernel: "one_endpoint" (every cell active on one endpoint and one
    service), "out_of_range" (every endpoint in {-2, E, E + 7}, every
    service >= S) or "smem_limit" (E + S fills the kernel's shared
    memory)."""
    rng = np.random.RandomState(seed)
    pool = list(_pool(I, C, seed, active_p=active_p))
    E, S = JR.MAX_ENDPOINTS, JR.MAX_SERVICES
    if case == "smem_limit":
        E = _build.SMEM_DEFAULT // 4 - S
    odd = rng.rand(I, C) < 0.1
    pool[1] = np.where(odd, rng.choice([-1, E, E + 7], (I, C)),
                       pool[1]).astype(np.int32)
    pool[2] = np.where(rng.rand(I, C) < 0.1, rng.choice([-2, S, S + 3],
                                                        (I, C)),
                       pool[2]).astype(np.int32)
    if case == "one_endpoint":
        pool[1][:] = 5
        pool[2][:] = 3
        pool[5][:] = True
    if case == "out_of_range":
        pool[1] = rng.choice([-2, E, E + 7], (I, C)).astype(np.int32)
        pool[2] = rng.choice([S, S + 3], (I, C)).astype(np.int32)
    load = rng.randint(3, 9, E).astype(np.int32)
    rx = rng.randint(0, 100, S).astype(np.int32)
    nxt = np.where(rng.rand(I, C) < 0.25, eos,
                   rng.randint(2, 97, (I, C))).astype(np.int32)
    ewl = rng.uniform(0, 6, E).astype(np.float32)
    ewt = rng.uniform(0, 2, E).astype(np.float32)
    return pool, nxt, load, rx, ewl, ewt


COMPLETE_POOL = ("req_id", "endpoint", "svc", "length", "token", "active")


def _case(*a, case="random"):
    """A case of (I, C, seed, case) with the id its three numbers always
    had, plus the edge's name."""
    return pytest.param(*a, case, id="-".join(map(str, a))
                        + ("" if case == "random" else f"-{case}"))


@pytest.mark.parametrize("I,C,seed,case", [
    _case(2, 8, 0), _case(8, 16, 1), _case(8, 64, 2), _case(64, 16, 3),
    _case(64, 64, 4), _case(3, 5, 5),
    _case(64, 16, 6, case="one_endpoint"),
    _case(64, 16, 7, case="out_of_range"),
    _case(8, 16, 8, case="smem_limit"),
    _case(64, 16, 9, case="misaligned")])
@pytest.mark.parametrize("warm", [True, False])
def test_complete_matches_oracle(I, C, seed, case, warm):
    """"misaligned" hands over the pool as views one element past an
    allocation's start (on the card the kernel's scalar build)."""
    pool, nxt, load, rx, ewl, ewt = _complete_case(I, C, seed, case=case)
    tpool = [_t(p) for p in pool]
    if case == "misaligned":
        tpool = [torch.cat([t.new_zeros(1), t.reshape(-1)])[1:].view(I, C)
                 for t in tpool]
        assert all(t.storage_offset() == 1 for t in tpool)
    ew = (ewl, ewt) if warm else (None, None)
    got = ops.complete(PoolState(*tpool), _t(nxt), _t(load),
                       _t(rx), *[None if e is None else _t(e) for e in ew],
                       eos=1, max_len=8)
    want = ref.complete_ref(*pool, nxt, load, rx, *ew, eos=1, max_len=8)
    for name in COMPLETE_POOL:
        np.testing.assert_array_equal(
            np.asarray(getattr(got.pool, name)).astype(np.int32),
            getattr(want, name), err_msg=f"pool field {name!r}")
    np.testing.assert_array_equal(np.asarray(got.done), want.done > 0)
    for mine, theirs in (("ep_load", "ep_load"), ("rx_bytes", "rx_bytes"),
                         ("done_cnt", "done_cnt"),
                         ("ep_inflight_ewma", "inflight_ewma"),
                         ("ep_tput_ewma", "tput_ewma")):
        np.testing.assert_array_equal(np.asarray(getattr(got, mine)),
                                      np.asarray(getattr(want, theirs)),
                                      err_msg=f"field {mine!r}")
    assert int(got.done.sum()) > 0
    assert not np.asarray(got.done)[~pool[5]].any()


def test_complete_matches_reference_ops():
    """Through the reference ``ops.complete`` (Pallas interpreter), warm
    EWMAs included — bit-exact."""
    pool, nxt, load, rx, ewl, ewt = _complete_case(8, 16, 7, eos=5)
    got = ops.complete(PoolState(*[_t(p) for p in pool]), _t(nxt), _t(load),
                       _t(rx), _t(ewl), _t(ewt), eos=5, max_len=6)
    want = jops.complete(JPool(*[jnp.asarray(p) for p in pool]),
                         jnp.asarray(nxt), jnp.asarray(load),
                         jnp.asarray(rx), jnp.asarray(ewl), jnp.asarray(ewt),
                         eos=5, max_len=6)
    _assert_fields(got.pool, want.pool, JPool._fields)
    _assert_fields(got, want, ("done", "ep_load", "rx_bytes", "done_cnt",
                               "ep_inflight_ewma", "ep_tput_ewma"))


def test_build_state_matches_reference():
    """The port's own builder gives the reference's tables bit for bit,
    Maglev rows included."""
    services, clusters = _six_policy_config()
    st, ids = JR.build_state(services, clusters)
    conv = lambda objs, cls: [cls(**vars(o)) for o in objs]
    tsv = [TR.ServiceConfig(s.name, conv(s.rules, TR.Rule))
           for s in services]
    tst, tids = TR.build_state(tsv, conv(clusters, TR.Cluster), CPU)
    assert tids == ids
    for f in st._fields:
        np.testing.assert_array_equal(np.asarray(getattr(tst, f)),
                                      np.asarray(getattr(st, f)),
                                      err_msg=f"field {f!r}")


def test_flow_hash_matches_reference_on_negative_features():
    from repro.core import policy_defs as JP
    rng = np.random.RandomState(0)
    feats = rng.randint(-2**31, 2**31 - 1, (64, 8), dtype=np.int64
                        ).astype(np.int32)
    want = np.asarray(JP.flow_hash(jnp.asarray(feats)))
    np.testing.assert_array_equal(flow_hash(_t(feats)).numpy(), want)
    np.testing.assert_array_equal(flow_hash(feats), want)

"""The port's sharded datapath (``kernels/shard_admit.py``, the shard mesh
of ``launch/mesh.py``, ``relay.sharded_apply``, ``Engine(shards=…)`` and
``serve --shards``) against the JAX reference, on the CPU with the plain
kernel versions.

* ``admit_commit_sharded`` at M ∈ {1, 2, 4} over the reference's sharded
  sweep (its case makers from ``tests/test_shard_admit.py``): an
  all-padding shard with a near-full pool, uneven queues, a ragged batch,
  the hash policies at volume, a fully drained cluster, and the two M = 1
  cases; every field against the reference's single-shard
  ``ops.admit_commit`` on the same batch and against the shard-major
  oracle ``ref.admit_sharded_ref``.
* B3's all-free mode (what each shard runs) against the plain version
  given an all-ones mask, and against the reference's ``ops.admit``.
* ``complete_sharded`` against the reference's ``ops.complete``, EWMA
  bits included; ``waterfill_lr`` against the reference's on random
  loads, per shard row and with its search cut to ``k_max``.
* ``sharded_apply`` at M = 4 against the reference's einsum oracle.
* ``Engine`` and mesh validation, with the reference's messages.
* ``ServeLoop`` over ``Engine(shards=2)`` and ``(shards=4)``: the same
  drain as the unsharded port and the unsharded reference.
* A mid-serve ``ControlPlane`` transaction and the transport crash and
  rejoin (the reference's subprocess scenarios) on a sharded port loop.
* ``serve --shards 2 --device cpu`` and its refusals.

Tolerance: exact, but ``sharded_apply`` (rtol = atol = 1e-5, the
reference's).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_shard_admit as T          # the reference's case makers
from repro.compat import make_mesh
from repro.configs.xlb_microbench import XLB_SERVICE_MODEL as JCFG
from repro.core import interpose as JI
from repro.core import relay as JRelay
from repro.core import routing_table as JR
from repro.kernels import ops as JOps
from repro.kernels import ref as JRef
from repro.kernels.shard_admit import waterfill_lr as j_waterfill
from repro.models import model as JM
from repro.runtime import serve_loop as JS
from repro_torch import convert
from repro_torch.configs import XLB_SERVICE_MODEL as TCFG
from repro_torch.core import control as TCtl
from repro_torch.core import interpose as TI
from repro_torch.core import relay as TRelay
from repro_torch.core.balancer import PoolState, RequestBatch, make_balancer
from repro_torch.kernels import ops, shard_admit
from repro_torch.kernels import route_match as rm
from repro_torch.launch import serve
from repro_torch.launch.mesh import make_shard_mesh
from repro_torch.models import model as TM
from repro_torch.runtime import serve_loop as TS
from repro_torch.runtime import transport as TT

CPU = torch.device("cpu")
MESH = {M: make_shard_mesh(M, device="cpu") for M in (1, 2, 4)}


def _t(x):
    return torch.from_numpy(np.array(x))


def _routing(st):
    return convert.routing_from_numpy(
        {f: np.asarray(getattr(st, f)) for f in st._fields}, CPU)


def _assert_same(want, got, ctx):
    """Every field of a reference result against the port's, bit for bit."""
    for name in want._fields:
        w, g = getattr(want, name), getattr(got, name)
        if name == "pool":
            for f in w._fields:
                np.testing.assert_array_equal(
                    getattr(g, f).numpy(), np.asarray(getattr(w, f)),
                    err_msg=f"{ctx} pool.{f}")
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=f"{ctx} {name}")


# --------------------------------------------------------------------------- #
# sharded admission
# --------------------------------------------------------------------------- #

# (R, batch seed, padded rows, pool (I, C), pool seed, active share, drain)
ADMIT_CASES = {
    "m1_R64": (64, 7, None, (4, 3), 9, 0.5, None),
    "m1_ragged_R33": (33, 3, None, (4, 3), 9, 0.5, None),
    "all_padding_shard_near_full": (96, 7, slice(48, 72), (4, 5), 9, 0.4,
                                    None),
    "uneven_queues": (96, 3, slice(8, 40), (4, 5), 11, 0.2, None),
    "ragged_R52": (52, 5, None, (4, 5), 13, 0.6, None),
    "hash_policies_at_volume": (128, 41, None, (4, 5), 23, 0.3, None),
    "fully_drained_cluster": (64, 21, None, (4, 5), 17, 0.5, slice(6, 8)),
}


@functools.lru_cache(maxsize=None)
def _admit_case(name):
    """The case's reference inputs, the reference's single-shard result,
    and the shard-major oracle on the batch padded to a multiple of 4."""
    R, seed, pad, (I, C), pseed, pact, drain = ADMIT_CASES[name]
    st = T._rich_state()
    if drain is not None:
        st = st._replace(ep_drained=st.ep_drained.at[drain].set(1))
    reqs, rnd, gum = T._batch(R, seed, pad_slice=pad)
    pool = T._pool(I, C, pseed, p_active=pact)
    want = JOps.admit_commit(reqs, st, pool, rnd, gum)
    R4 = -(-R // 4) * 4
    padr = lambda a, v: np.concatenate(                      # noqa: E731
        [np.asarray(a), np.full((R4 - R, *a.shape[1:]), v, a.dtype)])
    sh = lambda a, v=0: padr(a, v).reshape(4, R4 // 4, *a.shape[1:])  # noqa
    oracle = JRef.admit_sharded_ref(
        sh(reqs.req_id, -1), sh(reqs.svc), sh(reqs.features),
        sh(reqs.msg_bytes), sh(reqs.token), st, pool.req_id, pool.endpoint,
        pool.svc, pool.length, pool.token, pool.active, sh(rnd), sh(gum))
    return st, reqs, rnd, gum, pool, want, oracle


@pytest.mark.parametrize("M", [1, 2, 4])
@pytest.mark.parametrize("name", list(ADMIT_CASES))
def test_admit_commit_sharded_matches_reference(name, M):
    st, reqs, rnd, gum, pool, want, oracle = _admit_case(name)
    R = reqs.req_id.shape[0]
    treqs = RequestBatch(*map(_t, reqs))
    got = ops.admit_commit_sharded(treqs, _routing(st),
                                   PoolState(*map(_t, pool)), _t(rnd),
                                   _t(gum), mesh=MESH[M])
    _assert_same(want, got, f"{name} M={M} vs ops.admit_commit")
    flat = lambda a: np.asarray(a).reshape(-1)[:R]           # noqa: E731
    for f in ("cluster", "endpoint", "instance", "slot", "ok"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      flat(getattr(oracle, f)),
                                      err_msg=f"{name} M={M} oracle {f}")
    for f in ("ep_load", "rr_cursor", "svc_requests", "svc_tx_bytes",
              "no_route", "held", "aff_key", "aff_ep"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(oracle, f)),
                                      err_msg=f"{name} M={M} oracle {f}")
    for f, g in zip(("req_id", "endpoint", "svc", "length", "token",
                     "active"), got.pool):
        np.testing.assert_array_equal(
            g.numpy().astype(np.int32),
            np.asarray(getattr(oracle, f"pool_{f}")).astype(np.int32),
            err_msg=f"{name} M={M} oracle pool_{f}")
    if name == "all_padding_shard_near_full" and M == 4:
        assert shard_admit.live_shards(treqs.req_id, 4) == [True, True,
                                                           False, True]
        assert int(got.held) > 0
    if name == "hash_policies_at_volume":
        assert int((got.aff_ep >= 0).sum()) > 0       # the cache filled
    if name.startswith("m1"):
        assert int(got.held) > 0


@pytest.mark.parametrize("M", [1, 2, 4])
@pytest.mark.parametrize("name", list(ADMIT_CASES))
def test_admit_all_free_mode_matches_an_all_ones_mask(name, M):
    """B3's all-free mode, as the sharded admission calls it (each shard's
    rows against an all-free pool of width R/M), equals the plain version
    given an explicit all-ones (I, R/M) mask in every field; at M = 4 the
    first shard's rows also equal the reference's commit-free
    ``ops.admit`` given that mask."""
    st, reqs, rnd, gum, pool, _, _ = _admit_case(name)
    R = reqs.req_id.shape[0]
    I = pool.req_id.shape[0]
    R_loc = -(-R // M)
    routing = _routing(st)
    for m in range(M):
        sl = slice(m * R_loc, min((m + 1) * R_loc, R))
        args = [_t(a)[sl] for a in (reqs.req_id, reqs.svc, reqs.features,
                                    reqs.msg_bytes)]
        draws = [_t(rnd)[sl], _t(gum)[sl]]
        if args[0].shape[0] == 0:
            continue
        got = rm.admit(*args, routing, None, *draws, pool_shape=(I, R_loc))
        ones = torch.ones((I, R_loc), dtype=torch.int32)
        want = rm.admit(*args, routing, ones, *draws)
        for f in rm.AdmitResult._fields:
            assert torch.equal(getattr(got, f), getattr(want, f)), \
                f"{name} M={M} shard {m} {f}"
        if M == 4 and m == 0:
            jreqs = jax.tree.map(lambda a: a[sl], reqs)
            ref = JOps.admit(jreqs, st, jnp.ones((I, R_loc), jnp.int32),
                             rnd[sl], gum[sl])
            for f in rm.AdmitResult._fields:
                np.testing.assert_array_equal(
                    getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                    err_msg=f"{name} shard 0 vs the reference {f}")
    with pytest.raises(ValueError, match="pool_shape"):
        rm.admit(*args, routing, None, *draws)


def test_admit_commit_sharded_empty_batch_passes_the_pool_through():
    st = T._rich_state()
    reqs, rnd, gum = T._batch(0, 0)
    pool = T._pool(4, 3, 9)
    want = JOps.admit_commit_sharded(reqs, st, pool, rnd, gum,
                                     mesh=make_mesh((1,), ("shard",)))
    got = ops.admit_commit_sharded(RequestBatch(*map(_t, reqs)),
                                   _routing(st), PoolState(*map(_t, pool)),
                                   _t(rnd), _t(gum), mesh=MESH[2])
    _assert_same(want, got, "empty batch")


# --------------------------------------------------------------------------- #
# sharded completion, the water-fill
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("M", [1, 2, 4])
@pytest.mark.parametrize("I,C,seed", [(8, 6, 23), (4, 16, 29), (4, 6, 23)])
def test_complete_sharded_matches_reference(I, C, seed, M):
    pool, nxt, load, rx, ewl, ewt = T._complete_case(I, C, seed)
    want = JOps.complete(pool, nxt, load, rx, ewl, ewt, eos=1, max_len=8)
    got = ops.complete_sharded(PoolState(*map(_t, pool)), _t(nxt), _t(load),
                               _t(rx), _t(ewl), _t(ewt), mesh=MESH[M],
                               eos=1, max_len=8)
    _assert_same(want, got, f"complete I={I} C={C} M={M}")
    assert int(got.done_cnt.sum()) > 0
    assert got.ep_inflight_ewma.dtype == torch.float32


@pytest.mark.parametrize("seed", range(6))
def test_waterfill_matches_reference(seed):
    """Random loads, drains and k over two least-request clusters and a
    round-robin one (which passes through): per shard row, batched over
    four rows, and with the search cut to ``k_max``."""
    rng = np.random.RandomState(seed)
    sizes = rng.randint(1, 9, size=3)
    cls, start = [], 0
    for c, (n, pol) in enumerate(zip(sizes, (JR.POLICY_LEAST_REQUEST,
                                             JR.POLICY_RR,
                                             JR.POLICY_LEAST_REQUEST))):
        cls.append(JR.Cluster(f"c{c}", list(range(start, start + n)),
                              policy=pol))
        start += n
    st, _ = JR.build_state([JR.ServiceConfig("s", [JR.Rule(0, None, "c0")])],
                           cls)
    arrs = {f: np.array(getattr(st, f)) for f in st._fields}
    arrs["ep_load"][:start] = rng.randint(0, 7, size=start)
    arrs["ep_drained"][:start] = rng.rand(start) < 0.25
    st = JR.RoutingState(*[jnp.asarray(arrs[f]) for f in st._fields])
    tst = convert.routing_from_numpy(arrs, CPU)
    CL = arrs["rr_cursor"].shape[0]
    k = np.zeros((4, CL), np.int32)
    k[:, :3] = rng.randint(0, 40, size=(4, 3))
    batched = shard_admit.waterfill_lr(tst, torch.from_numpy(k))
    cut = shard_admit.waterfill_lr(tst, torch.from_numpy(k), k_max=40)
    for m in range(4):
        want = np.asarray(j_waterfill(st, jnp.asarray(k[m])))
        got = shard_admit.waterfill_lr(tst, torch.from_numpy(k[m]))
        for what, g in (("row", got), ("batched", batched[m]),
                        ("k_max", cut[m])):
            np.testing.assert_array_equal(g.numpy(), want,
                                          err_msg=f"{what} m={m} k={k[m]}")
        assert got.dtype == torch.int32


# --------------------------------------------------------------------------- #
# sharded_apply: the relay round trip over the mesh
# --------------------------------------------------------------------------- #


def test_sharded_apply_matches_einsum_oracle():
    M, E, C, D, N = 4, 8, 16, 4, 64
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (N, D)))
    idx = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (N,), 0, E))
    w = np.asarray(jax.random.uniform(jax.random.PRNGKey(2), (N,)))
    scale = np.arange(1.0, E + 1.0, dtype=np.float32)[:, None]
    buf, _, d_oh = JRelay.relay_dispatch_einsum(jnp.asarray(x),
                                                jnp.asarray(idx), E, M * C)
    want = JRelay.relay_combine_einsum(buf * scale[:, None, :], d_oh,
                                       jnp.asarray(w))
    per = lambda a: torch.from_numpy(a).reshape(M, -1, *a.shape[1:])  # noqa
    out, meta = TRelay.sharded_apply(
        per(x), per(idx.astype(np.int32)), per(w), E, C, MESH[M], "shard",
        lambda p, pool: pool * p[:, None, :], per(scale))
    np.testing.assert_allclose(out.reshape(N, D).numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(meta.load.numpy(),
                                  np.bincount(idx, minlength=E))
    assert meta.ok.shape == (M, N // M) and bool(meta.ok.all())
    assert float(meta.overflow_frac) == 0.0
    # a per-source quota of 1 drops rows against each source's own quota
    _, tight = TRelay.sharded_apply(
        per(x), per(idx.astype(np.int32)), None, E, 1, MESH[M], "shard",
        lambda p, pool: pool, per(scale))
    kept = sum(len(np.unique(r)) for r in idx.reshape(M, -1))
    assert int(tight.ok.sum()) == kept
    np.testing.assert_array_equal(tight.load.numpy(),
                                  np.bincount(idx, minlength=E))


# --------------------------------------------------------------------------- #
# validation
# --------------------------------------------------------------------------- #


def _error(fn) -> str:
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_engine_and_mesh_validation_match_reference():
    def ref(**kw):
        JI.Engine(JCFG, kw.pop("n", 4), 2, 8, **kw)

    def port(**kw):
        TI.Engine(TCFG, kw.pop("n", 4), 2, 8, device="cpu", **kw)

    class FakeMesh:
        shape = {"shard": 2}

    assert _error(lambda: port(shards=2)) == _error(lambda: ref(shards=2))
    assert "shard_mesh" in _error(lambda: port(shards=2))
    want = _error(lambda: ref(shards=2,
                              shard_mesh=make_mesh((1,), ("shard",))))
    assert _error(lambda: port(shards=2, shard_mesh=MESH[1])) == want
    assert "mesh width" in want
    assert _error(lambda: port(n=3, shards=2, shard_mesh=MESH[2])) \
        == _error(lambda: ref(n=3, shards=2, shard_mesh=FakeMesh()))
    # the pool must divide over the mesh axis: the reference's message
    reqs, rnd, gum = T._batch(8, 0)
    pool = T._pool(3, 2, 0)
    want = _error(lambda: JOps.admit_commit_sharded(
        reqs, T._rich_state(), pool, rnd, gum, mesh=FakeMesh()))
    got = _error(lambda: ops.admit_commit_sharded(
        RequestBatch(*map(_t, reqs)), _routing(T._rich_state()),
        PoolState(*map(_t, pool)), _t(rnd), _t(gum), mesh=MESH[2]))
    assert got == want and "divide" in got
    c = T._complete_case(3, 2, 0)
    assert _error(lambda: ops.complete_sharded(
        PoolState(*map(_t, c[0])), *map(_t, c[1:]), mesh=MESH[2], eos=1,
        max_len=8)) == want
    assert "at least one shard" in _error(lambda: make_shard_mesh(0))
    assert MESH[4].shape == {"shard": 4} and MESH[4].device == CPU


def test_shard_mesh_over_several_devices_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert "ROADMAP.md" in _error(
        lambda: make_shard_mesh(2, device=["cuda:0", "cuda:1"]))
    assert make_shard_mesh(2, device=["cuda:1", "cuda:1"]).device \
        == torch.device("cuda", 1)


def test_shard_mesh_collectives():
    mesh = MESH[4]
    xs = [torch.arange(4, dtype=torch.int32) * 10 + m for m in range(4)]
    assert mesh.all_gather(xs).tolist() == [x.tolist() for x in xs]
    total = mesh.psum(xs)
    assert total.dtype == torch.int32 and total.tolist() == [6, 46, 86, 126]
    out = mesh.all_to_all(xs)          # out[j][m] = xs[m][j]
    assert out.tolist() == [[10 * j + m for m in range(4)] for j in range(4)]
    big = [torch.tensor([2**31 - 1], dtype=torch.int32)] * 2
    assert mesh.psum(big).tolist() == [-2]        # int32 wraps


# --------------------------------------------------------------------------- #
# ServeLoop over a sharded engine
# --------------------------------------------------------------------------- #

I, C, R, MAX_LEN = 4, 4, 8, 6


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
        return _t(rnd), _t(gum)


def _drain_routing():
    """One service per policy (one affinity cluster), each to a
    3-endpoint cluster spread over the lanes; random loads."""
    services = [JR.ServiceConfig(f"s{i}", [JR.Rule(0, None, f"c{i}")])
                for i in range(6)]
    clusters = [JR.Cluster(f"c{i}", [(i + k) % I for k in range(3)],
                           policy=i, weights=[1.0, 3.0, 0.5])
                for i in range(6)]
    st, _ = JR.build_state(services, clusters)
    arrs = {f: np.array(getattr(st, f)) for f in st._fields}
    arrs["ep_load"][:] = np.random.RandomState(1).randint(0, 3, 512)
    return (JR.RoutingState(*[jnp.asarray(arrs[f]) for f in st._fields]),
            convert.routing_from_numpy(arrs, CPU))


def _drain(loop, mod):
    """Submit the drain's traffic, drain, and summarise what is left."""
    rng = np.random.RandomState(3)
    for i in range(48):
        hdr = {"path": f"/p/{rng.randint(6)}", "user": f"u{rng.randint(9)}"}
        loop.submit(mod.Request(req_id=i, service=int(rng.randint(6)),
                                headers=hdr,
                                prompt_token=int(rng.randint(3, 500))))
    rep = loop.drain(max_ticks=400)
    a = lambda x: np.asarray(x).tolist()                    # noqa: E731
    return {"report": ([(r.req_id, r.tokens, r.retries, r.submit_tick,
                         r.admit_tick, r.done_tick) for r in rep.done],
                       [r.req_id for r in rep.dropped], rep.queued,
                       rep.inflight, rep.held_first),
            "ticks": loop.ticks,
            "routing": {f: a(getattr(loop.routing, f))
                        for f in loop.routing._fields},
            "metrics": {f: a(getattr(loop.state.metrics, f))
                        for f in loop.state.metrics._fields},
            "pool": {f: a(getattr(loop.state.pool, f))
                     for f in loop.state.pool._fields}}


@pytest.fixture(scope="module")
def reference_drain(weights):
    jroute, _ = _drain_routing()
    loop = JS.ServeLoop(JI.Engine(JCFG, I, C, MAX_LEN, eos=-1), weights[0],
                        jroute, admit_batch=R, dtype=jnp.float32)
    return _drain(loop, JS)


def _port_drain(weights, shards):
    kw = {} if shards == 1 else dict(shards=shards,
                                     shard_mesh=MESH[shards])
    eng = TI.Engine(TCFG, I, C, MAX_LEN, eos=-1, device="cpu", **kw)
    eng.draws = ReplayDraws()
    loop = TS.ServeLoop(eng, weights[1], _drain_routing()[1], admit_batch=R,
                        dtype=torch.float32)
    return _drain(loop, TS)


@pytest.mark.parametrize("shards", [2, 4])
def test_serve_loop_sharded_matches_unsharded_and_reference(
        weights, reference_drain, shards):
    got = _port_drain(weights, shards)
    assert got == _port_drain(weights, 1)
    assert got == reference_drain
    done, dropped, queued, inflight, held_first = got["report"]
    assert len(done) == 48 and not (dropped or queued or inflight)
    assert held_first > 0                          # the pool filled up
    assert got["metrics"]["overflow"] > 0


# --------------------------------------------------------------------------- #
# a sharded loop under the control plane and the plan transport
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def port_params():
    return TM.init_params(TCFG, torch.Generator().manual_seed(0),
                          torch.float32, "cpu")


def _sharded_engine():
    return make_balancer("xlb", TCFG, 2, 2, 8, device="cpu", shards=2,
                         shard_mesh=MESH[2])


def test_mid_serve_transaction_reaches_a_sharded_loop(port_params):
    """One transaction mid-serve: one version bump on the loop and on a
    second consumer applying the shipped plan; no admission after the
    drain lands on the drained endpoint, on either shard's slice."""
    cp = TCtl.ControlPlane(
        [TCtl.ServiceConfig("svc", rules=[TCtl.Rule(0, None, "pool")])],
        [TCtl.Cluster("pool", endpoints=[0, 1], policy=JR.POLICY_RR)])
    loop = TS.ServeLoop(_sharded_engine(), port_params, cp, admit_batch=4)

    class RemoteIngress:
        def __init__(self, cp):
            self.routing = cp.snapshot()

        def apply_refresh(self, plan):
            plan = TCtl.unpack_plan(TCtl.pack_plan(plan))
            self.routing = TCtl.apply_plan(self.routing, plan)

    remote = RemoteIngress(cp)
    cp.attach(remote)
    for i in range(4):
        loop.submit(TS.Request(req_id=i, service=0, headers={},
                               prompt_token=3 + i))
    loop.tick()
    v0 = int(loop.routing.version)
    with cp.transaction():
        cp.drain_endpoint("pool", 1)
        cp.set_weight("pool", 0, 2.0)
    slot = cp.endpoint_slot("pool", 1)
    for r in (loop.routing, remote.routing):
        assert int(r.version) == v0 + 1
        assert int(r.ep_drained[slot]) == 1
    for i in range(4, 10):
        loop.submit(TS.Request(req_id=i, service=0, headers={},
                               prompt_token=3 + i))
    saw_new = False
    for _ in range(30):
        loop.tick()
        p = loop.state.pool
        assert not bool(((p.endpoint == slot) & (p.req_id >= 4)
                         & p.active).any())
        saw_new = saw_new or bool(((p.req_id >= 4) & p.active).any())
    assert saw_new                         # traffic kept flowing


def test_transport_crash_and_rejoin_on_a_sharded_loop(port_params):
    """A sharded loop attached through the lossy plan transport holds load
    on an endpoint the operator drains, then crashes: the lease expiry
    unpins the drain, and the restarted incarnation lands exactly one
    resync and serves again."""
    cp = TCtl.ControlPlane(
        [TCtl.ServiceConfig("svc", rules=[TCtl.Rule(0, None, "pool")])],
        [TCtl.Cluster("pool", endpoints=[0, 1], policy=JR.POLICY_RR)],
        lease_epochs=2)
    hub = TT.Transport(cp, TT.LossyChannel(seed=5))
    rc = hub.consumer("ingress-0")
    eng = _sharded_engine()
    loop = TS.ServeLoop(eng, port_params, rc, admit_batch=4,
                        fault=TS.FaultInjector([TS.Fault(instance=1,
                                                         kind="stall")]))
    t = [0]

    def pump(n, lp=None):
        for _ in range(n):
            hub.pump(t[0])
            if lp is not None:
                lp.tick()
            t[0] += 1

    for i in range(6):
        loop.submit(TS.Request(req_id=200 + i, service=0, headers={},
                               prompt_token=3 + i))
    pump(4, loop)
    cp.drain_endpoint("pool", 1)
    pump(3, loop)
    slot1 = cp.endpoint_slot("pool", 1)
    assert rc.version == cp.version == 1
    assert int(loop.routing.ep_drained[slot1]) == 1
    proxy = hub.publisher.nodes["ingress-0"].proxy
    assert int(proxy.routing.ep_load[slot1]) > 0   # reported load pins it
    cp.reap()
    assert len(cp.cluster_members("pool")) == 2 and cp.version == 1
    rc.crash()
    for _ in range(4):
        cp.advance_epoch()
        pump(1)
    assert not cp.lease_live(proxy)
    cp.reap()
    assert len(cp.cluster_members("pool")) == 1 and cp.version == 2
    cp.set_weight("pool", 0, 2.0)
    assert cp.version == 3
    pump(4)
    assert hub.publisher.nodes["ingress-0"].acked == 1
    rc.restart()
    loop2 = TS.ServeLoop(eng, port_params, rc, admit_batch=4)
    pump(12, loop2)
    assert rc.resyncs == 1 and rc.version == cp.version == 3
    TT.assert_converged(cp, [rc])
    for i in range(4):
        loop2.submit(TS.Request(req_id=300 + i, service=0, headers={},
                                prompt_token=3))
    pump(20, loop2)
    assert len(loop2.done) == 4


# --------------------------------------------------------------------------- #
# the launcher
# --------------------------------------------------------------------------- #


def test_serve_launcher_shards_on_cpu(capsys):
    assert serve.main(["--shards", "2", "--device", "cpu", "--requests",
                       "12", "--max-len", "6"]) == 12
    assert "2 shards" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="--engine xlb"):
        serve.main(["--shards", "2", "--engine", "istio", "--device", "cpu"])
    with pytest.raises(SystemExit, match="must divide"):
        serve.main(["--shards", "3", "--instances", "4", "--device", "cpu"])

"""The serving tick as a captured program (``runtime/graphs.py``), on the
CPU, where the same bodies run without a graph.

* No host sync in the bodies a capture records.  Every body that
  ``Graphs.run`` runs (the XLB engine's arrival tick and decode-only tick,
  the sidecars' decode, the tick of each arch ``serve --arch`` takes) runs
  under a ``TorchDispatchMode`` that raises on the operations that break a
  CUDA graph capture: a read of a device value on the host
  (``_local_scalar_dense``: ``.item()``, ``bool(t)``, ``int(t)``), an op
  whose output shape depends on the data (``nonzero``, ``masked_select``,
  boolean indexing, ``unique``, ...), and ``.cpu()`` / ``.numpy()`` /
  ``.tolist()``, a read of the RNG state and a tensor made from host
  data.  The ticks include one after a control-plane splice and one
  after a fault's rollback.
* The static-state plumbing against the reference: the nine-tick
  sequence of ``test_torch_engine.py`` with the reference's draws fed in,
  a transaction spliced in at tick 3 and a stalled lane rolled back at
  ticks 5-6, every field bit-exact against ``repro.core.interpose.Engine``
  on every tick; a state the tick produced passes through with no copy, a
  foreign one is copied in field by field, one of another shape raises.
* The sharded tick on a one-process ``ShardMesh`` (M = 2, 4): its
  decode-only body and its arrival bodies, one a set of live shards
  (an idle shard among them), under the same dispatch mode; the same
  splice-and-rollback sequence tick for tick against the reference's
  jitted engine on the one device this process has (the sharded datapath
  is bit-exact against it, as ``test_torch_shard.py`` holds it), every
  arrival through the sharded admission.
* The sanitized tick (``XLB_SANITIZE=1``), unsharded and at M 2 / 4:
  its bodies under the same dispatch mode (the guards' verdicts stay on
  the device, one read after each unsharded call, none sharded), and the
  same nine ticks against the reference's ``jit(checkify(serve_step))``.
* ``ops.capture_launches`` / ``count_replay`` and which tick
  ``make_jitted`` returns (captured, sanitizing under the sanitizer,
  eager on a rank shard mesh).

Tolerance: bit-exact (integers and f32), as in ``test_torch_engine.py``.
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs.xlb_microbench import XLB_SERVICE_MODEL as JCFG
from repro.core import control as JC
from repro.core import interpose as JI
from repro.core import routing_table as JR
from repro.core.balancer import RequestBatch as JBatch
from repro.runtime import serve_loop as JS
from repro_torch.configs import XLB_SERVICE_MODEL as TCFG
from repro_torch.core import control as TC
from repro_torch.core import interpose as TI
from repro_torch.core import routing_table as TR
from repro_torch.core.balancer import RequestBatch, make_balancer
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.launch.mesh import RankShardMesh, make_shard_mesh
from repro_torch.models import model as TM
from repro_torch.runtime import graphs
from repro_torch.runtime import serve_loop as TS
from test_torch_engine import ReplayDraws, _assert_state_equal, _ticks
from test_torch_engine import weights  # noqa: F401  (the fixture)

I, C, R, MAX_LEN = 4, 4, 8, 6
aten = torch.ops.aten

# ops a capture cannot record: a device value read on the host, or an
# output whose shape depends on the data
_SYNCS = {aten._local_scalar_dense, aten.nonzero, aten.masked_select,
          aten._unique, aten._unique2, aten.unique_dim,
          aten.unique_consecutive, aten.argwhere, aten.bincount,
          aten.equal, aten.is_nonzero, aten.item, aten.histc,
          aten.repeat_interleave, aten._assert_scalar}
_INDEXING = {aten.index, aten.index_put, aten.index_put_,
             aten._index_put_impl_}


class HostSync(AssertionError):
    pass


# the plain versions the kernel wrappers run on the CPU: on the card each is
# one kernel launch, so what they do inside is not checked
_KERNELS = ((ops._rm, "admit_commit"), (ops._rm, "admit"),
            (ops._rm, "route_match"), (ops._cp, "complete"),
            (ops._da, "decode_attention"), (ops._rd, "relay_slots"))
_inside_kernel = [0]
# memoised per shape and device: filled by the eager warm-up that runs
# before every capture, so a capture finds it filled
_WARMED = ((TM, "_sinusoid_on"),)


class _NoSync(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        packet = func.overloadpacket
        if _inside_kernel[0]:
            pass
        elif packet in _SYNCS:
            raise HostSync(f"{func} syncs with the host or takes its shape "
                           "from the data")
        elif packet in _INDEXING and any(
                i is not None and i.dtype in (torch.bool, torch.uint8)
                for i in args[1]):
            raise HostSync(f"{func} with a boolean index takes its shape "
                           "from the data")
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def no_host_sync():
    """Raise on the host syncs a CUDA graph capture refuses, on a read of
    the RNG state (``torch.utils.checkpoint`` saves it unless told not
    to; the CUDA generator's cannot be read during a capture) and on a
    tensor made from host data (``torch.tensor``, ``torch.from_numpy``:
    on the card its copy to the device is from pageable memory, which a
    capture refuses)."""
    saved = {n: getattr(torch.Tensor, n) for n in ("cpu", "numpy", "tolist")}
    made = {n: getattr(torch, n) for n in ("get_rng_state", "from_numpy",
                                           "tensor")}

    def refuse(name):
        def call(*a, **k):
            if _inside_kernel[0]:
                return saved[name](*a, **k)
            raise HostSync(f"Tensor.{name}() inside a captured body")
        return call

    def refuse_host(name):
        def call(*a, **k):
            if _inside_kernel[0]:
                return made[name](*a, **k)
            raise HostSync(f"torch.{name}() inside a captured body")
        return call

    for n in saved:
        setattr(torch.Tensor, n, refuse(n))
    for n in made:
        setattr(torch, n, refuse_host(n))
    try:
        with _NoSync():
            yield
    finally:
        for n, f in saved.items():
            setattr(torch.Tensor, n, f)
        for n, f in made.items():
            setattr(torch, n, f)


@pytest.fixture
def checked_bodies(monkeypatch):
    """Every body ``Graphs.run`` runs, under ``no_host_sync`` (the kernels'
    plain versions taken as the launches they are on the card, and the
    caches the warm-up fills as filled); yields the keys it ran."""
    keys = []

    def kernel(fn):
        def call(*a, **k):
            _inside_kernel[0] += 1
            try:
                return fn(*a, **k)
            finally:
                _inside_kernel[0] -= 1
        return call

    for mod, name in _KERNELS + _WARMED:
        monkeypatch.setattr(mod, name, kernel(getattr(mod, name)))

    def run(self, key, body, keep=()):
        assert not self.cuda
        keys.append(key)
        with no_host_sync():
            body()

    monkeypatch.setattr(graphs.Graphs, "run", run)
    return keys


def test_no_host_sync_catches_what_a_capture_refuses():
    x = torch.arange(4)
    for bad in (lambda: x.sum().item(), lambda: bool(x.any()),
                lambda: x[x > 1], lambda: torch.nonzero(x), lambda: x.cpu(),
                lambda: x.unique(), lambda: x.tolist(),
                lambda: torch.tensor([1.0]), lambda: torch.get_rng_state(),
                lambda: torch.from_numpy(np.zeros(2))):
        with pytest.raises(HostSync), no_host_sync():
            bad()
    idx = torch.tensor([1, 2])
    with no_host_sync():
        x[idx] = 0
        torch.where(x > 1, x, -x).argmax()


# --------------------------------------------------------------------------- #
# the XLB engine's tick: a splice and a rollback on the way
# --------------------------------------------------------------------------- #


def _control_planes():
    """One service per policy, each to its own 3-endpoint cluster, on a
    reference and a port ControlPlane."""
    def build(mod, RT):
        services = [RT.ServiceConfig(f"s{i}", [RT.Rule(0, None, f"c{i}")])
                    for i in range(6)]
        clusters = [RT.Cluster(f"c{i}", [(i + k) % I for k in range(3)],
                               policy=i, weights=[1.0, 3.0, 0.5])
                    for i in range(6)]
        return mod.ControlPlane(services, clusters)
    return build(JC, JR), build(TC, TR)


def _commit(cp):
    """Drain, remove (swap-with-last) and add an endpoint, one commit."""
    with cp.transaction():
        cp.drain_endpoint("c1", 2)
        cp.remove_endpoint("c4", 4 % I)
        cp.add_endpoint("c3", instance=1)
    return cp.last_plan


SPLICE_AT, STALL = 3, (5, 7)      # the tick before which each happens


def _drive(tp, on_tick, jp=None, shards=1):
    """The port's engine (``shards``-way on a one-process mesh) through
    ``make_jitted`` over nine ticks of ``_ticks``; with ``jp`` the
    reference's unsharded engine beside it.  ``on_tick(t, tstate, tout,
    jstate, jout, tick)`` after each."""
    jcp, tcp = _control_planes()
    kw = {} if shards == 1 else dict(
        shards=shards, shard_mesh=make_shard_mesh(shards, device="cpu"))
    teng = TI.Engine(TCFG, I, C, MAX_LEN, eos=-1, device="cpu", **kw)
    teng.draws = ReplayDraws()
    tick = teng.make_jitted()
    ts = teng.init_state(tcp.snapshot(), dtype=torch.float32)
    tfault = TS.FaultInjector([TS.Fault(1, "stall", start=STALL[0],
                                        end=STALL[1])])
    if jp is not None:
        jeng = JI.Engine(JCFG, I, C, MAX_LEN, eos=-1)
        jstep = jeng.make_jitted(donate=False)
        js = jeng.init_state(jcp.snapshot(), dtype=jnp.float32)
        jfault = JS.FaultInjector([JS.Fault(1, "stall", start=STALL[0],
                                            end=STALL[1])])
    jout = None
    for t, batch in enumerate(_ticks(9, 6)):
        if t == SPLICE_AT:
            ts = teng.apply_refresh(ts, _commit(tcp))
            if jp is not None:
                js = jeng.apply_refresh(js, _commit(jcp))
        ts = ts._replace(pool=tfault.apply(ts.pool, t))
        if jp is not None:
            js = js._replace(pool=jfault.apply(js.pool, t))
            js, jout = jstep(jp, js, JBatch(*map(jnp.asarray, batch)))
        ts, tout = tick(tp, ts, RequestBatch(*map(torch.from_numpy, batch)))
        on_tick(t, ts, tout, js if jp is not None else None, jout, tick)
    return tick


def test_engine_tick_bodies_issue_no_host_sync(weights, checked_bodies):
    _, tp = weights
    _drive(tp, lambda *a: None)
    kinds = {r for r, *_ in checked_bodies}
    assert R in kinds and None in kinds       # arrival and decode-only
    assert len(checked_bodies) == 9


def _follow_reference(jp, tp, shards=1):
    """``_drive`` with the reference beside it: every field of the state
    and every output bit-exact on every tick; the per-tick summaries."""
    seen = {}

    def on_tick(t, ts, tout, js, jout, tick):
        _assert_state_equal(ts, js, t)
        for name in ("emitted", "done", "req_id", "active"):
            np.testing.assert_array_equal(
                tout[name].numpy(), np.asarray(jout[name]),
                err_msg=f"tick {t}: out {name}")
        n = I * C
        np.testing.assert_array_equal(
            tout["packed"].numpy(), np.concatenate(
                [np.asarray(jout[k], np.int32).reshape(-1)
                 for k in ("emitted", "done", "req_id")]
                + [[int(jout["active"])]]).astype(np.int32),
            err_msg=f"tick {t}: packed")
        assert tout["packed"].shape == (3 * n + 1,)
        seen[t] = (int(ts.routing.version), int(tout["active"]),
                   int(ts.pool.length.sum()))

    tick = _drive(tp, on_tick, jp, shards)
    assert seen[SPLICE_AT][0] == 1 and seen[0][0] == 0
    assert max(a for _, a, _ in seen.values()) > 0
    return seen, tick


def test_static_state_matches_reference_through_splice_and_rollback(
        weights):
    jp, tp = weights
    _follow_reference(jp, tp)


def test_produced_state_passes_through_and_foreign_state_is_copied_in(
        weights):
    _, tp = weights
    record = []

    def on_tick(t, ts, tout, js, jout, tick):
        record.append((t, ts, tick.copied_in, tout))

    tick = _drive(tp, on_tick)
    states = {id(ts) for _, ts, _, _ in record}
    assert len(states) == 1                   # one static EngineState
    outs = {id(out["packed"]) for *_, out in record}
    assert len(outs) == 1                     # one static packed output
    copied = {t: n for t, _, n, _ in record}
    # the first state is cloned, not counted; a produced state is free
    assert copied[0] == copied[1] == copied[2] == 0
    spliced = copied[SPLICE_AT] - copied[SPLICE_AT - 1]
    assert spliced > 1                        # tables and pool.endpoint
    assert copied[SPLICE_AT + 1] == copied[SPLICE_AT]
    # each tick the lane is stalled, its rollback replaces pool.length
    for t in range(STALL[0], STALL[1]):
        assert copied[t] - copied[t - 1] == 1, t
    assert copied[STALL[1]] == copied[STALL[1] - 1]
    st = tick.state
    with pytest.raises(ValueError, match="fixed shapes"):
        tick(tp, st._replace(pool=st.pool._replace(
            length=torch.zeros((I + 1, C), dtype=torch.int32))),
            RequestBatch(*map(torch.from_numpy, _ticks(1, 6)[0])))


# --------------------------------------------------------------------------- #
# the sharded tick on a one-process mesh
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("M", [2, 4])
def test_sharded_tick_bodies_issue_no_host_sync(weights, checked_bodies, M):
    """The decode-only body and an arrival body a set of live shards, the
    splice and the rollback on the way, then a batch whose shard 1 is all
    padding (an idle ingress host between live ones)."""
    _, tp = weights
    tick = _drive(tp, lambda *a: None, shards=M)
    _, *rest = _ticks(1, 6, seed=4)[0]
    rid = np.arange(R, dtype=np.int32)
    rid[R // M:2 * R // M] = -1
    tick(tp, tick.state, RequestBatch(*map(torch.from_numpy, (rid, *rest))))
    assert len(checked_bodies) == 10
    arrivals = {live for r, live, _ in checked_bodies if r is not None}
    assert (None, None) in {(r, live) for r, live, _ in checked_bodies}
    assert all(len(live) == M for live in arrivals) and len(arrivals) >= 2
    idle = (True, False) + (True,) * (M - 2)
    assert idle in arrivals


@pytest.mark.parametrize("M", [2, 4])
def test_sharded_static_tick_matches_reference_through_splice_and_rollback(
        weights, monkeypatch, M):
    """The sharded captured tick through the same nine ticks, a splice and
    a rollback: tick for tick equal to the reference, each arrival tick
    through ``ops.admit_commit_sharded`` with the live set the host read."""
    jp, tp = weights
    calls = []
    sharded = ops.admit_commit_sharded

    def counted(*a, **k):
        calls.append(k["live"])
        return sharded(*a, **k)

    monkeypatch.setattr(ops, "admit_commit_sharded", counted)
    _follow_reference(jp, tp, shards=M)
    n_arrivals = sum((b[0] >= 0).any() for b in _ticks(9, 6))
    assert len(calls) == n_arrivals
    assert all(live is not None and len(live) == M for live in calls)


# --------------------------------------------------------------------------- #
# the sanitized tick (XLB_SANITIZE=1): the reference's checkified program
# --------------------------------------------------------------------------- #

N_ARRIVALS = sum(bool((b[0] >= 0).any()) for b in _ticks(9, 6))
# the laws each guard checks: admit's four, complete's three
ADMIT_LAWS, COMPLETE_LAWS = 4, 3


@pytest.mark.parametrize("M", [1, 2, 4])
def test_sanitized_tick_bodies_issue_no_host_sync(weights, checked_bodies,
                                                  monkeypatch, M):
    """The sanitized tick's decode-only and arrival bodies (unsharded and
    one a live set at M 2 / 4), a splice and a rollback on the way: the
    guards' verdicts stay on the device; the tick reads them once after
    each call, and a sharded body, which calls no guard, reads nothing."""
    _, tp = weights
    monkeypatch.setenv("XLB_SANITIZE", "1")
    tick = _drive(tp, lambda *a: None, shards=M)
    assert tick.sanitize and len(checked_bodies) == 9
    kinds = {r for r, *_ in checked_bodies}
    assert R in kinds and None in kinds
    if M == 1:
        assert tick.verdict_reads == 9
        assert tick.laws_checked == 9 * COMPLETE_LAWS \
            + N_ARRIVALS * ADMIT_LAWS
    else:
        assert tick.verdict_reads == tick.laws_checked == 0


@pytest.mark.parametrize("M", [1, 2, 4])
def test_sanitized_static_tick_matches_reference_through_splice_and_rollback(
        weights, monkeypatch, M):
    """Under XLB_SANITIZE=1 both ``make_jitted``s sanitize: the port's
    captured tick (``M``-way on a one-process mesh) tick for tick equal
    to the reference's ``jit(checkify(serve_step))`` through the same
    nine ticks, a splice and a rollback, no law firing on either."""
    jp, tp = weights
    monkeypatch.setenv("XLB_SANITIZE", "1")
    _, tick = _follow_reference(jp, tp, shards=M)
    assert tick.sanitize
    assert tick.verdict_reads == (9 if M == 1 else 0)


# --------------------------------------------------------------------------- #
# the sidecars' decode and the other archs' ticks
# --------------------------------------------------------------------------- #


def _routing(n_lanes):
    st, _ = TR.build_state(
        [TR.ServiceConfig("svc", [TR.Rule(0, None, "pool")])],
        [TR.Cluster("pool", list(range(n_lanes)),
                    policy=TR.POLICY_LEAST_REQUEST)], "cpu")
    return st


def _serve_ticks(eng, params, vocab, n_ticks=4):
    """A few ticks through ``make_jitted``: arrivals on the first two."""
    tick = eng.make_jitted()
    st = eng.init_state(_routing(eng.n_instances), dtype=torch.float32)
    outs = []
    for t in range(n_ticks):
        rid = np.full(R, -1, np.int32)
        if t < 2:
            rid[:3] = np.arange(3 * t, 3 * t + 3)
        z = np.zeros(R, np.int32)
        feats = np.zeros((R, TR.N_FEATURES), np.int32)
        tok = (3 + np.arange(R) % (vocab - 3)).astype(np.int32)
        st, out = tick(params, st, RequestBatch(*map(
            torch.from_numpy, (rid, z, feats, tok, z + 100))))
        outs.append(out)
    return st, outs


@pytest.mark.parametrize("kind", ["istio", "cilium"])
def test_sidecar_decode_bodies_issue_no_host_sync(weights, checked_bodies,
                                                  kind):
    _, tp = weights
    eng = make_balancer(kind, TCFG, I, C, MAX_LEN, eos=-1, device="cpu")
    _, outs = _serve_ticks(eng, tp, TCFG.vocab)
    per_tick = I if kind == "istio" else 1
    assert len(checked_bodies) == 4 * per_tick
    assert len({k for k, _ in checked_bodies}) == per_tick   # one a cache
    for out in outs:
        np.testing.assert_array_equal(out["packed"], np.concatenate(
            [np.asarray(out[k], np.int32).reshape(-1)
             for k in ("emitted", "done", "req_id", "active")]))


SERVE_ARCHS = [a for a in serve.ASSIGNED_ARCHS if a not in serve.ENCDEC_ARCHS]


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_arch_tick_bodies_issue_no_host_sync(checked_bodies, arch):
    """``serve --arch`` captures each arch's tick on the card: its decode
    must not sync either (reduced configs, two lanes of two slots)."""
    cfg = serve.arch_config(arch, smoke=True)
    params = TM.init_params(cfg, torch.Generator().manual_seed(0),
                            torch.float32, "cpu")
    eng = TI.Engine(cfg, 2, 2, 6, device="cpu")
    _, outs = _serve_ticks(eng, params, cfg.vocab, n_ticks=3)
    assert [k for k, *_ in checked_bodies] == [R, R, None]
    assert int(outs[-1]["active"]) > 0


# --------------------------------------------------------------------------- #
# launch accounting and which tick make_jitted returns
# --------------------------------------------------------------------------- #


def test_capture_launches_moves_a_capture_counts_to_its_replays():
    before = dict(ops.LAUNCHES)
    with ops.capture_launches() as delta:
        ops.LAUNCHES["complete"] += 1
        ops.LAUNCHES["decode_attention"] += 2
    assert ops.LAUNCHES == before
    assert delta == {"complete": 1, "decode_attention": 2}
    ops.count_replay(delta)
    ops.count_replay(delta)
    assert ops.LAUNCHES["complete"] == before["complete"] + 2
    assert ops.LAUNCHES["decode_attention"] == \
        before["decode_attention"] + 4
    ops.LAUNCHES.update(before)


def test_make_jitted_is_captured_unless_on_a_rank_mesh(monkeypatch):
    eng = TI.Engine(TCFG, I, C, MAX_LEN, device="cpu")
    sharded = TI.Engine(TCFG, I, C, MAX_LEN, device="cpu", shards=2,
                        shard_mesh=make_shard_mesh(2, device="cpu"))
    ranked = TI.Engine(TCFG, I, C, MAX_LEN, device="cpu", shards=2,
                       shard_mesh=RankShardMesh({"shard": 2},
                                                torch.device("cpu"), 0))
    for e in (eng, sharded):
        tick = e.make_jitted()
        assert isinstance(tick, graphs.StaticTick) and not tick.sanitize
    assert ranked.make_jitted() == ranked.eager_step
    with pytest.raises(ValueError, match="rank shard mesh"):
        graphs.StaticTick(ranked)
    monkeypatch.setenv("XLB_SANITIZE", "1")
    for e in (eng, sharded):
        tick = e.make_jitted()
        assert isinstance(tick, graphs.StaticTick) and tick.sanitize
    assert ranked.make_jitted() == ranked.eager_step

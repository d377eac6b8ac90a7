"""The hand-written CUDA kernels against their plain PyTorch versions on the
card: admission, completion, the route match and the relay slot
assignment bit-exact on every integer output and both f32 EWMAs; decode
attention, flash attention and the SSD scan within the tolerances of
``tests/test_kernels.py`` (f32 2e-5, the SSD's f32 recurrence 2e-4; bf16
rtol 2e-2 with atol 2e-2 times the output's RMS); the nine-product f32
product within twice ``torch.matmul``'s f32 error against float64.  Needs a CUDA device and nvcc: ``PYTHONPATH=src python -m pytest
-q -m gpu tests/test_torch_cuda.py``; skipped without a card."""

import numpy as np
import pytest
import torch

from repro_torch.core import routing_table as RT
from repro_torch.core.balancer import PoolState, RequestBatch
from repro_torch.kernels import (_build, completion, decode_attention,
                                 dense_x9, flash_attention, ops,
                                 relay_dispatch, route_match, ssd_scan)

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _routing(dev, seed):
    services = [RT.ServiceConfig(f"s{p}", [RT.Rule(0, "v2", f"c{p}"),
                                           RT.Rule(1, None, f"d{p}")])
                for p in range(6)]
    clusters = []
    for p in range(6):
        clusters += [RT.Cluster(f"c{p}", [(3 * p + k) % 16 for k in range(5)],
                                policy=p, weights=[1.0, 4.0, 0.5, 2.0, 1.0]),
                     RT.Cluster(f"d{p}", [(5 * p + k) % 16 for k in range(3)],
                                policy=(p + 1) % 5)]
    st, _ = RT.build_state(services, clusters, "cpu")
    rng = np.random.RandomState(seed)
    load = torch.from_numpy(rng.randint(0, 6, 512).astype(np.int32))
    drained = st.ep_drained.clone()
    drained[[1, 11, 21]] = 1
    return st._replace(ep_load=load, ep_drained=drained).to(dev)


def _batch(R, seed, dev):
    rng = np.random.RandomState(seed)
    svc = rng.randint(0, 7, R).astype(np.int32)
    feats = rng.randint(0, 30, (R, 8)).astype(np.int32)
    feats[:, 0] = np.where(rng.rand(R) < 0.6, RT.fnv1a("v2"), 5)
    rid = np.where(rng.rand(R) < 0.9, np.arange(R), -1).astype(np.int32)
    cols = [rid, svc, feats, rng.randint(0, 97, R).astype(np.int32),
            rng.randint(1, 500, R).astype(np.int32)]
    t = lambda a: torch.from_numpy(a).to(dev)
    rnd = rng.randint(0, 1 << 30, R).astype(np.int32)
    gum = rng.gumbel(size=(R, 64)).astype(np.float32)
    return RequestBatch(*map(t, cols)), t(rnd), t(gum)


def _pool(I, C, seed, dev, busy=0.5):
    g = torch.Generator().manual_seed(seed)
    act = (torch.rand((I, C), generator=g) < busy).to(dev)
    return PoolState(*[torch.randint(-1, 50, (I, C), generator=g,
                                     dtype=torch.int32).to(dev)
                       for _ in range(5)], act), g


def _check_admit(reqs, routing, pool, rnd, gum, free, block_r=256):
    """Both kernels through ops against their plain versions at the same
    ``block_r``, bit-exact on every output; returns the plain commit
    result."""
    n0 = ops.LAUNCHES["admit_commit"]
    k = ops.admit_commit(reqs, routing, pool, rnd, gum, block_r=block_r)
    assert ops.LAUNCHES["admit_commit"] == n0 + 1
    p = route_match.admit_commit(reqs.req_id, reqs.svc, reqs.features,
                                 reqs.msg_bytes, reqs.token, routing,
                                 *pool[:5], pool.active, rnd, gum,
                                 block_r=block_r)
    for f in route_match.AdmitResult._fields:
        assert torch.equal(getattr(k, f), getattr(p, f)), f
    for f, pf in zip(PoolState._fields, route_match.AdmitCommitResult
                     ._fields[13:]):
        assert torch.equal(getattr(k.pool, f), getattr(p, pf)), f
    n0 = ops.LAUNCHES["admit"]
    k2 = ops.admit(reqs, routing, free, rnd, gum, block_r=block_r)
    assert ops.LAUNCHES["admit"] == n0 + 1
    p2 = route_match.admit(reqs.req_id, reqs.svc, reqs.features,
                           reqs.msg_bytes, routing, free, rnd, gum,
                           block_r=block_r)
    for f in route_match.AdmitResult._fields:
        assert torch.equal(getattr(k2, f), getattr(p2, f)), f
    torch.cuda.synchronize()
    return p


# 4096 rows: 16 tiles of 256 (64 of 64, 4 of 1024) carrying the counters
# from one to the next; every tile the kernel is built for
@pytest.mark.parametrize("block_r", [64, 256, 1024])
@pytest.mark.parametrize("R,I,C", [(256, 64, 16), (300, 16, 4), (7, 2, 2),
                                   (4096, 64, 16)])
def test_admit_kernels_match_plain(dev, R, I, C, block_r):
    routing = _routing(dev, R)
    reqs, rnd, gum = _batch(R, R + 1, dev)
    pool, g = _pool(I, C, R, dev)
    free = (torch.rand((I, C), generator=g) < 0.6).int().to(dev) * 3
    _check_admit(reqs, routing, pool, rnd, gum, free, block_r)


def _rows_to(reqs, svc, rows, dev):
    """``reqs`` with ``rows`` sent to service ``svc``'s first rule (the
    "v2" header, cluster c<svc>)."""
    s, f = reqs.svc.clone(), reqs.features.clone()
    s[rows] = svc
    f[rows, 0] = RT.fnv1a("v2")
    return reqs._replace(svc=s.to(dev), features=f.to(dev))


@pytest.mark.parametrize("block_r", [64, 256, 1024])
@pytest.mark.parametrize("case", ["least_request_all_rows", "full_pool",
                                  "rogue_svc", "stale_maglev",
                                  "affinity_same_flow", "nan_gumbel"])
def test_admit_kernels_match_plain_at_the_edges(dev, case, block_r):
    """The policies' corner cases, each bit-exact in both modes at every
    tile: a tile whose rows all go to one least-request cluster (in-tile
    ranks up to block_r - 1 on the water-fill; at 1024 rows the batch of
    512 is one tile), a full pool (every routable row held),
    svc < 0 and svc >= S, Maglev entries past the window, on a drained
    lane or empty, two rows of one flow in an affinity cluster (the first
    writer wins; a live flow of another key is not evicted), and NaN in
    the Gumbel rows of weighted rows (NaN wins the argmax)."""
    R, I, C = 512, 64, 16
    routing = _routing(dev, 3)
    reqs, rnd, gum = _batch(R, 4, dev)
    pool, g = _pool(I, C, 5, dev)
    rows = torch.arange(R)
    if case == "least_request_all_rows":      # c2: least request
        reqs = _rows_to(reqs, 2, rows, dev)
        reqs = reqs._replace(req_id=torch.arange(R, dtype=torch.int32,
                                                 device=dev))
        pool, g = _pool(I, C, 5, dev, busy=0.0)
    elif case == "full_pool":
        pool = pool._replace(active=torch.ones_like(pool.active))
    elif case == "rogue_svc":
        svc = reqs.svc.clone()
        svc[::5] = -3
        svc[1::5] = 64                        # S = MAX_SERVICES
        svc[2::5] = 1000
        reqs = reqs._replace(svc=svc)
    elif case == "stale_maglev":              # c4: maglev, c5: affinity
        reqs = _rows_to(reqs, 4, rows[::2], dev)
        reqs = _rows_to(reqs, 5, rows[1::2], dev)
        mg = routing.maglev_table.clone()
        for c in (4 * 2, 5 * 2):              # clusters c4, c5
            mg[c, ::3] = 7                    # past the 5-lane window
            mg[c, 1::3] = 1                   # lane 1 of c4/c5 is drained
            mg[c, 2::5] = -1                  # empty entry
        drained = routing.ep_drained.clone()
        drained[routing.cluster_ep_start[8] + 1] = 1
        drained[routing.cluster_ep_start[10] + 1] = 1
        routing = routing._replace(maglev_table=mg, ep_drained=drained)
    elif case == "affinity_same_flow":
        reqs = _rows_to(reqs, 5, rows, dev)
        f = reqs.features.clone()
        f[1::2] = f[0::2]                     # pairs of one flow key
        f[3::8] = f[0::8]                     # and flows spread over tiles
        reqs = reqs._replace(features=f)
        keys = route_match.policy_defs.flow_hash(f.cpu())
        ak, ae = routing.aff_key.clone(), routing.aff_ep.clone()
        A = ak.shape[0]
        start = int(routing.cluster_ep_start[10])
        for i in range(0, 64, 4):             # cached flows: hits
            ak[int(keys[i]) % A] = int(keys[i])
            ae[int(keys[i]) % A] = start + 2
        for i in range(2, 64, 8):             # slots held by another key
            ak[int(keys[i]) % A] = int(keys[i]) + 1
        routing = routing._replace(aff_key=ak.to(dev), aff_ep=ae.to(dev))
    elif case == "nan_gumbel":                # c3: weighted
        reqs = _rows_to(reqs, 3, rows[::2], dev)
        gum = gum.clone()
        gum[::6, 0] = float("nan")
        gum[1::6, 3] = float("nan")
        gum[2::6, :] = float("nan")
        gum[3::6, 1] = float("inf")
    free = (torch.rand((I, C), generator=g) < 0.6).to(dev)
    p = _check_admit(reqs, routing, pool, rnd, gum, free, block_r)
    pol = routing.cluster_policy[p.cluster[p.cluster >= 0].long()]
    if case == "least_request_all_rows":
        assert set(pol.tolist()) == {2} and bool((p.cluster >= 0).all())
    if case == "full_pool":
        assert int(p.ok.sum()) == 0 and int(p.held) > 0


def test_admit_refuses_a_block_r_it_is_not_built_for(dev):
    """The plain versions walk any block_r; the kernel walks 64, 256 or
    1024 rows a tile (or one tile at least the batch).  Another explicit
    block_r raises ValueError naming the tiles, and nothing launches."""
    R, I, C = 256, 64, 16
    routing = _routing(dev, 1)
    reqs, rnd, gum = _batch(R, 2, dev)
    pool, _ = _pool(I, C, 3, dev)
    n0 = dict(ops.LAUNCHES)
    for block_r in (100, 128, 32):
        with pytest.raises(ValueError, match=r"\(64, 256, 1024\)"):
            ops.admit_commit(reqs, routing, pool, rnd, gum, block_r=block_r)
        with pytest.raises(ValueError, match=r"\(64, 256, 1024\)"):
            ops.admit(reqs, routing, pool.active == 0, rnd, gum,
                      block_r=block_r)
    assert dict(ops.LAUNCHES) == n0
    # block_r at least the batch is one tile: the smallest build holding it
    free = pool.active == 0
    a = ops.admit(reqs, routing, free, rnd, gum, block_r=300)
    b = route_match.admit(reqs.req_id, reqs.svc, reqs.features,
                          reqs.msg_bytes, routing, free, rnd, gum,
                          block_r=300)
    for f in route_match.AdmitResult._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_sweep_on_the_card_times_each_tile(dev, monkeypatch):
    """With autotune on, the first plan of a shape times B2 (or B3) at
    every candidate on the card, caches the fastest and logs each
    candidate's time; the pins and XLB_AUTOTUNE=0 time nothing."""
    from repro_torch.kernels import tune
    monkeypatch.setenv(tune.ENV_AUTOTUNE, "1")
    monkeypatch.delenv(tune.ENV_BLOCK_R, raising=False)
    tune.clear_cache()
    n0 = dict(ops.LAUNCHES)
    for commit in (True, False):
        br, _ = tune.plan_admit(4096, (64, 16), commit=commit, device=dev)
        key, best, timings, dropped = tune._log[-1]
        assert key[:2] == ("admit_commit" if commit else "admit", "cuda")
        assert br == best and set(timings) == {64, 256, 1024}
        assert all(0 < t < 1e-2 for t in timings.values()) and not dropped
        assert tune.plan_admit(4096, (64, 16), commit=commit,
                               device=dev)[0] == br
    assert len(tune._log) == 2 and dict(ops.LAUNCHES) == n0
    monkeypatch.setenv(tune.ENV_BLOCK_R, "64")
    assert tune.plan_admit(2048, (64, 16), device=dev)[0] == 64
    monkeypatch.delenv(tune.ENV_BLOCK_R)
    monkeypatch.setenv(tune.ENV_AUTOTUNE, "0")
    assert tune.plan_admit(2048, (64, 16), device=dev)[0] == 256
    assert len(tune._log) == 2
    tune.clear_cache()


def test_sweep_drops_a_tile_past_the_shared_memory_optin(dev, monkeypatch):
    """At I = 64 and a width C where the 256-row build's shared memory fits
    the 227 KB opt-in and the 1024-row build's does not, the sweep drops
    1024 (its launch raises before it is made) and plans among the rest;
    an explicit block_r = 1024 there raises ValueError."""
    from repro_torch.kernels import tune
    monkeypatch.setenv(tune.ENV_AUTOTUNE, "1")
    monkeypatch.delenv(tune.ENV_BLOCK_R, raising=False)
    tune.clear_cache()
    routing = _routing(dev, 1)
    I, F = 64, RT.N_FEATURES
    smem = lambda C, t: route_match.admit_smem_bytes(   # noqa: E731
        routing, I, C, F, False, t, dev)
    C = next(c for c in range(16, 4096, 16)
             if smem(c, 256) <= route_match.SMEM_OPTIN < smem(c, 1024))
    R = 2048
    br, _ = tune.plan_admit(R, (I, C), device=dev)
    key, best, timings, dropped = tune._log[-1]
    assert set(timings) == {64, 256} and br in (64, 256)
    assert list(dropped) == [1024] and "tile 1024" in dropped[1024]
    reqs, rnd, gum = _batch(R, 5, dev)
    free = torch.ones((I, C), dtype=torch.bool, device=dev)
    n0 = ops.LAUNCHES["admit"]
    with pytest.raises(ValueError, match="shared memory"):
        ops.admit(reqs, routing, free, rnd, gum, block_r=1024)
    assert ops.LAUNCHES["admit"] == n0
    k = ops.admit(reqs, routing, free, rnd, gum, block_r=256)
    p = route_match.admit(reqs.req_id, reqs.svc, reqs.features,
                          reqs.msg_bytes, routing, free, rnd, gum,
                          block_r=256)
    for f in route_match.AdmitResult._fields:
        assert torch.equal(getattr(k, f), getattr(p, f)), f
    tune.clear_cache()


def _complete_args(I, C, E, S, seed, case="random"):
    """Completion inputs on the CPU: a pool with ~70 % active cells, some
    endpoints and services out of range, warm EWMAs.  ``case``
    "one_endpoint" puts every cell, active, on one endpoint and one
    service; "out_of_range" every endpoint in {-2, E, E + 7} and every
    service at or past S."""
    g = torch.Generator().manual_seed(seed)
    act = torch.rand((I, C), generator=g) < 0.7
    pool = [torch.randint(-1, 99, (I, C), generator=g, dtype=torch.int32),
            torch.randint(-2, E + 3, (I, C), generator=g, dtype=torch.int32),
            torch.randint(-1, S + 2, (I, C), generator=g, dtype=torch.int32),
            torch.randint(0, 8, (I, C), generator=g, dtype=torch.int32),
            torch.randint(0, 97, (I, C), generator=g, dtype=torch.int32), act]
    if case == "one_endpoint":
        pool[1][:], pool[2][:], pool[5][:] = 5, 3, True
    if case == "out_of_range":
        pool[1] = torch.tensor([-2, E, E + 7], dtype=torch.int32)[
            torch.randint(0, 3, (I, C), generator=g)]
        pool[2] = S + torch.randint(0, 4, (I, C), generator=g,
                                    dtype=torch.int32)
    nxt = torch.randint(0, 4, (I, C), generator=g, dtype=torch.int32)
    load = torch.randint(3, 9, (E,), generator=g, dtype=torch.int32)
    rx = torch.randint(0, 100, (S,), generator=g, dtype=torch.int32)
    ewl, ewt = torch.rand(E, generator=g) * 6, torch.rand(E, generator=g)
    return [*pool, nxt, load, rx, ewl, ewt]


@pytest.mark.parametrize("I,C", [(64, 16), (3, 5), (64, 64)])
def test_complete_kernel_matches_plain(dev, I, C):
    args = [t.to(dev) for t in _complete_args(I, C, 512, 64, I)]
    k = completion.complete_cuda(*args, eos=1, max_len=8)
    p = completion.complete(*args, eos=1, max_len=8)
    for f in completion.CompleteResult._fields:
        assert torch.equal(getattr(k, f), getattr(p, f)), f
    assert int(k.done.sum()) > 0


def _misaligned(t):
    """``t`` on the card as a view one element past an allocation's start
    (4 bytes for int32, 1 for bool): the kernel's scalar build."""
    flat = torch.empty((t.numel() + 1,), dtype=t.dtype, device=t.device)
    v = flat[1:].view(t.shape)
    v.copy_(t)
    return v


@pytest.mark.parametrize("case", ["one_endpoint", "out_of_range",
                                  "smem_limit", "misaligned"])
def test_complete_kernel_matches_plain_at_the_edges(dev, case):
    """Through ``ops.complete``, bit-exact with one launch: every cell on
    one endpoint and one service (the most contended folds), every
    endpoint and service out of range, E + S at the shared-memory limit
    (one more raises), and a pool handed over as misaligned views."""
    I, C, E, S = 64, 16, 512, 64
    if case == "smem_limit":
        E = _build.SMEM_DEFAULT // 4 - S
    args = [t.to(dev) for t in _complete_args(I, C, E, S, 7, case)]
    if case == "misaligned":
        args[:7] = [_misaligned(t) for t in args[:7]]
    n0 = ops.LAUNCHES["complete"]
    k = ops.complete(PoolState(*args[:6]), *args[6:], eos=1, max_len=8)
    assert ops.LAUNCHES["complete"] == n0 + 1
    p = completion.complete(*args, eos=1, max_len=8)
    for f, a, b in zip(PoolState._fields, k.pool, p[:6]):
        assert torch.equal(a, b), f
    for f, a, b in zip(("done", "ep_load", "rx_bytes", "done_cnt",
                        "inflight_ewma", "tput_ewma"), k[1:], p[6:]):
        assert torch.equal(a, b), f
    assert int(k.done.sum()) > 0
    if case == "smem_limit":
        more = torch.zeros((S + 1,), dtype=torch.int32, device=dev)
        with pytest.raises(ValueError, match="shared memory"):
            ops.complete(PoolState(*args[:6]), args[6], args[7], more,
                         *args[9:], eos=1, max_len=8)
        assert ops.LAUNCHES["complete"] == n0 + 1
    torch.cuda.synchronize()


@pytest.mark.parametrize("R", [256, 4096, 1, 31, 255, 257])
def test_route_match_kernel_matches_plain(dev, R):
    routing = _routing(dev, R)
    reqs, _, _ = _batch(R, R + 2, dev)
    svc = reqs.svc.clone()
    svc[::17] = 70                        # clamps to the last service
    n0 = ops.LAUNCHES["route_match"]
    k = ops.route_match(svc, reqs.features, routing)
    assert ops.LAUNCHES["route_match"] == n0 + 1
    p = route_match.route_match(svc, reqs.features, routing)
    for a, b in zip(k, p):
        assert torch.equal(a, b)
    torch.cuda.synchronize()


def _route_edge(routing, case):
    """``routing`` with one of B4's edges planted."""
    if case == "rule_field":            # -1 wraps to column 7; 9, -9 read
        rf = routing.rule_field.clone()  # INT_MIN and never match
        rf[[0, 2, 4, 6]] = torch.tensor([-1, 9, -9, 7], dtype=torch.int32,
                                        device=rf.device)
        return routing._replace(rule_field=rf)
    if case == "empty_clusters":
        cc = routing.cluster_ep_count.clone()
        cc[1::2] = 0
        return routing._replace(cluster_ep_count=cc)
    load = routing.ep_load.clone()
    if case == "equal_loads":           # every lane ties: the first wins
        load[:] = 3
    elif case == "big_loads":           # in-window loads at and past BIG
        load[:] = 2**30
        load[::7] = 2**30 + 5
    elif case == "negative_load":       # a corrupt table: signed compares
        load[[5, 40, 41]] = torch.tensor([-4, -2**31, -7], dtype=torch.int32,
                                         device=load.device)
    return routing._replace(ep_load=load)


def _pad_windows(routing, rows):
    """``routing`` with its service and cluster window tables grown to
    ``rows`` rows (empty windows): past the 64 rows the route kernel holds
    in registers, so it reads them from memory."""
    grow = lambda t: torch.cat([t, t.new_zeros(rows - t.shape[0])])
    return routing._replace(
        svc_rule_start=grow(routing.svc_rule_start),
        svc_rule_count=grow(routing.svc_rule_count),
        cluster_ep_start=grow(routing.cluster_ep_start),
        cluster_ep_count=grow(routing.cluster_ep_count))


@pytest.mark.parametrize("rows", [64, 100])
@pytest.mark.parametrize("case", ["rule_field", "empty_clusters",
                                  "equal_loads", "big_loads",
                                  "negative_load"])
def test_route_match_kernel_matches_plain_at_the_edges(dev, case, rows):
    """B4 at its edges, with the service and cluster windows held in
    registers (64 rows) and read from memory (100 rows): rogue and
    negative svc, feature columns wrapping or out of range, empty
    clusters, tied loads, loads at BIG and negative loads."""
    for R in (1, 31, 257):
        routing = _pad_windows(_route_edge(_routing(dev, R), case), rows)
        reqs, _, _ = _batch(R, R + 5, dev)
        svc = reqs.svc.clone()
        svc[::17] = 170                 # clamps to the last service
        svc[::13] = -3
        feats = reqs.features.clone()
        feats[::2, 7] = RT.fnv1a("v2")
        n0 = ops.LAUNCHES["route_match"]
        k = ops.route_match(svc, feats, routing)
        assert ops.LAUNCHES["route_match"] == n0 + 1
        p = route_match.route_match(svc, feats, routing)
        for a, b in zip(k, p):
            assert torch.equal(a, b), (case, R)
        assert bool((p[0] >= 0).any())
    torch.cuda.synchronize()


# one tile (one block), one row past it (a cluster of 2 blocks), one row
# past a cluster of 8 blocks of one tile each (2049) and past 16 tiles
# (4097), and 256 tiles (8 blocks walking 32 tiles each)
@pytest.mark.parametrize("N,n_dest", [(256, 65), (256, 513), (4096, 65),
                                      (1000, 7), (1, 3), (257, 65),
                                      (2049, 65), (4097, 65), (65536, 65)])
def test_relay_slots_kernel_matches_plain(dev, N, n_dest):
    g = torch.Generator().manual_seed(N + n_dest)
    idx = torch.randint(0, n_dest + 1, (N,), generator=g,
                        dtype=torch.int32).to(dev)    # n_dest = sentinel
    _check_relay(idx, n_dest)


@pytest.mark.parametrize("case", ["one_destination", "all_sentinel",
                                  "dest_limit"])
def test_relay_slots_kernel_matches_plain_at_the_edges(dev, case):
    """Every row of 4096 on one destination (a whole tile in one group),
    every row at the sentinel, and n_dest at ``MAX_DEST`` (one more
    raises)."""
    N, n_dest = 4096, 65
    if case == "one_destination":
        idx = torch.zeros((N,), dtype=torch.int32, device=dev)
        n_dest = 1
    elif case == "all_sentinel":
        idx = torch.full((N,), n_dest, dtype=torch.int32, device=dev)
    else:
        n_dest = relay_dispatch.MAX_DEST
        g = torch.Generator().manual_seed(n_dest)
        idx = torch.randint(0, n_dest + 1, (N,), generator=g,
                            dtype=torch.int32).to(dev)
        n0 = ops.LAUNCHES["relay_slots"]
        with pytest.raises(ValueError, match="n_dest"):
            ops.relay_slots(idx, n_dest + 1)
        assert ops.LAUNCHES["relay_slots"] == n0
    _check_relay(idx, n_dest)


def _check_relay(idx, n_dest):
    """The kernel through ``ops.relay_slots``, one launch, against the
    plain version, bit-exact."""
    n0 = ops.LAUNCHES["relay_slots"]
    slot, load = ops.relay_slots(idx, n_dest)
    assert ops.LAUNCHES["relay_slots"] == n0 + 1
    ps, pl = relay_dispatch.relay_slots(idx, n_dest)
    assert torch.equal(slot, ps) and torch.equal(load, pl)
    assert int(load.sum()) == int((idx < n_dest).sum())
    torch.cuda.synchronize()


def _assert_close(got, want, f32_tol=2e-5):
    """f32: rtol = atol = ``f32_tol``.  bf16: rtol 2e-2 and atol 2e-2 x the
    RMS of ``want``, so that the bound follows outputs far below 1
    (attention over n unit-variance values averages to an RMS of about
    sqrt(e / n))."""
    tol = dict(rtol=f32_tol, atol=f32_tol)
    if want.dtype == torch.bfloat16:
        tol = dict(rtol=2e-2,
                   atol=2e-2 * float(want.float().square().mean().sqrt()))
    torch.testing.assert_close(got, want, **tol)


def _randn(g, shape, dtype, dev, scale=1.0):
    return (torch.randn(shape, generator=g) * scale).to(dtype).to(dev)


def _counted(name, call):
    n0 = ops.LAUNCHES[name]
    out = call()
    torch.cuda.synchronize()
    assert ops.LAUNCHES[name] == n0 + 1
    return out


@pytest.mark.parametrize("B,S,H,K,hd,dtype,lengths", [
    (1024, 32, 4, 2, 32, torch.float32, None),   # the serving model's decode
    (2, 4128, 24, 8, 128, torch.bfloat16, None),  # minitron-4b decode
    (2, 4128, 24, 8, 128, torch.float32, None),
    (2, 1000, 8, 1, 64, torch.float32, None),    # G = 8, ragged S, split
    (3, 300, 6, 2, 128, torch.bfloat16, None),
    # lengths on the kernel's tile and split boundaries (128 keys)
    (4, 4128, 24, 8, 128, torch.bfloat16, [63, 64, 127, 128]),
    (2, 500, 16, 1, 128, torch.bfloat16, None),  # G = 16: passes of 4 heads
    (2, 300, 32, 2, 128, torch.float32, None),   # G = 16: passes of 8 heads
    (600, 40, 4, 2, 64, torch.bfloat16, None),   # bf16, a warp a pair
    (300, 200, 4, 2, 64, torch.float32, None),   # n_split = 1, 4 warps a pair
    (3, 1000, 6, 2, 32, torch.bfloat16, None),   # 4 lanes a key row
    # hd 16: the smoke configs' decode (a warp a pair), and split keys
    # through the merge (16 of a warp's lanes hold a dim each)
    (2, 67, 4, 2, 16, torch.float32, None),
    (2, 67, 4, 2, 16, torch.bfloat16, None),
    (2, 1000, 4, 2, 16, torch.float32, None),
    (2, 1000, 4, 2, 16, torch.bfloat16, None),
    # G = 48 (granite-20b's MQA): 12 passes of 4 heads in bf16, 6 of 8 in f32
    (2, 500, 48, 1, 128, torch.float32, None),
    (2, 500, 48, 1, 128, torch.bfloat16, None),
    # G = 7 (arctic-480b's 56 / 8): passes of 4 + 3 heads in bf16, one of 7
    # in f32; G = 4 (jamba-v0.1-52b's 32 / 8)
    (2, 4128, 56, 8, 128, torch.bfloat16, None),
    (2, 4128, 56, 8, 128, torch.float32, None),
    (3, 1000, 7, 1, 128, torch.bfloat16, None),
    (2, 4128, 32, 8, 128, torch.bfloat16, None),
    (2, 1000, 32, 8, 128, torch.float32, None),
    # whisper-large-v3's cross decode: every one of 1500 frames valid
    (8, 1500, 20, 20, 64, torch.bfloat16, [1499] * 8),
    (8, 1500, 20, 20, 64, torch.float32, [1499] * 8),
])
def test_decode_attention_kernel_matches_plain(dev, B, S, H, K, hd, dtype,
                                               lengths):
    g = torch.Generator().manual_seed(S + H)
    L = 2                                    # a layer of a stacked cache
    q = _randn(g, (B, H, hd), dtype, dev)
    kc = _randn(g, (L, B, S, K, hd), dtype, dev)[1]
    vc = _randn(g, (L, B, S, K, hd), dtype, dev)[1]
    if lengths is None:
        lengths = torch.randint(0, S, (B,), generator=g, dtype=torch.int32)
        lengths[0] = -1                      # every key masked
        lengths[-1] = S + 3                  # every key
    else:
        lengths = torch.tensor(lengths, dtype=torch.int32)
    lengths = lengths.to(dev)
    got = _counted("decode_attention",
                   lambda: ops.decode_attention(q, kc, vc, lengths))
    want = decode_attention.decode_attention(q, kc, vc, lengths)
    _assert_close(got, want)


@pytest.mark.parametrize("B,S,H,K,hd,dtype,causal,stacked", [
    (2, 256, 8, 2, 64, torch.float32, True, False),
    (2, 256, 8, 2, 64, torch.float32, False, False),
    (1, 200, 4, 1, 128, torch.bfloat16, True, False),   # ragged S, MQA
    (1, 1024, 24, 8, 128, torch.bfloat16, True, False),  # minitron's heads
    (1, 1024, 24, 8, 128, torch.float32, True, False),
    (2, 97, 4, 4, 32, torch.float32, True, False),
    # the bf16 tensor-core kernel: S not a multiple of its 128-row tiles,
    # minitron-4b's whole prefill, hd 64 and 32 (64-byte swizzle)
    # without the mask, and q, k, v as layers of stacked tensors
    (1, 1000, 8, 2, 128, torch.bfloat16, True, False),
    (2, 4096, 24, 8, 128, torch.bfloat16, True, False),
    (2, 300, 8, 2, 64, torch.bfloat16, False, False),
    (2, 257, 4, 2, 32, torch.bfloat16, False, False),
    (2, 300, 6, 3, 128, torch.bfloat16, True, True),
    (1, 130, 4, 2, 64, torch.bfloat16, False, True),
    # hd 16 (the smoke configs): the FMA kernel in both dtypes
    (2, 64, 4, 2, 16, torch.float32, True, False),
    (2, 64, 4, 2, 16, torch.bfloat16, True, False),
    (1, 200, 4, 2, 16, torch.bfloat16, False, True),
    # G = 7 (arctic-480b's 56 / 8) and G = 4 (jamba-v0.1-52b's 32 / 8)
    (1, 1024, 56, 8, 128, torch.bfloat16, True, False),
    (1, 1024, 56, 8, 128, torch.float32, True, False),
    (1, 300, 7, 1, 128, torch.bfloat16, True, False),
    (1, 1024, 32, 8, 128, torch.bfloat16, True, False),
    (1, 1024, 32, 8, 128, torch.float32, True, False),
    # whisper-large-v3's encoder, not causal: 1500 frames (a ragged last
    # 128-row tile), 20 / 20 heads of hd 64
    (8, 1500, 20, 20, 64, torch.bfloat16, False, False),
    (2, 1500, 20, 20, 64, torch.float32, False, False),
    (2, 130, 20, 20, 64, torch.bfloat16, False, True),
])
def test_flash_attention_kernel_matches_plain(dev, B, S, H, K, hd, dtype,
                                              causal, stacked):
    g = torch.Generator().manual_seed(S + H + causal)
    L = 3 if stacked else 1
    q = _randn(g, (L, B, S, H, hd), dtype, dev)[L - 1]
    k = _randn(g, (L, B, S, K, hd), dtype, dev)[L // 2]
    v = _randn(g, (L, B, S, K, hd), dtype, dev)[0]
    got = _counted("flash_attention",
                   lambda: ops.flash_attention(q, k, v, causal=causal))
    want = flash_attention.flash_attention(q, k, v, causal=causal)
    _assert_close(got, want)


_F32, _BF16 = torch.float32, torch.bfloat16


@pytest.mark.parametrize("B,S,nh,hd,N,dtype,chunk,per_head", [
    (2, 256, 4, 64, 128, _F32, 64, ""),
    (1, 300, 3, 32, 32, _F32, 300, ""),        # ragged tail tile
    (1, 512, 2, 128, 128, _F32, 128, ""),
    (2, 512, 8, 64, 128, _BF16, 256, ""),      # mamba2-2.7b's head
    # the bf16 passes: 16 chunks of 256 rows in the state hand-off
    (1, 4096, 2, 64, 128, _BF16, 256, ""),
    (1, 4096, 2, 64, 128, _F32, 256, ""),
    (1, 4096, 2, 64, 128, _BF16, 256, "BC"),
    # scores shared by the heads (stride 0) beside B and C per head, and
    # beside only C per head
    (2, 512, 8, 64, 128, _BF16, 256, "BC"),
    (2, 512, 8, 64, 128, _BF16, 256, "C"),
    (1, 1, 2, 64, 128, _BF16, 1, ""),          # shorter than one chunk
    (1, 100, 3, 64, 128, _BF16, 100, ""),
    (1, 100, 3, 64, 128, _BF16, 100, "BC"),
    (2, 1000, 4, 64, 128, _BF16, 1000, ""),    # ragged: 3 chunks + 232
    (2, 1000, 4, 64, 128, _BF16, 1000, "BC"),
    (1, 600, 1, 64, 64, _BF16, 600, "BC"),     # one head
    # every (hd, N) build of the bf16 passes, with a ragged tail
    (1, 300, 2, 32, 32, _BF16, 300, ""),
    (1, 300, 2, 32, 64, _BF16, 300, "BC"),
    (1, 300, 2, 32, 128, _BF16, 300, ""),
    (1, 300, 2, 64, 32, _BF16, 300, "BC"),
    (1, 300, 2, 64, 64, _BF16, 300, ""),
    (1, 300, 2, 128, 32, _BF16, 300, ""),
    (1, 300, 2, 128, 64, _BF16, 300, "BC"),
    (1, 300, 2, 128, 128, _BF16, 300, ""),
    (1, 300, 2, 128, 128, _BF16, 300, "BC"),
    # hd 16 / N 16 (mamba2-2.7b's smoke config: 8 heads, chunk 32): the
    # FMA kernel in both dtypes, and beside larger hd or N
    (2, 64, 8, 16, 16, _F32, 32, ""),
    (2, 64, 8, 16, 16, _BF16, 32, ""),
    (1, 300, 2, 16, 64, _BF16, 300, "BC"),
    (1, 300, 2, 64, 16, _BF16, 300, ""),
])
def test_ssd_scan_kernel_matches_plain(dev, B, S, nh, hd, N, dtype, chunk,
                                       per_head):
    g = torch.Generator().manual_seed(S + nh)
    x = _randn(g, (B, S, nh, hd), dtype, dev, 0.5)
    a = (-torch.nn.functional.softplus(torch.randn((B, S, nh), generator=g))
         * 0.5).to(dev)
    # one group broadcast over the heads by stride, as the mixer passes it,
    # or (named in per_head) a projection per head
    def proj():
        return _randn(g, (B, S, nh, N), dtype, dev, 0.3)

    def group():
        return _randn(g, (B, S, 1, N), dtype, dev, 0.3).expand(-1, -1, nh,
                                                               -1)
    Bm = proj() if "B" in per_head else group()
    Cm = proj() if "C" in per_head else group()
    y, h = _counted("ssd_scan", lambda: ops.ssd_scan(
        x, a, Bm, Cm, chunk=chunk, return_state=True))
    wy, wh = ssd_scan.ssd_scan(x, a, Bm, Cm, chunk)
    _assert_close(y, wy, f32_tol=2e-4)
    _assert_close(h, wh, f32_tol=2e-4)


# the kernel launches of a smoke prefill and 4 decode steps: a GQA layer
# launches B7 once and B6 once a step, a mamba layer B8 once, a MoE layer
# B5 once a prefill and once a step (deepseek's MLA runs no kernel)
SMOKE_LAUNCHES = {
    "minitron-4b": {"flash_attention": 2, "decode_attention": 8},
    "mamba2-2.7b": {"ssd_scan": 2},
    "arctic-480b": {"flash_attention": 2, "decode_attention": 8,
                    "relay_slots": 10},
    "deepseek-v2-236b": {"relay_slots": 5},
    "jamba-v0.1-52b": {"flash_attention": 1, "decode_attention": 4,
                       "ssd_scan": 7, "relay_slots": 20},
    # 2 encoder layers (not causal) + 2 decoder layers; B6 self and cross
    "whisper-large-v3": {"flash_attention": 4, "decode_attention": 16}}


@pytest.mark.parametrize("arch", list(SMOKE_LAUNCHES))
def test_prefill_decode_smoke_configs_on_the_card(dev, arch):
    """The launcher's reduced config (hd 16; mamba's N 16) on the card:
    finite logits, every attention, SSD and MoE dispatch call through its
    kernel."""
    from repro_torch.launch import prefill_decode
    before = dict(ops.LAUNCHES)
    res = prefill_decode.main(["--smoke", "--arch", arch, "--batch", "2",
                               "--prompt", "64", "--steps", "4"])
    assert bool(torch.isfinite(res["logits"]).all())
    runs = {k: ops.LAUNCHES[k] - before[k] for k in before}
    assert {k: v for k, v in runs.items() if v} == SMOKE_LAUNCHES[arch]


@pytest.mark.parametrize("arch", ["whisper-large-v3", "jamba-v0.1-52b",
                                  "arctic-480b", "mamba2-2.7b"])
def test_training_step_on_the_card_matches_the_cpu(dev, arch):
    """The smoke config's loss and every gradient leaf (f32) on the card
    against the CPU with the same weights: the forward through B7, B8
    and B5, the backward recomputing the plain attention and scan."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models import model as TM
    from repro_torch.tree import leaves, map_tree
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = smoke_config(get_config(arch))
    params = TM.init_params(cfg, torch.Generator().manual_seed(3),
                            torch.float32, "cpu")
    g = torch.Generator().manual_seed(4)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 64), generator=g),
             "labels": torch.randint(-1, cfg.vocab, (2, 64), generator=g)}
    if cfg.is_encdec:
        batch["enc_frames"] = torch.randn((2, cfg.enc_frames, cfg.d_model),
                                          generator=g)
    out = {}
    for d in ("cpu", dev):
        tree = map_tree(lambda t: t.to(d, copy=True).requires_grad_(),
                        params)
        before = dict(ops.LAUNCHES)
        loss, _ = TM.loss_fn(cfg, tree, {k: v.to(d) for k, v in
                                         batch.items()})
        grads = torch.autograd.grad(loss, leaves(tree))
        runs = {k: ops.LAUNCHES[k] - before[k] for k in before}
        out[d] = (loss.detach().cpu(), [x.cpu() for x in grads], runs)
    assert sum(out[dev][2].values()) > 0 and sum(out["cpu"][2].values()) == 0
    torch.testing.assert_close(out[dev][0], out["cpu"][0], rtol=1e-4,
                               atol=1e-4)
    for a, b in zip(out[dev][1], out["cpu"][1]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def test_train_launcher_on_the_card(dev, tmp_path):
    """``launch.train`` of whisper's smoke config on the card: finite
    losses, B7 in every forward (2 encoder + 2 decoder layers a step)."""
    from repro_torch.launch import train
    before = dict(ops.LAUNCHES)
    out = train.main(["--arch", "whisper-large-v3", "--steps", "2",
                      "--global-batch", "2", "--seq", "32", "--ckpt-dir",
                      str(tmp_path)])
    assert all(np.isfinite(h["loss"]) for h in out["history"])
    runs = {k: ops.LAUNCHES[k] - before[k] for k in before}
    assert {k: v for k, v in runs.items() if v} == {"flash_attention": 8}


def _control_plane():
    from repro_torch.core.control import ControlPlane
    return ControlPlane(
        [RT.ServiceConfig("svc", rules=[RT.Rule(0, None, "pool")]),
         RT.ServiceConfig("hashed", rules=[RT.Rule(0, None, "ring")])],
        [RT.Cluster("pool", [0, 1, 2, 3], policy=RT.POLICY_LEAST_REQUEST),
         RT.Cluster("ring", [4, 5, 6], policy=RT.POLICY_AFFINITY)])


def test_apply_plan_on_the_card_matches_the_cpu(dev):
    """The splice and the pool remap on CUDA state against the same calls
    on CPU copies, bit for bit, with warm loads, EWMAs and affinity."""
    from repro_torch.core import control
    cp = _control_plane()
    rng = np.random.RandomState(0)
    live = cp.snapshot()
    E, A = live.ep_load.shape[0], live.aff_key.shape[0]
    t = torch.from_numpy
    live = live._replace(
        ep_load=t(rng.randint(0, 9, E).astype(np.int32)),
        ep_inflight_ewma=t(rng.rand(E).astype(np.float32)),
        ep_tput_ewma=t(rng.rand(E).astype(np.float32)),
        rr_cursor=t(rng.randint(0, 50, live.rr_cursor.shape[0])
                    .astype(np.int32)),
        aff_key=t(np.where(rng.rand(A) < 0.5, rng.randint(0, 1 << 30, A),
                           -1).astype(np.int32)),
        aff_ep=t(np.where(rng.rand(A) < 0.5, rng.randint(0, 8, A),
                          -1).astype(np.int32)))
    with cp.transaction():
        cp.drain_endpoint("pool", 1)
        cp.remove_endpoint("pool", 0)          # swap-with-last
        cp.add_endpoint("pool", instance=7)
        cp.drain_endpoint("ring", 5)
    for plan in (cp.last_plan, cp.last_plan._replace(version=-1)):
        want = control.apply_plan(live, plan)
        got = control.apply_plan(live.to(dev), plan)
        assert got.ep_load.device.type == "cuda"
        for f in RT.RoutingState._fields:
            a, b = getattr(got, f).cpu(), getattr(want, f)
            assert a.dtype == b.dtype and torch.equal(a, b), f
    ep = t(rng.randint(-1, 12, (64, 16)).astype(np.int32))
    got = control.remap_endpoints(cp.last_plan, ep.to(dev))
    assert torch.equal(got.cpu(), control.remap_endpoints(cp.last_plan, ep))


def test_serve_loop_drains_across_a_mid_drain_commit_on_the_card(dev):
    """ServeLoop over the XLB engine on the card, attached to a
    ControlPlane: a commit mid-drain (drain a loaded endpoint, remove one,
    add one) bumps the version once, no later admission lands on the
    drained endpoint, every request completes, the loads return to zero
    and the drained endpoint is reaped on a later commit."""
    from repro_torch.configs import XLB_SERVICE_MODEL as cfg
    from repro_torch.core.interpose import Engine
    from repro_torch.models import model as M
    from repro_torch.runtime.serve_loop import Request, ServeLoop
    cp = _control_plane()
    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           torch.float32, dev)
    loop = ServeLoop(Engine(cfg, 8, 4, 8, eos=-1, device=dev), params, cp,
                     admit_batch=8)
    for i in range(64):
        loop.submit(Request(req_id=i, service=i % 2,
                            headers={"user": f"u{i % 9}"},
                            prompt_token=3 + i))
    for _ in range(3):
        loop.tick()
    slot = cp.endpoint_slot("pool", 2)
    loaded = int(loop.routing.ep_load[slot])
    assert loaded > 0
    held = int(((loop.state.pool.endpoint == slot)
                & loop.state.pool.active).sum())
    with cp.transaction():
        cp.drain_endpoint("pool", 2)
        cp.remove_endpoint("pool", 0)
        cp.add_endpoint("pool", instance=7)
    assert cp.version == 1 and int(loop.routing.version) == 1
    slot = cp.endpoint_slot("pool", 2)
    admitted_after = 0
    while loop.queue or loop._waiting or loop.inflight:
        before = loop.state.pool.active.clone()
        loop.tick()
        new = loop.state.pool.active & ~before
        if cp.endpoint_slot("pool", 2) == slot:     # not reaped yet
            admitted_after += int(
                (new & (loop.state.pool.endpoint == slot)).sum())
            cp.reap()
        assert loop.ticks < 400
    assert admitted_after == 0 and held == loaded, (admitted_after, held, loaded)
    assert cp.endpoint_slot("pool", 2) < 0 and cp.version >= 2
    assert ("reap", "pool", 2) in cp.last_commit_log or cp.version > 2
    assert len(loop.done) == 64
    assert not bool(loop.routing.ep_load.any())
    torch.cuda.synchronize()


def test_fault_injector_and_shaper_on_the_card_match_the_cpu(dev):
    """The progress rollback on a card pool: one functional update on the
    card equal to the CPU's; the same pool back when nothing is held."""
    from repro_torch.runtime.serve_loop import Fault, FaultInjector
    from repro_torch.workload import LognormalServiceTimes, ServiceTimeShaper
    pool, _ = _pool(64, 16, 3, "cpu", busy=0.7)
    pool = pool._replace(length=pool.length.clamp(0, 5))
    inj = FaultInjector([Fault(3, "stall"), Fault(7, "slow", factor=2),
                         Fault(99, "stall")])
    for t in (0, 1):
        got = inj.apply(pool.__class__(*[x.to(dev) for x in pool]), t)
        assert got.length.device.type == "cuda"
        assert torch.equal(got.length.cpu(), inj.apply(pool, t).length)
    idle = FaultInjector([Fault(3, "stall", start=50)])
    card = pool.__class__(*[x.to(dev) for x in pool])
    assert idle.apply(card, 0) is card
    law = LognormalServiceTimes(seed=9, median=6.0, sigma=0.5, cap=16)
    a, b = ServiceTimeShaper(law, 2), ServiceTimeShaper(law, 2)
    for t in range(4):
        got = a.apply(card, t)
        want = b.apply(pool, t)
        assert torch.equal(got.length.cpu(), want.length)
        card, pool = got, want


def test_guards_on_the_card(dev):
    """The sanitizer's laws on card tensors: the kernels' outputs pass,
    a planted off-by-one release raises naming its law."""
    from repro_torch.analysis.invariants import guard
    routing = _routing(dev, 1)
    reqs, rnd, gum = _batch(256, 1, dev)
    out = ops.admit_commit(reqs, routing, PoolState.init(64, 16, dev), rnd,
                           gum)
    guard("admit", dict(load_before=routing.ep_load, load_after=out.ep_load,
                        ok=out.ok, held=out.held, endpoint=out.endpoint,
                        instance=out.instance, slot=out.slot,
                        req_id=reqs.req_id, pool_req_id=out.pool.req_id,
                        pool_active=out.pool.active))
    nxt = torch.randint(0, 97, (64, 16), dtype=torch.int32, device=dev)
    res = ops.complete(out.pool, nxt, out.ep_load,
                       torch.zeros(64, dtype=torch.int32, device=dev),
                       eos=5, max_len=8)
    ctx = dict(load_before=out.ep_load, load_after=res.ep_load,
               done_cnt=res.done_cnt, done=res.done,
               active_after=res.pool.active, req_id_after=res.pool.req_id)
    guard("complete", ctx)
    with pytest.raises(AssertionError, match="release-conservation"):
        guard("complete", dict(ctx, load_after=res.ep_load + 1))


def test_health_and_transport_read_card_state(dev):
    """The daemon's EWMA read, the heartbeat's load vote, a snapshot
    resync and a convergence report over a sink whose tables live on the
    card: the same results as over the CPU copy."""
    from repro_torch.core.control import ControlPlane
    from repro_torch.core.health import HealthPolicy
    from repro_torch.runtime import transport as tr
    cp = ControlPlane([RT.ServiceConfig("s", [RT.Rule(0, None, "pool")])],
                      [RT.Cluster("pool", list(range(4)))])
    live = cp.snapshot()
    infl = torch.zeros(512)
    infl[:4] = torch.tensor([4.0, 4.0, 4.0, 40.0])
    live = live._replace(ep_inflight_ewma=infl, ep_tput_ewma=(infl > 0)
                         .float(), ep_load=torch.arange(512,
                                                        dtype=torch.int32))
    acts = []
    for routing in (live, live.to(dev)):
        c = ControlPlane([RT.ServiceConfig("s", [RT.Rule(0, None, "pool")])],
                         [RT.Cluster("pool", list(range(4)))])
        pol = HealthPolicy(c)
        acts.append([pol.epoch(routing) for _ in range(3)])
    assert acts[0] == acts[1] and acts[1][1] == [("eject", "pool", 3)]
    hub = tr.Transport(cp, tr.LossyChannel(delay_min=0))
    rc = hub.consumer("n0", sink=tr.RoutingView(live.to(dev)))
    rc.pump(0)
    hb = hub.channel.recv(tr.CP_NODE, 0)[-1]
    assert np.array_equal(hb["ep_load"], live.ep_load.numpy())
    cp.add_endpoint("pool", instance=9)
    plan = tr.snapshot_plan(cp.packed_snapshot(), live.to(dev))
    want = tr.snapshot_plan(cp.packed_snapshot(), live)
    assert np.array_equal(plan.ep_src, want.ep_src)
    for t in range(1, 4):
        hub.pump(t)
        rc.pump(t)
    assert rc.routing.ep_load.device.type == "cuda"
    assert hub.report()["converged"] and rc.version == cp.version


# --------------------------------------------------------------------------- #
# sharded admission and completion on the card
# --------------------------------------------------------------------------- #


def _equal_fields(got, want, ctx):
    for f in want._fields:
        w, g = getattr(want, f), getattr(got, f)
        if f == "pool":
            _equal_fields(g, w, f"{ctx} pool")
        else:
            assert g.dtype == w.dtype and torch.equal(g, w), f"{ctx} {f}"


# the serving shape, a ragged batch, and an idle ingress host (a shard of
# padding rows, which launches nothing)
@pytest.mark.parametrize("M", [2, 4])
@pytest.mark.parametrize("case", ["serving", "ragged", "idle_shard"])
def test_sharded_admission_matches_unsharded_on_the_card(dev, case, M):
    from repro_torch.kernels import shard_admit
    from repro_torch.launch.mesh import make_shard_mesh
    R, I, C = {"serving": (256, 64, 16), "ragged": (300, 16, 4),
               "idle_shard": (256, 64, 16)}[case]
    routing = _routing(dev, R)
    reqs, rnd, gum = _batch(R, R + M, dev)
    if case == "idle_shard":
        rid = reqs.req_id.clone()
        rid[R // M:2 * R // M] = -1
        reqs = reqs._replace(req_id=rid)
    pool, _ = _pool(I, C, R, dev)
    live = shard_admit.live_shards(reqs.req_id, M)
    assert (case == "idle_shard") == (not all(live))
    n0 = dict(ops.LAUNCHES)
    k = ops.admit_commit_sharded(reqs, routing, pool, rnd, gum,
                                 mesh=make_shard_mesh(M))
    assert ops.LAUNCHES["admit"] - n0["admit"] == sum(live)
    assert ops.LAUNCHES["route_match"] - n0["route_match"] == 1
    assert ops.LAUNCHES["relay_slots"] - n0["relay_slots"] == 1
    assert ops.LAUNCHES["admit_commit"] == n0["admit_commit"]
    _equal_fields(k, ops.admit_commit(reqs, routing, pool, rnd, gum),
                  f"{case} M={M} vs unsharded")
    cpu = lambda t: t.cpu()                                  # noqa: E731
    c = ops.admit_commit_sharded(
        RequestBatch(*map(cpu, reqs)), routing.to("cpu"),
        PoolState(*map(cpu, pool)), cpu(rnd), cpu(gum),
        mesh=make_shard_mesh(M, device="cpu"))
    on_cpu = k._replace(pool=PoolState(*map(cpu, k.pool)),
                        **{f: cpu(getattr(k, f)) for f in k._fields[:-1]})
    _equal_fields(on_cpu, c, f"{case} M={M} vs the CPU")
    assert int(k.ok.sum()) > 0 and int(k.held) > 0


@pytest.mark.parametrize("M", [2, 4])
@pytest.mark.parametrize("I,C", [(64, 16), (8, 6)])
def test_sharded_completion_matches_unsharded_on_the_card(dev, I, C, M):
    """EWMA bits included: B1's epilogue unsharded, ``health_update`` in
    torch ops after the psum sharded."""
    from repro_torch.launch.mesh import make_shard_mesh
    args = [t.to(dev) for t in _complete_args(I, C, 512, 64, I + M)]
    n0 = ops.LAUNCHES["complete"]
    k = ops.complete_sharded(PoolState(*args[:6]), *args[6:],
                             mesh=make_shard_mesh(M), eos=1, max_len=8)
    assert ops.LAUNCHES["complete"] == n0 + M
    _equal_fields(k, ops.complete(PoolState(*args[:6]), *args[6:], eos=1,
                                  max_len=8), f"complete M={M}")
    assert int(k.done_cnt.sum()) > 0


# --------------------------------------------------------------------------- #
# B3's all-free mode (the sharded admission's kernel)
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("block_r", [64, 256, 1024])
@pytest.mark.parametrize("W", [1, 64, 256, 1024, 4096])
def test_admit_all_free_mode_matches_plain(dev, W, block_r):
    """The commit-free kernel against an all-free pool of width W, staging
    nothing of it, at each tile, bit-exact against the plain version in
    the same mode,
    against the plain version given an explicit all-ones (I, W) mask, and,
    where the staged mask fits a block (W <= 256), against the kernel
    given that mask.  The batch holds out-of-range services and weighted
    rows with NaN Gumbel values; at W = 1 most routable rows are held."""
    R, I = 512, 64
    routing = _routing(dev, W)
    reqs, rnd, gum = _batch(R, W + 2, dev)
    reqs = _rows_to(reqs, 3, torch.arange(R)[::2], dev)   # c3: weighted
    svc = reqs.svc.clone()
    svc[1::7], svc[3::7] = -3, 1000
    gum = gum.clone()
    gum[::6, 0] = float("nan")
    gum[2::6, :] = float("nan")
    reqs = reqs._replace(svc=svc)
    args = (reqs.req_id, reqs.svc, reqs.features, reqs.msg_bytes)
    n0 = ops.LAUNCHES["admit"]
    k = route_match.admit_cuda(*args, None, routing, None, None, rnd, gum,
                               block_r=block_r, pool_shape=(I, W))
    assert ops.LAUNCHES["admit"] == n0              # counted by its callers
    cpu = [t.cpu() for t in (*args, rnd, gum)]
    rcpu = routing.to("cpu")
    p = route_match.admit(*cpu[:4], rcpu, None, *cpu[4:], block_r=block_r,
                          pool_shape=(I, W))
    ones = torch.ones((I, W), dtype=torch.int32)
    m = route_match.admit(*cpu[:4], rcpu, ones, *cpu[4:], block_r=block_r)
    for f in route_match.AdmitResult._fields:
        assert torch.equal(getattr(k, f).cpu(), getattr(p, f)), f
        assert torch.equal(getattr(p, f), getattr(m, f)), f
    if W <= 256:
        k2 = route_match.admit_cuda(*args, None, routing, ones.bool().to(dev),
                                    None, rnd, gum, block_r=block_r)
        for f in route_match.AdmitResult._fields:
            assert torch.equal(getattr(k, f), getattr(k2, f)), f
    assert int(k.ok.sum()) > 0
    assert W > 1 or int(k.held) > 0


@pytest.mark.parametrize("M", [1, 4])
def test_sharded_admission_at_width_1024_matches_unsharded(dev, M):
    """F4: at I = 64 and R/M = 1024 the sharded admission used to stage a
    (64, 1024) all-free mask in B3's shared memory, past the 227 KB a
    block may have, and raised.  In the all-free mode it stages none and
    equals the unsharded wrapper bit for bit."""
    from repro_torch.launch.mesh import make_shard_mesh
    R, I, C = 1024 * M, 64, 16
    routing = _routing(dev, R)
    reqs, rnd, gum = _batch(R, R + 7, dev)
    pool, _ = _pool(I, C, R, dev, busy=0.3)
    n0 = ops.LAUNCHES["admit"]
    k = ops.admit_commit_sharded(reqs, routing, pool, rnd, gum,
                                 mesh=make_shard_mesh(M))
    assert ops.LAUNCHES["admit"] - n0 == M
    _equal_fields(k, ops.admit_commit(reqs, routing, pool, rnd, gum),
                  f"M={M} R/M=1024")
    assert int(k.ok.sum()) > 0 and int(k.held) > 0


# --------------------------------------------------------------------------- #
# the chain and the analysis gate on the card
# --------------------------------------------------------------------------- #


def test_depth2_xlb_chain_on_the_card_matches_the_cpu(dev):
    """A depth-2 xlb chain of the full-width serving model (16 lanes x 8
    slots a hop) on the card: the same row and tick records as the CPU
    run; each hop's engine draws from one seeded CPU generator."""
    import json
    from repro_torch.configs import XLB_SERVICE_MODEL as cfg
    from repro_torch.core import interpose, policies
    from repro_torch.models import model as M
    from repro_torch.workload import PoissonArrivals, Workload, hops

    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           torch.float32, "cpu")

    def run(d):
        post, n = interpose.Engine.__post_init__, iter(range(9))

        def seeded(self):
            post(self)
            gen = torch.Generator().manual_seed(next(n))
            self.draws = lambda R: [t.to(self.device)
                                    for t in policies.draws(gen, R)]
        interpose.Engine.__post_init__ = seeded
        try:
            out = hops.run_chain_scenario(
                "xlb", depth=2, workload=Workload(
                    PoissonArrivals(rate=6.0, seed=3), n_requests=96,
                    vocab=cfg.vocab),
                n_instances=16, slots=8, tokens_per_req=4, admit_batch=64,
                policy=RT.POLICY_WEIGHTED, cfg=cfg,
                params=params if d == "cpu" else _to_dev(params, dev),
                device=d)
        finally:
            interpose.Engine.__post_init__ = post
        res = out["result"]
        return out["row"], (res.ticks, res.submit_tick, res.done_tick,
                            res.hop_submit, res.hop_done)

    card, cpu = run(dev), run("cpu")
    assert json.dumps(card[0]) == json.dumps(cpu[0]) and card[1] == cpu[1]
    assert card[0]["completed"] == 96


def _to_dev(tree, dev):
    if isinstance(tree, dict):
        return {k: _to_dev(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def test_analysis_kernels_section_exits_zero_on_the_card():
    """``python -m repro_torch.analysis`` with its kernels section against
    the bounds-checking build, in a process of its own."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    root = Path(__file__).resolve().parents[1]
    p = subprocess.run([sys.executable, "-m", "repro_torch.analysis"],
                       cwd=root, capture_output=True, text=True,
                       timeout=900,
                       env=dict(os.environ, PYTHONPATH=str(root / "src")))
    assert p.returncode == 0, p.stdout[-4000:] + p.stderr[-4000:]
    assert "bounds-checking build" in p.stdout
    assert "verified: all sections clean" in p.stdout


# --------------------------------------------------------------------------- #
# the serving tick and the sidecars' decode as captured CUDA graphs
# --------------------------------------------------------------------------- #


def _serve_record(dev, captured, draws, midway, shards=1, tracer=False):
    """64 requests through ServeLoop over the XLB engine (8 x 4 slots,
    admit 8; ``shards``-way on a one-process mesh) on the card, through
    ``make_jitted``'s captured tick or the eager tick; ``draws``:
    "engine" (its own generator on the card) or "host" (a seeded CPU
    generator, copied over without a sync); ``midway``: a commit at tick
    4 and lane 1 stalled over ticks 6-9; ``tracer``: a ``Tracer`` on the
    loop.  Returns everything the drain leaves: completions, tokens,
    ticks, routing, metrics and pool (with ``tracer`` also the spans and
    the captures' set-up split)."""
    from repro_torch.configs import XLB_SERVICE_MODEL as cfg
    from repro_torch.core import policies
    from repro_torch.core.interpose import Engine
    from repro_torch.launch.mesh import make_shard_mesh
    from repro_torch.models import model as M
    from repro_torch.runtime import graphs
    from repro_torch.runtime.serve_loop import (Fault, FaultInjector,
                                                Request, ServeLoop)
    from repro_torch.runtime.trace import Tracer
    cp = _control_plane()
    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           torch.float32, dev)
    kw = {} if shards == 1 else dict(
        shards=shards, shard_mesh=make_shard_mesh(shards, device=dev))
    eng = Engine(cfg, 8, 4, 8, device=dev, **kw)
    if draws == "host":
        gen = torch.Generator().manual_seed(5)

        def host(R):
            rnd, gum = policies.draws(gen, R)
            return (rnd.to(dev, non_blocking=True),
                    gum.to(dev, non_blocking=True))
        eng.draws = host
    fault = FaultInjector([Fault(1, "stall", start=6, end=10)]) \
        if midway else None
    loop = ServeLoop(eng, params, cp, admit_batch=8, fault=fault)
    assert isinstance(loop.serve_step, graphs.StaticTick)
    if not captured:
        loop.serve_step = eng.eager_step
    if tracer:
        loop.tracer = Tracer()
    for i in range(64):
        loop.submit(Request(req_id=i, service=i % 2,
                            headers={"user": f"u{i % 9}"},
                            prompt_token=3 + i))
    while loop.queue or loop._waiting or loop.inflight:
        if midway and loop.ticks == 4:
            with cp.transaction():
                cp.drain_endpoint("pool", 2)
                cp.remove_endpoint("pool", 0)
                cp.add_endpoint("pool", instance=7)
        loop.tick()
        assert loop.ticks < 400
    torch.cuda.synchronize()
    lists = lambda t: {f: getattr(t, f).tolist() for f in t._fields}  # noqa
    extra = {}
    if tracer:
        g = loop.serve_step.graphs
        extra = {"spans": loop.tracer.totals()["spans"],
                 "split": (g.warmup_s, g.sync_s, g.capture_s, g.setup_s)}
    return {**extra,
            "done": [(r.req_id, r.retries, r.admit_tick, r.done_tick)
                     for r in loop.done],
            "tokens": [r.tokens for r in loop.done],
            "ticks": loop.ticks, "routing": lists(loop.routing),
            "metrics": lists(loop.state.metrics),
            "pool": lists(loop.state.pool),
            "graphs": len(loop.serve_step.graphs) if captured else 0,
            "reads": loop.serve_step.verdict_reads if captured else 0}


@pytest.mark.parametrize("draws,midway", [("engine", False),
                                          ("host", False),
                                          ("engine", True)])
def test_captured_tick_equals_the_eager_tick_on_the_card(dev, draws,
                                                         midway):
    """A drain through the captured tick bit-equal to the same drain
    through the eager tick: every completion, token, routing counter,
    EWMA, metric and pool cell; the loads and the pool back to zero."""
    got = _serve_record(dev, True, draws, midway)
    want = _serve_record(dev, False, draws, midway)
    assert got.pop("graphs") == 2            # the arrival and decode-only
    want.pop("graphs")
    assert got.pop("reads") == want.pop("reads") == 0
    assert got == want
    assert len(got["done"]) == 64
    assert not any(got["routing"]["ep_load"])
    assert not any(map(any, got["pool"]["active"]))
    if midway:
        assert got["routing"]["version"] >= 1


def test_traced_captured_tick_equals_untraced_and_splits_its_set_up(dev):
    """The captured drain with a ``Tracer`` on the loop bit-equal to the
    same drain without one; each program's first call timed as its
    capture, every later call as a replay; the captures' set-up split
    into warm-up, sync and capture seconds that sum to ``setup_s``."""
    got = _serve_record(dev, True, "engine", True, tracer=True)
    want = _serve_record(dev, True, "engine", True)
    spans, split = got.pop("spans"), got.pop("split")
    assert got == want and got["graphs"] == 2
    assert spans["static_tick.capture"][0] == 2
    assert spans["static_tick.replay"][0] == got["ticks"] - 2
    assert spans["serve_loop.tick"][0] == got["ticks"]
    warm, sync, cap, setup = split
    assert min(warm, sync, cap) > 0
    assert abs(warm + sync + cap - setup) < 1e-9


@pytest.mark.parametrize("M", [2, 4])
@pytest.mark.parametrize("draws,midway", [("engine", False),
                                          ("host", True)])
def test_sharded_captured_tick_equals_the_eager_tick_on_the_card(
        dev, draws, midway, M):
    """The sharded tick on a one-process mesh: the captured drain
    bit-equal to the eager sharded drain and to the unsharded one; at
    most M + 1 programs (the batch is filled from the front)."""
    got = _serve_record(dev, True, draws, midway, shards=M)
    want = _serve_record(dev, False, draws, midway, shards=M)
    flat = _serve_record(dev, True, draws, midway)
    assert 2 <= got.pop("graphs") <= M + 1
    for r in (got, want, flat):
        r.pop("reads")
    want.pop("graphs")
    flat.pop("graphs")
    assert got == want
    assert got == flat
    assert len(got["done"]) == 64


@pytest.mark.parametrize("M", [1, 2, 4])
def test_sanitized_captured_tick_equals_eager_and_plain_on_the_card(
        dev, monkeypatch, M):
    """Under XLB_SANITIZE=1 the captured tick (M-way on a one-process
    mesh) drains bit-equal to the sanitized eager tick and to the plain
    captured tick, with a commit and a stalled lane midway; unsharded it
    reads its verdicts once a tick, sharded (no guard) never."""
    monkeypatch.setenv("XLB_SANITIZE", "1")
    got = _serve_record(dev, True, "host", True, shards=M)
    want = _serve_record(dev, False, "host", True, shards=M)
    monkeypatch.delenv("XLB_SANITIZE")
    plain = _serve_record(dev, True, "host", True, shards=M)
    assert got.pop("reads") == (got["ticks"] if M == 1 else 0)
    assert plain.pop("reads") == want.pop("reads") == 0
    assert got.pop("graphs") == plain.pop("graphs")
    want.pop("graphs")
    assert got == want
    assert got == plain
    assert len(got["done"]) == 64 and got["routing"]["version"] >= 1


def test_sanitized_leak_from_a_replay_raises_and_keeps_the_state(
        dev, monkeypatch):
    """A leak recorded in the arrival graph that fires from its second
    replay on (a device counter the body increments): that tick raises
    naming load-delta-conservation, no graph is captured anew, and the
    loop's tick count, routing, pool and metrics are as before it."""
    from repro_torch.configs import XLB_SERVICE_MODEL as cfg
    from repro_torch.core.interpose import Engine
    from repro_torch.models import model as M
    from repro_torch.runtime.serve_loop import Request, ServeLoop
    trigger = torch.zeros((), dtype=torch.int32, device=dev)
    real = route_match.admit_cuda

    def leaky(*a, **k):
        res = real(*a, **k)
        trigger.add_(1)
        return res._replace(ep_load=res.ep_load
                            + (trigger >= 3).to(torch.int32))

    monkeypatch.setattr(route_match, "admit_cuda", leaky)
    monkeypatch.setenv("XLB_SANITIZE", "1")
    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           torch.float32, dev)
    loop = ServeLoop(Engine(cfg, 8, 4, 8, device=dev), params,
                     _control_plane(), admit_batch=8)
    tick = loop.serve_step
    assert tick.sanitize
    for i in range(200):
        loop.submit(Request(req_id=i, service=i % 2, headers={},
                            prompt_token=3 + i))
    fields = lambda: {f"{n}.{g}": getattr(getattr(loop.state, n), g)  # noqa
                      .clone() for n in ("routing", "pool", "metrics")
                      for g in getattr(loop.state, n)._fields}
    for t in range(20):
        before, graphs_before = fields(), len(tick.graphs)
        try:
            loop.tick()
        except AssertionError as e:
            assert "XLB_SANITIZE[admit/load-delta-conservation]" in str(e)
            break
        assert int(trigger) < 3, f"tick {t}: the leak did not raise"
    else:
        pytest.fail("no tick raised")
    assert int(trigger) == 3 and len(tick.graphs) == graphs_before
    assert graphs_before >= 1 and loop.ticks == t
    after = fields()
    for k, v in before.items():
        assert torch.equal(after[k], v), k
    assert tick.verdict_reads == t + 1


def test_sharded_replayed_arrival_tick_launches_equal_the_profiler(dev):
    """One replayed arrival tick of the sharded tick (M = 4, shard 1
    idle): ``ops.LAUNCHES`` counts as many B3, B4, B5, B1 and B6 launches
    as the profiler sees kernels, B3 once a live shard."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import XLB_SERVICE_MODEL as cfg
    from repro_torch.core.interpose import Engine
    from repro_torch.launch.mesh import make_shard_mesh
    from repro_torch.models import model as M
    from repro_torch.runtime import graphs
    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           torch.float32, dev)
    eng = Engine(cfg, 8, 4, 8, device=dev, shards=4,
                 shard_mesh=make_shard_mesh(4, device=dev))
    tick = eng.make_jitted()
    assert isinstance(tick, graphs.StaticTick)
    state = eng.init_state(_control_plane().snapshot(), dtype=torch.float32)

    def batch(t):
        b, _, _ = _batch(16, t, "cpu")
        rid = torch.arange(16 * t, 16 * t + 16, dtype=torch.int32)
        rid[4:8] = -1                       # shard 1 of 4: padding only
        return b._replace(req_id=rid, svc=b.svc % 2)

    for t in range(2):                       # warm-up and capture, replay
        state, _ = tick(params, state, batch(t))
    assert len(tick.graphs) == 1
    names = {"admit": "admit_kernel", "route_match": "route_kernel",
             "relay_slots": "relay_kernel", "complete": "complete_kernel",
             "decode_attention": "decode_kernel"}
    torch.cuda.synchronize()
    n0 = {k: ops.LAUNCHES[k] for k in names}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        state, _ = tick(params, state, batch(2))
        torch.cuda.synchronize()
    assert len(tick.graphs) == 1             # a replay
    seen = dict.fromkeys(names, 0)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            for k, n in names.items():
                if n in e.name:
                    seen[k] += 1
    got = {k: ops.LAUNCHES[k] - n0[k] for k in names}
    assert got == seen, (got, seen)
    assert got == {"admit": 3, "route_match": 1, "relay_slots": 1,
                   "complete": 4, "decode_attention": cfg.n_layers}


def test_live_shards_of_a_card_batch_inside_a_capture_raises(dev):
    """The captured tick reads its live set from the host batch; a body
    that reads it from a batch on the card fails its capture loudly."""
    from repro_torch.kernels import shard_admit
    from repro_torch.runtime import graphs
    rid = torch.arange(8, dtype=torch.int32, device=dev)
    g = graphs.Graphs(dev)
    with pytest.raises(graphs.CaptureError, match="live_shards"):
        g.run("live", lambda: shard_admit.live_shards(rid, 2))
    assert len(g) == 0
    assert shard_admit.live_shards(rid, 2) == [True, True]   # outside one


@pytest.mark.parametrize("kind", ["istio", "cilium"])
def test_sidecar_captured_decode_equals_eager_on_the_card(dev, kind):
    """The sidecar's captured decode (``engine.decode``) against the eager
    decode step on a copy of its cache: the same argmax and cache on
    every step; one graph a cache."""
    from repro_torch.configs import XLB_SERVICE_MODEL as cfg
    from repro_torch.core.balancer import make_balancer
    from repro_torch.models import model as M
    I, C, L = 4, 4, 8
    eng = make_balancer(kind, cfg, I, C, L, device=dev)
    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           torch.float32, dev)
    st = eng.init_state(_control_plane().snapshot())
    caches = st.caches if kind == "istio" else [st.caches]
    copies = [_clone(c) for c in caches]
    rng = np.random.RandomState(1)
    for step in range(L - 1):
        for c, e in zip(caches, copies):
            B = c["blocks"]["self"]["k"].shape[1]
            tok = rng.randint(3, cfg.vocab, B).astype(np.int32)
            lens = np.full(B, step, np.int32)
            got = eng.decode(params, tok, lens, c)
            logits, _ = M.decode_step(
                cfg, params, torch.from_numpy(tok[:, None]).to(dev),
                torch.from_numpy(lens).to(dev), e)
            want = torch.argmax(logits, -1).to(torch.int32).cpu().numpy()
            np.testing.assert_array_equal(got, want, err_msg=f"step {step}")
    for c, e in zip(caches, copies):
        for a, b in zip(_leaves(c), _leaves(e)):
            assert torch.equal(a, b)
    assert len(eng.decode.graphs) == len(caches)


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def test_replayed_launches_equal_the_profiler_counts(dev):
    """Over a profiled window of captured ticks, ``ops.LAUNCHES`` counts
    as many B2, B1 and B6 launches as the profiler sees kernels."""
    _replayed_window(dev)


def test_sanitized_replayed_launches_equal_the_profiler_counts(
        dev, monkeypatch):
    """The same window through the sanitized captured tick: the laws run
    inside the graphs, the counts still equal the profiler's, one verdict
    read a tick."""
    monkeypatch.setenv("XLB_SANITIZE", "1")
    tick = _replayed_window(dev)
    assert tick.sanitize and tick.verdict_reads == 10


def _replayed_window(dev):
    """Four ticks (warm-up and capture), then six profiled replays of a
    ServeLoop over an 8 x 4 engine; the tick."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import XLB_SERVICE_MODEL as cfg
    from repro_torch.core.interpose import Engine
    from repro_torch.models import model as M
    from repro_torch.runtime.serve_loop import Request, ServeLoop
    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           torch.float32, dev)
    loop = ServeLoop(Engine(cfg, 8, 4, 8, device=dev), params,
                     _control_plane(), admit_batch=8)
    for i in range(200):
        loop.submit(Request(req_id=i, service=i % 2, headers={},
                            prompt_token=3 + i))
    for _ in range(4):                       # warm-up and capture
        loop.tick()
    torch.cuda.synchronize()
    names = {"admit_commit": "admit_kernel", "complete": "complete_kernel",
             "decode_attention": "decode_kernel"}
    n0 = {k: ops.LAUNCHES[k] for k in names}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(6):
            loop.tick()
        torch.cuda.synchronize()
    seen = dict.fromkeys(names, 0)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            for k, n in names.items():
                if n in e.name:
                    seen[k] += 1
    got = {k: ops.LAUNCHES[k] - n0[k] for k in names}
    assert got == seen and got["complete"] == 6, (got, seen)
    assert got["decode_attention"] == 6 * cfg.n_layers
    return loop.serve_step


# --------------------------------------------------------------------------- #
# the training step and the launcher's decode step as captured CUDA graphs
# --------------------------------------------------------------------------- #

#: the profiler's names of the kernels each wrapper launches
_KERNEL_NAMES = {"flash_attention": "flash_kernel", "ssd_scan": "ssd_",
                 "relay_slots": "relay_kernel",
                 "decode_attention": "decode_kernel"}


def _profiled_launches(fn, names):
    """(``ops.LAUNCHES`` added by ``fn()``, the profiler's count of each
    wrapper's kernels; an SSD launch of the bf16 build runs four)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    before = dict(ops.LAUNCHES)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    seen = dict.fromkeys(names, 0)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            for k in names:
                if _KERNEL_NAMES[k] in e.name:
                    seen[k] += 1
    return {k: ops.LAUNCHES[k] - before[k] for k in names}, seen


@pytest.mark.parametrize("remat", ["none", "block"])
@pytest.mark.parametrize("arch", ["whisper-large-v3", "jamba-v0.1-52b",
                                  "arctic-480b", "mamba2-2.7b"])
def test_captured_training_step_equals_eager_on_the_card(dev, arch, remat):
    """Three smoke training steps (f32) through ``StaticTrainStep`` (a
    warm-up, a capture, replays) and through the eager step from the same
    init and batches: losses and gradient norms within 1e-4; the
    replay's launches equal to the profiler's count of its kernels."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.data.pipeline import DataConfig, Pipeline
    from repro_torch.models import model as M
    from repro_torch.models.transformer import RunCtx
    from repro_torch.optim import adamw
    from repro_torch.runtime import graphs, train_loop
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = smoke_config(get_config(arch))
    pipe = Pipeline(DataConfig(
        vocab=cfg.vocab, seq_len=32, global_batch=2,
        enc_frames=cfg.enc_frames if cfg.is_encdec else 0,
        d_model=cfg.d_model))
    tcfg = train_loop.TrainConfig(steps=6, warmup=2,
                                  opt=adamw.AdamWConfig(lr=1e-2))
    step_fn = train_loop.make_train_step(cfg, RunCtx(remat=remat), tcfg)
    runs = {}
    for captured in (True, False):
        params = M.init_params(cfg, torch.Generator(dev).manual_seed(0),
                               torch.float32, dev)
        state = (params, adamw.init(params),
                 torch.zeros((max(cfg.moe.n_experts, 1),), device=dev))
        step = graphs.StaticTrainStep(step_fn, dev) if captured else step_fn
        hist = []
        for i in range(3):
            batch = pipe.batch_at(i)
            if not captured:
                batch = {k: torch.from_numpy(v).to(dev)
                         for k, v in batch.items()}
            *state, m = step(*state, batch)
            hist.append((float(m["loss"]), float(m["grad_norm"])))
        runs[captured] = hist
        if captured:
            assert len(step.graphs) == 1 and int(state[1].step) == 3
            names = [k for k in _KERNEL_NAMES if k != "decode_attention"]
            got, seen = _profiled_launches(
                lambda: step(*state, pipe.batch_at(3)), names)
            assert got == seen and sum(got.values()) > 0, (got, seen)
    np.testing.assert_allclose(runs[True], runs[False], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("arch", ["minitron-4b", "mamba2-2.7b",
                                  "arctic-480b", "deepseek-v2-236b",
                                  "jamba-v0.1-52b", "whisper-large-v3"])
def test_captured_model_decode_equals_eager_on_the_card(dev, arch):
    """The launcher's captured decode (smoke config, f32) against
    ``decode_eager`` from one prefill: the same tokens, the last logits
    within 1e-4; one graph; the replays' launches equal to the
    profiler's count of B6 and B5."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.launch import prefill_decode as PDL
    from repro_torch.models import model as M
    from repro_torch.runtime import graphs
    from repro_torch.tree import map_tree
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = smoke_config(get_config(arch))
    params = M.init_params(cfg, torch.Generator(dev).manual_seed(0),
                           torch.float32, dev)
    g = torch.Generator(dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (2, 64), generator=g, device=dev,
                           dtype=torch.int32)
    frames = torch.randn((2, cfg.enc_frames, cfg.d_model), generator=g,
                         device=dev) if cfg.is_encdec else None
    logits, cache, _ = PDL.prefill(cfg, params, tokens, 9, frames)
    twin = map_tree(torch.clone, cache)
    dec = graphs.StaticModelDecode(cfg, dev)
    got, glog = PDL.decode(cfg, params, logits, cache, 64, 8, dec)
    want, wlog = PDL.decode_eager(cfg, params, logits, twin, 64, 8)
    assert torch.equal(got, want)
    torch.testing.assert_close(glog, wlog, rtol=1e-4, atol=1e-4)
    assert len(dec.graphs) == 1
    dec.load(cache, glog, torch.full((2,), 64 + 8, dtype=torch.int32))
    got_n, seen = _profiled_launches(lambda: dec.step(params, cache),
                                     ["decode_attention", "relay_slots"])
    assert got_n == seen, (got_n, seen)


#: Minitron-4B's (K, N) at the gateway's decode: wq and wo, wk and wv,
#: w_in, w_out, the head
X9_SHAPES = [(3072, 3072), (3072, 1024), (3072, 9216), (9216, 3072),
             (3072, 256000)]


def _x9_inputs(dev, M, K, N):
    g = torch.Generator(device=dev).manual_seed(M * 7 + K + N)
    x = torch.randn((M, K), generator=g, device=dev)
    w = torch.randn((K, N), generator=g, device=dev) / K ** 0.5
    return x, w, dense_x9.X9Weight(w, dense_x9.split_planes(w))


@pytest.mark.parametrize("K,N", X9_SHAPES)
def test_dense_x9_error_at_most_twice_torch_matmul_f32(dev, K, N):
    """At 128 rows: the kernel's largest absolute error against float64 is
    at most twice that of ``torch.matmul`` in f32 (TF32 off); two launches
    are bitwise equal."""
    torch.backends.cuda.matmul.allow_tf32 = False
    x, w, h = _x9_inputs(dev, 128, K, N)
    assert ops.takes_x9(x, h)
    n0 = ops.LAUNCHES["dense_x9"]
    got = ops.dense(x, h)
    assert ops.LAUNCHES["dense_x9"] == n0 + 1
    want = x.double() @ w.double()
    err = float((got.double() - want).abs().max())
    lib = float(((x @ w).double() - want).abs().max())
    assert err <= 2 * lib, (err, lib)
    assert torch.equal(ops.dense(x, h), got)


def test_dense_x9_captured_replay_equals_the_eager_call(dev):
    x, _, h = _x9_inputs(dev, 128, 3072, 1024)
    want = ops.dense(x, h)
    graph, xs = torch.cuda.CUDAGraph(), x.clone()
    with torch.cuda.graph(graph):
        ys = ops.dense(xs, h)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(ys, want)


@pytest.mark.parametrize("M,K,N", [(1, 3072, 1024), (7, 100, 136),
                                   (200, 1024, 2048), (256, 4096, 1032),
                                   (64, 36, 8)])
def test_dense_x9_ragged_shapes_within_f32_accumulation(dev, M, K, N):
    """Rows, columns and depth off the tiles (zero-filled by TMA, masked
    at the store; one block a stage or one an SM): within the bound of
    f32 accumulation of the exact product, as the plain version."""
    x, w, h = _x9_inputs(dev, M, K, N)
    got = ops.dense(x, h)
    want = x.double() @ w.double()
    bound = 1.01 * (K + 9) * 2.0 ** -24 * (x.double().abs()
                                          @ w.double().abs())
    assert got.shape == (M, N)
    assert bool(((got.double() - want).abs() <= bound).all())
    plain = dense_x9.dense_x9(x, h.planes)
    assert bool(((plain.double() - want).abs() <= bound).all())


def test_dense_gate_keeps_the_plain_product_on_the_card(dev):
    """More than MAX_ROWS rows, a recorded gradient and a weight without
    planes take ``x @ W`` as PyTorch computes it, bitwise."""
    x, w, h = _x9_inputs(dev, 300, 1024, 1024)
    n0 = ops.LAUNCHES["dense_x9"]
    assert torch.equal(ops.dense(x, h), x @ w)
    xg = x[:8].clone().requires_grad_()
    assert torch.equal(ops.dense(xg, h), xg @ w)
    assert torch.equal(ops.dense(x[:8], w), x[:8] @ w)
    assert ops.LAUNCHES["dense_x9"] == n0


def test_captured_tick_keeps_each_params_planes_across_a_switch(
        dev, monkeypatch):
    """Params A, then B, then A again after an in-place update of A, on
    the service model with planes on every projection (the size gate
    lifted): each tick of the captured tick bit-equal to the eager
    tick's, pool and KV cache, so A's replay reads A's planes split again
    from the update; one set of planes a params object."""
    from repro_torch.configs import XLB_SERVICE_MODEL as cfg
    from repro_torch.core.interpose import Engine
    from repro_torch.models import model as M
    monkeypatch.setattr(dense_x9, "MIN_ELEMS", 1)
    A, B = (M.init_params(cfg, torch.Generator().manual_seed(s),
                          torch.float32, dev) for s in (0, 1))
    snap = _control_plane().snapshot()
    engs = [Engine(cfg, 8, 4, 8, device=dev) for _ in range(2)]
    steps = [engs[0].make_jitted(), engs[1].eager_step]
    states = [e.init_state(snap, dtype=torch.float32) for e in engs]

    def batch(t):
        b, _, _ = _batch(8, t, "cpu")
        rid = torch.arange(8 * t, 8 * t + 8, dtype=torch.int32)
        return b._replace(req_id=rid, svc=b.svc % 2)

    n0 = ops.LAUNCHES["dense_x9"]
    for t, (params, update) in enumerate([(A, False), (A, False),
                                          (B, False), (A, True),
                                          (A, False)]):
        if update:
            with torch.no_grad():
                A["head"].copy_(B["head"])
                A["blocks"]["attn"]["wk"].mul_(1.5)
        for i in range(2):
            states[i], _ = steps[i](params, states[i], batch(t))
        torch.cuda.synchronize()
        _equal_fields(states[0].pool, states[1].pool, f"tick {t}")
        for g, w in zip(torch.utils._pytree.tree_leaves(states[0].cache),
                        torch.utils._pytree.tree_leaves(states[1].cache)):
            assert torch.equal(g, w), f"tick {t} cache"
    assert len(steps[0].graphs) == 2         # A's and B's
    per_set = sum(3 * 2 * t.numel() for t in
                  [*A["blocks"]["attn"].values(),
                   *A["blocks"]["ffn"].values(), A["head"]])
    for e in engs:
        assert len(e._planed) == 2 and e.plane_bytes == 2 * per_set
    assert ops.LAUNCHES["dense_x9"] > n0

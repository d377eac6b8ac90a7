"""The hand-written CUDA kernels against their plain PyTorch versions on the
card: admission, completion, the route match and the relay slot
assignment bit-exact on every integer output and both f32 EWMAs; decode
attention, flash attention and the SSD scan within the tolerances of
``tests/test_kernels.py`` (f32 2e-5, the SSD's f32 recurrence 2e-4; bf16
rtol 2e-2 with atol 2e-2 times the output's RMS).  Needs a CUDA device and nvcc: ``PYTHONPATH=src python -m pytest
-q -m gpu tests/test_torch_cuda.py``; skipped without a card."""

import numpy as np
import pytest
import torch

from repro_torch.core import routing_table as RT
from repro_torch.core.balancer import PoolState, RequestBatch
from repro_torch.kernels import (_build, completion, decode_attention,
                                 flash_attention, ops, relay_dispatch,
                                 route_match, ssd_scan)

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


def _check_admit(reqs, routing, pool, rnd, gum, free):
    """Both kernels through ops against their plain versions, bit-exact on
    every output; returns the plain commit result."""
    n0 = ops.LAUNCHES["admit_commit"]
    k = ops.admit_commit(reqs, routing, pool, rnd, gum)
    assert ops.LAUNCHES["admit_commit"] == n0 + 1
    p = route_match.admit_commit(reqs.req_id, reqs.svc, reqs.features,
                                 reqs.msg_bytes, reqs.token, routing,
                                 *pool[:5], pool.active, rnd, gum)
    for f in route_match.AdmitResult._fields:
        assert torch.equal(getattr(k, f), getattr(p, f)), f
    for f, pf in zip(PoolState._fields, route_match.AdmitCommitResult
                     ._fields[13:]):
        assert torch.equal(getattr(k.pool, f), getattr(p, pf)), f
    n0 = ops.LAUNCHES["admit"]
    k2 = ops.admit(reqs, routing, free, rnd, gum)
    assert ops.LAUNCHES["admit"] == n0 + 1
    p2 = route_match.admit(reqs.req_id, reqs.svc, reqs.features,
                           reqs.msg_bytes, routing, free, rnd, gum)
    for f in route_match.AdmitResult._fields:
        assert torch.equal(getattr(k2, f), getattr(p2, f)), f
    torch.cuda.synchronize()
    return p


# 4096 rows: 16 tiles carrying the counters from one to the next
@pytest.mark.parametrize("R,I,C", [(256, 64, 16), (300, 16, 4), (7, 2, 2),
                                   (4096, 64, 16)])
def test_admit_kernels_match_plain(dev, R, I, C):
    routing = _routing(dev, R)
    reqs, rnd, gum = _batch(R, R + 1, dev)
    pool, g = _pool(I, C, R, dev)
    free = (torch.rand((I, C), generator=g) < 0.6).int().to(dev) * 3
    _check_admit(reqs, routing, pool, rnd, gum, free)


def _rows_to(reqs, svc, rows, dev):
    """``reqs`` with ``rows`` sent to service ``svc``'s first rule (the
    "v2" header, cluster c<svc>)."""
    s, f = reqs.svc.clone(), reqs.features.clone()
    s[rows] = svc
    f[rows, 0] = RT.fnv1a("v2")
    return reqs._replace(svc=s.to(dev), features=f.to(dev))


@pytest.mark.parametrize("case", ["least_request_all_rows", "full_pool",
                                  "rogue_svc", "stale_maglev",
                                  "affinity_same_flow", "nan_gumbel"])
def test_admit_kernels_match_plain_at_the_edges(dev, case):
    """The policies' corner cases, each bit-exact in both modes: a tile
    whose 256 rows all go to one least-request cluster (in-tile ranks up
    to 255 on the water-fill), a full pool (every routable row held),
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
    p = _check_admit(reqs, routing, pool, rnd, gum, free)
    pol = routing.cluster_policy[p.cluster[p.cluster >= 0].long()]
    if case == "least_request_all_rows":
        assert set(pol.tolist()) == {2} and bool((p.cluster >= 0).all())
    if case == "full_pool":
        assert int(p.ok.sum()) == 0 and int(p.held) > 0


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


@pytest.mark.parametrize("arch", ["minitron-4b", "mamba2-2.7b"])
def test_prefill_decode_smoke_configs_on_the_card(dev, arch):
    """The launcher's reduced config (hd 16; mamba's N 16) on the card:
    finite logits, every attention or SSD call through its kernel."""
    from repro_torch.launch import prefill_decode
    before = dict(ops.LAUNCHES)
    res = prefill_decode.main(["--smoke", "--arch", arch, "--batch", "2",
                               "--prompt", "64", "--steps", "4"])
    assert bool(torch.isfinite(res["logits"]).all())
    runs = {k: ops.LAUNCHES[k] - before[k] for k in before}
    if arch == "mamba2-2.7b":
        assert runs["ssd_scan"] == 2                # 2 layers, one prefill
    else:
        assert runs["flash_attention"] == 2 and runs["decode_attention"] == 8


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


@pytest.mark.parametrize("W", [1, 64, 256, 1024, 4096])
def test_admit_all_free_mode_matches_plain(dev, W):
    """The commit-free kernel against an all-free pool of width W, staging
    nothing of it, bit-exact against the plain version in the same mode,
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
                               pool_shape=(I, W))
    assert ops.LAUNCHES["admit"] == n0              # counted by its callers
    cpu = [t.cpu() for t in (*args, rnd, gum)]
    rcpu = routing.to("cpu")
    p = route_match.admit(*cpu[:4], rcpu, None, *cpu[4:], pool_shape=(I, W))
    ones = torch.ones((I, W), dtype=torch.int32)
    m = route_match.admit(*cpu[:4], rcpu, ones, *cpu[4:])
    for f in route_match.AdmitResult._fields:
        assert torch.equal(getattr(k, f).cpu(), getattr(p, f)), f
        assert torch.equal(getattr(p, f), getattr(m, f)), f
    if W <= 256:
        k2 = route_match.admit_cuda(*args, None, routing, ones.bool().to(dev),
                                    None, rnd, gum)
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

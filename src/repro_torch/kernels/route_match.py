"""Fused admission datapath (twin of ``repro/kernels/route_match.py``).

Rule match → per-cluster policy dispatch → endpoint selection with
sequentially consistent load counters → free-slot allocation → fused
per-service metrics, and in commit mode the pool write-back.  The batch is
walked in tiles of ``block_r`` rows; every decision in a tile reads the
counters as the previous tile left them (the tile-start snapshot), and the
in-tile ranks are stable arrival-order ranks, so results do not depend on
the tile size.

``admit`` / ``admit_commit`` here are the plain PyTorch versions;
``admit_cuda`` launches ``csrc/admit.cu`` (one template, the tile and
``commit`` compile-time parameters, built at each of ``TILES``, and a
commit-free mode against an all-free pool for the sharded admission; O(1)
work per row: ranks by warp match, least request from per-cluster ticket
tables, tables staged in shared memory).
``route_match`` is the stateless building block
(rule match + least-request argmin, no drain mask, no counters) and
``route_match_cuda`` launches ``csrc/route.cu``; both kernels share the
match stage ``csrc/match.cuh``.  ``kernels/ops.py`` picks a version by the
tensors' device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import policy_defs
from repro_torch.core.policy_defs import BIG, POLICY_RR
from repro_torch.core.routing_table import (MAX_EPS_PER_CLUSTER,
                                            MAX_RULES_PER_SVC, WILDCARD)
from repro_torch.kernels import _build
from repro_torch.kernels._build import as_f32, as_i32

#: the default tile rows (``kernels/tune.py``'s static plan)
TILE = 256
#: the tiles ``csrc/admit.cu`` is built for (its ``kTile``): every
#: candidate of the autotuner's sweep
TILES = (64, 256, 1024)
#: shared memory one block may opt in to on sm_90 (227 KB)
SMEM_OPTIN = 232448
_INT32_MIN = -2**31


class AdmitResult(NamedTuple):
    """Everything ``Engine.admit`` needs from one admission launch."""

    cluster: torch.Tensor       # (R,) i32 destination cluster (-1 = none)
    endpoint: torch.Tensor      # (R,) i32 global endpoint (-1 = unroutable)
    instance: torch.Tensor      # (R,) i32 instance lane (-1 = unroutable)
    slot: torch.Tensor          # (R,) i32 pool slot (-1 = held/unroutable)
    ok: torch.Tensor            # (R,) i32 1 = admitted into a pool slot
    ep_load: torch.Tensor       # (E,) i32 updated outstanding requests
    rr_cursor: torch.Tensor     # (CL,) i32 updated round-robin cursors
    svc_requests: torch.Tensor  # (S,) i32 admitted requests per service
    svc_tx_bytes: torch.Tensor  # (S,) i32 admitted payload bytes
    no_route: torch.Tensor      # () i32 valid requests with no rule match
    held: torch.Tensor          # () i32 routable requests without a slot
    aff_key: torch.Tensor       # (A,) i32 updated affinity cache
    aff_ep: torch.Tensor        # (A,) i32


class AdmitCommitResult(NamedTuple):
    """``AdmitResult`` plus the committed (I, C) connection pool."""

    cluster: torch.Tensor
    endpoint: torch.Tensor
    instance: torch.Tensor
    slot: torch.Tensor
    ok: torch.Tensor
    ep_load: torch.Tensor
    rr_cursor: torch.Tensor
    svc_requests: torch.Tensor
    svc_tx_bytes: torch.Tensor
    no_route: torch.Tensor
    held: torch.Tensor
    aff_key: torch.Tensor
    aff_ep: torch.Tensor
    pool_req_id: torch.Tensor   # (I, C) i32
    pool_endpoint: torch.Tensor
    pool_svc: torch.Tensor
    pool_length: torch.Tensor
    pool_token: torch.Tensor
    pool_active: torch.Tensor   # (I, C) bool


def _seg_rank(ids, mask):
    """In-tile arrival rank of each row among masked rows sharing its id
    (rows with mask False get an arbitrary rank; callers gate on it)."""
    n = ids.shape[0]
    same = (ids[:, None] == ids[None, :]) & mask[None, :]
    earlier = torch.ones((n, n), dtype=torch.bool,
                         device=ids.device).tril(-1)
    return (same & earlier).sum(dim=1)


def _bincount(ids, n, weights=None):
    out = torch.zeros((n,), dtype=torch.int64, device=ids.device)
    return out.index_add_(0, ids, torch.ones_like(ids)
                          if weights is None else weights)


def _match(svc_c, feats, t):
    """Bounded rule-chain walk: first matching rule → cluster (-1 none)."""
    F = feats.shape[1]
    win = torch.arange(MAX_RULES_PER_SVC, device=feats.device)
    idx = (t["rs"][svc_c][:, None] + win).clamp(0, t["rf"].shape[0] - 1)
    in_range = win < t["rc"][svc_c][:, None]
    fields = t["rf"][idx]
    expect = t["rv"][idx]
    col = torch.where(fields < 0, fields + F, fields)   # negative wraps once
    inside = (col >= 0) & (col < F)
    actual = torch.where(inside, feats.gather(1, col.clamp(0, F - 1)),
                         _INT32_MIN)                    # gather fill value
    hit = in_range & ((expect == WILDCARD) | (expect == actual))
    first = torch.argmax(hit.to(torch.int32), dim=1)
    rix = idx.gather(1, first[:, None])[:, 0]
    return torch.where(hit.any(dim=1), t["rcl"][rix], -1)


def _admit_plain(req_id, svc, features, msg_bytes, token, state, free,
                 pool, rnd, gumbel, block_r: int, pool_shape=None):
    """Shared body of ``admit`` (pool None) and ``admit_commit``.
    ``free``: (I, C) bool, True = free slot; None (``admit`` only): an
    all-free pool of ``pool_shape`` (I, W), where a row's slot is its
    arrival rank on its instance."""
    dev = features.device
    i64 = lambda x: x.to(torch.int64)
    t = dict(rs=i64(state.svc_rule_start), rc=i64(state.svc_rule_count),
             rf=i64(state.rule_field), rv=i64(state.rule_value),
             rcl=i64(state.rule_cluster))
    cs, cc = i64(state.cluster_ep_start), i64(state.cluster_ep_count)
    cp, einst = i64(state.cluster_policy), i64(state.ep_instance)
    ew, ed = state.ep_weight.to(torch.float32), i64(state.ep_drained)
    mg = i64(state.maglev_table)
    R = features.shape[0]
    S, CL, E = t["rs"].shape[0], cs.shape[0], ed.shape[0]
    A = state.aff_key.shape[0]
    I, C = free.shape if free is not None else pool_shape
    WE = MAX_EPS_PER_CLUSTER

    loads, cur = i64(state.ep_load), i64(state.rr_cursor)
    affk, affe = i64(state.aff_key), i64(state.aff_ep)
    held_e = torch.zeros((E,), dtype=torch.int64, device=dev)
    icnt = torch.zeros((I,), dtype=torch.int64, device=dev)
    sreq = torch.zeros((S,), dtype=torch.int64, device=dev)
    stx = torch.zeros((S,), dtype=torch.int64, device=dev)
    no_route = torch.zeros((), dtype=torch.int64, device=dev)
    held_n = torch.zeros((), dtype=torch.int64, device=dev)

    rid_all, svc_all = i64(req_id), i64(svc)
    feats_all, bytes_all = i64(features), i64(msg_bytes)
    fkey_all = policy_defs.flow_hash(features)
    rnd_all, gum_all = i64(rnd), gumbel.to(torch.float32)
    if free is not None:
        free_i = free.to(torch.int64)
        fprefix = torch.cumsum(free_i, dim=1)
        n_free = fprefix[:, C - 1]
    outs = {k: torch.full((R,), -1, dtype=torch.int64, device=dev)
            for k in ("cluster", "ep", "inst", "slot")}
    ok_out = torch.zeros((R,), dtype=torch.int64, device=dev)
    if pool is not None:
        pool = [p.to(torch.int32).clone() for p in pool]
        pact = ~free
    ewin = torch.arange(WE, device=dev)

    for t0 in range(0, R, block_r):
        sl = slice(t0, min(t0 + block_r, R))
        rid, svc_raw = rid_all[sl], svc_all[sl]
        valid = rid >= 0
        svc_c = svc_raw.clamp(0, S - 1)
        cluster = torch.where(valid, _match(svc_c, feats_all[sl], t), -1)
        cl = cluster.clamp(0, CL - 1)
        count, estart, policy = cc[cl], cs[cl], cp[cl]
        eidx = (estart[:, None] + ewin).clamp(0, E - 1)
        eok = (ewin < count[:, None]) & (ed[eidx] == 0)
        cnt2 = eok.sum(dim=1)
        routable = valid & (cluster >= 0) & (cnt2 > 0)
        cum_e = torch.cumsum(eok.to(torch.int64), dim=1)

        def kth(k, eok=eok, cum_e=cum_e):
            return torch.argmax((eok & (cum_e == (k + 1)[:, None]))
                                .to(torch.int32), dim=1)

        ctx = policy_defs.KernelCtx(
            block_r=block_r, policy=policy, cl=cl, routable=routable,
            rank_c=_seg_rank(cl, routable), estart=estart, count=count,
            cnt1=cnt2.clamp_min(1), cnt2=cnt2, eidx=eidx, eok=eok,
            rnd=rnd_all[sl], fkey=fkey_all[sl], gum=gum_all[sl],
            loads=loads, ew=ew, ed=ed, cur_cl=cur[cl], mg_tab=mg,
            aff_key=affk, aff_ep=affe, kth=kth,
            seg_rank=lambda ids, m, n: _seg_rank(ids, m))
        off = policy_defs.BY_ENUM[POLICY_RR].kernel_offset(ctx)  # unknown → rr
        for p in policy_defs.REGISTRY:
            if p.enum != POLICY_RR:
                off = torch.where(policy == p.enum, p.kernel_offset(ctx), off)
        inside = (off >= 0) & (off < WE)
        ep = torch.where(inside,
                         eidx.gather(1, off.clamp(0, WE - 1)[:, None])[:, 0],
                         _INT32_MIN)
        ep = torch.where(routable, ep, -1)
        epc = ep.clamp_min(0)
        inst = torch.where(routable, einst[epc], -1)
        instc = inst.clamp(0, I - 1)

        rank_i = icnt[instc] + _seg_rank(instc, routable)
        if free is None:       # all free: the k-th free slot is slot k
            ok = routable & (rank_i < C)
            slot = torch.where(ok, rank_i, -1)
        else:
            ok = routable & (rank_i < n_free[instc])
            hit = (free_i[instc] > 0) \
                & (fprefix[instc] == (rank_i + 1)[:, None])
            slot = torch.where(ok, torch.argmax(hit.to(torch.int32), dim=1),
                               -1)
        held = routable & ~ok
        outs["cluster"][sl], outs["ep"][sl] = cluster, ep
        outs["inst"][sl], outs["slot"][sl] = inst, slot
        ok_out[sl] = ok.to(torch.int64)

        if pool is not None:   # one writer per cell by construction
            ii, ss = instc[ok], slot[ok]
            for p, v in zip(pool, (rid, ep, svc_raw, torch.zeros_like(rid),
                                   i64(token[sl]))):
                p[ii, ss] = v[ok].to(torch.int32)
            pact[ii, ss] = True

        affk, affe = policy_defs.affinity_kernel_update(ctx, ep)
        loads = loads + _bincount(epc[routable], E)
        held_e = held_e + _bincount(epc[held], E)
        cur = cur + _bincount(cl[routable], CL)
        icnt = icnt + _bincount(instc[routable], I)
        counted = ok & (svc_raw < S)          # metrics drop svc >= S
        sreq = sreq + _bincount(svc_c[counted], S)
        stx = stx + _bincount(svc_c[counted], S, bytes_all[sl][counted])
        no_route = no_route + (valid & (cluster < 0)).sum()
        held_n = held_n + held.sum()

    i32 = lambda x: x.to(torch.int32)
    head = (i32(outs["cluster"]), i32(outs["ep"]), i32(outs["inst"]),
            i32(outs["slot"]), i32(ok_out), i32(loads - held_e),
            i32(cur % cc.clamp_min(1)), i32(sreq), i32(stx), i32(no_route),
            i32(held_n), i32(affk), i32(affe))
    if pool is None:
        return AdmitResult(*head)
    return AdmitCommitResult(*head, *pool, pact)


def admit(req_id, svc, features, msg_bytes, state, free_mask, rnd, gumbel,
          *, block_r: int = TILE, pool_shape=None) -> AdmitResult:
    """Plain PyTorch admission over a request batch (no pool write-back).

    req_id/svc/msg_bytes/rnd: (R,) int (req_id < 0 = padding; rnd = host
    PRNG draws for the random policy); features: (R, F) int;
    gumbel: (R, MAX_EPS_PER_CLUSTER) f32; state: RoutingState;
    free_mask: (I, C), nonzero = free slot, or None with ``pool_shape``
    (I, W): an all-free pool, the same function as an all-ones mask.
    """
    free = None if free_mask is None else free_mask != 0
    if free is None and pool_shape is None:
        raise ValueError("an all-free admission needs pool_shape=(I, W)")
    return _admit_plain(req_id, svc, features, msg_bytes, None, state,
                        free, None, rnd, gumbel, block_r, pool_shape)


def admit_commit(req_id, svc, features, msg_bytes, token, state,
                 pool_req_id, pool_endpoint, pool_svc, pool_length,
                 pool_token, pool_active, rnd, gumbel, *,
                 block_r: int = TILE) -> AdmitCommitResult:
    """``admit`` with the free mask taken from ``pool_active`` (inactive =
    free) plus the pool write-back: each admitted request writes
    req_id/endpoint/svc/length=0/token/active=1 at its (instance, slot)."""
    pool = (pool_req_id, pool_endpoint, pool_svc, pool_length, pool_token)
    return _admit_plain(req_id, svc, features, msg_bytes, token, state,
                        pool_active == 0, pool, rnd, gumbel, block_r)


#: bytes of shared memory per admission launch, by its table sizes and tile
_SMEM: dict[tuple, int] = {}


def kernel_tile(block_r: int, R: int) -> int:
    """The tile of ``csrc/admit.cu`` that walks ``R`` rows in tiles of
    ``block_r``: ``block_r`` where it is one of ``TILES``; where
    ``block_r >= R`` the batch is one tile, which any tile of at least
    ``R`` rows walks the same, so the smallest such.  Raises
    ``ValueError`` for any other ``block_r`` (the plain versions take it;
    the kernel is not built for it)."""
    if block_r in TILES:
        return block_r
    if 0 < R <= block_r:
        fit = [t for t in TILES if t >= R]
        if fit:
            return fit[0]
    raise ValueError(f"the admission kernel walks tiles of {TILES} rows "
                     f"(or one tile of at most {TILES[-1]}); block_r = "
                     f"{block_r} over {R} rows is none of them")


def admit_smem_bytes(state, I: int, C: int, F: int, all_free: bool,
                     tile: int, device) -> int:
    """Bytes of shared memory one launch of ``csrc/admit.cu`` at ``tile``
    takes for ``state``'s tables over an (I, C) pool (cached)."""
    key = (state.ep_load.shape[0], state.cluster_ep_count.shape[0],
           state.svc_rule_start.shape[0], state.rule_field.shape[0],
           state.aff_key.shape[0], I, C, F, int(all_free), tile)
    smem = _SMEM.get(key)
    if smem is None:
        smem = _SMEM[key] = _build.library(device).xlb_admit_smem_bytes(*key)
    return smem


def admit_cuda(req_id, svc, features, msg_bytes, token, state, free, pool,
               rnd, gumbel, *, block_r: int = TILE, pool_shape=None):
    """Launch ``csrc/admit.cu`` on the tensors' CUDA device.

    ``free`` is the (I, C) free mask (bool, or int with nonzero = free) in
    both modes.  ``free`` None with ``pool_shape`` (I, W) and ``pool``
    None: the all-free mode of the commit-free kernel, which stages no
    mask (a row's slot is its arrival rank on its instance).  ``pool``
    None: the commit-free kernel, and the result an ``AdmitResult``.  Otherwise ``pool`` is the five incoming (I, C) int
    fields, the committed pool is active where ``free`` is not or where a
    request was admitted, and the result an ``AdmitCommitResult``.  Inputs
    that are contiguous and of the kernel's type are passed as they are;
    all int32 outputs are views of one allocation.  ``block_r``: the rows
    of a tile, as in the plain versions; ``kernel_tile`` picks the build
    (it raises ``ValueError`` for a ``block_r`` no build walks).  Raises
    if the shapes do not fit the kernel (a launch past ``SMEM_OPTIN``
    bytes of shared memory raises ``ValueError`` before it is made), the
    library cannot be built or the launch fails.  The caller skips empty
    batches.
    """
    commit = pool is not None
    all_free = free is None
    if all_free and (commit or pool_shape is None):
        raise ValueError("the all-free mode is commit-free and needs "
                         "pool_shape=(I, W)")
    R, F = features.shape
    I, C = pool_shape if all_free else free.shape
    S = state.svc_rule_start.shape[0]
    NR = state.rule_field.shape[0]
    CL = state.cluster_ep_count.shape[0]
    E = state.ep_load.shape[0]
    A = state.aff_key.shape[0]
    T = state.maglev_table.shape[1]
    if R == 0:
        raise ValueError("empty batch: the caller passes it through")
    if gumbel.shape != (R, MAX_EPS_PER_CLUSTER):
        raise ValueError(f"gumbel must be {(R, MAX_EPS_PER_CLUSTER)}")
    if C > 0xFFFF and not all_free:
        raise ValueError(f"admit keeps slot numbers in 16 bits; C = {C}")
    tile = kernel_tile(block_r, R)
    dev = features.device
    lib = _build.library(dev)
    smem = admit_smem_bytes(state, I, C, F, all_free, tile, dev)
    if smem > SMEM_OPTIN:
        raise ValueError(
            f"admit at tile {tile} needs {smem} B of shared memory for "
            f"tables of sizes (E, CL, S, NR, A, I, C, F) = "
            f"{(E, CL, S, NR, A, I, C, F)}; a block has {SMEM_OPTIN} B")
    reqs = [as_i32(req_id), as_i32(svc), as_i32(features), as_i32(msg_bytes),
            as_i32(rnd), as_f32(gumbel)]
    tok = as_i32(token) if commit else None
    tabs = [as_i32(x) for x in (state.svc_rule_start, state.svc_rule_count,
                                state.rule_field, state.rule_value,
                                state.rule_cluster, state.cluster_ep_start,
                                state.cluster_ep_count, state.cluster_policy,
                                state.ep_instance)]
    ew = as_f32(state.ep_weight)
    rest = [as_i32(x) for x in (state.ep_drained, state.ep_load,
                                state.rr_cursor, state.maglev_table,
                                state.aff_key, state.aff_ep)]
    masks = []
    if not all_free:
        fm = free if free.dtype == torch.bool else free != 0
        masks = [fm if fm.is_contiguous() else fm.contiguous()]
    pool_in = [as_i32(p) for p in pool] if commit else []
    _build.check_device(dev, *reqs, *tabs, ew, *rest, *masks, *pool_in,
                        *([tok] if commit else []))
    shapes = [(n,) for n in [R] * 5 + [E, CL, S, S, 2, A, A]] \
        + ([(I, C)] * 5 if commit else [])
    outs = _build.packed(shapes, torch.int32, dev)
    per_req, carried = outs[:5], outs[5:12]
    pool_out = outs[12:] + [torch.empty(
        (I, C), dtype=torch.bool, device=dev)] if commit else []
    p = _build.ptr
    maybe = lambda xs, n: [p(x) for x in xs] if xs else [None] * n
    rs, rc, rf, rv, rcl, cs, cc, cp, einst = tabs
    ed, load0, cur0, mg, affk0, affe0 = rest
    err = lib.xlb_admit(
        *[p(x) for x in reqs], p(tok) if commit else None, R, F,
        p(rs), p(rc), p(rf), p(rv), p(rcl), S, NR,
        p(cs), p(cc), p(cp), CL,
        p(einst), p(ew), p(ed), p(load0), E,
        p(cur0), p(mg), T, p(affk0), p(affe0), A,
        p(masks[0]) if masks else None, I, C,
        *maybe(pool_in, 5), *[p(x) for x in per_req],
        *[p(x) for x in carried], *maybe(pool_out, 6),
        int(commit), tile, _build.stream(dev))
    _build.check(err, "admit_commit" if commit else "admit")
    cnt = carried[4]
    head = (*per_req, *carried[:4], cnt[0], cnt[1], carried[5], carried[6])
    if commit:
        return AdmitCommitResult(*head, *pool_out)
    return AdmitResult(*head)


# --------------------------------------------------------------------------- #
# route_match: match + least-request scan (stateless building block)
# --------------------------------------------------------------------------- #


def _route_tables(state):
    return [state.svc_rule_start, state.svc_rule_count, state.rule_field,
            state.rule_value, state.rule_cluster, state.cluster_ep_start,
            state.cluster_ep_count, state.ep_load]


def route_match(svc, features, state) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch route match.  svc: (R,) int; features: (R, F) int;
    state: RoutingState.  Returns (cluster (R,) i32, endpoint (R,) i32).

    svc is clamped to [0, S-1] and the matched cluster to [0, CL-1]; the
    endpoint is the first least-loaded lane of the cluster's 64-lane
    window (lanes past its count at ``BIG``), -1 where no rule matched or
    the cluster is empty.  No drain mask."""
    rs, rc, rf, rv, rcl, cs, cc, load = [t.to(torch.int64)
                                         for t in _route_tables(state)]
    S, CL, E = rs.shape[0], cs.shape[0], load.shape[0]
    t = dict(rs=rs, rc=rc, rf=rf, rv=rv, rcl=rcl)
    cluster = _match(svc.to(torch.int64).clamp(0, S - 1),
                     features.to(torch.int64), t)
    cl = cluster.clamp(0, CL - 1)
    start, count = cs[cl], cc[cl]
    win = torch.arange(MAX_EPS_PER_CLUSTER, device=features.device)
    eidx = (start[:, None] + win).clamp(0, E - 1)
    lanes = torch.where(win < count[:, None], load[eidx], BIG)
    best = torch.argmin(lanes, dim=1)                 # the first minimum
    ep = eidx.gather(1, best[:, None])[:, 0]
    ep = torch.where((cluster >= 0) & (count > 0), ep, -1)
    return cluster.to(torch.int32), ep.to(torch.int32)


def route_match_cuda(svc, features, state):
    """Launch ``csrc/route.cu`` on the tensors' CUDA device; same contract
    and result as ``route_match``.  The two outputs are the rows of one
    (2, R) int32 allocation.  Raises if the library cannot be built or the
    launch fails.  The caller skips empty batches."""
    R, F = features.shape
    if R == 0 or svc.shape != (R,):
        raise ValueError(f"svc must be ({R},) and R > 0")
    dev = features.device
    x = [as_i32(svc), as_i32(features)]
    tabs = [as_i32(t) for t in _route_tables(state)]
    _build.check_device(dev, *x, *tabs)
    lib = _build.library(dev)
    rs, rc, rf, rv, rcl, cs, cc, load = tabs
    S, NR, CL, E = rs.shape[0], rf.shape[0], cs.shape[0], load.shape[0]
    out = torch.empty((2, R), dtype=torch.int32, device=dev)
    p = _build.ptr
    err = lib.xlb_route(p(x[0]), p(x[1]), R, F,
                        p(rs), p(rc), p(rf), p(rv), p(rcl), S, NR,
                        p(cs), p(cc), CL, p(load), E,
                        p(out), p(out) + 4 * R, _build.stream(dev))
    _build.check(err, "route_match")
    return out[0], out[1]

"""Mesh-sharded admission and completion: many ingress hosts feed one
fleet (twin of ``repro/kernels/shard_admit.py``).

The admission batch splits ``(R/M,)`` over a mesh axis and the pool
``(I/M,)``; the routing tables are replicated.  Each shard runs the
admission kernel without the commit (B3, ``csrc/admit.cu``) against an
all-free pool (its all-free mode: no mask staged), then ONE collective
pass reconciles.  The result is
bit-exact against single-shard ``admit_commit`` on the concatenated batch
under the shard-major merge rule: shard 0's rows come first, shard 1's
follow, as if one host had ingested the concatenation (the reference's
``ref.admit_sharded_ref`` pins it).  Across shards the kernels' carried
counters are replaced by offsets of their inputs, from a closed form of
the preceding shards' per-cluster routable counts:

  * rr cursors carry raw counts: shard m starts from ``rr_cursor + prev``
    and the final cursor is ``(rr_cursor + total) mod window``;
  * least-request loads advance by a water-fill (``waterfill_lr``): the
    loads after k sequential admissions to a cluster depend only on k;
  * random and weighted read per-row draws, split with the rows;
  * slots: against an all-free pool the kernel's ``slot`` IS the local
    arrival rank per instance; global ranks (the preceding shards' counts
    plus the local rank) are matched against the true free mask, which
    also decides the held rows.

Loads, held releases, per-service metrics and the ``no_route``/``held``
counts are ``psum``-reconciled; the affinity caches merge lowest shard
first; pool commits travel to their owner shards through the relay
kernel's counting sort (B5, ``ops.relay_slots``) and one ``all_to_all``
hop.

One body serves both shard meshes of ``launch/mesh.py``: a ``ShardMesh``,
where one process drives all M shards on one device, as the reference's
``shard_map`` does, and a ``RankShardMesh``, one rank of a process group a
shard.  Per-shard values are stacked on a leading axis of the shards this
process holds (``mesh.held``: all M, or the rank's own), and the
collectives are the mesh's.  Work that needs no collective and no
per-shard kernel runs once over the held rows: the route match of phase 1
(B4 through ``router.match_cluster``; it is stateless), the water-fill
search of phase 2 and the pool commits' sort.  The admission kernel runs
once per held shard that holds a valid row; an all-padding shard launches
nothing (the reference's ``lax.cond`` skip) but joins every collective.
Which shards hold one is read from the host batch (``live_shards``), so
the choice costs no device sync; a captured tick
(``runtime/graphs.py::StaticTick``) keys its programs by that set.
Everything else the body decides on the host comes from shapes (the
water-fill's ``k_max``, the tiles) or from caches the first, eager call
fills (the admission plan of ``kernels/tune.py``), so the body captures.

Completion: B1 (``csrc/complete.cu``) on each ``(I/M, C)`` pool slice with
zero bases, so its counts are the shard's deltas; a ``psum`` of the
integer counts; then ONE ``completion.health_update`` on the global
counts, which rounds as B1's epilogue does: the f32 EWMAs are bit-exact
for any M.
"""

from __future__ import annotations

import torch

from repro_torch.core import policy_defs, relay, router
from repro_torch.core.policy_defs import BIG
from repro_torch.core.routing_table import MAX_EPS_PER_CLUSTER
from repro_torch.kernels import completion as _cp
from repro_torch.kernels import ops
from repro_torch.kernels import route_match as _rm
from repro_torch.kernels.completion import CompleteResult
from repro_torch.kernels.route_match import AdmitCommitResult, AdmitResult

I32, I64 = torch.int32, torch.int64


def cluster_windows(state) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-cluster endpoint windows: (ceidx (CL, WE) int64, ceok (CL, WE)
    bool).  ``ceok`` marks lanes that are in-window AND not draining: the
    eligible set every selection path uses."""
    E = state.ep_load.shape[0]
    win = torch.arange(MAX_EPS_PER_CLUSTER, device=state.ep_load.device)
    ceidx = (state.cluster_ep_start.to(I64)[:, None] + win).clamp(0, E - 1)
    ceok = (win < state.cluster_ep_count[:, None]) \
        & (state.ep_drained[ceidx] == 0)
    return ceidx, ceok


def waterfill_lr(state, k_cl, k_max: int | None = None) -> torch.Tensor:
    """``ep_load`` after sequentially admitting ``k_cl[..., c]`` requests
    into each LEAST_REQUEST cluster ``c``: the closed form of "argmin, then
    increment" repeated k times.  The k taken tickets of the multiset
    ``{load_j + t}`` (ordered by value, then window offset) raise every
    engaged endpoint to the water level v and the first m at-level ones
    one higher.  Other clusters pass through: selection never reads their
    loads.  ``k_cl``: (CL,) or (M, CL), one row per shard, giving (E,) or
    (M, E) int32.  All arithmetic is int32, as the reference's.

    v is the smallest value with ``#tickets <= v >= k`` in [lo, lo + k],
    found by bisection.  The reference runs 32 steps; a step halves the
    interval at least, and once it is empty a step changes nothing, so
    ``k_max`` (a bound on every k, known on the host) cuts the search to
    ``k_max.bit_length()`` steps with the same result."""
    E = state.ep_load.shape[0]
    ceidx, ceok = cluster_windows(state)
    ep_load = state.ep_load.to(I32)
    load = torch.where(ceok, ep_load[ceidx], BIG)            # (CL, WE)
    k = k_cl.to(I32).clamp_min(0)                            # (..., CL)
    lo = load.min(dim=1).values.expand_as(k)
    hi = lo + k
    # lanes above lo + k never engage for k requests; the clamp keeps the
    # ticket counts far from int32 range when ineligible lanes read BIG
    lcl = torch.minimum(load, hi[..., None])                 # (..., CL, WE)
    steps = 32 if k_max is None else max(1, int(k_max).bit_length())
    for _ in range(steps):
        mid = lo + (hi - lo) // 2
        n_le = (mid[..., None] - lcl + 1).clamp_min(0).sum(-1, dtype=I32)
        ge = n_le >= k
        hi = torch.where(ge, mid, hi)
        lo = torch.where(ge, lo, mid + 1)
    v = lo[..., None]
    n_below = (v - lcl).clamp_min(0).sum(-1, dtype=I32)
    m_rem = k - n_below                          # value-v tickets taken
    engaged = ceok & (lcl <= v)                  # v < min + k: clamp is exact
    cum = torch.cumsum(engaged.to(I32), -1, dtype=I32)
    extra = (engaged & (cum <= m_rem[..., None])).to(I32)
    real = torch.where(ceok, ep_load[ceidx], 0)
    newl = torch.maximum(real, v) + extra
    # the registry's merge rule: every policy whose shard_merge is
    # "waterfill" carries its load counters through this closed form
    is_wf = torch.zeros_like(state.cluster_policy, dtype=torch.bool)
    for e in policy_defs.WATERFILL_ENUMS:
        is_wf = is_wf | (state.cluster_policy == e)
    apply = ceok & is_wf[:, None] & (k > 0)[..., None]
    # windows are disjoint, so every applied lane owns a unique slot; the
    # rest write the dump column E
    lead = k.shape[:-1]
    tgt = torch.where(apply, ceidx, E).reshape(*lead, -1)
    out = torch.cat([ep_load.expand(*lead, E),
                     torch.zeros((*lead, 1), dtype=I32,
                                 device=ep_load.device)], -1)
    out = out.scatter(-1, tgt, newl.reshape(*lead, -1))
    return out[..., :E]


def live_shards(req_id, shards: int) -> list[bool]:
    """Per shard of an ``shards``-way split of the batch (padded to a
    multiple of ``shards``), whether it holds a valid row (req_id >= 0).
    Give it the batch as the host built it; a batch on the card costs one
    copy to the host, and inside a CUDA graph capture raises (a captured
    tick takes its live set from the host batch and passes it in)."""
    if req_id.is_cuda and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("live_shards: a batch on the card inside a CUDA "
                           "graph capture; pass live, read from the batch "
                           "as the host built it")
    valid = (req_id.cpu() >= 0).tolist()
    R_loc = -(-len(valid) // shards)
    return [any(valid[m * R_loc:(m + 1) * R_loc]) for m in range(shards)]


def held_rows(x, mesh, axis: str = "shard", fill: int = 0):
    """The rows of a whole batch that this process's shards take: every
    row on a one-process mesh; on a rank mesh, rank m's rows [m·R/M,
    (m+1)·R/M) of the batch padded to a multiple of M with ``fill``.
    Every rank draws and builds the whole batch and takes its rows: the
    reference's "row-aligned with the batch split"."""
    M, held = mesh.shape[axis], mesh.held
    if len(held) == M:
        return x
    R_loc = -(-x.shape[0] // M)
    x = _pad(x, R_loc * M - x.shape[0], fill)
    return x[held[0] * R_loc:(held[-1] + 1) * R_loc]


def _bincount(ids, length: int, vals=None) -> torch.Tensor:
    """Masked scatter-add fold over the last axis (of ones where ``vals``
    is None), ids >= length drop: (..., N) ids → (..., length) int32."""
    out = torch.zeros((*ids.shape[:-1], length + 1), dtype=I32,
                      device=ids.device)
    out.scatter_add_(-1, ids.to(I64).clamp(0, length),
                     torch.ones_like(ids, dtype=I32) if vals is None
                     else vals.to(I32))
    return out[..., :length]


def _prefix_before(gathered, held) -> torch.Tensor:
    """Per held shard, the sum of the rows of the shards before it (L,
    ...): the exclusive scan of the gathered (M, ...) rows giving each
    shard its carried-counter offset."""
    before = torch.cumsum(gathered, 0, dtype=gathered.dtype) - gathered
    return before[held[0]:held[-1] + 1]


def _check_mesh(mesh, axis: str, I_held: int, t) -> tuple[int, tuple]:
    """(M, the held shards); the held pool's instances must split evenly
    over the held shards, and every tensor lie on the mesh's device."""
    M, held = mesh.shape[axis], mesh.held
    if I_held % len(held):
        raise ValueError(f"pool instances ({I_held}) must divide over the "
                         f"{M}-way mesh axis {axis!r}")
    if t.device != mesh.device:
        raise ValueError(f"tensors on {t.device} but the shard mesh is on "
                         f"{mesh.device}")
    return M, held


def _pad(x, n: int, fill: int):
    if n == 0:
        return x
    return torch.cat([x, torch.full((n, *x.shape[1:]), fill, dtype=x.dtype,
                                    device=x.device)])


def _admit_shard(rid, sv, feats, mb, st, shape, rnd, gum,
                 block_r: int) -> AdmitResult:
    """B3 on one shard's rows against an all-free pool of ``shape``
    (I, W): the admission kernel without the commit, in its all-free mode
    (nothing of the pool staged), in tiles of ``block_r`` rows, on the
    card; its plain version on the CPU."""
    if rid.is_cuda:
        res = _rm.admit_cuda(rid, sv, feats, mb, None, st, None, None, rnd,
                             gum, block_r=block_r, pool_shape=shape)
        ops.LAUNCHES["admit"] += 1
        return res
    return _rm.admit(rid, sv, feats, mb, st, None, rnd, gum,
                     block_r=block_r, pool_shape=shape)


def admit_commit_sharded(req_id, svc, features, msg_bytes, token, state,
                         pool_req_id, pool_endpoint, pool_svc, pool_length,
                         pool_token, pool_active, rnd, gumbel, *, mesh,
                         axis: str = "shard", live=None,
                         block_r: int = _rm.TILE) -> AdmitCommitResult:
    """``admit_commit`` sharded ``(R/M,)`` over the mesh axis ``axis``.

    Same flat contract as ``route_match.admit_commit``, over what this
    process holds (``mesh.held``): on a one-process mesh the whole batch
    and the whole (I, C) pool; on a rank mesh the rank's rows of the batch
    (``held_rows``: every rank passes as many) and its (I/M, C) slice of
    the pool.  Instance ``i`` belongs to shard ``i // (I/M)``, and the
    result is bit-exact against single-shard ``admit_commit`` on the whole
    batch: the per-row outputs and the pool for the held rows and
    instances, the routing counters and metrics replicated.  A ragged
    batch pads to a multiple of the held shards with inert ``req_id = -1``
    rows.  ``live``: ``live_shards`` of the held rows as the host built
    them, one entry a held shard (None computes it here, which a CUDA
    graph capture refuses).  Each shard's
    kernel walks tiles of ``min(block_r, R/M)`` rows, as the reference's
    does.  Requires ``I % M == 0`` and every tensor on the mesh's device.

    Four collectives a call, on every shard whatever its rows: two
    ``all_gather`` (the per-cluster counts with the pool's active mask;
    the per-instance counts with the affinity proposals), one ``psum`` of
    every integer delta, one ``all_to_all`` of the pool commits."""
    I_h, C = pool_req_id.shape
    M, held = _check_mesh(mesh, axis, I_h, features)
    L = len(held)
    I_loc = I_h // L
    I = I_loc * M
    pool = [p.to(I32) for p in (pool_req_id, pool_endpoint, pool_svc,
                                pool_length, pool_token)]
    act = pool_active != 0
    R0 = features.shape[0]
    if R0 == 0:                          # empty batch: pool passes through
        return AdmitCommitResult(*ops._empty_admit(state), *pool, act)
    if live is None:
        live = live_shards(req_id, L)
    dev = features.device
    R_loc = -(-R0 // L)
    R = R_loc * L
    S = state.svc_rule_start.shape[0]
    CL = state.cluster_ep_count.shape[0]
    E = state.ep_load.shape[0]
    A = state.aff_key.shape[0]
    if token is None:
        token = torch.zeros((R0,), dtype=I32, device=dev)
    rid = _pad(req_id.to(I32), R - R0, -1)
    svc, features, msg_bytes, rnd, gumbel, token = (
        _pad(x, R - R0, 0) for x in (svc.to(I32), features.to(I32),
                                     msg_bytes.to(I32), rnd.to(I32),
                                     gumbel.to(torch.float32),
                                     token.to(I32)))
    rows = lambda x: x.reshape(L, R_loc, *x.shape[1:])      # noqa: E731

    # ---- phase 1: match + eligibility -> per-cluster routable counts ---- #
    valid = rid >= 0
    svc_c = svc.clamp(0, S - 1)
    cluster = torch.where(valid, router.match_cluster(state, svc_c, features),
                          -1)
    _, ceok = cluster_windows(state)
    ecnt = ceok.sum(1, dtype=I32)                           # (CL,)
    clm = cluster.clamp_min(0).to(I64)
    routable = valid & (cluster >= 0) & (ecnt[clm.clamp(max=CL - 1)] > 0)
    cnt_cl = _bincount(rows(torch.where(routable, clm, CL)), CL)
    # the pool's active mask travels with the counts: every shard matches
    # global ranks against the whole pool's free slots in phase 4
    got = mesh.all_gather(torch.cat(
        [cnt_cl, act.to(I32).reshape(L, I_loc * C)], 1))    # (M, CL + ..)
    all_cl = got[:, :CL]
    act_all = got[:, CL:].reshape(I, C) > 0
    prev_cl = _prefix_before(all_cl, held)                  # (L, CL)
    total_cl = all_cl.sum(0, dtype=I32)

    # ---- phase 2: offset the carried-counter inputs --------------------- #
    # shard 0 has nothing before it: its loads are the state's
    ep_load0 = state.ep_load.to(I32)
    first = 1 if held[0] == 0 else 0
    parts = [ep_load0[None]] * first
    if L > first:
        parts.append(waterfill_lr(state, prev_cl[first:], k_max=R_loc * M))
    adj_load = parts[0] if len(parts) == 1 else torch.cat(parts)
    adj_cur = state.rr_cursor.to(I32) + prev_cl        # raw carry; mod at emit

    # ---- phase 3: the admission kernel per shard (all-free pool) -------- #
    # width R_loc >= any local instance count, so nothing is held in the
    # kernel and its slot is the local per-instance arrival rank
    neg = torch.full((R_loc,), -1, dtype=I32, device=dev)
    z = torch.zeros((R_loc,), dtype=I32, device=dev)
    zs = torch.zeros((S,), dtype=I32, device=dev)
    zero = torch.zeros((), dtype=I32, device=dev)
    per = []
    for m in range(L):
        if not live[m]:                  # an idle ingress host: no launch
            per.append((neg, neg, neg, z, adj_load[m], zs, zs, zero,
                        state.aff_key, state.aff_ep))
            continue
        sl = slice(m * R_loc, (m + 1) * R_loc)
        r = _admit_shard(rid[sl], svc[sl], features[sl], msg_bytes[sl],
                         state._replace(ep_load=adj_load[m],
                                        rr_cursor=adj_cur[m]),
                         (I, R_loc), rnd[sl], gumbel[sl],
                         min(block_r, R_loc))
        per.append((r.endpoint, r.instance, r.slot, r.ok, r.ep_load,
                    r.svc_requests, r.svc_tx_bytes, r.no_route, r.aff_key,
                    r.aff_ep))
    (endpoint, instance, lslot, lok, res_load, res_sreq, res_stx,
     res_noroute, res_affk, res_affe) = (torch.stack(f) for f in zip(*per))

    # ---- phase 4: global slot allocation + psum reconciliation ---------- #
    rt = lok > 0                               # == routable (all-free pool)
    instc = instance.clamp(0, I - 1).to(I64)
    local_rank = torch.where(rt, lslot, 0)
    cnt_i = _bincount(torch.where(rt, instc, I), I)      # (L, I)
    got = mesh.all_gather(torch.cat([cnt_i, res_affk.to(I32),
                                     res_affe.to(I32)], 1))  # (M, I + 2A)
    prev_i = _prefix_before(got[:, :I], held)
    g_rank = prev_i.gather(1, instc) + local_rank           # (L, R_loc)

    free = (~act_all).to(I32)                               # the whole pool
    fprefix = torch.cumsum(free, 1, dtype=I32)              # (I, C)
    ok = rt & (g_rank < fprefix[:, C - 1][instc])
    hit = (free[instc] > 0) & (fprefix[instc] == (g_rank + 1)[..., None])
    slot = torch.where(ok, torch.argmax(hit.to(I32), -1).to(I32), -1)
    held_r = rt & ~ok

    # one psum of every integer delta: the loads (the kernel's increments
    # less the globally held rows' releases), the per-service metrics (the
    # kernel counted every routable request; the held ones come out), the
    # no_route and held counts.  int32 sums wrap, so one sum of the
    # differences equals the sums' difference bit for bit
    epc = endpoint.clamp_min(0).to(I64)
    held_rel = _bincount(torch.where(held_r, epc, E), E)
    held_svc = torch.where(held_r & (rows(svc) < S), rows(svc_c).to(I64), S)
    tot = mesh.psum(torch.cat([
        res_load - adj_load - held_rel,
        res_sreq - _bincount(held_svc, S),
        res_stx - _bincount(held_svc, S, rows(msg_bytes)),
        res_noroute[:, None], held_r.sum(1, dtype=I32)[:, None]], 1))
    ep_load = ep_load0 + tot[:E]
    sreq, stx = tot[E:E + S], tot[E + S:E + 2 * S]
    no_route, held_n = tot[E + 2 * S], tot[E + 2 * S + 1]
    rr_cursor = (state.rr_cursor.to(I32) + total_cl) \
        % state.cluster_ep_count.to(I32).clamp_min(1)

    # affinity caches: every shard wrote against the same snapshot and the
    # miss fallback is a pure function of the flow key, so proposals for a
    # slot agree wherever the sequential batch would have hit.  The lowest
    # shard proposing a change wins: the first writer of the concatenation
    gk, ge = got[:, I:I + A], got[:, I + A:]                # (M, A)
    prop = (gk != state.aff_key) | (ge != state.aff_ep)
    has = prop.any(0)
    m1 = torch.argmax(prop.to(I32), 0, keepdim=True)        # first proposer
    aff_key = torch.where(has, gk.gather(0, m1)[0], state.aff_key)
    aff_ep = torch.where(has, ge.gather(0, m1)[0], state.aff_ep)

    # ---- phase 5: relay pool commits to their owner shards -------------- #
    # payload rows (req_id, endpoint, svc, token, slot, ok) counting-sorted
    # (B5) into per-instance pools, C slots per source and instance
    # (admitted global ranks are < C, so nothing drops), then one
    # all_to_all hop to the shard owning the instance.  One dispatch
    # serves every held source: held source m's instance i is destination
    # m * I + i
    x = torch.stack([rows(rid), endpoint, rows(svc), rows(token), slot,
                     ok.to(I32)], -1)                       # (L, R_loc, 6)
    src = torch.arange(L, device=dev)[:, None] * I
    dest = torch.where(ok, src + instc, L * I).reshape(R)
    rank, load = ops.relay_slots(dest, L * I)
    buf, _ = relay.relay_dispatch_at(x.reshape(R, 6), dest, rank, load,
                                     L * I, C)
    recv = mesh.all_to_all(buf.reshape(L, M, I_loc, C, 6))  # (dst, src, ..)
    rows_in = recv.reshape(-1, 6)
    owner = torch.arange(L * I_loc, device=dev).reshape(L, 1, I_loc, 1)
    gi = owner.expand(L, M, I_loc, C).reshape(-1)           # held instance
    rok = rows_in[:, 5] > 0
    W = -(-(I_h * C + 1) // 4) * 4        # a dump column; rows 16 B aligned
    tgt = torch.where(rok, gi * C + rows_in[:, 4], I_h * C)
    cells = torch.zeros((6, W), dtype=I32, device=dev)
    cells[:, :I_h * C] = torch.stack([*pool, act.to(I32)]).reshape(6, I_h * C)
    one = torch.ones_like(rows_in[:, 0])
    cells[:, tgt] = torch.stack([rows_in[:, 0], rows_in[:, 1],
                                 rows_in[:, 2], one * 0, rows_in[:, 3], one])
    out = cells[:, :I_h * C].reshape(6, I_h, C)

    flat = lambda x: x.reshape(R)[:R0]                      # noqa: E731
    return AdmitCommitResult(
        cluster[:R0], flat(endpoint), flat(instance), flat(slot),
        flat(ok.to(I32)), ep_load, rr_cursor, sreq, stx, no_route, held_n,
        aff_key, aff_ep, *out[:5], out[5] > 0)


# --------------------------------------------------------------------------- #
# Sharded completion: the close path over an (I/M,)-sharded pool
# --------------------------------------------------------------------------- #


def _complete_shard(*args, eos: int, max_len: int) -> CompleteResult:
    """B1 on one shard's pool slice: the completion kernel on the card,
    its plain version on the CPU."""
    if args[6].is_cuda:
        res = _cp.complete_cuda(*args, eos=eos, max_len=max_len)
        ops.LAUNCHES["complete"] += 1
        return res
    return _cp.complete(*args, eos=eos, max_len=max_len)


def complete_sharded(pool_req_id, pool_endpoint, pool_svc, pool_length,
                     pool_token, pool_active, nxt, ep_load, rx_bytes,
                     ep_inflight_ewma, ep_tput_ewma, *, mesh,
                     axis: str = "shard", eos: int,
                     max_len: int) -> CompleteResult:
    """``completion.complete`` over an ``(I/M,)``-sharded pool.

    Same flat contract, over the pool this process holds (the whole pool
    on a one-process mesh, the rank's (I/M, C) slice on a rank mesh); the
    (E,) load and EWMA tables and the (S,) rx table are replicated, each
    shard folds its own pool slice against zero bases, and one psum
    reconciles the integer counts before the shared ``health_update``
    epilogue: bit-exact against single-shard ``complete`` on the whole
    pool.  Requires ``I % M == 0`` and every tensor on the mesh's
    device."""
    I_h, C = pool_req_id.shape
    _, held = _check_mesh(mesh, axis, I_h, nxt)
    L = len(held)
    I_loc = I_h // L
    E, S = ep_load.shape[0], rx_bytes.shape[0]
    dev = nxt.device
    zi = torch.zeros((E + S,), dtype=I32, device=dev)
    zf = torch.zeros((E,), dtype=torch.float32, device=dev)
    fields = (pool_req_id, pool_endpoint, pool_svc, pool_length, pool_token,
              pool_active, nxt)
    per = [_complete_shard(*(f[m * I_loc:(m + 1) * I_loc] for f in fields),
                           zi[:E], zi[E:], zf, zf, eos=eos, max_len=max_len)
           for m in range(L)]
    # global releases and rx bytes, one psum
    tot = mesh.psum([torch.cat([r.done_cnt, r.rx_bytes]) for r in per])
    cnt = tot[:E]
    load0 = ep_load.to(I32)
    ewl, ewt = _cp.health_update(ep_inflight_ewma.to(torch.float32),
                                 ep_tput_ewma.to(torch.float32), load0, cnt)
    cat = lambda xs: xs[0] if L == 1 else torch.cat(xs)     # noqa: E731
    return CompleteResult(
        *(cat(x) for x in zip(*(r[:7] for r in per))),
        load0 - cnt, rx_bytes.to(I32) + tot[E:], cnt, ewl, ewt)

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
first; pool commits travel to their owner shards through the
``relay_dispatch`` counting sort and one ``all_to_all`` hop.

One controller drives the M shards (``launch/mesh.py::ShardMesh``), as
the reference's ``shard_map`` does: per-shard values are stacked on a
leading shard axis and the collectives are the mesh's functions.  Work
that needs no collective and no per-shard kernel runs once over the stack:
the route match of phase 1 (B4 through ``router.match_cluster``, over the
whole padded batch; it is stateless) and the water-fill search of phase 2
for all shards at once.  The admission kernel runs once per shard that
holds a valid row; an all-padding shard launches nothing (the reference's
``lax.cond`` skip).  Which shards hold one is read from the host batch
(``live_shards``), so the choice costs no device sync.

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
    copy to the host."""
    valid = (req_id.cpu() >= 0).tolist()
    R_loc = -(-len(valid) // shards)
    return [any(valid[m * R_loc:(m + 1) * R_loc]) for m in range(shards)]


def _bincount(ids, length: int, vals=None) -> torch.Tensor:
    """Masked scatter-add fold over the last axis (of ones where ``vals``
    is None), ids >= length drop: (..., N) ids → (..., length) int32."""
    out = torch.zeros((*ids.shape[:-1], length + 1), dtype=I32,
                      device=ids.device)
    out.scatter_add_(-1, ids.to(I64).clamp(0, length),
                     torch.ones_like(ids, dtype=I32) if vals is None
                     else vals.to(I32))
    return out[..., :length]


def _prefix_before(gathered) -> torch.Tensor:
    """Per shard, the sum of the rows of the shards before it (M, ...):
    the exclusive scan giving each shard its carried-counter offset."""
    return torch.cumsum(gathered, 0, dtype=gathered.dtype) - gathered


def _check_mesh(mesh, axis: str, I: int, t) -> int:
    M = mesh.shape[axis]
    if I % M:
        raise ValueError(f"pool instances ({I}) must divide over the "
                         f"{M}-way mesh axis {axis!r}")
    if t.device != mesh.device:
        raise ValueError(f"tensors on {t.device} but the shard mesh is on "
                         f"{mesh.device}")
    return M


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

    Same flat contract as ``route_match.admit_commit``; instance ``i`` of
    the (I, C) pool belongs to shard ``i // (I/M)``, and the result is
    bit-exact against single-shard ``admit_commit`` on the same batch.  A
    ragged batch pads to a multiple of M with inert ``req_id = -1`` rows.
    ``live``: ``live_shards`` of the batch as the host built it (None
    computes it here).  Each shard's kernel walks tiles of
    ``min(block_r, R/M)`` rows, as the reference's does.  Requires
    ``I % M == 0`` and every tensor on the mesh's device."""
    I, C = pool_req_id.shape
    M = _check_mesh(mesh, axis, I, features)
    pool = [p.to(I32) for p in (pool_req_id, pool_endpoint, pool_svc,
                                pool_length, pool_token)]
    act = pool_active != 0
    R0 = features.shape[0]
    if R0 == 0:                          # empty batch: pool passes through
        return AdmitCommitResult(*ops._empty_admit(state), *pool, act)
    if live is None:
        live = live_shards(req_id, M)
    dev = features.device
    R_loc = -(-R0 // M)
    R, I_loc = R_loc * M, I // M
    S = state.svc_rule_start.shape[0]
    CL = state.cluster_ep_count.shape[0]
    E = state.ep_load.shape[0]
    if token is None:
        token = torch.zeros((R0,), dtype=I32, device=dev)
    rid = _pad(req_id.to(I32), R - R0, -1)
    svc, features, msg_bytes, rnd, gumbel, token = (
        _pad(x, R - R0, 0) for x in (svc.to(I32), features.to(I32),
                                     msg_bytes.to(I32), rnd.to(I32),
                                     gumbel.to(torch.float32),
                                     token.to(I32)))
    rows = lambda x: x.reshape(M, R_loc, *x.shape[1:])      # noqa: E731

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
    all_cl = mesh.all_gather(cnt_cl)                        # (M, CL)
    prev_cl = _prefix_before(all_cl)
    total_cl = mesh.psum(all_cl)

    # ---- phase 2: offset the carried-counter inputs --------------------- #
    # shard 0 has nothing before it: its loads are the state's
    ep_load0 = state.ep_load.to(I32)
    adj_load = ep_load0[None] if M == 1 else torch.cat(
        [ep_load0[None], waterfill_lr(state, prev_cl[1:], k_max=R)])
    adj_cur = state.rr_cursor.to(I32) + prev_cl        # raw carry; mod at emit

    # ---- phase 3: the admission kernel per shard (all-free pool) -------- #
    # width R_loc >= any local instance count, so nothing is held in the
    # kernel and its slot is the local per-instance arrival rank
    neg = torch.full((R_loc,), -1, dtype=I32, device=dev)
    z = torch.zeros((R_loc,), dtype=I32, device=dev)
    zs = torch.zeros((S,), dtype=I32, device=dev)
    zero = torch.zeros((), dtype=I32, device=dev)
    per = []
    for m in range(M):
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
     res_noroute, res_affk, res_affe) = (mesh.all_gather(f)
                                         for f in zip(*per))

    # ---- phase 4: global slot allocation + psum reconciliation ---------- #
    rt = lok > 0                               # == routable (all-free pool)
    instc = instance.clamp(0, I - 1).to(I64)
    local_rank = torch.where(rt, lslot, 0)
    cnt_i = _bincount(torch.where(rt, instc, I), I)      # (M, I)
    prev_i = _prefix_before(mesh.all_gather(cnt_i))
    g_rank = prev_i.gather(1, instc) + local_rank           # (M, R_loc)

    free = (~act).to(I32)                                   # the whole pool
    fprefix = torch.cumsum(free, 1, dtype=I32)              # (I, C)
    ok = rt & (g_rank < fprefix[:, C - 1][instc])
    hit = (free[instc] > 0) & (fprefix[instc] == (g_rank + 1)[..., None])
    slot = torch.where(ok, torch.argmax(hit.to(I32), -1).to(I32), -1)
    held = rt & ~ok

    epc = endpoint.clamp_min(0).to(I64)
    held_rel = _bincount(torch.where(held, epc, E), E)
    ep_load = ep_load0 + mesh.psum(res_load - adj_load) \
        - mesh.psum(held_rel)
    # the kernel counted every routable request (nothing held locally);
    # take the globally held ones out before the metric psum
    held_svc = torch.where(held & (rows(svc) < S), rows(svc_c).to(I64), S)
    sreq = mesh.psum(res_sreq - _bincount(held_svc, S))
    stx = mesh.psum(res_stx - _bincount(held_svc, S, rows(msg_bytes)))
    no_route = mesh.psum(res_noroute)
    held_n = mesh.psum(held.sum(1, dtype=I32))
    rr_cursor = (state.rr_cursor.to(I32) + total_cl) \
        % state.cluster_ep_count.to(I32).clamp_min(1)

    # affinity caches: every shard wrote against the same snapshot and the
    # miss fallback is a pure function of the flow key, so proposals for a
    # slot agree wherever the sequential batch would have hit.  The lowest
    # shard proposing a change wins: the first writer of the concatenation
    gk, ge = res_affk, res_affe                             # (M, A)
    prop = (gk != state.aff_key) | (ge != state.aff_ep)
    has = prop.any(0)
    m1 = torch.argmax(prop.to(I32), 0, keepdim=True)        # first proposer
    aff_key = torch.where(has, gk.gather(0, m1)[0], state.aff_key)
    aff_ep = torch.where(has, ge.gather(0, m1)[0], state.aff_ep)

    # ---- phase 5: relay pool commits to their owner shards -------------- #
    # payload rows (req_id, endpoint, svc, token, slot, ok) counting-sorted
    # into per-instance pools, C slots per source and instance (admitted
    # global ranks are < C, so nothing drops), then one all_to_all hop to
    # the shard owning the instance.  One dispatch serves all M sources:
    # source m's instance i is destination m * I + i.
    x = torch.stack([rows(rid), endpoint, rows(svc), rows(token), slot,
                     ok.to(I32)], -1)                       # (M, R_loc, 6)
    src = torch.arange(M, device=dev)[:, None] * I
    dest = torch.where(ok, src + instc, M * I)
    buf, _ = relay.relay_dispatch(x.reshape(R, 6), dest.reshape(R), M * I, C)
    recv = mesh.all_to_all(buf.reshape(M, M, I_loc, C, 6))  # (dst, src, ..)
    rows_in = recv.reshape(-1, 6)
    owner = torch.arange(M * I_loc, device=dev).reshape(M, 1, I_loc, 1)
    gi = owner.expand(M, M, I_loc, C).reshape(-1)           # global instance
    rok = rows_in[:, 5] > 0
    W = -(-(I * C + 1) // 4) * 4          # a dump column; rows 16 B aligned
    tgt = torch.where(rok, gi * C + rows_in[:, 4], I * C)
    cells = torch.zeros((6, W), dtype=I32, device=dev)
    cells[:, :I * C] = torch.stack([*pool, act.to(I32)]).reshape(6, I * C)
    one = torch.ones_like(rows_in[:, 0])
    cells[:, tgt] = torch.stack([rows_in[:, 0], rows_in[:, 1],
                                 rows_in[:, 2], one * 0, rows_in[:, 3], one])
    out = cells[:, :I * C].reshape(6, I, C)

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

    Same flat contract; the (E,) load and EWMA tables and the (S,) rx
    table are replicated, each shard folds its own pool slice against zero
    bases, and one psum reconciles the integer counts before the shared
    ``health_update`` epilogue: bit-exact against single-shard
    ``complete`` on the whole pool.  Requires ``I % M == 0`` and every
    tensor on the mesh's device."""
    I, C = pool_req_id.shape
    M = _check_mesh(mesh, axis, I, nxt)
    I_loc = I // M
    E, S = ep_load.shape[0], rx_bytes.shape[0]
    dev = nxt.device
    zi = torch.zeros((E + S,), dtype=I32, device=dev)
    zf = torch.zeros((E,), dtype=torch.float32, device=dev)
    fields = (pool_req_id, pool_endpoint, pool_svc, pool_length, pool_token,
              pool_active, nxt)
    per = [_complete_shard(*(f[m * I_loc:(m + 1) * I_loc] for f in fields),
                           zi[:E], zi[E:], zf, zf, eos=eos, max_len=max_len)
           for m in range(M)]
    cnt = mesh.psum([r.done_cnt for r in per])              # global releases
    load0 = ep_load.to(I32)
    ewl, ewt = _cp.health_update(ep_inflight_ewma.to(torch.float32),
                                 ep_tput_ewma.to(torch.float32), load0, cnt)
    cat = lambda xs: xs[0] if M == 1 else torch.cat(xs)     # noqa: E731
    return CompleteResult(
        *(cat(x) for x in zip(*(r[:7] for r in per))),
        load0 - cnt, rx_bytes.to(I32) + mesh.psum([r.rx_bytes for r in per]),
        cnt, ewl, ewt)

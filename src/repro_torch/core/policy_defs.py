"""The LB policies, defined once for the port (twin of
``repro/core/policy_defs.py``).

Each policy is one ``PolicyDef`` in ``REGISTRY`` carrying its enum, its
CLI name and three lowering hooks:

  * ``kernel_offset`` - plain PyTorch over one tile of the admission path
    (``kernels/route_match.py``); the CUDA kernel ``csrc/admit.cu``
    computes the same selections per thread and is held bit-exactly
    against it on the card;
  * ``staged_offset`` - batched PyTorch for the staged chain
    (``core/policies.py``);
  * ``host_pick`` - per-request numpy in the sidecar baselines'
    ``HostRouter`` (``core/sidecar.py``); maglev and affinity run the
    sequential oracle hooks through ``_HostOracleView``.

Kernel-hook ctx (``KernelCtx``), per request row of the tile ((BR,) unless
noted):

  block_r            tile rows (static)
  policy, cl         policy enum / clamped cluster id
  routable, rank_c   eligibility mask / in-tile arrival rank within cluster
  estart, count      cluster window start / raw window count
  cnt1, cnt2         eligible-endpoint count (>= 1 clamped / raw)
  eidx, eok          (BR, WE) window endpoint indices / eligibility mask
  rnd, fkey          host PRNG draw / flow id
  gum                (BR, WE) Gumbel noise
  loads, ew, ed      (E,) tile-start loads / weights / drain mask
  cur_cl             per-request raw rr cursor at tile start
  mg_tab             (CL, T) Maglev table
  aff_key, aff_ep    (A,) affinity cache (tile-start snapshot)
  kth(k)             window offset of the k-th eligible endpoint
  seg_rank(ids, mask, n)  in-tile stable arrival rank among equal ids

Staged-hook ctx (``StagedCtx``, filled per batch by ``policies.select``):

  state              RoutingState
  cl, start, count   clamped cluster / window start / raw count
  cnt1, ok, idx      eligible count (>= 1) / (B, WE) masks / indices
  rank               arrival rank within cluster
  rnd, fkey, gum     PRNG draws / flow ids / Gumbel noise
  kth(k)             k-th eligible offset

Host-hook arguments (``HostRouter``, one request at a time, numpy):
``h.t`` the router's mutable numpy ``RoutingState``, ``h.rng`` its
``np.random.RandomState``.

Kernel and staged hooks return WINDOW OFFSETS (int64 tensors); host hooks
return ABSOLUTE endpoint indices.
"""

from __future__ import annotations

import dataclasses
import types
from typing import Any, Callable

import numpy as np
import torch

POLICY_RR = 0             # round-robin over eligible endpoints
POLICY_RANDOM = 1         # host-PRNG uniform over eligible endpoints
POLICY_LEAST_REQUEST = 2  # sequentially-consistent least outstanding
POLICY_WEIGHTED = 3       # Gumbel-max over log weights
POLICY_MAGLEV = 4         # Maglev consistent hash over the flow id
POLICY_AFFINITY = 5       # session stickiness, Maglev fallback on miss

POLICY_NAMES = {
    "rr": POLICY_RR,
    "random": POLICY_RANDOM,
    "least_request": POLICY_LEAST_REQUEST,
    "weighted": POLICY_WEIGHTED,
    "maglev": POLICY_MAGLEV,
    "affinity": POLICY_AFFINITY,
}

#: Maglev permutation-table width per cluster (prime).
MAGLEV_TABLE_SIZE = 521

#: Direct-mapped session-affinity cache slots (flow_hash % slots).
AFFINITY_SLOTS = 512

#: Sentinel load for ineligible lanes.
BIG = 2**30

_FNV_OFFSET = 0x811C9DC5
_FNV_PRIME = 0x01000193
_U32 = 0xFFFFFFFF


# --------------------------------------------------------------------------- #
# Flow identity
# --------------------------------------------------------------------------- #


def flow_hash(features):
    """31-bit FNV-style flow id over the request's feature columns.

    ``(..., F)`` int → ``(...,)`` non-negative ids, for numpy arrays and
    torch tensors alike.  Torch has no wrapping uint32 multiply, so the
    torch branch works in int64 and masks to 32 bits after every step
    (the product of two 32-bit values fits in 64 bits).
    """
    if isinstance(features, np.ndarray):
        f = features.astype(np.uint32)
        h = np.full(f.shape[:-1], _FNV_OFFSET, np.uint32)
        with np.errstate(over="ignore"):     # uint32 wraparound is the hash
            for j in range(f.shape[-1]):
                h = (h ^ f[..., j]) * np.uint32(_FNV_PRIME)
        return (h & np.uint32(0x7FFFFFFF)).astype(np.int32)
    f = features.to(torch.int64) & _U32          # int32 bits as uint32
    h = torch.full(f.shape[:-1], _FNV_OFFSET, dtype=torch.int64,
                   device=f.device)
    for j in range(f.shape[-1]):
        h = ((h ^ f[..., j]) * _FNV_PRIME) & _U32
    return h & 0x7FFFFFFF


# --------------------------------------------------------------------------- #
# Maglev table construction (host side, numpy)
# --------------------------------------------------------------------------- #


def _mix(x: int, salt: int) -> int:
    """Deterministic 32-bit scramble of an endpoint identity."""
    h = (int(x) ^ salt) & 0xFFFFFFFF
    h = (h * 0x01000193 + 0x811C9DC5) & 0xFFFFFFFF
    h ^= h >> 13
    h = (h * 0x5BD1E995) & 0xFFFFFFFF
    h ^= h >> 15
    return h


def _maglev_row(offsets: list[int], ids: list[int], T: int) -> np.ndarray:
    """One cluster's Maglev lookup row (T,) of WINDOW OFFSETS, -1 = empty.

    Endpoint k probes slots ``(offset_k + j·skip_k) % T`` and claims the
    next untaken one, round-robin across endpoints, until the table is
    full.  Probe sequences are keyed on the endpoint's identity (``ids``),
    not its window position, so membership changes remap ~1/E of slots.
    """
    row = np.full((T,), -1, np.int32)
    if not offsets:
        return row
    E = len(offsets)
    offset = [_mix(i, 0x9E3779B9) % T for i in ids]
    skip = [_mix(i, 0x85EBCA6B) % (T - 1) + 1 for i in ids]
    ptr = [0] * E
    filled = 0
    while filled < T:
        for k in range(E):
            while True:
                c = (offset[k] + ptr[k] * skip[k]) % T
                ptr[k] += 1
                if row[c] < 0:
                    row[c] = offsets[k]
                    filled += 1
                    break
            if filled == T:
                break
    return row


def build_maglev_table(ep_start, ep_count, ep_instance, ep_drained,
                       table_size: int = MAGLEV_TABLE_SIZE) -> np.ndarray:
    """(CL, T) i32 Maglev table over every cluster's non-drained endpoints;
    rows of empty or fully-drained clusters stay -1."""
    cs = np.asarray(ep_start, np.int64)
    cc = np.asarray(ep_count, np.int64)
    inst = np.asarray(ep_instance, np.int64)
    dr = np.asarray(ep_drained, np.int64)
    CL = cs.shape[0]
    tab = np.full((CL, table_size), -1, np.int32)
    for c in range(CL):
        n = int(cc[c])
        if n <= 0:
            continue
        s = int(cs[c])
        offs = [j for j in range(n) if dr[s + j] == 0]
        ids = [int(inst[s + j]) for j in offs]
        tab[c] = _maglev_row(offs, ids, table_size)
    return tab


def maglev_row_inputs(cfg: dict, c: int) -> tuple:
    """The exact inputs one cluster's table row depends on: the control
    plane diffs them across a transaction to rebuild only dirty rows."""
    s = int(cfg["cluster_ep_start"][c])
    n = int(cfg["cluster_ep_count"][c])
    return (n, tuple(np.asarray(cfg["ep_instance"][s:s + n]).tolist()),
            tuple(np.asarray(cfg["ep_drained"][s:s + n]).tolist()))


# --------------------------------------------------------------------------- #
# Kernel hooks (plain PyTorch over one tile)
# --------------------------------------------------------------------------- #


class KernelCtx(types.SimpleNamespace):
    """The kernel-hook ctx (fields in the module docstring)."""


def _rr_kernel(ctx):
    return ctx.kth((ctx.cur_cl + ctx.rank_c) % ctx.cnt1)


def _random_kernel(ctx):
    return ctx.kth(ctx.rnd % ctx.cnt1)


def _lr_kernel(ctx):
    """Sequential least-request without a per-request scan: the request with
    in-tile cluster rank ρ owns the ρ-th smallest ticket of the multiset
    {load_j + t : t >= 0} ordered by (value, j) — the water-filling closed
    form of "argmin then increment".  The ticket level is found by a
    binary search over [min load, min load + ρ]."""
    eok, rank = ctx.eok, ctx.rank_c
    load = torch.where(eok, ctx.loads[ctx.eidx], BIG)          # (BR, WE)
    lo = load.min(dim=1).values
    hi = lo + rank
    tgt = rank + 1
    for _ in range(max(ctx.block_r, 2).bit_length()):   # hi - lo < block_r
        mid = (lo + hi) // 2
        n_mid = (mid[:, None] - load + 1).clamp_min(0).sum(dim=1)
        ge = n_mid >= tgt
        hi = torch.where(ge, mid, hi)
        lo = torch.where(ge, lo, mid + 1)
    v = lo
    m = rank - (v[:, None] - load).clamp_min(0).sum(dim=1)     # rank in ties
    elig = load <= v[:, None]
    ec = torch.cumsum(elig.to(torch.int64), dim=1)
    return torch.argmax((elig & (ec == (m + 1)[:, None])).to(torch.int32),
                        dim=1)


def _wt_kernel(ctx):
    w = torch.where(ctx.eok, ctx.ew[ctx.eidx], 0.0)
    score = torch.where(ctx.eok, torch.log(w + 1e-9) + ctx.gum, -torch.inf)
    return torch.argmax(score, dim=1)


def _maglev_kernel(ctx):
    T = ctx.mg_tab.shape[1]
    t = ctx.mg_tab[ctx.cl, ctx.fkey % T].to(torch.int64)       # offsets
    te = (ctx.estart + t).clamp(0, ctx.ed.shape[0] - 1)
    t_ok = (t >= 0) & (t < ctx.count) & (ctx.ed[te] == 0)
    return torch.where(t_ok, t, ctx.kth(ctx.fkey % ctx.cnt1))


def _aff_hit(ctx):
    A = ctx.aff_key.shape[0]
    s = ctx.fkey % A
    ak = ctx.aff_key[s]
    ae = ctx.aff_ep[s]
    aec = ae.clamp(0, ctx.ed.shape[0] - 1)
    hit = ((ak == ctx.fkey) & (ae >= ctx.estart)
           & (ae < ctx.estart + ctx.count) & (ctx.ed[aec] == 0))
    return s, ak, ae, hit


def _affinity_kernel(ctx):
    _, _, ae, hit = _aff_hit(ctx)
    return torch.where(hit, ae - ctx.estart, _maglev_kernel(ctx))


def affinity_kernel_update(ctx, ep):
    """This tile's affinity writes folded into the carried cache: the first
    writer per slot in arrival order wins, and a live flow of another key
    is never evicted.  ``ep`` is the chosen absolute endpoint per request.
    Returns (new_aff_key, new_aff_ep)."""
    A = ctx.aff_key.shape[0]
    s, ak, _, hit = _aff_hit(ctx)
    want = (ctx.routable & (ctx.policy == POLICY_AFFINITY) & ~hit
            & ((ak == -1) | (ak == ctx.fkey)))
    win = want & (ctx.seg_rank(s, want, A) == 0)
    nk, ne = ctx.aff_key.clone(), ctx.aff_ep.clone()
    nk[s[win]] = ctx.fkey[win].to(nk.dtype)
    ne[s[win]] = ep[win].to(ne.dtype)
    return nk, ne


# --------------------------------------------------------------------------- #
# Staged hooks (batched PyTorch, core/policies.py)
# --------------------------------------------------------------------------- #


class StagedCtx(types.SimpleNamespace):
    """The staged-hook ctx (``core/policies.py`` fills it per batch)."""


def _i64(t):
    return t.to(torch.int64)


def _rr_staged(s):
    return s.kth((_i64(s.state.rr_cursor)[s.cl] + s.rank) % s.cnt1)


def _random_staged(s):
    return s.kth(s.rnd % s.cnt1)


def _lr_staged(s):
    """The r-th request (arrival order) of a cluster takes the r-th LEAST
    loaded endpoint, emulating sequential per-request counters; ineligible
    endpoints sort behind INT32_MAX."""
    load = torch.where(s.ok, _i64(s.state.ep_load)[s.idx], 2**31 - 1)
    by_load = torch.argsort(load, dim=1, stable=True)
    return by_load.gather(1, (s.rank % s.cnt1)[:, None])[:, 0]


def _wt_staged(s):
    w = torch.where(s.ok, s.state.ep_weight.to(torch.float32)[s.idx], 0.0)
    return torch.argmax(torch.where(s.ok, torch.log(w + 1e-9) + s.gum,
                                    -torch.inf), dim=1)


def _maglev_staged(s):
    mg = _i64(s.state.maglev_table)
    ed = _i64(s.state.ep_drained)
    t = mg[s.cl, s.fkey % mg.shape[1]]
    te = (s.start + t).clamp(0, ed.shape[0] - 1)
    t_ok = (t >= 0) & (t < s.count) & (ed[te] == 0)
    return torch.where(t_ok, t, s.kth(s.fkey % s.cnt1))


def _staged_aff(s):
    """(slot, stored key, hit) of each request against the batch-start
    affinity cache."""
    A = s.state.aff_key.shape[0]
    ed = _i64(s.state.ep_drained)
    sl = s.fkey % A
    ak = _i64(s.state.aff_key)[sl]
    ae = _i64(s.state.aff_ep)[sl]
    aec = ae.clamp(0, ed.shape[0] - 1)
    hit = ((ak == s.fkey) & (ae >= s.start) & (ae < s.start + s.count)
           & (ed[aec] == 0))
    return sl, ak, ae, hit


def _affinity_staged(s):
    _, _, ae, hit = _staged_aff(s)
    return torch.where(hit, ae - s.start, _maglev_staged(s))


def affinity_staged_update(s, ep, routable, policy):
    """Batch-snapshot cache update for the staged chain: the first writer
    per slot in arrival order wins (rank 0 of the slot's counting sort,
    ``ops.relay_slots``), and a live flow of another key is never evicted.
    Returns (new_aff_key, new_aff_ep), int32."""
    from repro_torch.kernels import ops
    A = s.state.aff_key.shape[0]
    sl, ak, _, hit = _staged_aff(s)
    want = (routable & (policy == POLICY_AFFINITY) & ~hit
            & ((ak == -1) | (ak == s.fkey)))
    rank_w, _ = ops.relay_slots(torch.where(want, sl, A), A + 1)
    win = want & (rank_w == 0)
    tgt = torch.where(win, sl, A)          # losers write the dump slot A
    dump = torch.zeros((1,), dtype=torch.int32, device=ep.device)

    def put(table, vals):
        out = torch.cat([table.to(torch.int32), dump])
        return out.index_put_((tgt,), vals.to(torch.int32))[:A]

    return put(s.state.aff_key, s.fkey), put(s.state.aff_ep, ep)


# --------------------------------------------------------------------------- #
# Sequential oracle hooks (numpy) the host router runs for maglev/affinity
# --------------------------------------------------------------------------- #


def _maglev_oracle(o, r, c, elig):
    key = int(o.fkey[r])
    t = int(o.mg[c, key % o.T])
    if 0 <= t < o.cc[c]:
        e = min(max(o.cs[c] + t, 0), o.E - 1)
        if o.drained[e] == 0:
            return e
    return elig[key % len(elig)]


def _affinity_oracle(o, r, c, elig):
    key = int(o.fkey[r])
    s = key % o.A
    ae = int(o.affe[s])
    if (int(o.affk[s]) == key and o.cs[c] <= ae < o.cs[c] + o.cc[c]
            and o.drained[ae] == 0):
        return ae
    ep = _maglev_oracle(o, r, c, elig)
    if o.affk[s] == -1 or o.affk[s] == key:     # first admit writes through
        o.affk[s] = key
        o.affe[s] = ep
    return ep


# --------------------------------------------------------------------------- #
# Host hooks (per-request numpy, core/sidecar.py::HostRouter)
# --------------------------------------------------------------------------- #


def _rr_host(h, c, elig, feats):
    ep = elig[h.t.rr_cursor[c] % len(elig)]
    h.t.rr_cursor[c] += 1
    return ep


def _random_host(h, c, elig, feats):
    return elig[h.rng.randint(0, len(elig))]


def _lr_host(h, c, elig, feats):
    return elig[int(np.argmin(h.t.ep_load[elig]))]


def _wt_host(h, c, elig, feats):
    w = np.maximum(h.t.ep_weight[elig], 0.0)
    tot = float(w.sum())
    if tot <= 0.0:
        return elig[h.rng.randint(0, len(elig))]
    return elig[h.rng.choice(len(elig), p=w / tot)]


class _HostOracleView:
    """A HostRouter and one request in the oracle hooks' field contract, so
    maglev/affinity run the sequential oracle hooks per request (the
    sidecar is sequential by construction)."""

    def __init__(self, h, feats):
        t = h.t
        self.cs = t.cluster_ep_start
        self.cc = t.cluster_ep_count
        self.E = t.ep_instance.shape[0]
        self.drained = t.ep_drained
        self.mg = t.maglev_table
        self.T = t.maglev_table.shape[1]
        self.affk = t.aff_key
        self.affe = t.aff_ep
        self.A = t.aff_key.shape[0]
        self.fkey = np.array([flow_hash(np.asarray(feats, np.int32))])


def _maglev_host(h, c, elig, feats):
    return _maglev_oracle(_HostOracleView(h, feats), 0, c, elig)


def _affinity_host(h, c, elig, feats):
    return _affinity_oracle(_HostOracleView(h, feats), 0, c, elig)


# --------------------------------------------------------------------------- #
# The registry
# --------------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class PolicyDef:
    """One LB policy, defined once for every datapath of the port."""

    name: str
    enum: int
    shard_merge: str                     # 'cursor' | 'waterfill' | 'none'
    kernel_offset: Callable[[Any], Any]  # plain tile path → window offsets
    staged_offset: Callable[[Any], Any]  # staged chain → window offsets
    host_pick: Callable                  # sidecar numpy → absolute endpoint


REGISTRY: tuple[PolicyDef, ...] = (
    PolicyDef("rr", POLICY_RR, "cursor", _rr_kernel, _rr_staged, _rr_host),
    PolicyDef("random", POLICY_RANDOM, "cursor", _random_kernel,
              _random_staged, _random_host),
    PolicyDef("least_request", POLICY_LEAST_REQUEST, "waterfill", _lr_kernel,
              _lr_staged, _lr_host),
    PolicyDef("weighted", POLICY_WEIGHTED, "none", _wt_kernel, _wt_staged,
              _wt_host),
    PolicyDef("maglev", POLICY_MAGLEV, "none", _maglev_kernel,
              _maglev_staged, _maglev_host),
    PolicyDef("affinity", POLICY_AFFINITY, "none", _affinity_kernel,
              _affinity_staged, _affinity_host),
)

BY_ENUM: dict[int, PolicyDef] = {p.enum: p for p in REGISTRY}

#: enums whose shard merge rule needs the water-fill load carry-in
#: (``kernels/shard_admit.py::waterfill_lr``)
WATERFILL_ENUMS: tuple[int, ...] = tuple(
    p.enum for p in REGISTRY if p.shard_merge == "waterfill")

# import-time guards: the registry is dense over 0..N-1 and its names agree
# with POLICY_NAMES, so drift between the enum and the hooks fails here
assert tuple(p.enum for p in REGISTRY) == tuple(range(len(REGISTRY))), \
    "policy registry enums must be dense and ordered"
assert {p.name: p.enum for p in REGISTRY} == POLICY_NAMES, \
    "POLICY_NAMES and REGISTRY disagree"
assert (POLICY_RR, POLICY_RANDOM, POLICY_LEAST_REQUEST, POLICY_WEIGHTED,
        POLICY_MAGLEV, POLICY_AFFINITY) == tuple(range(6)), \
    "policy enum constants drifted"

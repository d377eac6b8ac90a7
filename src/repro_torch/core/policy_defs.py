"""The LB policies, defined once for the port (twin of
``repro/core/policy_defs.py``).

This slice carries the enum, the flow hash, the host-side Maglev table
builder and the six ``kernel_offset`` hooks as plain PyTorch over one tile
of requests.  The plain admission path (``kernels/route_match.py``) calls
the hooks; the CUDA kernel (``kernels/csrc/admit.cu``) computes the same
selections per thread and is held bit-exactly against them on the card.

Every hook receives a ``KernelCtx`` whose fields are, per request row of
the tile ((BR,) unless noted):

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

Hooks return WINDOW OFFSETS (int64 tensors).
"""

from __future__ import annotations

import types

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


#: enum → kernel_offset hook (dense over 0..5)
KERNEL_OFFSET = (_rr_kernel, _random_kernel, _lr_kernel, _wt_kernel,
                 _maglev_kernel, _affinity_kernel)

assert {v for v in POLICY_NAMES.values()} == set(range(len(KERNEL_OFFSET)))

"""Load-balancing policies over cluster endpoints, the staged lowering
(twin of ``repro/core/policies.py``).

``select`` builds the batch context and dispatches over the registry's
``staged_offset`` hooks (``core/policy_defs.py``).  The mutable LB state
(load counters, rr cursors, affinity cache) lives in ``RoutingState`` and
is returned updated, never written in place.  The arrival rank within a
cluster is the relay kernel's counting sort (``ops.relay_slots``).

The reference draws from a JAX key; the port takes the draws explicitly
(``rnd`` and ``gumbel``), and ``draws`` makes them from a
``torch.Generator`` for callers that serve.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import policy_defs
from repro_torch.core.policy_defs import POLICY_RR, flow_hash
from repro_torch.core.routing_table import MAX_EPS_PER_CLUSTER, RoutingState
from repro_torch.kernels import ops

_INT32_MIN = -2**31


class Selection(NamedTuple):
    endpoint: torch.Tensor   # (B,) i32 global endpoint (-1 = unroutable)
    instance: torch.Tensor   # (B,) i32 instance lane (-1 = unroutable)


def draws(generator: torch.Generator, B: int):
    """One batch of policy draws on the generator's device: ``rnd`` (B,)
    int32 in [0, 2**30) for the random policy and ``gumbel`` (B, 64) f32
    for the weighted policy."""
    dev = generator.device
    rnd = torch.randint(0, 1 << 30, (B,), generator=generator,
                        dtype=torch.int32, device=dev)
    u = torch.rand((B, MAX_EPS_PER_CLUSTER), generator=generator,
                   dtype=torch.float32, device=dev)
    tiny = torch.finfo(torch.float32).tiny
    return rnd, -torch.log(-torch.log(u.clamp_min(tiny)))


def select(state: RoutingState, cluster, rnd, gumbel, features=None
           ) -> tuple[Selection, RoutingState]:
    """Pick one endpoint per request under each cluster's policy and
    return the updated LB state.

    cluster: (B,) int, -1 (NO_ROUTE) → endpoint -1; rnd: (B,) int draws;
    gumbel: (B, 64) f32 noise; features: (B, F) int request features, hashed
    into the flow id of the hash-keyed policies (None → flow id 0).
    Drained endpoints are ineligible under every policy, and a cluster
    with no eligible endpoint is unroutable.
    """
    dev = cluster.device
    i64 = lambda t: t.to(torch.int64)
    B = cluster.shape[0]
    n_cl = state.cluster_ep_start.shape[0]
    E = state.ep_instance.shape[0]
    cluster = i64(cluster)
    cl = cluster.clamp(0, n_cl - 1)       # -1 and ids past the table clamp
    start, count = i64(state.cluster_ep_start)[cl], \
        i64(state.cluster_ep_count)[cl]
    win = torch.arange(MAX_EPS_PER_CLUSTER, device=dev)
    idx = (start[:, None] + win).clamp(0, E - 1)            # (B, WE)
    ok = (win < count[:, None]) & (i64(state.ep_drained)[idx] == 0)
    count2 = ok.sum(dim=1)
    routable = (cluster >= 0) & (count2 > 0)
    policy = i64(state.cluster_policy)[cl]
    cum = torch.cumsum(ok.to(torch.int64), dim=1)

    def kth(k):
        return torch.argmax((ok & (cum == (k + 1)[:, None])).to(torch.int32),
                            dim=1)

    # unroutable rows rank in the sentinel bucket n_cl, so they never
    # inflate the ranks of genuine cluster-0 traffic
    rank, _ = ops.relay_slots(torch.where(routable, cl, n_cl), n_cl + 1)
    fkey = (torch.zeros((B,), dtype=torch.int64, device=dev)
            if features is None else flow_hash(features))
    sctx = policy_defs.StagedCtx(
        state=state, cl=cl, start=start, count=count,
        cnt1=count2.clamp_min(1), ok=ok, idx=idx, rank=i64(rank),
        rnd=i64(rnd), fkey=fkey, gum=gumbel.to(torch.float32), kth=kth)
    off = policy_defs.BY_ENUM[POLICY_RR].staged_offset(sctx)  # unknown → rr
    for p in policy_defs.REGISTRY:
        if p.enum != POLICY_RR:
            off = torch.where(policy == p.enum, p.staged_offset(sctx), off)

    inside = (off >= 0) & (off < MAX_EPS_PER_CLUSTER)
    ep = torch.where(inside, idx.gather(
        1, off.clamp(0, MAX_EPS_PER_CLUSTER - 1)[:, None])[:, 0], _INT32_MIN)
    ep = torch.where(routable, ep, -1)
    epc = ep.clamp_min(0)
    inst = torch.where(routable, i64(state.ep_instance)[epc], -1)

    # load++ on the chosen endpoints, cursors advance, the affinity cache
    # learns first admits
    n_load = state.ep_load.shape[0]
    new_load = state.ep_load.to(torch.int32).index_add(
        0, epc.clamp(max=n_load - 1),
        (routable & (epc < n_load)).to(torch.int32))
    per_cluster = torch.zeros((n_cl,), dtype=torch.int64, device=dev)
    per_cluster.index_add_(0, cl, routable.to(torch.int64))
    new_cursor = (i64(state.rr_cursor) + per_cluster) \
        % i64(state.cluster_ep_count).clamp_min(1)
    nk, ne = policy_defs.affinity_staged_update(sctx, ep, routable, policy)
    state = state._replace(ep_load=new_load,
                           rr_cursor=new_cursor.to(torch.int32),
                           aff_key=nk, aff_ep=ne)
    return Selection(ep.to(torch.int32), inst.to(torch.int32)), state


def release(state: RoutingState, endpoint, done) -> RoutingState:
    """Decrement load counters for finished requests (connection close);
    endpoints outside [0, E) are skipped."""
    E = state.ep_load.shape[0]
    e = endpoint.to(torch.int64)
    dec = (done & (e >= 0) & (e < E)).to(torch.int32)
    return state._replace(ep_load=state.ep_load.to(torch.int32).index_add(
        0, e.clamp(0, E - 1), -dec))

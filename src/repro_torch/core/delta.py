"""Delta refresh: incremental control-plane updates (paper §4.2; twin of
``repro/core/delta.py``).

Adds follow bottom-up order (endpoints → cluster → rules → service),
deletes top-down, so a datapath mid-step on the previous state never
observes a dangling index.  Every function is pure: it returns a new
``RoutingState`` (tensors on the input's device, no host sync) with the
version bumped by one.

This is the raw slot-index layer: callers compute global slots and window
offsets themselves, and each call bumps the version.  Application code
goes through ``core/control.py::ControlPlane`` instead, which batches any
number of deltas into one buffer swap and owns the slot arithmetic.

Writes follow the reference's ``.at[i].set(v, mode="drop")``: a negative
index counts from the end, and an index still outside the table is
dropped.
"""

from __future__ import annotations

import torch

from repro_torch.core.routing_table import WILDCARD, RoutingState


def _bump(state: RoutingState) -> RoutingState:
    return state._replace(version=(state.version + 1).to(torch.int32))


def _put(t: torch.Tensor, i, v, add: bool = False) -> torch.Tensor:
    """``t`` with ``t[i] = v`` (or ``+= v``), ``i`` a Python int or a
    0-d tensor; out-of-range writes are dropped."""
    n = t.shape[0]
    i = torch.as_tensor(i, device=t.device).long()
    i = torch.where(i < 0, i + n, i)
    inside = (i >= 0) & (i < n)
    ic = i.clamp(0, n - 1).reshape(1)
    old = t[ic]
    new = (old + v) if add else torch.as_tensor(v, device=t.device)
    new = torch.where(inside, new.to(t.dtype), old)
    return t.index_put((ic,), new.reshape(1))


# --------------------------------------------------------------------------- #
# Endpoint level (lowest level first on add)
# --------------------------------------------------------------------------- #


def add_endpoint(state: RoutingState, cluster_id: int, ep_slot: int,
                 instance: int, weight: float = 1.0) -> RoutingState:
    """Insert one endpoint at global slot ``ep_slot``, then grow the
    cluster: the row is written before the count exposes it."""
    st = state._replace(
        ep_instance=_put(state.ep_instance, ep_slot, instance),
        ep_weight=_put(state.ep_weight, ep_slot, weight),
        ep_drained=_put(state.ep_drained, ep_slot, 0),
        ep_load=_put(state.ep_load, ep_slot, 0),
        ep_inflight_ewma=_put(state.ep_inflight_ewma, ep_slot, 0.0),
        ep_tput_ewma=_put(state.ep_tput_ewma, ep_slot, 0.0))
    st = st._replace(
        cluster_ep_count=_put(st.cluster_ep_count, cluster_id, 1, add=True))
    return _bump(st)


_EP_FIELDS = ("ep_instance", "ep_weight", "ep_drained", "ep_load",
              "ep_inflight_ewma", "ep_tput_ewma")
_EP_CLEAR = (-1, 1.0, 0, 0, 0.0, 0.0)


def remove_endpoint(state: RoutingState, cluster_id: int, ep_off: int
                    ) -> RoutingState:
    """Top-down: shrink the cluster count first, then compact the window
    by moving the last endpoint (with its load) into the vacated offset,
    and zero the vacated last slot.  Removing from an empty cluster is a
    version-bump no-op: both writes go to the drop sentinel E."""
    E = state.ep_instance.shape[0]
    start = state.cluster_ep_start[cluster_id].long()
    count = state.cluster_ep_count[cluster_id].long()
    has = count > 0
    st = state._replace(cluster_ep_count=_put(
        state.cluster_ep_count, cluster_id, -has.long(), add=True))
    last = torch.where(has, start + count - 1, E)
    off = torch.minimum(torch.clamp_min(count - 1, 0),
                       torch.as_tensor(max(ep_off, 0), device=count.device))
    tgt = torch.where(has, start + off, E)
    lastc = last.clamp_max(E - 1)
    moved = {f: _put(getattr(st, f), tgt, getattr(st, f)[lastc])
             for f in _EP_FIELDS}
    cleared = {f: _put(moved[f], last, v)
               for f, v in zip(_EP_FIELDS, _EP_CLEAR)}
    return _bump(st._replace(**cleared))


# --------------------------------------------------------------------------- #
# Rule level
# --------------------------------------------------------------------------- #


def add_rule(state: RoutingState, svc_id: int, rule_slot: int, field: int,
             value_hash: int, cluster_id: int) -> RoutingState:
    """Write the rule row first (bottom), then extend the service chain."""
    st = state._replace(
        rule_field=_put(state.rule_field, rule_slot, field),
        rule_value=_put(state.rule_value, rule_slot, value_hash),
        rule_cluster=_put(state.rule_cluster, rule_slot, cluster_id))
    st = st._replace(svc_rule_count=_put(st.svc_rule_count, svc_id, 1,
                                         add=True))
    return _bump(st)


_RULE_FIELDS = ("rule_field", "rule_value", "rule_cluster")
_RULE_CLEAR = (0, WILDCARD, -1)


def remove_rule(state: RoutingState, svc_id: int, rule_off: int
                ) -> RoutingState:
    """Top-down: shrink the chain, then compact (swap-with-last); the
    vacated last row resets to the empty-state defaults.  Removing from
    an empty chain is a version-bump no-op."""
    R = state.rule_field.shape[0]
    start = state.svc_rule_start[svc_id].long()
    count = state.svc_rule_count[svc_id].long()
    has = count > 0
    st = state._replace(svc_rule_count=_put(
        state.svc_rule_count, svc_id, -has.long(), add=True))
    last = torch.where(has, start + count - 1, R)
    off = torch.minimum(torch.clamp_min(count - 1, 0),
                        torch.as_tensor(max(rule_off, 0),
                                        device=count.device))
    tgt = torch.where(has, start + off, R)
    lastc = last.clamp_max(R - 1)
    moved = {f: _put(getattr(st, f), tgt, getattr(st, f)[lastc])
             for f in _RULE_FIELDS}
    cleared = {f: _put(moved[f], last, v)
               for f, v in zip(_RULE_FIELDS, _RULE_CLEAR)}
    return _bump(st._replace(**cleared))


def set_policy(state: RoutingState, cluster_id: int, policy: int
               ) -> RoutingState:
    return _bump(state._replace(
        cluster_policy=_put(state.cluster_policy, cluster_id, policy)))


def set_weight(state: RoutingState, ep_slot: int, weight: float
               ) -> RoutingState:
    return _bump(state._replace(
        ep_weight=_put(state.ep_weight, ep_slot, weight)))


def set_drained(state: RoutingState, ep_slot: int, drained: bool
                ) -> RoutingState:
    """Raise or clear the drain bit: a drained endpoint receives no new
    traffic under any policy."""
    return _bump(state._replace(
        ep_drained=_put(state.ep_drained, ep_slot, int(drained))))

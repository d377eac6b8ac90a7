"""Nested-map routing state (twin of ``repro/core/routing_table.py``).

The Envoy-style configuration tree (listener → route → cluster → endpoint)
flattened into capacity-bounded int32/float32 tensors with index
references in place of pointers.  ``build_state`` compiles a config in
numpy and moves the tables to the requested device.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.policy_defs import (AFFINITY_SLOTS,  # noqa: F401
                                          MAGLEV_TABLE_SIZE,
                                          POLICY_AFFINITY,
                                          POLICY_LEAST_REQUEST,
                                          POLICY_MAGLEV, POLICY_NAMES,
                                          POLICY_RANDOM, POLICY_RR,
                                          POLICY_WEIGHTED,
                                          build_maglev_table)

# Capacity bounds (the paper's FILTER_MAX_NUM / ROUTE_MAX_NUM / map capacity).
MAX_SERVICES = 64          # listeners (virtual IPs)
MAX_RULES = 256            # route rules, globally
MAX_RULES_PER_SVC = 16     # bounded rule-chain walk per request
MAX_CLUSTERS = 64          # destination clusters
MAX_ENDPOINTS = 512        # backend instances, globally
MAX_EPS_PER_CLUSTER = 64   # bounded LB scan per cluster
N_FEATURES = 8             # hashed L7 header fields per request

WILDCARD = -1


class RoutingState(NamedTuple):
    """All tables the datapath reads (+ the counters it writes)."""

    svc_rule_start: torch.Tensor    # (MAX_SERVICES,) i32 → index into rule_*
    svc_rule_count: torch.Tensor    # (MAX_SERVICES,) i32
    rule_field: torch.Tensor        # (MAX_RULES,) i32 feature column
    rule_value: torch.Tensor        # (MAX_RULES,) i32 expected hash; -1 any
    rule_cluster: torch.Tensor      # (MAX_RULES,) i32 destination cluster
    cluster_ep_start: torch.Tensor  # (MAX_CLUSTERS,) i32 → index into ep_*
    cluster_ep_count: torch.Tensor  # (MAX_CLUSTERS,) i32
    cluster_policy: torch.Tensor    # (MAX_CLUSTERS,) i32 POLICY_*
    ep_instance: torch.Tensor       # (MAX_ENDPOINTS,) i32 instance-lane id
    ep_weight: torch.Tensor         # (MAX_ENDPOINTS,) f32
    ep_drained: torch.Tensor        # (MAX_ENDPOINTS,) i32 1 = no new traffic
    maglev_table: torch.Tensor      # (MAX_CLUSTERS, MAGLEV_TABLE_SIZE) i32
    ep_load: torch.Tensor           # (MAX_ENDPOINTS,) i32 outstanding requests
    ep_inflight_ewma: torch.Tensor  # (MAX_ENDPOINTS,) f32 in-flight EWMA
    ep_tput_ewma: torch.Tensor      # (MAX_ENDPOINTS,) f32 completions EWMA
    rr_cursor: torch.Tensor         # (MAX_CLUSTERS,) i32 round-robin cursor
    aff_key: torch.Tensor           # (AFFINITY_SLOTS,) i32 flow id, -1 empty
    aff_ep: torch.Tensor            # (AFFINITY_SLOTS,) i32 cached endpoint
    version: torch.Tensor           # () i32, bumped by every delta refresh

    def to(self, device) -> "RoutingState":
        return RoutingState(*[t.to(device) for t in self])


class FlowMetrics(NamedTuple):
    """Per-service traffic metrics.  ``overflow`` counts hold events, one
    per admission attempt (a re-queued request counts once per attempt)."""

    tx_bytes: torch.Tensor          # (MAX_SERVICES,) i32
    rx_bytes: torch.Tensor          # (MAX_SERVICES,) i32
    requests: torch.Tensor          # (MAX_SERVICES,) i32
    no_route_match: torch.Tensor    # () i32
    overflow: torch.Tensor          # () i32 hold events per attempt

    @staticmethod
    def zeros(device) -> "FlowMetrics":
        z = lambda *s: torch.zeros(s, dtype=torch.int32, device=device)
        return FlowMetrics(z(MAX_SERVICES), z(MAX_SERVICES),
                           z(MAX_SERVICES), z(), z())


def _empty_numpy() -> dict[str, np.ndarray]:
    i = lambda n: np.zeros((n,), np.int32)
    return dict(
        svc_rule_start=i(MAX_SERVICES), svc_rule_count=i(MAX_SERVICES),
        rule_field=i(MAX_RULES),
        rule_value=np.full((MAX_RULES,), WILDCARD, np.int32),
        rule_cluster=np.full((MAX_RULES,), -1, np.int32),
        cluster_ep_start=i(MAX_CLUSTERS), cluster_ep_count=i(MAX_CLUSTERS),
        cluster_policy=i(MAX_CLUSTERS),
        ep_instance=np.full((MAX_ENDPOINTS,), -1, np.int32),
        ep_weight=np.ones((MAX_ENDPOINTS,), np.float32),
        ep_drained=i(MAX_ENDPOINTS),
        maglev_table=np.full((MAX_CLUSTERS, MAGLEV_TABLE_SIZE), -1,
                             np.int32),
        ep_load=i(MAX_ENDPOINTS),
        ep_inflight_ewma=np.zeros((MAX_ENDPOINTS,), np.float32),
        ep_tput_ewma=np.zeros((MAX_ENDPOINTS,), np.float32),
        rr_cursor=i(MAX_CLUSTERS),
        aff_key=np.full((AFFINITY_SLOTS,), -1, np.int32),
        aff_ep=np.full((AFFINITY_SLOTS,), -1, np.int32),
        version=np.zeros((), np.int32),
    )


def state_from_numpy(arrays: dict, device) -> RoutingState:
    """A ``RoutingState`` from a field-name → array mapping, on ``device``."""
    return RoutingState(*[torch.as_tensor(np.asarray(arrays[f])).to(device)
                          for f in RoutingState._fields])


def empty_state(device) -> RoutingState:
    return state_from_numpy(_empty_numpy(), device)


# --------------------------------------------------------------------------- #
# Host-side (control plane) builder
# --------------------------------------------------------------------------- #


def fnv1a(s: str) -> int:
    """Stable 31-bit string hash (the host-side 'protocol parse' helper)."""
    h = 0x811C9DC5
    for ch in s.encode():
        h = ((h ^ ch) * 0x01000193) & 0xFFFFFFFF
    return int(h & 0x7FFFFFFF)


@dataclasses.dataclass
class Rule:
    field: int                   # feature column
    value: str | None            # None = wildcard
    cluster: str


@dataclasses.dataclass
class Cluster:
    name: str
    endpoints: list[int]         # instance-lane ids
    policy: int = POLICY_LEAST_REQUEST
    weights: list[float] | None = None


@dataclasses.dataclass
class ServiceConfig:
    name: str
    rules: list[Rule]


def build_state(services: list[ServiceConfig], clusters: list[Cluster],
                device) -> tuple[RoutingState, dict[str, dict[str, int]]]:
    """Compile a control-plane config tree into the flat tables on
    ``device``.  Returns (state, name→id maps for services and clusters)."""
    if len(services) > MAX_SERVICES or len(clusters) > MAX_CLUSTERS:
        raise ValueError("config exceeds the service/cluster capacity")
    st = _empty_numpy()
    cluster_id = {c.name: i for i, c in enumerate(clusters)}
    svc_id = {s.name: i for i, s in enumerate(services)}

    ep_cursor = 0
    for ci, c in enumerate(clusters):
        n = len(c.endpoints)
        if n > MAX_EPS_PER_CLUSTER or ep_cursor + n > MAX_ENDPOINTS:
            raise ValueError(f"cluster {c.name!r} exceeds endpoint capacity")
        st["cluster_ep_start"][ci] = ep_cursor
        st["cluster_ep_count"][ci] = n
        st["cluster_policy"][ci] = c.policy
        st["ep_instance"][ep_cursor:ep_cursor + n] = c.endpoints
        if c.weights is not None:
            st["ep_weight"][ep_cursor:ep_cursor + n] = c.weights
        ep_cursor += n

    st["maglev_table"][...] = build_maglev_table(
        st["cluster_ep_start"], st["cluster_ep_count"], st["ep_instance"],
        st["ep_drained"])

    rule_cursor = 0
    for si, s in enumerate(services):
        if len(s.rules) > MAX_RULES_PER_SVC:
            raise ValueError(f"service {s.name!r} has too many rules")
        st["svc_rule_start"][si] = rule_cursor
        st["svc_rule_count"][si] = len(s.rules)
        for r in s.rules:
            st["rule_field"][rule_cursor] = r.field
            st["rule_value"][rule_cursor] = (WILDCARD if r.value is None
                                             else fnv1a(r.value))
            st["rule_cluster"][rule_cursor] = cluster_id[r.cluster]
            rule_cursor += 1

    return state_from_numpy(st, device), {"services": svc_id,
                                          "clusters": cluster_id}

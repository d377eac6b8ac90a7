"""Declarative invariants of the routing tables (twin of
``repro/analysis/invariants.py``): the plan wire checks.

``core/control.py::unpack_plan`` validates every payload against
:data:`FIELD_BOUNDS` and :data:`PLAN_LAWS` before anything is applied, as
the eBPF side sanitizes map updates before the datapath may read them.
A law returns a list of violation strings (empty = holds), and
:func:`check_plan_wire` prefixes each with the law's name.

Only the plan-wire part is here.  The conservation laws run under
``XLB_SANITIZE=1``, the sanitizer that runs them and the row schemas of
the benchmark trend file are not ported yet.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from repro_torch.core.policy_defs import BIG, POLICY_NAMES
from repro_torch.core.routing_table import (MAX_CLUSTERS, MAX_ENDPOINTS,
                                            MAX_EPS_PER_CLUSTER, MAX_RULES,
                                            MAX_RULES_PER_SVC, N_FEATURES,
                                            WILDCARD)

INT32_MAX = 2**31 - 1


# --------------------------------------------------------------------------- #
# Table-value bounds: what every int32 routing-table cell may hold.
# --------------------------------------------------------------------------- #

FIELD_BOUNDS: dict[str, tuple[int, int]] = {
    "svc_rule_start": (0, MAX_RULES - 1),
    "svc_rule_count": (0, MAX_RULES_PER_SVC),
    "rule_field": (0, N_FEATURES - 1),
    "rule_value": (WILDCARD, INT32_MAX),
    "rule_cluster": (-1, MAX_CLUSTERS - 1),
    "cluster_ep_start": (0, MAX_ENDPOINTS - 1),
    "cluster_ep_count": (0, MAX_EPS_PER_CLUSTER),
    "cluster_policy": (0, len(POLICY_NAMES) - 1),
    "ep_instance": (-1, INT32_MAX),
    "ep_drained": (0, 1),
    # maglev rows hold WINDOW OFFSETS (-1 = empty), not absolute slots
    "maglev_table": (-1, MAX_EPS_PER_CLUSTER - 1),
    "ep_src": (-1, MAX_ENDPOINTS - 1),
    "ep_dst": (-1, MAX_ENDPOINTS - 1),
    # mutable datapath state (kept in bounds by the kernels themselves;
    # BIG is the least-request sentinel ceiling)
    "ep_load": (0, BIG),
    "rr_cursor": (0, INT32_MAX),
    "aff_key": (-1, INT32_MAX),
    "aff_ep": (-1, MAX_ENDPOINTS - 1),
}


# --------------------------------------------------------------------------- #
# Plan wire laws: cross-field invariants of a packed RefreshPlan.
# --------------------------------------------------------------------------- #


def _law_field_bounds(a: dict) -> list[str]:
    errs = []
    for k, (lo, hi) in FIELD_BOUNDS.items():
        if k not in a:
            continue
        v = np.asarray(a[k])
        if not np.issubdtype(v.dtype, np.integer):
            continue
        if v.size and (int(v.min()) < lo or int(v.max()) > hi):
            errs.append(f"field {k!r} out of bounds [{lo}, {hi}]: "
                        f"min={int(v.min())}, max={int(v.max())}")
    return errs


def _law_windows(a: dict) -> list[str]:
    """Rule and endpoint windows stay inside their tables, and occupied
    cluster windows are pairwise disjoint."""
    errs = []
    ss, sc = np.asarray(a["svc_rule_start"]), np.asarray(a["svc_rule_count"])
    if np.any((sc > 0) & (ss + sc > MAX_RULES)):
        errs.append("service rule window exceeds MAX_RULES")
    cs = np.asarray(a["cluster_ep_start"])
    cc = np.asarray(a["cluster_ep_count"])
    if np.any((cc > 0) & (cs + cc > MAX_ENDPOINTS)):
        errs.append("cluster endpoint window exceeds MAX_ENDPOINTS")
    occupied = np.zeros((MAX_ENDPOINTS,), np.int32)
    for c in np.nonzero(cc > 0)[0]:
        occupied[cs[c]:cs[c] + cc[c]] += 1
    if int(occupied.max(initial=0)) > 1:
        errs.append("cluster endpoint windows overlap "
                    f"(slot {int(np.argmax(occupied))} owned twice)")
    return errs


def _law_permutation(a: dict) -> list[str]:
    """ep_src and ep_dst are mutually consistent partial permutations, or
    ``apply_plan`` would count an in-flight load twice."""
    errs = []
    src, dst = np.asarray(a["ep_src"]), np.asarray(a["ep_dst"])
    live = np.nonzero(src >= 0)[0]
    if live.size and np.any(dst[src[live]] != live):
        errs.append("ep_src/ep_dst disagree (dst[src[n]] != n)")
    kept = np.nonzero(dst >= 0)[0]
    if kept.size:
        if np.any(src[dst[kept]] != kept):
            errs.append("ep_dst/ep_src disagree (src[dst[e]] != e)")
        vals = dst[kept]
        if np.unique(vals).size != vals.size:
            errs.append("ep_dst maps two old slots to one new slot")
    return errs


def _law_version(a: dict) -> list[str]:
    """A versioned plan advances past the config it was diffed against
    (-1 = unversioned)."""
    base, version = int(a["base_version"]), int(a["version"])
    if version == 0 or (version > 0 and base >= version):
        return [f"base_version={base}, version={version}"]
    return []


PLAN_LAWS: tuple[tuple[str, Callable[[dict], list[str]]], ...] = (
    ("field-bounds", _law_field_bounds),
    ("window-disjoint", _law_windows),
    ("slot-permutation", _law_permutation),
    ("version-monotone", _law_version),
)


def check_plan_wire(arrays: dict) -> list[str]:
    """All plan-law violations of an unpacked wire dict (shape and dtype
    checks are ``unpack_plan``'s; this is the semantic layer on top)."""
    errs = []
    for name, law in PLAN_LAWS:
        errs += [f"[{name}] {e}" for e in law(arrays)]
    return errs

"""Declarative invariants (twin of ``repro/analysis/invariants.py``):
conservation laws, table-value bounds and row schemas, written once.

  * **Plan wire checks**: ``core/control.py::unpack_plan`` validates every
    payload against :data:`FIELD_BOUNDS` and :data:`PLAN_LAWS` before
    anything is applied, as the eBPF side sanitizes map updates before the
    datapath may read them.  A plan law returns a list of violation
    strings (empty = holds); :func:`check_plan_wire` prefixes each with
    the law's name.
  * **The sanitizer**: under ``XLB_SANITIZE=1`` the kernel wrappers
    (``kernels/ops.py``) run :func:`guard` on their outputs and
    ``ServeLoop`` runs :func:`assert_host` after every tick.  The device
    laws are functions on tensors: ``guard`` evaluates them on the
    tensors' own device and stacks the verdicts.  Called eagerly it reads
    them back with one ``.cpu()`` and raises ``AssertionError`` naming
    the first law that failed.  Inside :func:`deferred` (the engine's
    captured tick, ``runtime/graphs.py::StaticTick``, opens it around its
    body) it reads nothing: it records the scope, the laws and the
    verdict tensor, the body writes the verdicts into a static device
    buffer, and after the call (a replay on the card, the body itself on
    the CPU) the tick reads that buffer once and :func:`raise_first`
    raises the same text.  That is the reference's ``checkify`` program
    (checks functionalized inside one jitted program, one ``err.throw()``
    on the host after it).
  * **Row schemas** of the scenario and chaos trend rows
    (``workload/slo.py`` builds and validates rows with them).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import os
from typing import Any, Callable, Iterator

import numpy as np
import torch

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


# --------------------------------------------------------------------------- #
# Conservation laws: the device (tensor) and host (python) registries.
# --------------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class Law:
    """One conservation law: ``check(ctx)`` over the ctx keys in
    ``requires``.  ``traced`` laws take tensors and return a bool scalar
    tensor on their device; host laws take plain python values."""

    name: str
    scope: str               # admit | complete | loop | chain
    doc: str
    requires: tuple[str, ...]
    check: Callable[[dict], Any]
    traced: bool = True


def _l_admit_load(c):
    return (c["load_after"].sum() - c["load_before"].sum()
            == c["ok"].sum())


def _l_load_nonneg(c):
    return c["load_after"].min() >= 0


def _l_admit_held(c):
    return c["held"] == ((c["endpoint"] >= 0) & (c["ok"] == 0)).sum()


def _l_admit_pool(c):
    # clip before the gather: a rejected row's -1 instance or slot must
    # never index out of range on the card
    I, C = c["pool_req_id"].shape
    ii = c["instance"].long().clamp(0, I - 1)
    ss = c["slot"].long().clamp(0, C - 1)
    ok = c["ok"] > 0
    stored = c["pool_req_id"][ii, ss]
    act = c["pool_active"][ii, ss] != 0
    return (~ok | ((stored == c["req_id"]) & act)).all()


def _l_complete_release(c):
    return (c["load_before"].sum() - c["load_after"].sum()
            == c["done_cnt"].sum())


def _l_complete_free(c):
    done = c["done"] != 0
    freed = ~done | (c["active_after"] == 0)
    cleared = ~done | (c["req_id_after"] == -1)
    return freed.all() & cleared.all()


def _l_loop_queue(c):
    return (c["submitted"]
            == c["done"] + c["dropped"] + c["queued"] + c["inflight"])


def _l_chain_position(c):
    return all(0 <= p < c["depth"] for p in c["positions"])


def _l_chain_disjoint(c):
    return not (set(c["positions_ids"]) & set(c["done_ids"]))


LAWS: tuple[Law, ...] = (
    Law("load-delta-conservation", "admit",
        "sum of ep_load deltas == admitted count (admits - releases)",
        ("load_before", "load_after", "ok"), _l_admit_load),
    Law("load-nonnegative", "admit",
        "outstanding-request counters never go negative",
        ("load_after",), _l_load_nonneg),
    Law("held-accounting", "admit",
        "held == routable requests that did not land a slot",
        ("held", "endpoint", "ok"), _l_admit_held),
    Law("admit-commit-visible", "admit",
        "every admitted (instance, slot) holds the request in the pool",
        ("pool_req_id", "pool_active", "instance", "slot", "ok", "req_id"),
        _l_admit_pool),
    Law("release-conservation", "complete",
        "sum of ep_load releases == completions counted",
        ("load_before", "load_after", "done_cnt"), _l_complete_release),
    Law("load-nonnegative", "complete",
        "outstanding-request counters never go negative",
        ("load_after",), _l_load_nonneg),
    Law("done-frees-slot", "complete",
        "a completed slot is inactive with req_id == -1",
        ("done", "active_after", "req_id_after"), _l_complete_free),
    Law("queue-conservation", "loop",
        "submitted == done + dropped + queued + inflight",
        ("submitted", "done", "dropped", "queued", "inflight"),
        _l_loop_queue, traced=False),
    Law("position-in-range", "chain",
        "every in-chain request sits at a real hop",
        ("positions", "depth"), _l_chain_position, traced=False),
    Law("done-disjoint", "chain",
        "a finished request is no longer positioned in the chain",
        ("positions_ids", "done_ids"), _l_chain_disjoint, traced=False),
)


def laws(scope: str) -> list[Law]:
    return [l for l in LAWS if l.scope == scope]


# --------------------------------------------------------------------------- #
# The XLB_SANITIZE=1 sanitizer.
# --------------------------------------------------------------------------- #


def sanitize_enabled() -> bool:
    return os.environ.get("XLB_SANITIZE", "0") not in ("", "0")


#: the sink of the enclosing :func:`deferred`, None outside one
_DEFERRED: contextvars.ContextVar = contextvars.ContextVar(
    "xlb_sanitize_deferred", default=None)


@contextlib.contextmanager
def deferred() -> Iterator[list]:
    """Inside: :func:`guard` reads nothing back; it appends ``(scope,
    laws, verdicts)`` to the list this yields, ``verdicts`` a bool tensor
    on the laws' device, one entry a law, in the guards' call order."""
    sink: list = []
    token = _DEFERRED.set(sink)
    try:
        yield sink
    finally:
        _DEFERRED.reset(token)


def raise_first(verdicts, recorded) -> None:
    """Raise ``AssertionError`` naming the first violated law: ``recorded``
    is ``[(scope, laws), ...]`` in the guards' call order, ``verdicts``
    the host booleans of those laws, flattened in the same order (by
    guard call, then by law within a call: the eager order, and
    ``checkify``'s)."""
    flat = [(scope, law) for scope, active in recorded for law in active]
    if len(flat) != len(verdicts):
        raise ValueError(f"{len(verdicts)} verdicts for {len(flat)} laws")
    for (scope, law), ok in zip(flat, verdicts):
        if not ok:
            raise AssertionError(
                f"XLB_SANITIZE[{scope}/{law.name}]: {law.doc}")


def guard(scope: str, ctx: dict) -> None:
    """Run every device law of ``scope`` whose ctx keys are present and
    raise ``AssertionError`` naming the first violated law.  The laws run
    where the tensors lie; their verdicts come back to the host in one
    ``.cpu()`` (one sync per call), or, inside :func:`deferred`, not at
    all: they go to its sink.  Callers gate on :func:`sanitize_enabled`:
    this is the opt-in sanitizer, not a hot-path check."""
    active = tuple(l for l in laws(scope)
                   if l.traced and set(l.requires) <= set(ctx))
    if not active:
        return
    ctx = {k: torch.as_tensor(v) for k, v in ctx.items()}
    verdicts = torch.stack([law.check(ctx).reshape(()) for law in active])
    sink = _DEFERRED.get()
    if sink is not None:
        sink.append((scope, active, verdicts))
        return
    raise_first(verdicts.cpu().tolist(), [(scope, active)])


def assert_host(scope: str, ctx: dict) -> None:
    """Run the host-side laws of ``scope``; raise AssertionError naming
    the violated law."""
    for law in laws(scope):
        if law.traced or not set(law.requires) <= set(ctx):
            continue
        if not law.check(ctx):
            raise AssertionError(
                f"XLB_SANITIZE[{scope}/{law.name}]: {law.doc} — ctx="
                + repr({k: ctx[k] for k in law.requires
                        if not isinstance(ctx[k], (list, set, dict))}))


# --------------------------------------------------------------------------- #
# Trend-row schemas: the scenario and chaos rows, field specs plus
# cross-field laws.
# --------------------------------------------------------------------------- #

SCENARIO_ROW_REQUIRED = {
    "bench": str, "scenario": str, "mode": str, "depth": int, "seed": int,
    "arrivals": str, "n_requests": int, "completed": int, "dropped": int,
    "ticks": int, "p50_ticks": float, "p99_ticks": float,
    "p999_ticks": float,
}
SCENARIO_ROW_OPTIONAL = {
    "service": str, "scale": float, "ops": int, "txns": int,
    "held_first": int, "rate": float, "shards": int,
    "mean_ticks": float, "per_hop_p99_ticks": list,
    "health_txns": int, "end_weights": list,
}
CHAOS_ROW_REQUIRED = {
    "bench": str, "scenario": str, "mode": str, "seed": int,
    "n_requests": int, "completed": int, "dropped": int, "ticks": int,
    "flush_ticks": int, "versions": int, "consumers": int,
    "resyncs": int, "crashes": int, "converged": bool,
    "healthy_p99_ticks": float, "chaos_p99_ticks": float,
    "recovered_p99_ticks": float, "recovery_ratio": float,
    "msgs_sent": int, "msgs_dropped": int, "msgs_duped": int,
    "msgs_delivered": int,
}
CHAOS_ROW_OPTIONAL = {
    "msgs_partitioned": int, "stale": int, "held": int, "rejected": int,
    "plan_sends": int, "snap_sends": int, "ops": int, "txns": int,
    "rate": float, "baseline_p99_ticks": float,
}


def type_errs(row: dict, required: dict, optional: dict) -> list[str]:
    """Field-presence + type errors for one row schema.  ``bool`` fields
    accept only bool; ``float`` fields accept int-or-float (never bool)."""
    def ok(v, t):
        if t is bool:
            return isinstance(v, bool)
        if isinstance(v, bool):
            return False
        if t is float:
            return isinstance(v, (int, float))
        return isinstance(v, t)

    errs = []
    for k, t in required.items():
        if k not in row:
            errs.append(f"missing field {k!r}")
        elif not ok(row[k], t):
            errs.append(f"field {k!r} wants {t.__name__}, got "
                        f"{type(row[k]).__name__}")
    allowed = set(required) | set(optional) | {"ts", "commit"}
    for k in row:
        if k not in allowed:
            errs.append(f"unknown field {k!r}")
        elif k in optional and not ok(row[k], optional[k]):
            errs.append(f"field {k!r} wants {optional[k].__name__}, got "
                        f"{type(row[k]).__name__}")
    return errs


def _scenario_laws(row: dict) -> list[str]:
    errs = []
    if row["completed"] + row["dropped"] > row["n_requests"]:
        errs.append("completed + dropped exceeds n_requests")
    ps = [row["p50_ticks"], row["p99_ticks"], row["p999_ticks"]]
    fin = [p for p in ps if not np.isnan(p)]
    if fin != sorted(fin):
        errs.append("percentiles not monotone (p50 <= p99 <= p999)")
    return errs


def _chaos_laws(row: dict) -> list[str]:
    errs = []
    if row["completed"] + row["dropped"] > row["n_requests"]:
        errs.append("completed + dropped exceeds n_requests")
    for k in ("versions", "consumers", "resyncs", "crashes", "msgs_sent",
              "msgs_dropped", "msgs_duped", "msgs_delivered"):
        if row[k] < 0:
            errs.append(f"field {k!r} negative")
    if row["msgs_delivered"] > row["msgs_sent"] + row["msgs_duped"]:
        errs.append("delivered exceeds sent + duplicated")
    if not np.isnan(row["recovery_ratio"]) and row["recovery_ratio"] < 0:
        errs.append("recovery_ratio negative")
    return errs


@dataclasses.dataclass(frozen=True)
class RowSchema:
    """Declarative trend-row schema: field specs + cross-field laws."""

    bench: str
    required: dict
    optional: dict
    cross: Callable[[dict], list[str]]

    def errors(self, row: dict) -> list[str]:
        errs = type_errs(row, self.required, self.optional)
        if not errs:
            if row["bench"] != self.bench:
                errs.append(f'bench must be "{self.bench}", got '
                            f'{row["bench"]!r}')
            else:
                errs += self.cross(row)
        return errs


ROW_SCHEMAS: dict[str, RowSchema] = {
    "scenario": RowSchema("scenario", SCENARIO_ROW_REQUIRED,
                          SCENARIO_ROW_OPTIONAL, _scenario_laws),
    "chaos": RowSchema("chaos", CHAOS_ROW_REQUIRED, CHAOS_ROW_OPTIONAL,
                       _chaos_laws),
}


def validate_row(row: dict, kind: str) -> None:
    """Raise ValueError on any schema violation of a ``kind`` trend row."""
    errs = ROW_SCHEMAS[kind].errors(row)
    if errs:
        raise ValueError(f"invalid {kind} row: " + "; ".join(errs))

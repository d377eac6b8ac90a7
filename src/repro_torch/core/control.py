"""ControlPlane: the paper's userspace control daemon (§4.2) as a
transactional, named API over the nested-map routing tables (twin of
``repro/core/control.py``).

The daemon owns everything the datapath must never own:

  * the **name → id directory** of services and clusters;
  * a **slot allocator** over the flat endpoint and rule arrays: every
    cluster (service) holds a contiguous window whose extent comes from a
    free-list; windows relocate when they outgrow their capacity and the
    vacated extent returns to the free-list;
  * **transactions**: ``with cp.transaction(): ...`` batches any number of
    named deltas into one buffer swap with a single version bump.  Adds
    write bottom-up (the endpoint row before the count that exposes it),
    deletes top-down (the count shrinks before the row is compacted); the
    order is observable through ``last_commit_log``;
  * **swap-with-last hygiene**: compaction migrates the moved endpoint's
    in-flight load with it and zeroes the vacated slot; consumers remap
    their pool's endpoint references through the plan's old → new map;
  * **drain before remove**: ``drain_endpoint`` zeroes the weight and
    raises the drain bit at once, but the row survives until every leased
    consumer's live load for it reads zero; a later commit reaps it.

The directory, the allocator and the staged tables are host numpy.  A
commit compiles into a :class:`RefreshPlan` (new config arrays plus an
endpoint slot permutation) and hands it to every attached consumer, which
splices it into its live state with :func:`apply_plan`: the config
tables swap, load counters and health EWMAs gather through the
permutation, ``rr_cursor`` passes through, and the version bumps once.
``apply_plan`` works on torch tensors on the live state's device and
uploads the plan in one copy without a host sync.  The reaper reads each
leased consumer's live ``routing.ep_load`` on the host: for a consumer
on the card that is one ``.cpu()`` read, a host sync, per commit that
has a drain pending.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import dataclasses
import weakref
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.analysis.invariants import check_plan_wire
from repro_torch.core import policy_defs
from repro_torch.core.routing_table import (AFFINITY_SLOTS, MAGLEV_TABLE_SIZE,
                                            MAX_CLUSTERS, MAX_ENDPOINTS,
                                            MAX_EPS_PER_CLUSTER, MAX_RULES,
                                            MAX_RULES_PER_SVC, MAX_SERVICES,
                                            POLICY_LEAST_REQUEST, WILDCARD,
                                            Cluster, RoutingState, Rule,
                                            ServiceConfig, build_state, fnv1a)

# The tables the control plane owns.  The rest of RoutingState (ep_load,
# the EWMAs, rr_cursor, the affinity cache, version) is datapath-owned and
# only migrated by a commit.  ``maglev_table`` is config, rebuilt per
# dirty row inside ``_commit``.
CONFIG_FIELDS = ("svc_rule_start", "svc_rule_count", "rule_field",
                 "rule_value", "rule_cluster", "cluster_ep_start",
                 "cluster_ep_count", "cluster_policy", "ep_instance",
                 "ep_weight", "ep_drained", "maglev_table")


class RefreshPlan(NamedTuple):
    """One committed transaction, ready to splice into any live state.

    The control plane's wire format: one commit, one plan, fanned out to
    every attached consumer, or shipped as a plain ndarray dict through
    ``pack_plan``/``unpack_plan``.  ``base_version`` is the config
    version the plan was diffed against; ``version`` is stamped by
    ``apply_plan`` (-1 for both: unversioned, the live version + 1)."""

    config: tuple            # new config arrays (numpy), CONFIG_FIELDS order
    ep_src: np.ndarray       # (E,) i32: new slot → old slot (-1 = fresh)
    ep_dst: np.ndarray       # (E,) i32: old slot → new slot (-1 = removed)
    base_version: int = -1
    version: int = -1


# Expected wire shapes and kinds of every pack_plan field: what
# unpack_plan checks a payload against before anything is applied.
_WIRE_SPECS: dict = {
    "svc_rule_start": ((MAX_SERVICES,), "i"),
    "svc_rule_count": ((MAX_SERVICES,), "i"),
    "rule_field": ((MAX_RULES,), "i"),
    "rule_value": ((MAX_RULES,), "i"),
    "rule_cluster": ((MAX_RULES,), "i"),
    "cluster_ep_start": ((MAX_CLUSTERS,), "i"),
    "cluster_ep_count": ((MAX_CLUSTERS,), "i"),
    "cluster_policy": ((MAX_CLUSTERS,), "i"),
    "ep_instance": ((MAX_ENDPOINTS,), "i"),
    "ep_weight": ((MAX_ENDPOINTS,), "f"),
    "ep_drained": ((MAX_ENDPOINTS,), "i"),
    "maglev_table": ((MAX_CLUSTERS, MAGLEV_TABLE_SIZE), "i"),
    "ep_src": ((MAX_ENDPOINTS,), "i"),
    "ep_dst": ((MAX_ENDPOINTS,), "i"),
}


def pack_plan(plan: RefreshPlan) -> dict:
    """Flatten a plan into a name → ndarray dict for a consumer that is
    not in this process.  Inverse of :func:`unpack_plan`, bit-exact."""
    out = {k: np.asarray(v) for k, v in zip(CONFIG_FIELDS, plan.config)}
    out["ep_src"] = np.asarray(plan.ep_src)
    out["ep_dst"] = np.asarray(plan.ep_dst)
    out["base_version"] = int(plan.base_version)
    out["version"] = int(plan.version)
    return out


def _wire_scalar(arrays: dict, key: str) -> int:
    v = arrays[key]
    ok = (isinstance(v, int) and not isinstance(v, bool)) \
        or isinstance(v, np.integer) \
        or (isinstance(v, np.ndarray) and v.ndim == 0
            and np.issubdtype(v.dtype, np.integer))
    if not ok:
        raise ValueError(f"plan payload field {key!r} must be an integer "
                         f"scalar, got {v!r}")
    iv = int(v)
    if iv < -1:
        raise ValueError(f"plan payload field {key!r} out of range: {iv}")
    return iv


def unpack_plan(arrays: dict) -> RefreshPlan:
    """Rebuild a :class:`RefreshPlan` from ``pack_plan`` output.

    The payload is validated before anything is returned: missing keys,
    wrong shapes, wrong dtype kinds and malformed version fields each
    raise :class:`ValueError` naming the field, and so does a payload
    that breaks a plan law (``analysis/invariants.py``).  Unknown extra
    keys are ignored."""
    if not isinstance(arrays, dict):
        raise ValueError(f"plan payload must be a dict, got "
                         f"{type(arrays).__name__}")
    missing = [k for k in (*_WIRE_SPECS, "base_version", "version")
               if k not in arrays]
    if missing:
        raise ValueError(f"plan payload missing fields: {missing}")
    vals: dict = {}
    for k, (shape, kind) in _WIRE_SPECS.items():
        try:
            a = np.asarray(arrays[k])
        except Exception as e:
            raise ValueError(f"plan payload field {k!r} is not "
                             f"array-like") from e
        if a.shape != shape:
            raise ValueError(f"plan payload field {k!r} has shape "
                             f"{a.shape}, expected {shape}")
        want = np.integer if kind == "i" else np.floating
        if not np.issubdtype(a.dtype, want):
            raise ValueError(f"plan payload field {k!r} has dtype "
                             f"{a.dtype}, expected "
                             f"{'integer' if kind == 'i' else 'floating'}")
        vals[k] = a.astype(np.int32 if kind == "i" else np.float32)
    base = _wire_scalar(arrays, "base_version")
    version = _wire_scalar(arrays, "version")
    if version == 0 or (version > 0 and base >= version):
        raise ValueError(f"plan payload has bad version fields: "
                         f"base_version={base}, version={version}")
    violations = check_plan_wire(
        {**vals, "base_version": base, "version": version})
    if violations:
        raise ValueError("plan payload violates invariants: "
                         + "; ".join(violations))
    return RefreshPlan(
        config=tuple(vals[k] for k in CONFIG_FIELDS),
        ep_src=vals["ep_src"], ep_dst=vals["ep_dst"],
        base_version=base, version=version)


def _upload(arrays, device: torch.device) -> list[torch.Tensor]:
    """``arrays`` (numpy, int32 or f32) on ``device`` as views of one
    int32 buffer, each on a 16-byte boundary, filled on the host and
    copied over once without a host sync (the CUDA runtime stages a
    pageable source before the copy call returns)."""
    arrays = [np.asarray(a) for a in arrays]
    offs, total = [], 0
    for a in arrays:
        offs.append(total)
        total += -(-a.size // 4) * 4
    host = np.empty((total,), np.int32)
    for a, o in zip(arrays, offs):
        host[o:o + a.size] = a.reshape(-1).view(np.int32) \
            if a.dtype == np.float32 else a.reshape(-1)
    buf = torch.from_numpy(host)
    if device.type != "cpu":
        buf = buf.to(device, non_blocking=True)
    out = []
    for a, o in zip(arrays, offs):
        t = buf[o:o + a.size].view(a.shape)
        out.append(t.view(torch.float32) if a.dtype == np.float32 else t)
    return out


def _shifted(a: np.ndarray) -> np.ndarray:
    """``a`` behind a leading -1: indexed by ``(e + 1).clamp(0, E)`` it
    reads -1 for e < 0 and ``a[min(e, E - 1)]`` otherwise."""
    return np.concatenate([np.full((1,), -1, np.int32), a.astype(np.int32)])


def apply_plan(live: RoutingState, plan: RefreshPlan) -> RoutingState:
    """The single buffer swap, on ``live``'s device: the new config in,
    live loads and health EWMAs migrated through the slot permutation
    (fresh slots start at zero), ``rr_cursor`` untouched, the affinity
    cache remapped and cleared where its endpoint was removed or is
    drained in the new config.  A versioned plan stamps its version; an
    unversioned one (``plan.version == -1``) bumps the live one by 1.
    Shapes and dtypes (int32, f32) are unchanged; nothing syncs.

    The index maps are built on the host and travel with the config in
    the one upload, so the device work is a handful of gathers: fresh
    slots gather column E of the live columns padded with a zero, and an
    affinity entry follows its endpoint's old → new map with -1 where
    the endpoint is gone or drained."""
    dev = live.ep_load.device
    src, dst = np.asarray(plan.ep_src), np.asarray(plan.ep_dst)
    E = dst.shape[0]
    drained = np.asarray(plan.config[CONFIG_FIELDS.index("ep_drained")])
    alive = (dst >= 0) & (drained[np.clip(dst, 0, E - 1)] == 0)
    host = [*plan.config, np.where(src >= 0, src, E).astype(np.int32),
            _shifted(np.where(alive, dst, -1)),
            np.asarray([plan.version], np.int32)]
    *config, gather, follow, version = _upload(host, dev)
    cfg = dict(zip(CONFIG_FIELDS, config))
    version = version.reshape(()) if plan.version >= 0 \
        else (live.version + 1).to(torch.int32)
    cols = torch.stack([live.ep_load.to(torch.int32),
                        live.ep_inflight_ewma.view(torch.int32),
                        live.ep_tput_ewma.view(torch.int32)])
    moved = torch.nn.functional.pad(cols, (0, 1))[:, gather]
    aff_ep = follow[(live.aff_ep + 1).clamp(0, E)]
    return live._replace(
        ep_load=moved[0], ep_inflight_ewma=moved[1].view(torch.float32),
        ep_tput_ewma=moved[2].view(torch.float32), aff_ep=aff_ep,
        aff_key=torch.where(aff_ep >= 0, live.aff_key, -1).to(torch.int32),
        version=version, **cfg)


def remap_endpoints(plan: RefreshPlan,
                    endpoint: torch.Tensor) -> torch.Tensor:
    """Rewrite endpoint slot references (``PoolState.endpoint``) from old
    to new coordinates, on ``endpoint``'s device; references to removed
    endpoints become -1, so a later release is a no-op instead of
    corrupting the slot's new occupant."""
    (dst,) = _upload([_shifted(np.asarray(plan.ep_dst))], endpoint.device)
    E = dst.shape[0] - 1
    return dst[(endpoint.to(torch.int32) + 1).clamp(0, E)]


def _host_loads(consumer) -> np.ndarray:
    """A consumer's live ``routing.ep_load`` on the host (a tensor on the
    card costs one host sync)."""
    load = consumer.routing.ep_load
    if isinstance(load, torch.Tensor):
        return load.cpu().numpy()
    return np.asarray(load)


# --------------------------------------------------------------------------- #
# Free-list extents (the slot allocator)
# --------------------------------------------------------------------------- #


def _extent_alloc(extents: list[list[int]], size: int) -> int:
    """First-fit carve from a sorted [(start, size), ...] free-list."""
    if size == 0:
        return 0
    for ext in extents:
        if ext[1] >= size:
            start = ext[0]
            ext[0] += size
            ext[1] -= size
            if ext[1] == 0:
                extents.remove(ext)
            return start
    raise RuntimeError("slot space exhausted (or too fragmented)")


def _extent_free(extents: list[list[int]], start: int, size: int) -> None:
    """Return an extent and coalesce neighbours."""
    if size == 0:
        return
    extents.append([start, size])
    extents.sort()
    merged: list[list[int]] = []
    for ext in extents:
        if merged and merged[-1][0] + merged[-1][1] == ext[0]:
            merged[-1][1] += ext[1]
        else:
            merged.append(ext)
    extents[:] = merged


@dataclasses.dataclass
class _Window:
    start: int
    cap: int


@dataclasses.dataclass
class _Dir:
    id: int
    win: _Window


@dataclasses.dataclass
class _Store:
    """Everything a commit swaps atomically (host side)."""

    cfg: dict
    services: dict
    clusters: dict
    ep_free: list
    rule_free: list
    draining: dict          # {(cluster_name, instance): reason}: "operator"
    #                         (reaped once its load reads zero) or "health"
    #                         (a circuit-breaker ejection, never reaped)
    # removed service and cluster ids return here and are reused before
    # the high-water counters grow the tables
    svc_id_free: list = dataclasses.field(default_factory=list)
    cluster_id_free: list = dataclasses.field(default_factory=list)
    svc_id_next: int = 0
    cluster_id_next: int = 0


class _Txn:
    def __init__(self, store: _Store):
        self.store = copy.deepcopy(store)
        self.src = np.arange(MAX_ENDPOINTS, dtype=np.int32)
        self.log: list[tuple] = []


class ControlPlane:
    """Owner of the routing config: directory, allocator, transactions."""

    def __init__(self, services: list[ServiceConfig] = (),
                 clusters: list[Cluster] = (), *, lease_epochs: int = 0,
                 journal_limit: int = 64):
        # the initial build is a build_state build; the directory and the
        # free-lists are recovered from its window layout
        st, ids = build_state(list(services), list(clusters), "cpu")
        cfg = {k: getattr(st, k).numpy().copy() for k in CONFIG_FIELDS}
        store = _Store(cfg=cfg, services={}, clusters={}, ep_free=[],
                       rule_free=[], draining={})
        ep_cursor = 0
        for c in clusters:
            ci = ids["clusters"][c.name]
            store.clusters[c.name] = _Dir(
                ci, _Window(int(cfg["cluster_ep_start"][ci]),
                            len(c.endpoints)))
            ep_cursor += len(c.endpoints)
        rule_cursor = 0
        for s in services:
            si = ids["services"][s.name]
            store.services[s.name] = _Dir(
                si, _Window(int(cfg["svc_rule_start"][si]), len(s.rules)))
            rule_cursor += len(s.rules)
        _extent_free(store.ep_free, ep_cursor, MAX_ENDPOINTS - ep_cursor)
        _extent_free(store.rule_free, rule_cursor, MAX_RULES - rule_cursor)
        store.svc_id_next = len(services)
        store.cluster_id_next = len(clusters)
        self._store = store
        self._txn: _Txn | None = None
        self._refs: list[weakref.ref] = []
        self.version = 0
        self.last_commit_log: list[tuple] = []
        self.last_plan: RefreshPlan | None = None
        # the last ``journal_limit`` commits as packed plans, each stamped
        # base_version/version, for consumers that fell behind
        self.journal: collections.deque = collections.deque(
            maxlen=max(1, int(journal_limit)))
        # liveness leases: a consumer's heartbeat records the control epoch
        # it was last seen at.  With lease_epochs > 0 the reaper ignores
        # load pinned by a consumer whose lease expired; 0 disables expiry.
        self.lease_epochs = lease_epochs
        self.epoch = 0
        self._leases: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()

    # ------------------------------------------------------------------ #
    # directory / snapshots
    # ------------------------------------------------------------------ #
    def _view(self) -> _Store:
        """The open transaction's staged store, else the committed one."""
        return self._txn.store if self._txn is not None else self._store

    @property
    def ids(self) -> dict:
        """build_state-compatible name → id maps."""
        return {"services": {n: d.id for n, d in
                             self._store.services.items()},
                "clusters": {n: d.id for n, d in
                             self._store.clusters.items()}}

    def service_id(self, name: str) -> int:
        return self._store.services[name].id

    def cluster_id(self, name: str) -> int:
        return self._store.clusters[name].id

    def endpoint_slot(self, cluster: str, instance: int) -> int:
        """Global slot currently holding ``instance`` in ``cluster``."""
        return self._find_slot(self._view(), cluster, instance)

    def snapshot(self) -> RoutingState:
        """A fresh RoutingState of CPU tensors at the current config (zero
        load, cursors and EWMAs: the datapath owns those from here on);
        an engine moves it to its device in ``init_state``."""
        cfg = self._store.cfg
        z = lambda n, dt: torch.zeros((n,), dtype=dt)
        return RoutingState(
            ep_load=z(MAX_ENDPOINTS, torch.int32),
            ep_inflight_ewma=z(MAX_ENDPOINTS, torch.float32),
            ep_tput_ewma=z(MAX_ENDPOINTS, torch.float32),
            rr_cursor=z(MAX_CLUSTERS, torch.int32),
            aff_key=torch.full((AFFINITY_SLOTS,), -1, dtype=torch.int32),
            aff_ep=torch.full((AFFINITY_SLOTS,), -1, dtype=torch.int32),
            version=torch.tensor(self.version, dtype=torch.int32),
            **{k: torch.from_numpy(cfg[k].copy()) for k in CONFIG_FIELDS})

    def packed_snapshot(self) -> dict:
        """The full current config as a wire-format dict (CONFIG_FIELDS
        arrays + the config version): the resync payload of a consumer
        that fell behind the journal."""
        out = {k: np.array(self._store.cfg[k]) for k in CONFIG_FIELDS}
        out["version"] = int(self.version)
        return out

    def cluster_names(self) -> list[str]:
        return list(self._store.clusters)

    def cluster_members(self, name: str) -> list[tuple[int, int]]:
        """[(global slot, instance), ...] currently in cluster ``name``."""
        store = self._view()
        d = store.clusters[name]
        n = int(store.cfg["cluster_ep_count"][d.id])
        return [(d.win.start + j,
                 int(store.cfg["ep_instance"][d.win.start + j]))
                for j in range(n)]

    def cluster_policy(self, name: str) -> int:
        """The cluster's LB policy id (POLICY_*)."""
        store = self._view()
        return int(store.cfg["cluster_policy"][store.clusters[name].id])

    def endpoint_weight(self, cluster: str, instance: int) -> float:
        store = self._view()
        slot = self._find_slot(store, cluster, instance)
        if slot < 0:
            raise KeyError(f"no endpoint {instance} in {cluster!r}")
        return float(store.cfg["ep_weight"][slot])

    def drain_reason(self, cluster: str, instance: int) -> str | None:
        """Pending drain reason for an endpoint, or None if not draining."""
        return self._view().draining.get((cluster, instance))

    def attach(self, consumer) -> None:
        """Register a consumer (``ServeLoop``, ...): its
        ``apply_refresh(plan)`` runs on every commit, and its live
        ``routing.ep_load`` gates the drain reaper.  Held by weak
        reference, so an abandoned consumer drops out on its own.
        Attaching is a heartbeat."""
        if consumer not in self._consumers():
            self._refs.append(weakref.ref(consumer))
        self.heartbeat(consumer)

    def detach(self, consumer) -> None:
        self._refs = [r for r in self._refs if r() is not consumer]

    def _consumers(self) -> list:
        live = [(r, r()) for r in self._refs]
        self._refs = [r for r, c in live if c is not None]
        return [c for _, c in live if c is not None]

    # ------------------------------------------------------------------ #
    # liveness leases
    # ------------------------------------------------------------------ #
    def heartbeat(self, consumer) -> None:
        """Record the consumer alive at the current control epoch."""
        try:
            self._leases[consumer] = self.epoch
        except TypeError:                  # not weak-referenceable: its
            pass                           # lease never expires

    def advance_epoch(self) -> int:
        """Tick the control-epoch clock."""
        self.epoch += 1
        return self.epoch

    def lease_live(self, consumer) -> bool:
        """Whether the consumer's liveness lease holds."""
        if self.lease_epochs <= 0:
            return True
        last = self._leases.get(consumer)
        if last is None:                   # never heard from: the attach
            return True                    # itself is the heartbeat
        return (self.epoch - last) <= self.lease_epochs

    # ------------------------------------------------------------------ #
    # transactions
    # ------------------------------------------------------------------ #
    @contextlib.contextmanager
    def transaction(self):
        """Batch named deltas into one swap with a single version bump;
        an exception inside discards every staged write."""
        if self._txn is not None:
            raise RuntimeError("ControlPlane transactions do not nest")
        self._txn = _Txn(self._store)
        try:
            yield self
        except BaseException:
            self._txn = None               # abort: staged writes discarded
            raise
        txn, self._txn = self._txn, None
        self._commit(txn)

    @contextlib.contextmanager
    def _auto(self):
        if self._txn is not None:
            yield self._txn
        else:
            with self.transaction():
                yield self._txn

    def reap(self) -> None:
        """Run just the drain reaper (an empty transaction)."""
        with self.transaction():
            pass

    def _commit(self, txn: _Txn) -> None:
        consumers = self._consumers()
        # drain reaper: an operator-drained endpoint leaves once no leased
        # consumer counts in-flight load against it (health drains are
        # never reaped)
        leased = [c for c in consumers if self.lease_live(c)]
        loads: dict[int, np.ndarray] = {}
        for cl, inst in sorted(txn.store.draining):
            if txn.store.draining.get((cl, inst)) == "health":
                continue
            slot = self._find_slot(txn.store, cl, inst)
            if slot < 0:
                txn.store.draining.pop((cl, inst), None)
                continue
            old = int(txn.src[slot])
            load = 0
            if old >= 0:
                for c in leased:
                    if id(c) not in loads:
                        loads[id(c)] = _host_loads(c)
                    load = max(load, int(loads[id(c)][old]))
            if load == 0:
                self._do_remove_endpoint(txn, cl, inst)
                txn.log.append(("reap", cl, inst))
        if not txn.log:                    # nothing happened: no bump
            return
        # Maglev rows rebuild only for clusters whose (membership, drain)
        # inputs changed in this transaction
        T = txn.store.cfg["maglev_table"].shape[1]
        for c in range(MAX_CLUSTERS):
            new_in = policy_defs.maglev_row_inputs(txn.store.cfg, c)
            if new_in == policy_defs.maglev_row_inputs(self._store.cfg, c):
                continue
            n, insts, drs = new_in
            offs = [j for j in range(n) if drs[j] == 0]
            txn.store.cfg["maglev_table"][c] = policy_defs._maglev_row(
                offs, [int(insts[j]) for j in offs], T)
        dst = np.full((MAX_ENDPOINTS,), -1, np.int32)
        occupied = txn.src >= 0
        dst[txn.src[occupied]] = np.nonzero(occupied)[0]
        plan = RefreshPlan(
            config=tuple(txn.store.cfg[k].copy() for k in CONFIG_FIELDS),
            ep_src=txn.src.copy(), ep_dst=dst,
            base_version=self.version, version=self.version + 1)
        self._store = txn.store
        self.version += 1
        self.last_commit_log = list(txn.log)
        self.last_plan = plan
        self.journal.append(pack_plan(plan))
        for consumer in consumers:
            consumer.apply_refresh(plan)

    # ------------------------------------------------------------------ #
    # named deltas
    # ------------------------------------------------------------------ #
    def add_service(self, name: str, rules: list[Rule] = ()) -> int:
        with self._auto() as t:
            if name in t.store.services:
                raise ValueError(f"service {name!r} exists")
            if t.store.svc_id_free:            # recycle a removed id first
                sid = t.store.svc_id_free.pop(0)
            else:
                sid = t.store.svc_id_next
                if sid >= MAX_SERVICES:
                    raise RuntimeError("service table full")
                t.store.svc_id_next += 1
            if len(rules) > MAX_RULES_PER_SVC:
                raise ValueError(f"service {name!r} has too many rules")
            start = _extent_alloc(t.store.rule_free, len(rules))
            for j, r in enumerate(rules):      # bottom-up: rows first
                self._write_rule(t, start + j, r.field, r.value,
                                 r.cluster)
            t.store.cfg["svc_rule_start"][sid] = start
            t.store.cfg["svc_rule_count"][sid] = len(rules)
            t.log.append(("svc_count", sid, len(rules)))
            t.store.services[name] = _Dir(sid, _Window(start, len(rules)))
            return sid

    def add_cluster(self, name: str, policy: int = POLICY_LEAST_REQUEST,
                    endpoints: list[int] = (), weights=None) -> int:
        with self._auto() as t:
            if name in t.store.clusters:
                raise ValueError(f"cluster {name!r} exists")
            if t.store.cluster_id_free:        # recycle a removed id first
                cid = t.store.cluster_id_free.pop(0)
            else:
                cid = t.store.cluster_id_next
                if cid >= MAX_CLUSTERS:
                    raise RuntimeError("cluster table full")
                t.store.cluster_id_next += 1
            if len(endpoints) > MAX_EPS_PER_CLUSTER:
                raise ValueError(f"cluster {name!r} exceeds endpoint "
                                 "capacity")
            start = _extent_alloc(t.store.ep_free, len(endpoints))
            for j, inst in enumerate(endpoints):   # bottom-up: rows first
                w = 1.0 if weights is None else weights[j]
                self._write_ep(t, start + j, inst, w)
            t.store.cfg["cluster_ep_start"][cid] = start
            t.store.cfg["cluster_policy"][cid] = policy
            t.log.append(("cluster_window", cid, start, len(endpoints)))
            t.store.cfg["cluster_ep_count"][cid] = len(endpoints)
            t.log.append(("cluster_count", cid, len(endpoints)))
            t.store.clusters[name] = _Dir(cid, _Window(start,
                                                       len(endpoints)))
            return cid

    def add_endpoint(self, cluster: str, instance: int,
                     weight: float = 1.0) -> int:
        """Grow ``cluster`` by one endpoint; returns its global slot.
        Bottom-up: the endpoint row lands before the count exposes it."""
        with self._auto() as t:
            d = t.store.clusters[cluster]
            count = int(t.store.cfg["cluster_ep_count"][d.id])
            if count >= MAX_EPS_PER_CLUSTER:
                raise RuntimeError(f"cluster {cluster!r} at capacity")
            if count >= d.win.cap:
                self._grow_ep_window(t, cluster)
            slot = d.win.start + count
            self._write_ep(t, slot, instance, weight)
            t.store.cfg["cluster_ep_count"][d.id] += 1
            t.log.append(("cluster_count", d.id, +1))
            return slot

    def remove_endpoint(self, cluster: str, instance: int) -> None:
        """Top-down: shrink the count first, then compact the window,
        migrating the moved endpoint's load and zeroing the vacated
        slot."""
        with self._auto() as t:
            self._do_remove_endpoint(t, cluster, instance)

    def drain_endpoint(self, cluster: str, instance: int,
                       reason: str = "operator") -> None:
        """Graceful removal: the weight drops to zero and the endpoint's
        ``ep_drained`` bit rises at once, so new traffic stops under every
        policy.  ``reason="operator"``: the row survives until a later
        commit finds every leased consumer's load for it at zero, then
        the reaper removes it.  ``reason="health"``: a circuit-breaker
        ejection, never reaped and immune to ``set_weight`` (only
        ``undrain_endpoint`` lifts it)."""
        if reason not in ("operator", "health"):
            raise ValueError(f"unknown drain reason {reason!r}")
        with self._auto() as t:
            slot = self._find_slot(t.store, cluster, instance)
            if slot < 0:
                raise KeyError(f"no endpoint {instance} in {cluster!r}")
            t.store.cfg["ep_weight"][slot] = 0.0
            t.store.cfg["ep_drained"][slot] = 1
            t.store.draining[(cluster, instance)] = reason
            t.log.append(("drain", t.store.clusters[cluster].id, instance,
                          reason))

    def undrain_endpoint(self, cluster: str, instance: int,
                         weight: float = 1.0) -> None:
        """Lift a pending drain (any reason) and restore the endpoint to
        service at ``weight``."""
        with self._auto() as t:
            slot = self._find_slot(t.store, cluster, instance)
            if slot < 0:
                raise KeyError(f"no endpoint {instance} in {cluster!r}")
            t.store.cfg["ep_weight"][slot] = weight
            t.store.cfg["ep_drained"][slot] = 0
            t.store.draining.pop((cluster, instance), None)
            t.log.append(("undrain", t.store.clusters[cluster].id, instance))

    def set_weight(self, cluster: str, instance: int,
                   weight: float) -> None:
        """Set an endpoint's weight, and cancel a pending operator drain
        on it.  A health drain is not cancelled: the weight is staged for
        when the breaker closes, and the drain bit stays up."""
        with self._auto() as t:
            slot = self._find_slot(t.store, cluster, instance)
            if slot < 0:
                raise KeyError(f"no endpoint {instance} in {cluster!r}")
            t.store.cfg["ep_weight"][slot] = weight
            if t.store.draining.get((cluster, instance)) != "health":
                t.store.cfg["ep_drained"][slot] = 0  # drain cancelled
                t.store.draining.pop((cluster, instance), None)
            t.log.append(("weight", slot))

    def set_policy(self, cluster: str, policy: int) -> None:
        with self._auto() as t:
            d = t.store.clusters[cluster]
            t.store.cfg["cluster_policy"][d.id] = policy
            t.log.append(("policy", d.id))

    def remove_cluster(self, name: str) -> None:
        """Tear a cluster down, top-down: the count hides the window, the
        rows clear, then the extent and the id return to their
        free-lists.  Refuses while a service rule still routes to it."""
        with self._auto() as t:
            d = t.store.clusters[name]
            cfg = t.store.cfg
            for sname, sd in t.store.services.items():
                for j in range(int(cfg["svc_rule_count"][sd.id])):
                    if int(cfg["rule_cluster"][sd.win.start + j]) == d.id:
                        raise RuntimeError(
                            f"cluster {name!r} still referenced by service "
                            f"{sname!r}; remove or retarget the rule first")
            count = int(cfg["cluster_ep_count"][d.id])
            cfg["cluster_ep_count"][d.id] = 0      # top-down: hide first
            t.log.append(("cluster_count", d.id, 0))
            for j in range(count):
                self._clear_ep(t, d.win.start + j)
            cfg["cluster_ep_start"][d.id] = 0
            cfg["cluster_policy"][d.id] = 0
            _extent_free(t.store.ep_free, d.win.start, d.win.cap)
            t.store.draining = {(c, i): r for (c, i), r
                                in t.store.draining.items() if c != name}
            del t.store.clusters[name]
            t.store.cluster_id_free.append(d.id)
            t.store.cluster_id_free.sort()
            t.log.append(("cluster_remove", d.id))

    def remove_service(self, name: str) -> None:
        """Remove a service and its rule chain, top-down: the chain count
        zeroes first, the rows clear, then the extent and the id return to
        their free-lists."""
        with self._auto() as t:
            d = t.store.services[name]
            cfg = t.store.cfg
            count = int(cfg["svc_rule_count"][d.id])
            cfg["svc_rule_count"][d.id] = 0        # top-down: hide first
            t.log.append(("svc_count", d.id, 0))
            for j in range(count):
                self._clear_rule(t, d.win.start + j)
            cfg["svc_rule_start"][d.id] = 0
            _extent_free(t.store.rule_free, d.win.start, d.win.cap)
            del t.store.services[name]
            t.store.svc_id_free.append(d.id)
            t.store.svc_id_free.sort()
            t.log.append(("service_remove", d.id))

    def upsert_rule(self, service: str, field: int, value: str | None,
                    cluster: str) -> None:
        """Retarget the service's rule matching (field, value), or append
        a new one (bottom-up: row before count)."""
        with self._auto() as t:
            d = t.store.services[service]
            cfg = t.store.cfg
            vhash = WILDCARD if value is None else fnv1a(value)
            count = int(cfg["svc_rule_count"][d.id])
            for j in range(count):
                s = d.win.start + j
                if (int(cfg["rule_field"][s]) == field
                        and int(cfg["rule_value"][s]) == vhash):
                    cfg["rule_cluster"][s] = t.store.clusters[cluster].id
                    t.log.append(("rule_row", s))
                    return
            if count >= MAX_RULES_PER_SVC:
                raise RuntimeError(f"service {service!r} rule chain full")
            if count >= d.win.cap:
                self._grow_rule_window(t, service)
            self._write_rule(t, d.win.start + count, field, value, cluster)
            cfg["svc_rule_count"][d.id] += 1
            t.log.append(("svc_count", d.id, +1))

    def remove_rule(self, service: str, field: int,
                    value: str | None) -> None:
        """Top-down: the chain shrinks before the row compacts."""
        with self._auto() as t:
            d = t.store.services[service]
            cfg = t.store.cfg
            vhash = WILDCARD if value is None else fnv1a(value)
            count = int(cfg["svc_rule_count"][d.id])
            for j in range(count):
                s = d.win.start + j
                if (int(cfg["rule_field"][s]) == field
                        and int(cfg["rule_value"][s]) == vhash):
                    cfg["svc_rule_count"][d.id] -= 1
                    t.log.append(("svc_count", d.id, -1))
                    last = d.win.start + count - 1
                    if s != last:
                        for k in ("rule_field", "rule_value",
                                  "rule_cluster"):
                            cfg[k][s] = cfg[k][last]
                        t.log.append(("rule_row", s))
                    self._clear_rule(t, last)
                    return
            raise KeyError(f"no rule ({field}, {value!r}) on {service!r}")

    # ------------------------------------------------------------------ #
    # staged-write primitives
    # ------------------------------------------------------------------ #
    @staticmethod
    def _find_slot(store: _Store, cluster: str, instance: int) -> int:
        d = store.clusters[cluster]
        count = int(store.cfg["cluster_ep_count"][d.id])
        for j in range(count):
            if int(store.cfg["ep_instance"][d.win.start + j]) == instance:
                return d.win.start + j
        return -1

    def _write_ep(self, t: _Txn, slot: int, instance: int,
                  weight: float) -> None:
        t.store.cfg["ep_instance"][slot] = instance
        t.store.cfg["ep_weight"][slot] = weight
        t.store.cfg["ep_drained"][slot] = 0
        t.src[slot] = -1                       # fresh row: load starts at 0
        t.log.append(("ep_row", slot, instance))

    def _clear_ep(self, t: _Txn, slot: int) -> None:
        t.store.cfg["ep_instance"][slot] = -1
        t.store.cfg["ep_weight"][slot] = 1.0
        t.store.cfg["ep_drained"][slot] = 0
        t.src[slot] = -1                       # vacated: counter zeroed
        t.log.append(("ep_clear", slot))

    def _move_ep(self, t: _Txn, dst: int, src: int) -> None:
        """Relocate one endpoint row, its drain bit and (through the plan
        permutation) its live load."""
        cfg = t.store.cfg
        cfg["ep_instance"][dst] = cfg["ep_instance"][src]
        cfg["ep_weight"][dst] = cfg["ep_weight"][src]
        cfg["ep_drained"][dst] = cfg["ep_drained"][src]
        t.src[dst] = t.src[src]
        t.log.append(("ep_row", dst, int(cfg["ep_instance"][dst])))

    def _write_rule(self, t: _Txn, slot: int, field: int,
                    value: str | None, cluster: str) -> None:
        cfg = t.store.cfg
        cfg["rule_field"][slot] = field
        cfg["rule_value"][slot] = (WILDCARD if value is None
                                   else fnv1a(value))
        cfg["rule_cluster"][slot] = t.store.clusters[cluster].id
        t.log.append(("rule_row", slot))

    def _clear_rule(self, t: _Txn, slot: int) -> None:
        cfg = t.store.cfg
        cfg["rule_field"][slot] = 0
        cfg["rule_value"][slot] = WILDCARD
        cfg["rule_cluster"][slot] = -1
        t.log.append(("rule_clear", slot))

    def _do_remove_endpoint(self, t: _Txn, cluster: str,
                            instance: int) -> None:
        slot = self._find_slot(t.store, cluster, instance)
        if slot < 0:
            raise KeyError(f"no endpoint {instance} in {cluster!r}")
        d = t.store.clusters[cluster]
        count = int(t.store.cfg["cluster_ep_count"][d.id])
        t.store.cfg["cluster_ep_count"][d.id] -= 1    # top-down: count first
        t.log.append(("cluster_count", d.id, -1))
        last = d.win.start + count - 1
        if slot != last:
            self._move_ep(t, slot, last)       # swap-with-last + load migrate
        self._clear_ep(t, last)                # vacated slot zeroed
        t.store.draining.pop((cluster, instance), None)

    def _grow_ep_window(self, t: _Txn, cluster: str) -> None:
        """Relocate a full cluster window to a larger extent (bottom-up:
        the new rows are written before the start pointer swings)."""
        d = t.store.clusters[cluster]
        count = int(t.store.cfg["cluster_ep_count"][d.id])
        new_cap = min(MAX_EPS_PER_CLUSTER, max(2 * d.win.cap, 2))
        new_start = _extent_alloc(t.store.ep_free, new_cap)
        for j in range(count):
            self._move_ep(t, new_start + j, d.win.start + j)
        t.store.cfg["cluster_ep_start"][d.id] = new_start
        t.log.append(("cluster_window", d.id, new_start, new_cap))
        old = d.win
        for j in range(count):
            self._clear_ep(t, old.start + j)
        _extent_free(t.store.ep_free, old.start, old.cap)
        d.win = _Window(new_start, new_cap)

    def _grow_rule_window(self, t: _Txn, service: str) -> None:
        d = t.store.services[service]
        cfg = t.store.cfg
        count = int(cfg["svc_rule_count"][d.id])
        new_cap = min(MAX_RULES_PER_SVC, max(2 * d.win.cap, 2))
        new_start = _extent_alloc(t.store.rule_free, new_cap)
        for j in range(count):
            for k in ("rule_field", "rule_value", "rule_cluster"):
                cfg[k][new_start + j] = cfg[k][d.win.start + j]
            t.log.append(("rule_row", new_start + j))
        cfg["svc_rule_start"][d.id] = new_start
        t.log.append(("svc_window", d.id, new_start, new_cap))
        old = d.win
        for j in range(count):
            self._clear_rule(t, old.start + j)
        _extent_free(t.store.rule_free, old.start, old.cap)
        d.win = _Window(new_start, new_cap)

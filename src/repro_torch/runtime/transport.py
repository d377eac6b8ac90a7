"""Fault-tolerant plan transport (twin of ``repro/runtime/transport.py``):
shipping RefreshPlans over a channel that drops, reorders, duplicates,
partitions, and loses whole consumers.

  * :class:`LossyChannel` — a seeded, deterministic message channel: each
    message's fate (drop / duplicate / delay → reorder) is drawn from
    ``default_rng((seed, send_seq))``, and :class:`ChannelFault` windows
    model partitions.  Same seed → same fate for every message.
  * :class:`RemoteConsumer` — the far end.  Applies packed plans
    idempotently keyed by version (``base_version`` must equal the
    consumer's version; out-of-order plans are held and chained, stale
    and duplicate ones are no-ops) and resyncs from a snapshot message
    (load-preserving: rows are matched by (cluster, instance)).  Its
    heartbeat carries the applied version and the sink's live ``ep_load``
    vote for the drain reaper over the same lossy channel.
  * :class:`PlanPublisher` — the ControlPlane end: one proxy per node
    attached to the control plane, per-node acks from heartbeats, retries
    of unacked suffixes with capped-exponential backoff, a full snapshot
    for a node behind the journal floor or restarted at version -1, and
    nothing for a node whose liveness lease expired.
  * :func:`convergence_report` / :func:`assert_converged` — after any
    chaos schedule every live consumer's config is bit-exact with
    ``cp.snapshot()``, its version equals ``cp.version``, and its history
    is strictly monotone with contiguous plan chaining.

Everything is tick-driven and seeded, so a chaos schedule replays
byte-identically.  Consumer state is torch on the sink's device (a
``RoutingView`` replica holds CPU tensors; a ``ServeLoop`` sink may live
on the card) or a sidecar's host numpy.  The host reads of it are
explicit: the heartbeat's ``ep_load`` vote (one ``.cpu()`` a tick for a
sink on the card), the live window tables a snapshot resync matches
against, and the config a convergence report compares.
"""

from __future__ import annotations

import dataclasses
import heapq

import numpy as np
import torch

from repro_torch.core import control
from repro_torch.core.routing_table import (MAX_CLUSTERS, MAX_ENDPOINTS,
                                            RoutingState, empty_state)

#: channel address of the publisher (heartbeats go here)
CP_NODE = "cp"

# the wire fields a snapshot message carries (full config, no permutation)
_SNAP_FIELDS = control.CONFIG_FIELDS


def _host(a) -> np.ndarray:
    """A routing field on the host: a tensor (on any device) through an
    explicit ``.cpu()``, a sidecar's numpy array as it is."""
    if isinstance(a, torch.Tensor):
        return a.cpu().numpy()
    return np.asarray(a)


# --------------------------------------------------------------------------- #
# The lossy channel
# --------------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class ChannelFault:
    """A partition window: every message sent in ``[start, end)`` to ``dst``
    (or to anyone, if ``dst`` is None) is lost.  Heartbeats *from* a node
    are messages to :data:`CP_NODE` — partition both directions by listing
    two faults."""

    start: int
    end: int
    dst: str | None = None

    def hits(self, dst: str, tick: int) -> bool:
        return (self.start <= tick < self.end
                and (self.dst is None or self.dst == dst))


class LossyChannel:
    """Seeded lossy datagram channel.  Message fate (drop / duplicate /
    delay) is drawn from ``default_rng((seed, send_seq))`` at send time, so
    a replay with the same seed and the same send sequence is bit-exact.
    Random per-copy delays produce reordering; delivery order is the
    deterministic heap order (deliver_tick, send_seq, copy)."""

    def __init__(self, *, seed: int = 0, p_drop: float = 0.0,
                 p_dup: float = 0.0, delay_min: int = 1,
                 delay_max: int | None = None, faults=()):
        if delay_min < 0:
            raise ValueError("delay_min must be >= 0")
        self.seed = int(seed)
        self.p_drop = float(p_drop)
        self.p_dup = float(p_dup)
        self.delay_min = int(delay_min)
        self.delay_max = int(delay_min if delay_max is None else delay_max)
        if self.delay_max < self.delay_min:
            raise ValueError("delay_max must be >= delay_min")
        self.faults = tuple(faults)
        self._q: dict[str, list] = {}
        self._seq = 0
        self.sent = 0
        self.dropped = 0          # random drops
        self.partitioned = 0      # partition-window losses
        self.duped = 0
        self.delivered = 0

    def send(self, dst: str, msg: dict, tick: int) -> bool:
        """Queue ``msg`` for ``dst``; returns False if the channel ate it
        (the sender cannot tell — retries live above this layer)."""
        seq = self._seq
        self._seq += 1
        self.sent += 1
        if any(f.hits(dst, tick) for f in self.faults):
            self.partitioned += 1
            return False
        rng = np.random.default_rng((self.seed, seq))
        if self.p_drop > 0.0 and rng.random() < self.p_drop:
            self.dropped += 1
            return False
        copies = 1
        if self.p_dup > 0.0 and rng.random() < self.p_dup:
            copies = 2
            self.duped += 1
        q = self._q.setdefault(dst, [])
        for copy_i in range(copies):
            span = self.delay_max - self.delay_min
            delay = self.delay_min + (int(rng.integers(0, span + 1))
                                      if span > 0 else 0)
            heapq.heappush(q, (tick + delay, seq, copy_i, msg))
        return True

    def recv(self, dst: str, tick: int) -> list[dict]:
        """Every message matured for ``dst`` by ``tick``, in deterministic
        delivery order."""
        q = self._q.get(dst)
        out: list[dict] = []
        while q and q[0][0] <= tick:
            out.append(heapq.heappop(q)[3])
            self.delivered += 1
        return out

    def stats(self) -> dict:
        return {"sent": self.sent, "dropped": self.dropped,
                "partitioned": self.partitioned, "duped": self.duped,
                "delivered": self.delivered}


# --------------------------------------------------------------------------- #
# Snapshot resync
# --------------------------------------------------------------------------- #


def _validate_snapshot(packed: dict) -> tuple[dict, int]:
    """Shape/dtype-check a ``packed_snapshot`` payload (same discipline as
    ``unpack_plan``) and return (canonical config arrays, version)."""
    if not isinstance(packed, dict):
        raise ValueError(f"snapshot payload must be a dict, got "
                         f"{type(packed).__name__}")
    missing = [k for k in (*_SNAP_FIELDS, "version") if k not in packed]
    if missing:
        raise ValueError(f"snapshot payload missing fields: {missing}")
    cfg: dict = {}
    for k in _SNAP_FIELDS:
        shape, kind = control._WIRE_SPECS[k]
        a = np.asarray(packed[k])
        if a.shape != shape:
            raise ValueError(f"snapshot field {k!r} has shape {a.shape}, "
                             f"expected {shape}")
        want = np.integer if kind == "i" else np.floating
        if not np.issubdtype(a.dtype, want):
            raise ValueError(f"snapshot field {k!r} has dtype {a.dtype}")
        cfg[k] = a.astype(np.int32 if kind == "i" else np.float32)
    version = control._wire_scalar(packed, "version")
    if version < 0:
        raise ValueError(f"snapshot payload has bad version: {version}")
    return cfg, version


def snapshot_state(packed: dict) -> RoutingState:
    """A cold RoutingState at the snapshot's config — the boot state of a
    consumer that joins (or rejoins) with no live datapath counters."""
    cfg, version = _validate_snapshot(packed)
    base = empty_state("cpu")
    return base._replace(
        version=torch.tensor(version, dtype=torch.int32),
        **{k: torch.from_numpy(cfg[k]) for k in _SNAP_FIELDS})


def snapshot_plan(packed: dict, live: RoutingState) -> control.RefreshPlan:
    """Turn a full-config snapshot into a RefreshPlan against ``live``.

    The slot permutation is recovered by matching (cluster id, instance)
    rows between the live config and the snapshot config, so a consumer
    that resyncs over a *gap* (rather than a cold restart) keeps the live
    load / EWMA counters of every endpoint that survived — exactly what a
    chained journal replay would have preserved.  ``base_version`` is -1:
    a snapshot applies on any current version."""
    cfg, version = _validate_snapshot(packed)
    old_start = _host(live.cluster_ep_start)
    old_count = _host(live.cluster_ep_count)
    old_inst = _host(live.ep_instance)
    old_pos: dict[tuple[int, int], int] = {}
    for c in range(MAX_CLUSTERS):
        for j in range(int(old_count[c])):
            s = int(old_start[c]) + j
            old_pos[(c, int(old_inst[s]))] = s
    ep_src = np.full((MAX_ENDPOINTS,), -1, np.int32)
    for c in range(MAX_CLUSTERS):
        for j in range(int(cfg["cluster_ep_count"][c])):
            s = int(cfg["cluster_ep_start"][c]) + j
            ep_src[s] = old_pos.get((c, int(cfg["ep_instance"][s])), -1)
    ep_dst = np.full((MAX_ENDPOINTS,), -1, np.int32)
    occupied = ep_src >= 0
    ep_dst[ep_src[occupied]] = np.nonzero(occupied)[0]
    return control.RefreshPlan(
        config=tuple(cfg[k] for k in _SNAP_FIELDS),
        ep_src=ep_src, ep_dst=ep_dst, base_version=-1, version=version)


# --------------------------------------------------------------------------- #
# The consumer end
# --------------------------------------------------------------------------- #


class RoutingView:
    """The minimal plan sink: a bare RoutingState replica (a remote ingress
    host's routing table, sans datapath), as CPU tensors.  Anything with
    ``routing`` + ``apply_refresh`` (a ServeLoop) plugs into
    :class:`RemoteConsumer` the same way."""

    def __init__(self, routing: RoutingState | None = None):
        self.routing = empty_state("cpu") if routing is None else routing

    def apply_refresh(self, plan: control.RefreshPlan) -> None:
        self.routing = control.apply_plan(self.routing, plan)


class RemoteConsumer:
    """The far end of the transport: idempotent versioned plan application,
    snapshot resync, heartbeats, and a crash/restart fault model.

    ``pump(tick)`` drains the channel — plans apply iff their
    ``base_version`` matches the current version (stale/duplicate → no-op,
    out-of-order → held until the gap closes, corrupt → rejected whole) —
    then heartbeats the publisher with the applied version and the sink's
    live ``ep_load``.  ``crash()`` silences it (messages queue up
    undelivered); ``restart()`` models a process restart: a fresh
    incarnation at version -1 whose first heartbeat triggers exactly one
    snapshot resync."""

    def __init__(self, node: str, channel: LossyChannel, *,
                 sink=None, snapshot: dict | None = None):
        self.node = node
        self.channel = channel
        self.alive = True
        self.incarnation = 0
        self._hb_seq = 0
        # channel clock: monotone across restarts.  A restarted sink (a
        # fresh ServeLoop) pumps with its own tick counter reset to zero;
        # the channel's time only moves forward, so the consumer keeps the
        # larger of (its own clock + 1, the caller's tick).
        self.clock = -1
        self.version = -1
        self.boot_routing = empty_state("cpu")
        if snapshot is not None:
            self.boot_routing = snapshot_state(snapshot)
            self.version = int(snapshot["version"])
        self.sink = RoutingView(self.boot_routing) if sink is None else sink
        self._pending: dict[int, control.RefreshPlan] = {}
        self.history: list[tuple] = []   # (tick, kind, base, version)
        self.resyncs = 0
        self.stale = 0       # duplicate / already-applied messages ignored
        self.held = 0        # out-of-order plans parked for later
        self.rejected = 0    # corrupt payloads refused by validation
        self.crashes = 0

    def bind(self, sink) -> None:
        """Attach the real plan sink (e.g. the ServeLoop built around this
        consumer); it must carry the boot state this consumer was seeded
        with."""
        self.sink = sink

    @property
    def routing(self) -> RoutingState:
        return self.sink.routing

    # -- fault model --------------------------------------------------- #
    def crash(self) -> None:
        """The consumer process dies: no pumps, no heartbeats.  In-flight
        messages stay queued and deliver to the restarted incarnation as
        stale no-ops."""
        self.alive = False
        self.crashes += 1

    def restart(self, sink=None) -> None:
        """A fresh process: version -1, cold state, new incarnation (so the
        publisher discards reordered heartbeats of the dead one)."""
        self.alive = True
        self.incarnation += 1
        self.version = -1
        self._pending.clear()
        self.boot_routing = empty_state("cpu")
        self.sink = RoutingView(self.boot_routing) if sink is None else sink

    # -- the protocol --------------------------------------------------- #
    def pump(self, tick: int) -> None:
        if not self.alive:
            return
        tick = self.clock = max(self.clock + 1, int(tick))
        for msg in self.channel.recv(self.node, tick):
            kind = msg.get("kind")
            if kind == "plan":
                self._on_plan(msg, tick)
            elif kind == "snapshot":
                self._on_snapshot(msg, tick)
        self._hb_seq += 1
        self.channel.send(CP_NODE, {
            "kind": "hb", "node": self.node, "inc": self.incarnation,
            "seq": self._hb_seq, "version": self.version,
            "ep_load": _host(self.sink.routing.ep_load).copy()}, tick)

    def _on_plan(self, msg: dict, tick: int) -> None:
        try:
            plan = control.unpack_plan(msg)
        except ValueError:
            self.rejected += 1
            return
        if plan.version < 0:               # unversioned plan has no place
            self.rejected += 1             # on the wire
            return
        if plan.version <= self.version:
            self.stale += 1
            return
        if plan.base_version != self.version:
            self._pending[int(plan.base_version)] = plan
            self.held += 1
            return
        self._apply(plan, tick, "plan")
        self._drain_pending(tick)

    def _on_snapshot(self, msg: dict, tick: int) -> None:
        try:
            plan = snapshot_plan(msg, self.sink.routing)
        except ValueError:
            self.rejected += 1
            return
        if plan.version <= self.version:
            self.stale += 1
            return
        self._apply(plan, tick, "resync")
        self.resyncs += 1
        self._drain_pending(tick)

    def _apply(self, plan: control.RefreshPlan, tick: int,
               kind: str) -> None:
        self.sink.apply_refresh(plan)
        self.history.append((tick, kind, int(plan.base_version),
                             int(plan.version)))
        self.version = int(plan.version)

    def _drain_pending(self, tick: int) -> None:
        """Chain any held out-of-order plans that now fit, and purge ones
        the applied prefix has overtaken."""
        while True:
            plan = self._pending.pop(self.version, None)
            if plan is None:
                break
            if plan.version <= self.version:
                continue
            self._apply(plan, tick, "plan")
        self._pending = {b: p for b, p in self._pending.items()
                         if p.version > self.version}


# --------------------------------------------------------------------------- #
# The publisher end
# --------------------------------------------------------------------------- #


class _LoadView:
    """What the drain reaper reads off a transport proxy: the node's last
    heartbeat-reported in-flight load."""

    def __init__(self):
        self.ep_load = np.zeros((MAX_ENDPOINTS,), np.int32)


class _NodeProxy:
    """The ControlPlane-attached stand-in for a remote node: commits fan
    out to it (a no-op — the journal is the delivery queue), the reaper
    reads its last-reported load, and its lease is the node's lease."""

    def __init__(self, node: str):
        self.node = node
        self.routing = _LoadView()

    def apply_refresh(self, plan) -> None:
        pass                               # shipped from the journal instead


@dataclasses.dataclass
class _NodeState:
    proxy: _NodeProxy
    idx: int                               # stable per-node backoff key
    acked: int = -1
    last_hb: tuple = (-1, -1)              # (incarnation, seq) high-water
    attempt: int = 0
    next_send: int = 0
    plan_sends: int = 0
    snap_sends: int = 0


class PlanPublisher:
    """Ships the ControlPlane's journal to registered nodes with ack
    tracking and capped-exponential retry (the ServeLoop backoff shape:
    ``min(base << (attempt-1), cap)`` plus seeded jitter)."""

    def __init__(self, cp: control.ControlPlane, channel: LossyChannel, *,
                 retry_base: int = 1, retry_cap: int = 16, seed: int = 0):
        self.cp = cp
        self.channel = channel
        self.retry_base = int(retry_base)
        self.retry_cap = int(retry_cap)
        self.seed = int(seed)
        self.nodes: dict[str, _NodeState] = {}

    def register(self, node: str, *, boot_version: int = -1) -> None:
        """Add a node.  ``boot_version`` is the version it was seeded at
        (-1 = cold: the first exchange is a snapshot resync)."""
        if node in self.nodes:
            raise ValueError(f"node {node!r} already registered")
        proxy = _NodeProxy(node)
        self.cp.attach(proxy)
        self.nodes[node] = _NodeState(proxy=proxy, idx=len(self.nodes),
                                      acked=int(boot_version))

    def pump(self, tick: int) -> None:
        """Process arrived heartbeats (ack + lease + load vote), then ship
        whatever each live, behind, retry-mature node is missing."""
        for msg in self.channel.recv(CP_NODE, tick):
            if msg.get("kind") != "hb":
                continue
            st = self.nodes.get(msg.get("node"))
            if st is None:
                continue
            hb = (int(msg["inc"]), int(msg["seq"]))
            if hb <= st.last_hb:           # reordered stale heartbeat
                continue
            st.last_hb = hb
            self.cp.heartbeat(st.proxy)
            st.proxy.routing.ep_load = np.asarray(
                msg["ep_load"]).astype(np.int32)
            v = int(msg["version"])
            if v != st.acked:              # progress OR a restarted node
                st.acked = v               # announcing itself at -1
                st.attempt = 0
                st.next_send = tick
        head = self.cp.version
        journal = self.cp.journal
        floor = int(journal[0]["base_version"]) if journal else head
        for node, st in self.nodes.items():
            if st.acked >= head:
                st.attempt = 0             # converged: next commit ships
                st.next_send = tick        # immediately
                continue
            if not self.cp.lease_live(st.proxy):
                continue                   # dead node: plans stop shipping
            if tick < st.next_send:
                continue
            if st.acked < 0 or st.acked < floor:
                self.channel.send(
                    node, {"kind": "snapshot", **self.cp.packed_snapshot()},
                    tick)
                st.snap_sends += 1
            else:
                for entry in journal:
                    if int(entry["version"]) > st.acked:
                        self.channel.send(node, {"kind": "plan", **entry},
                                          tick)
                        st.plan_sends += 1
            st.attempt += 1
            delay = min(self.retry_base << (st.attempt - 1), self.retry_cap)
            rng = np.random.default_rng((self.seed, st.idx, st.attempt))
            delay += int(rng.integers(0, delay)) if delay > 0 else 0
            st.next_send = tick + max(1, delay)

    def stats(self) -> dict:
        return {n: {"acked": st.acked, "plan_sends": st.plan_sends,
                    "snap_sends": st.snap_sends}
                for n, st in self.nodes.items()}


# --------------------------------------------------------------------------- #
# Convergence invariants
# --------------------------------------------------------------------------- #


def convergence_report(cp: control.ControlPlane, consumers) -> dict:
    """Check the transport's end-state invariants.

    For every *live* consumer: config bit-exact with ``cp.snapshot()``,
    applied version == ``cp.version`` (both the protocol counter and the
    RoutingState's own version field), and an applied-version history that
    is strictly monotone where every plain-plan hop chains exactly on the
    previous version — a version jump is only ever a counted resync.  Also
    checks the cp journal itself is a contiguous suffix of commits ending
    at ``cp.version`` (no lost bumps at the source)."""
    snap = cp.snapshot()
    issues: list[str] = []
    entries: list[dict] = []
    jv = [int(e["version"]) for e in cp.journal]
    if jv and (jv != list(range(jv[0], jv[0] + len(jv)))
               or jv[-1] != cp.version):
        issues.append(f"journal versions not a contiguous suffix: {jv} "
                      f"(head {cp.version})")
    for rc in consumers:
        e = {"node": rc.node, "alive": rc.alive, "version": rc.version,
             "resyncs": rc.resyncs, "crashes": rc.crashes,
             "stale": rc.stale, "rejected": rc.rejected}
        entries.append(e)
        if not rc.alive:
            continue
        if rc.version != cp.version:
            issues.append(f"{rc.node}: at version {rc.version}, control "
                          f"plane at {cp.version}")
        r = rc.sink.routing                # moved to the host first
        state_v = int(_host(r.version))
        if state_v != cp.version:
            issues.append(f"{rc.node}: RoutingState.version {state_v} != "
                          f"control plane {cp.version}")
        diff = [k for k in control.CONFIG_FIELDS
                if not np.array_equal(_host(getattr(r, k)),
                                      _host(getattr(snap, k)))]
        if diff:
            issues.append(f"{rc.node}: config fields differ from control "
                          f"plane: {diff}")
        prev = None
        for (tick, kind, base, version) in rc.history:
            if prev is not None and version <= prev:
                issues.append(f"{rc.node}: non-monotone history at tick "
                              f"{tick}: {prev} -> {version}")
            if kind == "plan" and prev is not None and base != prev:
                issues.append(f"{rc.node}: lost bump at tick {tick}: plan "
                              f"base {base} after version {prev}")
            prev = version
        if rc.resyncs > rc.crashes + 1:
            issues.append(f"{rc.node}: {rc.resyncs} resyncs for "
                          f"{rc.crashes} crashes")
    return {"converged": not issues, "issues": issues,
            "head": cp.version, "consumers": entries}


def assert_converged(cp: control.ControlPlane, consumers) -> dict:
    rep = convergence_report(cp, consumers)
    if not rep["converged"]:
        raise AssertionError("transport did not converge:\n  "
                             + "\n  ".join(rep["issues"]))
    return rep


# --------------------------------------------------------------------------- #
# Convenience wiring
# --------------------------------------------------------------------------- #


class Transport:
    """One channel + one publisher + N consumers, wired.

    >>> hub = Transport(cp, LossyChannel(seed=3, p_drop=0.2))
    >>> rc = hub.consumer("ingress-0")          # boots at cp's snapshot
    >>> loop = ServeLoop(engine, params, rc)    # binds rc to the loop
    >>> ... each tick: hub.pump(t); loop.tick() ...
    >>> hub.assert_converged()
    """

    def __init__(self, cp: control.ControlPlane,
                 channel: LossyChannel | None = None, *,
                 retry_base: int = 1, retry_cap: int = 16, seed: int = 0):
        self.cp = cp
        self.channel = LossyChannel() if channel is None else channel
        self.publisher = PlanPublisher(cp, self.channel,
                                       retry_base=retry_base,
                                       retry_cap=retry_cap, seed=seed)
        self.consumers: list[RemoteConsumer] = []

    def consumer(self, node: str, *, sink=None,
                 boot: bool = True) -> RemoteConsumer:
        """Create + register a consumer.  ``boot=True`` seeds it from the
        cp's current snapshot (a provisioned host); ``boot=False`` starts
        it cold at version -1 (its first exchange is a resync)."""
        snap = self.cp.packed_snapshot() if boot else None
        rc = RemoteConsumer(node, self.channel, sink=sink, snapshot=snap)
        self.publisher.register(node, boot_version=rc.version)
        self.consumers.append(rc)
        return rc

    def pump(self, tick: int) -> None:
        self.publisher.pump(tick)

    def report(self) -> dict:
        return convergence_report(self.cp, self.consumers)

    def assert_converged(self) -> dict:
        return assert_converged(self.cp, self.consumers)

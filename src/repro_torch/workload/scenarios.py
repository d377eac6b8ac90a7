"""Declarative live-ops scenarios: timed ControlPlane transactions mid-load
(twin of ``repro/workload/scenarios.py``).

A scenario is a list of :class:`Op` records — *when* (global tick), *where*
(chain hop), *what* (operation + kwargs) — and the :class:`ScenarioDriver`
replays them against the per-hop ControlPlanes while the workload is in
flight.  Each op commits as ONE ControlPlane transaction (one version bump,
one live splice into every attached consumer), exactly how an operator or a
rollout controller would drive the system; the driver never touches engine
state directly.

Operations:

  ``set_weight``       — one endpoint's weight (instance, weight)
  ``canary``           — %-shift: the canary instance takes ``pct``% of a
                         WEIGHTED cluster, peers split the rest evenly
  ``drain``/``undrain``— graceful connection drain / restore (instance)
  ``blue_green``       — cutover: ``green`` instances to full weight,
                         ``blue`` instances drained, one transaction
  ``scale``            — elastic scale-up/down to ``target`` endpoints via
                         ``runtime.elastic.scale_fleet``
  ``add_endpoint``     — grow the cluster by one standby instance
                         (instance, weight — weight 0 = blue-green standby)

``rolling_restart`` expands the classic staggered drain→dwell→undrain
sequence into primitive ops at construction, so the schedule itself stays
declarative and replayable.

Scenarios compose with fault injection and service-time shaping: those act
on pool *progress* inside each serving loop; the driver acts on *config*.
The same tick may carry both.
"""

from __future__ import annotations

import dataclasses

from repro_torch.runtime import elastic


@dataclasses.dataclass(frozen=True)
class Op:
    """One timed operation.  ``args`` are the operation's kwargs."""

    tick: int
    op: str
    hop: int = 0
    cluster: str = "pool"
    args: dict = dataclasses.field(default_factory=dict)


def rolling_restart(instances, *, start: int, dwell: int, gap: int | None
                    = None, hop: int = 0, cluster: str = "pool",
                    weight: float = 1.0) -> list[Op]:
    """Staggered restart: instance j drains at ``start + j·gap`` and
    returns at full weight ``dwell`` ticks later (gap defaults to dwell,
    so at most one instance is ever down)."""
    gap = dwell if gap is None else gap
    ops: list[Op] = []
    for j, inst in enumerate(instances):
        t = start + j * gap
        ops.append(Op(t, "drain", hop=hop, cluster=cluster,
                      args={"instance": inst}))
        ops.append(Op(t + dwell, "undrain", hop=hop, cluster=cluster,
                      args={"instance": inst, "weight": weight}))
    return ops


class ScenarioDriver:
    """Replay a scenario against the per-hop ControlPlanes.

    ``apply(tick)`` runs every op due at or before ``tick`` (in (tick,
    hop) order).  ``txns`` counts committed ControlPlane transactions and
    ``log`` is the audit trail — both deterministic, so a replayed
    scenario matches its first run exactly."""

    def __init__(self, cps, ops, *, max_instances: int | list | None = None):
        self.cps = list(cps)
        self.ops = sorted(ops, key=lambda o: (o.tick, o.hop))
        self._next = 0
        self.max_instances = max_instances
        self.txns = 0
        self.log: list[tuple] = []

    def done(self) -> bool:
        return self._next >= len(self.ops)

    def _cap(self, hop: int) -> int:
        if isinstance(self.max_instances, (list, tuple)):
            return int(self.max_instances[hop])
        if self.max_instances is None:
            raise ValueError("scale ops need max_instances (the pool's "
                             "instance-lane capacity)")
        return int(self.max_instances)

    def apply(self, tick: int) -> list[Op]:
        ran: list[Op] = []
        while self._next < len(self.ops) and self.ops[self._next].tick <= tick:
            op = self.ops[self._next]
            self._next += 1
            self._run(op, tick)
            ran.append(op)
        return ran

    # ------------------------------------------------------------------ #
    def _run(self, op: Op, tick: int) -> None:
        cp = self.cps[op.hop]
        v0 = cp.version
        a = op.args
        if op.op == "set_weight":
            cp.set_weight(op.cluster, a["instance"], a["weight"])
        elif op.op == "canary":
            self._canary(cp, op.cluster, a["instance"], a["pct"])
        elif op.op == "drain":
            cp.drain_endpoint(op.cluster, a["instance"])
        elif op.op == "undrain":
            self._undrain(cp, op.cluster, a["instance"],
                          a.get("weight", 1.0))
        elif op.op == "blue_green":
            self._blue_green(cp, op.cluster, a["blue"], a["green"])
        elif op.op == "scale":
            elastic.scale_fleet(cp, op.cluster, a["target"],
                                max_instances=self._cap(op.hop),
                                weight=a.get("weight", 1.0))
        elif op.op == "add_endpoint":
            cp.add_endpoint(op.cluster, a["instance"],
                            weight=a.get("weight", 1.0))
        else:
            raise ValueError(f"unknown scenario op {op.op!r}")
        self.txns += cp.version - v0
        # audit trail carries the post-op config version so a transport
        # replay can be checked op-for-op against the journal history
        self.log.append((tick, op.hop, op.op, cp.version, tuple(sorted(
            (k, tuple(v) if isinstance(v, list) else v)
            for k, v in a.items()))))

    @staticmethod
    def _undrain(cp, cluster: str, instance: int, weight: float) -> None:
        """Restore a drained endpoint.  If the reaper already removed the
        row (its in-flight load hit zero while drained — the normal end of
        a restart), the instance rejoins via ``add_endpoint``: same
        observable result, still one transaction."""
        if any(i == instance for _, i in cp.cluster_members(cluster)):
            cp.undrain_endpoint(cluster, instance, weight=weight)
        else:
            cp.add_endpoint(cluster, instance, weight=weight)

    @staticmethod
    def _canary(cp, cluster: str, instance: int, pct: float) -> None:
        """The canary takes ``pct``% of a WEIGHTED cluster's traffic; its
        *serving* peers split the remainder evenly.  Draining members are
        skipped — re-weighting one would silently cancel a pending
        operator drain as a side effect.  One transaction."""
        if cp.drain_reason(cluster, instance) is not None:
            raise ValueError(f"canary target {instance} in {cluster!r} "
                             "is draining")
        members = cp.cluster_members(cluster)
        peers = [i for _, i in members if i != instance
                 and cp.drain_reason(cluster, i) is None]
        if not peers:
            raise ValueError(f"canary needs peers in {cluster!r}")
        share = (100.0 - pct) / (100.0 * len(peers))
        with cp.transaction():
            cp.set_weight(cluster, instance, pct / 100.0)
            for p in peers:
                cp.set_weight(cluster, p, share)

    @staticmethod
    def _blue_green(cp, cluster: str, blue, green) -> None:
        """Cutover in one transaction: green to full weight (standby
        weight-0 endpoints go live), blue drained — new connections land
        on green this very tick, blue finishes its in-flight work and is
        reaped once its load hits zero."""
        with cp.transaction():
            for g in green:
                ScenarioDriver._undrain(cp, cluster, g, 1.0)
            for b in blue:
                cp.drain_endpoint(cluster, b)

"""Closed-loop endpoint health — the circuit-breaker daemon (twin of
``repro/core/health.py``).

The datapath observes for free: every completion tick the fused kernel
carries two per-endpoint EWMAs in ``RoutingState`` — ``ep_inflight_ewma``
(requests in flight during the step) and ``ep_tput_ewma`` (completions per
step).  Their ratio is the endpoint's latency estimate in ticks under
Little's law (L = λW ⇒ W = L/λ), which stays meaningful under every fault
mode: a slow endpoint's occupancy builds while its completion rate decays,
and a fully *stalled* endpoint — which never produces a completion sample —
still diverges because the denominator drains to zero.

``HealthPolicy`` is the decision half of the loop.  The kernel never
decides: ejection is config authorship (weights, drained bits), which is
ControlPlane's monopoly — the datapath only reads config, so a decision
made in-kernel would either race the control plane's transactions or need
its own write path into the tables.  Instead the daemon runs a per-endpoint
circuit breaker each control epoch and commits every resulting action in
ONE ControlPlane transaction (one plan, one version bump — the datapath
never sees partial state):

  CLOSED ──(latency > k_eject × fleet median, ``trip_after`` consecutive
            epochs, worst-first, capped by the max-ejection-fraction
            guard)──▶ OPEN   (drain reason="health": weight 0 + drained
                              bit up; never reaped, immune to set_weight)
  OPEN   ──(``cooldown`` epochs)──▶ HALF_OPEN  (undrain at a small probe
                              weight: a weight-limited trickle re-tastes
                              the endpoint)
  HALF_OPEN ──(healthy for ``recover_after`` epochs)──▶ CLOSED  (weight
                              restored, breaker reset)
            ──(still sick, or no recovery within ``probe_patience``
               epochs)──▶ OPEN  (re-ejected, cooldown restarts)

Outlier detection is *relative* — each endpoint is judged against the
leave-one-out median of its cluster peers — so a uniformly slow fleet has
no outlier and nothing is ejected: overload is the load balancer's problem,
not the breaker's.  Together with the max-ejection-fraction guard
(``min(floor(frac·n), n-1)`` open breakers at most) the policy can never
drain a whole cluster: the least-bad endpoints always keep serving, so a
degraded fleet degrades instead of returning NO_ROUTE.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.routing_table import POLICY_WEIGHTED

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

# An endpoint with both EWMAs below these floors has seen no meaningful
# traffic — it is not judged (no data is not evidence of health or sickness).
MIN_INFLIGHT = 0.05
MIN_TPUT = 0.02
# Completion-rate floor for the latency ratio: caps the estimate for a
# stalled endpoint (tput → 0) at inflight / TPUT_FLOOR instead of inf.
TPUT_FLOOR = 1.0 / 64.0


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    """Breaker thresholds, all in control epochs / multiples of the fleet
    median latency."""

    k_eject: float = 3.0        # trip when latency > k_eject × peer median
    k_recover: float = 2.0      # healthy when latency ≤ k_recover × median
    trip_after: int = 2         # consecutive sick epochs before ejection
    cooldown: int = 3           # OPEN epochs before the half-open probe
    recover_after: int = 2      # healthy probe epochs before closing
    probe_patience: int = 8     # half-open epochs without recovery → re-open
    max_eject_frac: float = 0.5  # ejection budget as a fraction of the fleet
    probe_weight: float = 0.1   # trickle weight during the half-open probe
    min_probe_tput: float = 0.05  # a probe must actually complete requests
    #                               at this EWMA rate to count as healthy
    # Graded-weight mode (WEIGHTED clusters only): continuously scale each
    # serving endpoint's weight by peer-median/latency instead of waiting
    # for the breaker's binary verdict — the paper's weighted-LB analogue
    # of gradual backend demotion.
    graded_weights: bool = False
    graded_floor: float = 0.25  # weight floor: demoted, never starved
    #                             (full removal stays the breaker's job)
    graded_alpha: float = 0.5   # EWMA smoothing toward the target weight
    graded_deadband: float = 0.05  # skip commits within this of the live
    #                                weight — the no-flap band


@dataclasses.dataclass
class _Breaker:
    state: str = CLOSED
    sick: int = 0               # consecutive sick epochs while CLOSED
    healthy: int = 0            # consecutive healthy epochs while HALF_OPEN
    open_epochs: int = 0
    probe_epochs: int = 0
    saved_weight: float = 1.0   # weight to restore when the breaker closes


def latency_estimate(inflight_ewma, tput_ewma) -> np.ndarray:
    """Per-endpoint latency estimate in ticks (Little's law W = L/λ), 0.0
    where the endpoint has seen no meaningful traffic."""
    infl = np.asarray(inflight_ewma, np.float32)
    tput = np.asarray(tput_ewma, np.float32)
    lat = infl / np.maximum(tput, TPUT_FLOOR)
    has_data = (infl >= MIN_INFLIGHT) | (tput >= MIN_TPUT)
    return np.where(has_data, lat, 0.0).astype(np.float32)


def _host_ewmas(routing) -> tuple[np.ndarray, np.ndarray]:
    """The two health EWMAs on the host as f32 numpy: tensors (the
    engine's, on any device) in one explicit ``.cpu()`` read, numpy arrays
    (a sidecar's tables, a test's stub) as they are."""
    infl, tput = routing.ep_inflight_ewma, routing.ep_tput_ewma
    if isinstance(infl, torch.Tensor):
        both = torch.stack([infl, tput]).cpu().numpy()
        return both[0], both[1]
    return np.asarray(infl, np.float32), np.asarray(tput, np.float32)


class HealthPolicy:
    """Per-cluster circuit breakers over the datapath's health EWMAs.

    ``epoch(routing)`` is the daemon tick: read the EWMAs out of a live
    RoutingState (one host read an epoch), run every breaker, and commit
    all resulting actions in one ControlPlane transaction.  Returns the action list (empty = no
    transaction, no version bump)."""

    def __init__(self, cp, cfg: HealthConfig | None = None,
                 clusters: list[str] | None = None):
        self.cp = cp
        self.cfg = cfg or HealthConfig()
        self.clusters = clusters            # None = every cluster
        self.breakers: dict[tuple[str, int], _Breaker] = {}
        self._gw: dict[tuple[str, int], float] = {}  # graded smoothed weights
        self.epochs = 0
        self.commits = 0
        self.events: list[tuple] = []       # (epoch, action...) audit trail

    # ------------------------------------------------------------------ #
    def _bk(self, cluster: str, instance: int) -> _Breaker:
        return self.breakers.setdefault((cluster, instance), _Breaker())

    def state_of(self, cluster: str, instance: int) -> str:
        bk = self.breakers.get((cluster, instance))
        return bk.state if bk is not None else CLOSED

    def ejected(self) -> list[tuple[str, int]]:
        return [k for k, b in self.breakers.items() if b.state == OPEN]

    # ------------------------------------------------------------------ #
    def _peer_median(self, cluster: str, members, lat, exclude: int) -> float:
        """Leave-one-out median latency of the cluster's serving peers —
        robust for small fleets (with a plain median a 2-endpoint cluster
        could never flag its sick half).  OPEN (ejected) peers don't vote
        unless nobody else has data."""
        vals = [float(lat[s]) for s, i in members
                if i != exclude and lat[s] > 0.0
                and self.state_of(cluster, i) != OPEN]
        if not vals:
            vals = [float(lat[s]) for s, i in members
                    if i != exclude and lat[s] > 0.0]
        return float(np.median(vals)) if vals else 0.0

    def _epoch_cluster(self, name: str, lat: np.ndarray) -> list[tuple]:
        cfg = self.cfg
        members = self.cp.cluster_members(name)
        if not members:
            return []
        alive = {inst for _, inst in members}
        for key in [k for k in self.breakers
                    if k[0] == name and k[1] not in alive]:
            del self.breakers[key]          # endpoint left the cluster

        acts: list[tuple] = []
        candidates: list[tuple] = []
        for slot, inst in members:
            bk = self._bk(name, inst)
            l = float(lat[slot])
            med = self._peer_median(name, members, lat, inst)
            has_data = l > 0.0 and med > 0.0
            sick = has_data and l > cfg.k_eject * med
            healthy = has_data and l <= cfg.k_recover * med
            if bk.state == CLOSED:
                bk.sick = bk.sick + 1 if sick else 0
                if bk.sick >= cfg.trip_after:
                    candidates.append((l, slot, inst, bk))
            elif bk.state == OPEN:
                bk.open_epochs += 1
                if bk.open_epochs >= cfg.cooldown:
                    bk.state = HALF_OPEN
                    bk.probe_epochs = 0
                    bk.healthy = 0
                    acts.append(("probe", name, inst, cfg.probe_weight))
            else:                           # HALF_OPEN: judge the probe
                bk.probe_epochs += 1
                tput = self._tput[slot]
                if healthy and tput >= cfg.min_probe_tput:
                    bk.healthy += 1
                    if bk.healthy >= cfg.recover_after:
                        bk.state = CLOSED
                        bk.sick = 0
                        acts.append(("close", name, inst, bk.saved_weight))
                else:
                    bk.healthy = 0
                    if sick or bk.probe_epochs >= cfg.probe_patience:
                        bk.state = OPEN      # re-ejected; cooldown restarts
                        bk.open_epochs = 0
                        acts.append(("eject", name, inst))

        # max-ejection-fraction guard: never more than floor(frac·n) open
        # breakers, and never the last serving endpoint — the least-bad
        # endpoints keep taking traffic instead of the cluster going
        # NO_ROUTE.  Worst (highest latency) candidates go first; the rest
        # stay CLOSED with their sick streak saturated for the next epoch.
        n = len(members)
        committed = sum(1 for _, i in members
                        if self.state_of(name, i) in (OPEN, HALF_OPEN))
        budget = min(int(cfg.max_eject_frac * n), n - 1) - committed
        for l, slot, inst, bk in sorted(candidates, key=lambda x: -x[0]):
            if budget <= 0:
                break
            bk.state = OPEN
            bk.open_epochs = 0
            bk.saved_weight = float(self.cp.endpoint_weight(name, inst))
            acts.append(("eject", name, inst))
            budget -= 1
        return acts

    def _graded_cluster(self, name: str, lat: np.ndarray) -> list[tuple]:
        """Graded-weight mode: nudge each serving endpoint's weight toward
        ``clip(peer_median / latency, graded_floor, 1.0)`` — a
        slow-but-not-sick endpoint sheds load *continuously* instead of
        waiting for the breaker's binary verdict.  WEIGHTED clusters only
        (the other policies never read ``ep_weight``).  The smoothed weight
        is EWMA'd (``graded_alpha``) and only committed when it moved past
        ``graded_deadband`` from the live weight, so a steady fleet
        converges and then stops producing transactions (no-flap).
        Endpoints that are not CLOSED, are draining, or have no data keep
        their weight — graded mode never fights the breaker."""
        if self.cp.cluster_policy(name) != POLICY_WEIGHTED:
            return []
        cfg = self.cfg
        members = self.cp.cluster_members(name)
        acts: list[tuple] = []
        for slot, inst in members:
            if self.state_of(name, inst) != CLOSED \
                    or self.cp.drain_reason(name, inst) is not None:
                continue
            l = float(lat[slot])
            med = self._peer_median(name, members, lat, inst)
            if l <= 0.0 or med <= 0.0:
                continue                    # no data: leave the weight alone
            target = float(np.clip(med / l, cfg.graded_floor, 1.0))
            prev = self._gw.get(
                (name, inst), float(self.cp.endpoint_weight(name, inst)))
            w = (1.0 - cfg.graded_alpha) * prev + cfg.graded_alpha * target
            self._gw[(name, inst)] = w
            if abs(w - float(self.cp.endpoint_weight(name, inst))) \
                    > cfg.graded_deadband:
                acts.append(("weight", name, inst, w))
        return acts

    # ------------------------------------------------------------------ #
    def epoch(self, routing) -> list[tuple]:
        """One daemon tick: read EWMAs → run breakers → one transaction."""
        self.epochs += 1
        self.cp.advance_epoch()             # the liveness-lease clock
        infl, tput = _host_ewmas(routing)
        lat = latency_estimate(infl, tput)
        self._tput = tput
        names = self.clusters if self.clusters is not None \
            else self.cp.cluster_names()
        actions: list[tuple] = []
        for name in names:
            actions += self._epoch_cluster(name, lat)
            if self.cfg.graded_weights:
                actions += self._graded_cluster(name, lat)
        if actions:
            with self.cp.transaction():
                for act in actions:
                    kind, name, inst = act[0], act[1], act[2]
                    if kind == "eject":
                        self.cp.drain_endpoint(name, inst, reason="health")
                    elif kind == "probe":
                        self.cp.undrain_endpoint(name, inst, weight=act[3])
                    elif kind == "weight":
                        self.cp.set_weight(name, inst, act[3])
                    elif kind == "close":
                        # an operator may have staged a weight while the
                        # breaker was open (set_weight doesn't un-eject);
                        # honor it over the pre-ejection saved weight.  The
                        # current weight is probe_weight unless somebody
                        # staged one mid-probe/mid-open.
                        staged = self.cp.endpoint_weight(name, inst)
                        w = act[3]
                        if staged > 0.0 and \
                                abs(staged - self.cfg.probe_weight) > 1e-6:
                            w = staged
                        self.cp.set_weight(name, inst, w)
            self.commits += 1
        self.events += [(self.epochs,) + a for a in actions]
        return actions

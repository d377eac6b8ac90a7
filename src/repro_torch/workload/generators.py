"""Trace-style workload generators: arrival processes + service-time laws
(twin of ``repro/workload/generators.py``).

The paper's evaluation regime is heavy traffic from very many clients —
not the uniform one-shot waves the early benchmarks drove.  This module
synthesizes that regime deterministically:

  * **Arrival processes** give the number of new requests per engine tick:
    ``PoissonArrivals`` (memoryless steady load), ``BurstyArrivals``
    (ON-OFF modulation — the flash-crowd / batch-job pattern), and
    ``DiurnalArrivals`` (a raised-cosine day curve).  All share a ``scale``
    knob that multiplies the offered rate, so one scenario definition
    sweeps from a smoke test toward the millions-of-users regime without
    changing shape.
  * **Service-time laws** give each request its occupancy in engine ticks:
    ``LognormalServiceTimes`` / ``ParetoServiceTimes`` (the heavy tails of
    real RPC latency) and ``FixedServiceTimes`` (the legacy deterministic
    setting).  ``ServiceTimeShaper`` enforces a sampled time on a live
    connection pool through the same progress-rollback model the fault
    injector uses — per *request* instead of per instance — on the XLB
    engine's tensor pools and the sidecars' numpy pools alike.
  * ``Workload`` ties both to a request factory that emits
    ``RequestBatch``es any engine admits directly (diverse flow features,
    so hash-keyed policies see real key entropy).

Determinism contract: every draw is keyed — arrivals by ``(seed, tick)``,
service times by ``(seed, hop, req_id)``, features by ``(seed, req_id)`` —
never by call order.  Two runs of the same scenario produce bit-identical
request streams, which is what makes the scenario rows replayable.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core.balancer import RequestBatch
from repro_torch.core.routing_table import N_FEATURES


def _rng(*key: int) -> np.random.Generator:
    """A fresh PCG64 stream for one keyed draw — stateless, order-free."""
    return np.random.default_rng([int(k) & 0x7FFFFFFF for k in key])


# --------------------------------------------------------------------------- #
# Arrival processes
# --------------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class ArrivalProcess:
    """Base: ``arrivals(tick)`` = Poisson draw at the process's rate(tick),
    scaled by ``scale`` and keyed by ``(seed, tick)``."""

    rate: float = 1.0
    scale: float = 1.0
    seed: int = 0

    def rate_at(self, tick: int) -> float:
        return self.rate

    def arrivals(self, tick: int) -> int:
        lam = self.rate_at(tick) * self.scale
        if lam <= 0.0:
            return 0
        return int(_rng(self.seed, tick).poisson(lam))


@dataclasses.dataclass(frozen=True)
class PoissonArrivals(ArrivalProcess):
    """Memoryless arrivals at a constant offered rate (requests/tick)."""


@dataclasses.dataclass(frozen=True)
class BurstyArrivals(ArrivalProcess):
    """ON-OFF modulated Poisson: ``on_ticks`` at ``rate``, then
    ``off_ticks`` at ``off_rate`` (default silent) — the flash-crowd
    stressor for admission capacity and the retry/backoff path."""

    on_ticks: int = 8
    off_ticks: int = 8
    off_rate: float = 0.0
    phase: int = 0

    def rate_at(self, tick: int) -> float:
        period = self.on_ticks + self.off_ticks
        return (self.rate if (tick + self.phase) % period < self.on_ticks
                else self.off_rate)


@dataclasses.dataclass(frozen=True)
class DiurnalArrivals(ArrivalProcess):
    """Raised-cosine day curve between ``rate`` (trough) and ``peak`` over
    ``period`` ticks — the slow swell elastic scaling rides."""

    peak: float = 4.0
    period: int = 64

    def rate_at(self, tick: int) -> float:
        frac = 0.5 * (1.0 - math.cos(2.0 * math.pi * tick / self.period))
        return self.rate + (self.peak - self.rate) * frac


# --------------------------------------------------------------------------- #
# Service-time laws
# --------------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class ServiceTimes:
    """Base: ``ticks(req_id, hop)`` = per-request occupancy in engine
    ticks, keyed by ``(seed, hop, req_id)`` — the same request re-sampled
    at a different hop draws independently."""

    seed: int = 0
    floor: int = 1
    cap: int = 64

    def _raw(self, rng: np.random.Generator) -> float:
        return float(self.floor)

    def ticks(self, req_id: int, hop: int = 0) -> int:
        raw = self._raw(_rng(self.seed, hop, req_id))
        return int(np.clip(round(raw), self.floor, self.cap))


@dataclasses.dataclass(frozen=True)
class FixedServiceTimes(ServiceTimes):
    """Every request takes exactly ``floor`` ticks (the legacy setting)."""


@dataclasses.dataclass(frozen=True)
class LognormalServiceTimes(ServiceTimes):
    """ticks ~ median · exp(sigma·Z) — the body of real RPC latency."""

    median: float = 2.0
    sigma: float = 0.8

    def _raw(self, rng) -> float:
        return self.median * math.exp(self.sigma * float(rng.normal()))


@dataclasses.dataclass(frozen=True)
class ParetoServiceTimes(ServiceTimes):
    """ticks ~ xm · (1-U)^(-1/alpha) — the heavy tail (alpha ≤ 2 has
    infinite variance; the ``cap`` bound keeps scenarios finite)."""

    xm: float = 1.0
    alpha: float = 1.5

    def _raw(self, rng) -> float:
        u = float(rng.random())
        return self.xm * (1.0 - u) ** (-1.0 / self.alpha)


class ServiceTimeShaper:
    """Enforce sampled per-request service times on a live pool.

    Same mechanism as ``runtime.serve_loop.FaultInjector`` — roll back
    ``pool.length`` so a decode step nets to zero progress — but keyed by
    *request* instead of instance: a request whose sampled time exceeds the
    fleet's base occupancy (``base_ticks``) is held for the difference, one
    rollback per extra tick.  A hold is only charged when it actually took
    effect (``length > 0``), so the delay is exact in ticks.  Works on
    both pool representations: numpy in place, and a tensor pool by one
    functional update on its own device (the hold decision needs the
    pool's ids, activity and lengths on the host: one read a tick)."""

    def __init__(self, service: ServiceTimes, base_ticks: int, hop: int = 0):
        self.service = service
        self.base_ticks = base_ticks
        self.hop = hop
        self._rem: dict[int, int] = {}      # req_id → extra ticks left

    def _extra(self, rid: int) -> int:
        if rid not in self._rem:
            self._rem[rid] = max(
                0, self.service.ticks(rid, self.hop) - self.base_ticks)
        return self._rem[rid]

    def apply(self, pool, tick: int):
        if isinstance(pool.length, torch.Tensor):
            host = torch.stack([pool.req_id, pool.active.to(torch.int32),
                                pool.length]).cpu().numpy()
            req, act, length = host[0], host[1] != 0, host[2]
        else:
            req, act = np.asarray(pool.req_id), np.asarray(pool.active)
            length = np.asarray(pool.length)
        hold = np.zeros_like(act)
        for i, c in zip(*np.nonzero(act & (length > 0))):
            rid = int(req[i, c])
            if rid >= 0 and self._extra(rid) > 0:
                hold[i, c] = True
                self._rem[rid] -= 1
        if not hold.any():
            return pool
        if isinstance(pool.length, np.ndarray):
            pool.length[hold] -= 1
            return pool
        hold = torch.from_numpy(hold.astype(np.int32)).to(
            pool.length.device, non_blocking=True)
        return pool._replace(length=pool.length - hold)


# --------------------------------------------------------------------------- #
# The request factory
# --------------------------------------------------------------------------- #


@dataclasses.dataclass
class Workload:
    """One generated request stream: arrivals + service law + features.

    ``wave(tick, next_id)`` gives the req_ids arriving at ``tick`` (clipped
    to the ``n_requests`` budget); ``request_batch(ids, pad_to)`` packs
    them into an engine-admittable ``RequestBatch`` with per-flow feature
    entropy (hash-keyed policies select on these) and per-request prompt
    tokens.  ``vocab`` bounds the token ids like the bench harness does."""

    arrivals: ArrivalProcess
    service: ServiceTimes | None = None
    n_requests: int | None = None
    seed: int = 0
    vocab: int = 256

    def wave(self, tick: int, next_id: int) -> list[int]:
        n = self.arrivals.arrivals(tick)
        if self.n_requests is not None:
            n = min(n, self.n_requests - next_id)
        return list(range(next_id, next_id + max(0, n)))

    def features(self, req_id: int) -> np.ndarray:
        f = _rng(self.seed, req_id).integers(
            0, 1 << 30, size=(N_FEATURES,), dtype=np.int64)
        return f.astype(np.int32)

    def request_batch(self, req_ids, pad_to: int) -> RequestBatch:
        """The ids as a host (CPU tensor) batch; an engine uploads it."""
        rid = np.full((pad_to,), -1, np.int32)
        svc = np.zeros((pad_to,), np.int32)
        feats = np.zeros((pad_to, N_FEATURES), np.int32)
        tok = np.zeros((pad_to,), np.int32)
        nbytes = np.full((pad_to,), 128, np.int32)
        n = min(len(req_ids), pad_to)
        for i in range(n):
            r = int(req_ids[i])
            rid[i] = r
            feats[i] = self.features(r)
            tok[i] = 3 + r % max(1, self.vocab - 3)
        t = torch.from_numpy
        return RequestBatch(req_id=t(rid), svc=t(svc), features=t(feats),
                            token=t(tok), msg_bytes=t(nbytes))

    def shaper(self, base_ticks: int, hop: int = 0):
        """A per-hop ServiceTimeShaper (None when the law is fixed/absent —
        the pool's own length-driven completion already enforces it)."""
        if self.service is None or isinstance(self.service,
                                              FixedServiceTimes):
            return None
        return ServiceTimeShaper(self.service, base_ticks, hop=hop)

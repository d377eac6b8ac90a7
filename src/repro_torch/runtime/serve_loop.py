"""Host serving driver (twin of ``repro/runtime/serve_loop.py``): ingress
parsing and continuous batching around a ``Balancer``.

The host hashes L7 header fields into the fixed int32 feature vector and
queues requests; routing, balancing, slot allocation and decode run on the
engine's device.  Per tick the host uploads one admission batch and
downloads the tick's ``packed`` output (emitted tokens, done flags,
serviced ids and the active count; the captured tick's is a static
buffer); the sidecar baselines hand it back as host numpy.

A loop built on a ``ControlPlane`` boots from its snapshot, attaches as a
consumer (every commit is spliced into the live engine state through
``apply_refresh``) and heartbeats its lease once a tick.  A loop built on
a ``transport.RemoteConsumer`` boots from the consumer's snapshot and
pumps it once a tick instead: plans arrive over its lossy channel, and
the heartbeat with the live ``ep_load`` goes back the same way.

Over an engine sharded one rank a shard (``launch/mesh.py::RankShardMesh``)
every rank runs this loop over the same requests: the engine gathers each
tick's host outputs from every rank, so each rank's loop sees the whole
tick and keeps the same host state.

A ``FaultInjector`` rolls back the progress of held instances before the
step (the degraded-backend model the health daemon must detect), and
under ``XLB_SANITIZE=1`` every tick ends with the queue-conservation law.

A ``runtime/trace.py::Tracer`` set on ``ServeLoop.tracer`` (none by
default) times each phase of a tick and counts its rows: taken, held
(first holds among them), dropped, released from backoff and completed;
the loop hands it to its captured tick, which times its own phases.
"""

from __future__ import annotations

import collections
import dataclasses
import heapq
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.analysis.invariants import assert_host, sanitize_enabled
from repro_torch.core import control
from repro_torch.core.balancer import Balancer, RequestBatch
from repro_torch.core.routing_table import N_FEATURES, RoutingState, fnv1a
from repro_torch.device import resolve_device
from repro_torch.runtime import transport
from repro_torch.runtime.trace import Tracer


@dataclasses.dataclass
class Request:
    req_id: int
    service: int
    headers: dict[str, str]
    prompt_token: int
    msg_bytes: int = 128
    t_submit: float = 0.0
    t_done: float = 0.0
    retries: int = 0
    hop: int = 0                # chain position of this admission
    tokens: list = dataclasses.field(default_factory=list)
    submit_tick: int = -1       # loop tick the request entered the ingress
    admit_tick: int = -1        # first tick it actually held a pool slot
    done_tick: int = -1         # tick its final token completed
    t_admit: float = 0.0        # host clock at the launch of admit_tick


class DrainReport(NamedTuple):
    """What a drain actually left behind — not just the completions."""

    done: list            # completed Requests (all-time, == loop.done)
    dropped: list         # gave up after max retries (== loop.dropped)
    queued: int           # still waiting at the ingress when draining ended
    inflight: int         # still holding a pool slot when draining ended
    held_first: int = 0   # DISTINCT requests ever re-queued


# --------------------------------------------------------------------------- #
# Fault injection: the degraded-scenario harness
# --------------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class Fault:
    """One injected endpoint fault, in engine ticks.

    Faults act on *progress*, not on routing: on a held tick the
    instance's active slots have their decode position rolled back by
    one, so the step nets to zero.  Requests pile up, occupancy rises,
    completions stop: a slow or wedged backend as the datapath sees it,
    visible only to the occupancy / throughput EWMAs of the completion
    kernel.

      slow   — the instance makes net progress on 1 tick in ``factor``
      stall  — no progress at all while the fault is active
      flap   — alternates ``period`` stalled ticks / ``period`` healthy
               ticks (the breaker-hysteresis stressor)
    """

    instance: int
    kind: str = "slow"          # slow | stall | flap
    factor: int = 10
    start: int = 0
    end: int | None = None      # None = never clears
    period: int = 8             # flap half-cycle, in ticks

    def holds(self, tick: int) -> bool:
        """Does this fault hold the instance's progress at ``tick``?"""
        if tick < self.start or (self.end is not None and tick >= self.end):
            return False
        if self.kind == "stall":
            return True
        if self.kind == "slow":
            return (tick - self.start) % self.factor != 0
        if self.kind == "flap":
            return ((tick - self.start) // self.period) % 2 == 0
        raise ValueError(f"unknown fault kind {self.kind!r}")


class FaultInjector:
    """Applies a set of :class:`Fault` schedules to a live pool.

    ``apply`` runs on the host between engine ticks and rolls back
    ``pool.length`` on the held instances' active slots (floored at 0):
    on a tensor pool as one functional update on the pool's own device
    (no host round trip of ``length``), on a sidecar's numpy pool in
    place.  With nothing held it returns the pool it was given."""

    def __init__(self, faults):
        self.faults = list(faults)

    def active(self, tick: int) -> list[int]:
        return [f.instance for f in self.faults if f.holds(tick)]

    def clear_tick(self) -> int | None:
        """Last tick at which any fault clears (None if one never does)."""
        ends = [f.end for f in self.faults]
        return None if any(e is None for e in ends) else max(ends, default=0)

    def apply(self, pool, tick: int, first: int = 0):
        """``first``: the global index of the pool's first lane (a rank of
        a sharded engine holds lanes ``first`` onward)."""
        # a fault naming a lane outside the live instance window (a
        # schedule written for a larger fleet, or another rank's lane) is
        # inert
        I = pool.length.shape[0]
        held = [i - first for i in self.active(tick) if 0 <= i - first < I]
        if not held:
            return pool
        if isinstance(pool.length, np.ndarray):
            for i in held:
                m = pool.active[i] & (pool.length[i] > 0)
                pool.length[i, m] -= 1
            return pool
        lanes = np.zeros((I,), bool)
        lanes[held] = True
        # one upload of the lane mask (the pageable source is staged before
        # the copy call returns, so no host sync)
        lanes = torch.from_numpy(lanes).to(pool.length.device,
                                           non_blocking=True)
        hold = lanes[:, None] & pool.active & (pool.length > 0)
        return pool._replace(length=pool.length - hold.to(torch.int32))


def parse_features(headers: dict[str, str]) -> np.ndarray:
    """Host ingress 'protocol parse': hash selected header fields into the
    feature vector the router matches on."""
    feats = np.zeros((N_FEATURES,), np.int32)
    for i, field in enumerate(("path", "user", "version", "tenant",
                               "method", "content-type", "region", "abtest")):
        if field in headers:
            feats[i] = fnv1a(headers[field])
    return feats


class ServeLoop:
    """Continuous batching driver for one service fleet, on the balancer's
    device (the engine's default is the card)."""

    def __init__(self, balancer: Balancer, params,
                 routing: RoutingState | control.ControlPlane
                 | transport.RemoteConsumer,
                 admit_batch: int = 8, dtype=torch.float32,
                 max_retries: int = 64, backoff_base: int = 1,
                 backoff_cap: int = 16, backoff_seed: int = 0,
                 fault: FaultInjector | None = None):
        resolve_device(balancer.device)
        self.balancer = balancer
        self.params = params
        self.admit_batch = admit_batch
        self.cp = None
        self.remote = None
        if isinstance(routing, control.ControlPlane):
            cp, routing = routing, routing.snapshot()
            cp.attach(self)
            self.cp = cp
        elif isinstance(routing, transport.RemoteConsumer):
            # attached through the plan transport: the consumer pumps its
            # lossy channel each tick and calls apply_refresh here; the
            # loop boots at the consumer's snapshot
            rc, routing = routing, routing.boot_routing
            rc.bind(self)
            self.remote = rc
        self.state = balancer.init_state(routing, dtype=dtype)
        # ``_step``: the tick built here, which the tracer setter reaches
        # even after a caller wraps ``serve_step``
        self.serve_step = self._step = balancer.make_jitted(donate=False)
        self._tracer = None
        self.queue: collections.deque[Request] = collections.deque()
        self.inflight: dict[int, Request] = {}
        self.done: list[Request] = []
        self.dropped: list[Request] = []    # gave up after max retries
        self.held_first = 0                 # distinct requests ever re-queued
        # Held/unroutable requests back off with capped exponential delay +
        # deterministic jitter seeded by (seed, req_id, attempt).
        self.max_retries = max_retries
        self.backoff_base = backoff_base
        self.backoff_cap = backoff_cap
        self.backoff_seed = backoff_seed
        self._waiting: list[tuple[int, int, Request]] = []   # backoff heap
        self._wseq = 0
        self.ticks = 0
        self.fault = fault                  # optional FaultInjector
        self.submitted = 0                  # all-time submit() count

    # ------------------------------------------------------------------ #
    # control-plane seam
    # ------------------------------------------------------------------ #
    @property
    def routing(self) -> RoutingState:
        """The live routing tables the engine is reading right now."""
        return self.balancer.get_routing(self.state)

    def apply_refresh(self, plan: control.RefreshPlan) -> None:
        """ControlPlane consumer hook: splice a committed transaction into
        the live engine state (same datapath, new tables)."""
        self.state = self.balancer.apply_refresh(self.state, plan)

    # ------------------------------------------------------------------ #
    @property
    def tracer(self) -> Tracer | None:
        """The tick's spans and counters (None: not kept)."""
        return self._tracer

    @tracer.setter
    def tracer(self, tracer: Tracer | None) -> None:
        """Also hands ``tracer`` to the tick built at construction (a
        captured tick times its own phases).  A tick a caller later puts
        in ``serve_step`` in its place is timed only as a whole
        (``serve_loop.step``)."""
        self._tracer = tracer
        if hasattr(self._step, "tracer"):       # the captured tick's own
            self._step.tracer = tracer

    @property
    def n_queued(self) -> int:
        """Everything still at the ingress: ready queue + backoff set.
        ``submitted == done + dropped + n_queued + inflight`` at all times."""
        return len(self.queue) + len(self._waiting)

    def submit(self, req: Request) -> None:
        req.t_submit = time.perf_counter()
        if req.submit_tick < 0:
            req.submit_tick = self.ticks
        self.submitted += 1
        self.queue.append(req)

    def latency_samples(self) -> dict:
        """Per-request tick samples over the completed set, aligned by row:
        ``admit_to_done``, ``submit_to_done`` and ``retries``."""
        done = [r for r in self.done if r.done_tick >= 0]
        return {
            "req_id": np.array([r.req_id for r in done], np.int64),
            "admit_to_done": np.array(
                [r.done_tick - r.admit_tick for r in done], np.int64),
            "submit_to_done": np.array(
                [r.done_tick - r.submit_tick for r in done], np.int64),
            "retries": np.array([r.retries for r in done], np.int64),
        }

    def _backoff(self, req: Request) -> None:
        """Park a held request until its retry matures (or drop it)."""
        if req.retries >= self.max_retries:
            req.t_done = time.perf_counter()
            self.dropped.append(req)
            return
        delay = min(self.backoff_base << (req.retries - 1), self.backoff_cap)
        rng = np.random.default_rng(
            (self.backoff_seed, req.req_id, req.retries))
        delay += int(rng.integers(0, delay))
        heapq.heappush(self._waiting,
                       (self.ticks + delay, self._wseq, req))
        self._wseq += 1

    def _release_matured(self) -> int:
        """Move matured backoff entries to the FRONT of the ready queue;
        how many."""
        batch = []
        while self._waiting and self._waiting[0][0] <= self.ticks:
            batch.append(heapq.heappop(self._waiting)[2])
        self.queue.extendleft(reversed(batch))
        return len(batch)

    def _next_admission(self) -> tuple[RequestBatch, list]:
        """The next admission batch as host (CPU) tensors."""
        R = self.admit_batch
        rid = np.full((R,), -1, np.int32)
        svc = np.zeros((R,), np.int32)
        feats = np.zeros((R, N_FEATURES), np.int32)
        tok = np.zeros((R,), np.int32)
        nbytes = np.zeros((R,), np.int32)
        taken = []
        for i in range(R):
            if not self.queue:
                break
            r = self.queue.popleft()
            rid[i], svc[i] = r.req_id, r.service
            feats[i] = parse_features(r.headers)
            tok[i], nbytes[i] = r.prompt_token, r.msg_bytes
            self.inflight[r.req_id] = r
            taken.append(r)
        t = torch.from_numpy
        return RequestBatch(req_id=t(rid), svc=t(svc), features=t(feats),
                            token=t(tok), msg_bytes=t(nbytes)), taken

    def tick(self) -> dict:
        """One engine step: admit waiting requests + decode every lane."""
        tr = self._tracer
        if tr is not None:
            tr.root("serve_loop.tick")
            tr.open("serve_loop.control")
            before = (len(self.done), len(self.dropped), self.held_first)
        if self.cp is not None:
            self.cp.heartbeat(self)          # liveness lease
        elif self.remote is not None:        # transport-attached: plans in,
            self.remote.pump(self.ticks)     # heartbeat + load report out
        if tr is not None:
            tr.next("serve_loop.fault")
        if self.fault is not None:           # roll progress back BEFORE
            pool = self.fault.apply(                             # the step
                self.state.pool, self.ticks,
                getattr(self.balancer, "first_instance", 0))
            if pool is not self.state.pool:
                self.state = self.state._replace(pool=pool)
        if tr is not None:
            tr.next("serve_loop.release")
        released = self._release_matured()
        if tr is not None:
            tr.next("serve_loop.ingress")
        reqs, taken = self._next_admission()
        if tr is not None:
            tr.next("serve_loop.step")
        t_launch = time.perf_counter()
        self.state, out = self.serve_step(self.params, self.state, reqs)
        if tr is not None:
            tr.next("serve_loop.download")
        I, C = out["emitted"].shape
        n = I * C
        host = out["packed"]                    # one download per tick
        if isinstance(host, torch.Tensor):      # (a sidecar's is host numpy)
            host = host.cpu().numpy()
        if tr is not None:
            tr.next("serve_loop.complete")
        emitted, done, ids = host[:n], host[n:2 * n], host[2 * n:3 * n]
        serviced = set()
        for cell in np.flatnonzero(ids >= 0):     # row-major (i, s) order
            rid = int(ids[cell])
            if rid in self.inflight:
                serviced.add(rid)
                req = self.inflight[rid]
                if req.admit_tick < 0:            # first tick holding a slot
                    req.admit_tick = self.ticks
                    req.t_admit = t_launch
                req.tokens.append(int(emitted[cell]))
                if done[cell]:
                    r = self.inflight.pop(rid)
                    r.t_done = time.perf_counter()
                    r.done_tick = self.ticks
                    self.done.append(r)
        if tr is not None:
            tr.next("serve_loop.requeue")
        # held requests (pool exhausted / unroutable this tick) re-queue
        held = [r for r in taken
                if r.req_id not in serviced and r.req_id in self.inflight]
        for r in held:
            self.inflight.pop(r.req_id)
            if r.retries == 0:              # first hold: count the REQUEST
                self.held_first += 1
            r.retries += 1
            self._backoff(r)
        if tr is not None:
            tr.close()
            for name, k in (
                    ("serve_loop.taken", len(taken)),
                    ("serve_loop.held", len(held)),
                    ("serve_loop.first_holds", self.held_first - before[2]),
                    ("serve_loop.dropped", len(self.dropped) - before[1]),
                    ("serve_loop.released", released),
                    ("serve_loop.completed", len(self.done) - before[0])):
                tr.count(name, k)
        self.ticks += 1
        if sanitize_enabled():
            assert_host("loop", dict(
                submitted=self.submitted, done=len(self.done),
                dropped=len(self.dropped), queued=self.n_queued,
                inflight=len(self.inflight)))
        if tr is not None:
            tr.close()
        return {"active": int(host[3 * n]), "queued": self.n_queued,
                "done": len(self.done), "dropped": len(self.dropped)}

    def drain(self, max_ticks: int = 10_000) -> DrainReport:
        """Tick until idle (or the budget runs out) and report everything."""
        t = 0
        while (self.queue or self._waiting or self.inflight) \
                and t < max_ticks:
            self.tick()
            t += 1
        return DrainReport(done=self.done, dropped=self.dropped,
                           queued=self.n_queued,
                           inflight=len(self.inflight),
                           held_first=self.held_first)

"""Chained-service traversal: the paper's long-service-chain regime (twin
of ``repro/workload/chain.py``).

A depth-D chain is D independent service fleets, each behind its own
balancer; a request completing at service k is *synchronously* admitted at
service k+1 — same global tick, so the forwarding itself is free and the
measured end-to-end latency is exactly the sum of the per-hop admit→done
tick latencies.  The balancer is traversed once per hop: this is the
regime where per-hop sidecar interposition compounds (PAPERS.md, *Sidecars
on the Central Lane*) and where the in-graph datapath must at least hold
even: the chain gate of the reference's benchmark pins that.

``ChainRunner`` is engine-agnostic: a hop is anything with the small
service-fleet protocol ``submit(ids)`` / ``tick() -> finished ids`` /
``busy`` / ``dropped`` (``workload.hops.Service`` for all three
engines).  Per-request chain position lives in ``ChainRunner.position``
and advances only on completion-forwarding, so a held or retried request
keeps its hop.  Live-ops scenarios (``scenarios.ScenarioDriver``) apply at
the top of every global tick, before any hop runs — an operator
transaction at tick T is visible to every admission at tick T.

All bookkeeping is in deterministic engine ticks; wall time is recorded
but advisory.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.analysis.invariants import assert_host, sanitize_enabled


@dataclasses.dataclass
class ChainResult:
    """Everything one chain run measured, in ticks."""

    depth: int
    completed: int
    dropped: int
    ticks: int
    wall_s: float
    submit_tick: dict            # req_id → tick entering hop 0
    done_tick: dict              # req_id → tick completing the last hop
    hop_submit: list             # [hop] req_id → tick admitted at hop
    hop_done: list               # [hop] req_id → tick completed at hop
    n_submitted: int = 0

    def samples(self) -> np.ndarray:
        """End-to-end latency samples (ticks) for every completed request."""
        return np.array([self.done_tick[r] - self.submit_tick[r]
                         for r in sorted(self.done_tick)], np.int64)

    def hop_samples(self, k: int) -> np.ndarray:
        """Per-hop admit→done tick samples at hop ``k``."""
        return np.array([self.hop_done[k][r] - self.hop_submit[k][r]
                         for r in sorted(self.hop_done[k])], np.int64)


class ChainRunner:
    """Drive a workload through a chain of service fleets."""

    def __init__(self, hops, workload, *, scenario=None, on_tick=None,
                 max_ticks: int = 4000, drain_ticks: int = 2000):
        self.hops = list(hops)
        self.workload = workload
        self.scenario = scenario
        self.on_tick = on_tick       # called with the tick after hops run
        self.max_ticks = max_ticks
        self.drain_ticks = drain_ticks
        self.position: dict[int, int] = {}   # req_id → current hop

    def run(self) -> ChainResult:
        D = len(self.hops)
        submit_tick: dict[int, int] = {}
        done_tick: dict[int, int] = {}
        hop_submit = [dict() for _ in range(D)]
        hop_done = [dict() for _ in range(D)]
        next_id = 0
        tick = 0
        idle_budget = self.drain_ticks
        t0 = time.perf_counter()
        while tick < self.max_ticks:
            if self.scenario is not None:
                self.scenario.apply(tick)
            wave = self.workload.wave(tick, next_id)
            next_id += len(wave)
            for r in wave:
                submit_tick[r] = tick
                hop_submit[0][r] = tick
                self.position[r] = 0
            if wave:
                self.hops[0].submit(wave)
            any_busy = False
            for k, hop in enumerate(self.hops):
                if not hop.busy:                 # event-driven: idle hops
                    continue                     # launch no program
                any_busy = True
                finished = hop.tick()
                for r in finished:
                    hop_done[k][r] = tick
                if k + 1 < D:
                    for r in finished:
                        hop_submit[k + 1][r] = tick
                        self.position[r] = k + 1
                    if finished:
                        self.hops[k + 1].submit(finished)
                else:
                    for r in finished:
                        done_tick[r] = tick
                        self.position.pop(r, None)
            if self.on_tick is not None:     # daemon seam: health epochs,
                self.on_tick(tick)           # transport pumps, chaos probes
            if sanitize_enabled():
                assert_host("chain", dict(
                    positions=list(self.position.values()), depth=D,
                    positions_ids=list(self.position), done_ids=done_tick))
            tick += 1
            exhausted = (self.workload.n_requests is not None
                         and next_id >= self.workload.n_requests)
            if exhausted and not any_busy \
                    and (self.scenario is None or self.scenario.done()):
                break
            if exhausted and not any_busy:
                idle_budget -= 1                 # scenario tail still pending
                if idle_budget <= 0:
                    break
        dropped = sum(len(h.dropped) for h in self.hops)
        return ChainResult(depth=D, completed=len(done_tick),
                           dropped=dropped, ticks=tick,
                           wall_s=time.perf_counter() - t0,
                           submit_tick=submit_tick, done_tick=done_tick,
                           hop_submit=hop_submit, hop_done=hop_done,
                           n_submitted=next_id)

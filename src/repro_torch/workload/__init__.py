"""Workload subsystem (twin of ``repro/workload``): trace-style request
generation, chained-service traversal, live-ops scenarios, and SLO tail
reporting.

  * ``generators``  — seeded arrival processes (Poisson / bursty ON-OFF /
    diurnal), heavy-tailed service-time samplers (lognormal / Pareto), and
    the ``Workload`` request factory that emits engine-compatible
    ``RequestBatch``es.  Every draw is keyed by ``(seed, tick)`` or
    ``(seed, hop, req_id)``: stateless draws, bit-identical replays.
  * ``chain``       — the chained-service scenario: a completion at service
    k synchronously admits at service k+1, the balancer is traversed once
    per hop, end-to-end latency = sum of per-hop tick latencies.
  * ``hops``        — ``Service`` (one fleet behind any balancer) and the
    chain runs ``run_chain`` / ``run_chain_scenario``.
  * ``scenarios``   — declarative live-ops driver replaying timed
    ControlPlane transactions mid-load (canary, blue-green, rolling
    restart, elastic scale), composable with the fault injector.
  * ``slo``         — p50/p99/p999 tail tables from per-request tick
    samples and the validated scenario and chaos rows.
"""

from repro_torch.workload.chain import ChainResult, ChainRunner
from repro_torch.workload.generators import (BurstyArrivals, DiurnalArrivals,
                                             FixedServiceTimes,
                                             LognormalServiceTimes,
                                             ParetoServiceTimes,
                                             PoissonArrivals,
                                             ServiceTimeShaper, Workload)
from repro_torch.workload.scenarios import Op, ScenarioDriver, rolling_restart
from repro_torch.workload.slo import (chaos_row, percentiles, scenario_row,
                                      validate_chaos_row,
                                      validate_scenario_row)

__all__ = [
    "PoissonArrivals", "BurstyArrivals", "DiurnalArrivals",
    "LognormalServiceTimes", "ParetoServiceTimes", "FixedServiceTimes",
    "ServiceTimeShaper", "Workload", "ChainRunner", "ChainResult",
    "Op", "ScenarioDriver", "rolling_restart", "percentiles",
    "scenario_row", "validate_scenario_row",
    "chaos_row", "validate_chaos_row",
]

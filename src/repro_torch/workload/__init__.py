"""Workload subsystem (twin of ``repro/workload``): trace-style request
generation, live-ops scenarios, and SLO tail reporting.

  * ``generators``  — seeded arrival processes (Poisson / bursty ON-OFF /
    diurnal), heavy-tailed service-time samplers (lognormal / Pareto), and
    the ``Workload`` request factory that emits engine-compatible
    ``RequestBatch``es.  Every draw is keyed by ``(seed, tick)`` or
    ``(seed, hop, req_id)``: stateless draws, bit-identical replays.
  * ``scenarios``   — declarative live-ops driver replaying timed
    ControlPlane transactions mid-load (canary, blue-green, rolling
    restart, elastic scale), composable with the fault injector.
  * ``slo``         — p50/p99/p999 tail tables from per-request tick
    samples and the validated scenario and chaos rows.

The chained-service runner waits for a port of its hop driver.
"""

from repro_torch.workload.generators import (BurstyArrivals, DiurnalArrivals,
                                             FixedServiceTimes,
                                             LognormalServiceTimes,
                                             ParetoServiceTimes,
                                             PoissonArrivals,
                                             ServiceTimeShaper, Workload)
from repro_torch.workload.scenarios import Op, ScenarioDriver, rolling_restart
from repro_torch.workload.slo import (append_scenario_row, chaos_row,
                                      percentiles, scenario_row,
                                      validate_chaos_row,
                                      validate_scenario_row)

__all__ = [
    "PoissonArrivals", "BurstyArrivals", "DiurnalArrivals",
    "LognormalServiceTimes", "ParetoServiceTimes", "FixedServiceTimes",
    "ServiceTimeShaper", "Workload",
    "Op", "ScenarioDriver", "rolling_restart", "percentiles",
    "scenario_row", "append_scenario_row", "validate_scenario_row",
    "chaos_row", "validate_chaos_row",
]

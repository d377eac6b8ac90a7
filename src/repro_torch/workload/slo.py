"""SLO tail reporting (twin of ``repro/workload/slo.py``): percentile
tables from per-request tick samples, and the scenario and chaos rows.

Latency samples are *engine ticks* (admit tick → done tick), the
deterministic clock every scenario runs on: the same seed reproduces the
same row bit for bit, on the CPU and on the card alike.  Wall-clock
numbers never enter a row.

``scenario_row`` and ``chaos_row`` build rows that validate against the
schemas of :mod:`repro_torch.analysis.invariants`; a malformed row fails
the run that produced it.  ``format_slo_table`` prints scenario rows
as a Markdown table.
"""

from __future__ import annotations

import numpy as np

from repro_torch.analysis.invariants import validate_row

PCTS = (50.0, 99.0, 99.9)


def percentiles(samples) -> dict:
    """p50/p99/p999 (+ mean, n) of a latency sample set, NaN when empty."""
    xs = np.asarray(list(samples), np.float64)
    if xs.size == 0:
        return {"n": 0, "mean": float("nan"), "p50": float("nan"),
                "p99": float("nan"), "p999": float("nan")}
    p50, p99, p999 = (float(np.percentile(xs, p)) for p in PCTS)
    return {"n": int(xs.size), "mean": float(xs.mean()),
            "p50": p50, "p99": p99, "p999": p999}


def scenario_row(scenario: str, mode: str, *, depth: int, seed: int,
                 arrivals: str, n_requests: int, completed: int,
                 dropped: int, ticks: int, samples, **extra) -> dict:
    """Build a canonical (deterministic, schema-valid) scenario row from
    raw end-to-end tick samples.  Extra fields must be in the optional
    schema — unknown keys are a validation error, not silent baggage."""
    p = percentiles(samples)
    row = {"bench": "scenario", "scenario": scenario, "mode": mode,
           "depth": int(depth), "seed": int(seed), "arrivals": arrivals,
           "n_requests": int(n_requests), "completed": int(completed),
           "dropped": int(dropped), "ticks": int(ticks),
           "p50_ticks": p["p50"], "p99_ticks": p["p99"],
           "p999_ticks": p["p999"], "mean_ticks": p["mean"]}
    row.update(extra)
    validate_scenario_row(row)
    return row


def validate_scenario_row(row: dict) -> None:
    """Raise ValueError on any schema violation (missing/extra/mistyped
    fields, impossible counts, unordered percentiles)."""
    validate_row(row, "scenario")


def chaos_row(scenario: str, mode: str, *, seed: int, **fields) -> dict:
    """Build a validated ``bench="chaos"`` row (the transport-chaos
    scenario's result)."""
    row = {"bench": "chaos", "scenario": scenario, "mode": mode,
           "seed": int(seed)}
    row.update(fields)
    validate_chaos_row(row)
    return row


def validate_chaos_row(row: dict) -> None:
    """Raise ValueError on any chaos-row schema violation.  A
    non-converged run still validates: the row records the truth."""
    validate_row(row, "chaos")


def format_slo_table(rows: list[dict]) -> str:
    """A Markdown SLO table of scenario rows: one line a row with its
    scenario, mode, depth, arrivals, completed of requested, and p50 / p99
    / p999 in ticks."""
    lines = ["| scenario | mode | depth | arrivals | done/req | "
             "p50 | p99 | p999 (ticks) |",
             "|---|---|---|---|---|---|---|---|"]
    for r in rows:
        lines.append(
            f"| {r['scenario']} | {r['mode']} | {r['depth']} | "
            f"{r['arrivals']} | {r['completed']}/{r['n_requests']} | "
            f"{r['p50_ticks']:.1f} | {r['p99_ticks']:.1f} | "
            f"{r['p999_ticks']:.1f} |")
    return "\n".join(lines)

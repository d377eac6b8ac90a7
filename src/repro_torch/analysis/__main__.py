"""``python -m repro_torch.analysis`` — the port's verification gate (twin
of ``repro/analysis/__main__.py``).

Sections (any finding fails the process with exit code 1):

  1. ``registry``  — every PolicyDef carries its lowering hooks
     (``kernel_offset``, ``staged_offset``, ``host_pick``), a valid
     shard-merge rule, and a unique enum.
  2. ``kernels``   — the eight CUDA kernels at the serving and model
     paths' shapes and edges, bounds-checked on the card
     (``analysis/kernel_sweep.py``); it takes the place of the reference's
     jaxpr sweep.  ``--kernel-build bounds`` (the default) runs the
     kernels' bounds-checking build; ``plain`` the normal build, for a run
     under ``compute-sanitizer``.  With ``--device cpu`` the same inputs go
     through the plain versions at reduced shapes.
  3. ``lint``      — AST lints + import-graph containment over the port.
  4. ``plans``     — one ControlPlane transaction of every named op kind;
     each journaled wire plan must round-trip ``unpack_plan`` with zero
     plan-law violations.
  5. ``lowerings`` — the plain admission and the sidecar ``HostRouter``:
     one batch per registered policy, outputs bounds-checked.

``--fast`` skips the kernel sweep (the slow section, and the only one
that needs the card); ``--report`` additionally prints the import-graph
dead-module report.  ``--device`` (default ``cuda``) is where the kernel
sweep runs; the other sections are host code.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

#: the hooks every PolicyDef must register, and the shard-merge rules the
#: sharded reconciliation can carry
REQUIRED_HOOKS = ("kernel_offset", "staged_offset", "host_pick")
VALID_MERGES = ("cursor", "waterfill", "none")
#: lanes of the per-policy sweep state
SWEEP_I = 18


def _registry_findings():
    from repro_torch.analysis.lint import Finding
    from repro_torch.core import policy_defs

    findings, seen = [], {}
    for p in policy_defs.REGISTRY:
        where = f"registry/{p.name}"
        for hook in REQUIRED_HOOKS:
            if not callable(getattr(p, hook, None)):
                findings.append(Finding(
                    "policy-missing-hook", where,
                    f"policy {p.name!r} lacks a callable {hook!r} — every "
                    "datapath lowering must be registered"))
        merge = getattr(p, "shard_merge", None)
        if merge not in VALID_MERGES:
            findings.append(Finding(
                "policy-bad-merge", where,
                f"shard_merge {merge!r} not one of {VALID_MERGES} — the "
                "sharded reconciliation cannot carry this policy's state"))
        if p.enum in seen:
            findings.append(Finding(
                "policy-dup-enum", where,
                f"enum {p.enum} already registered by {seen[p.enum]!r}"))
        seen.setdefault(p.enum, p.name)
    return findings


def _plan_ops_findings():
    """Exercise every named ControlPlane op; validate every wire plan."""
    from repro_torch.analysis.invariants import check_plan_wire
    from repro_torch.analysis.lint import Finding
    from repro_torch.core import control
    from repro_torch.core.routing_table import POLICY_MAGLEV, POLICY_RR, Rule

    findings = []
    cp = control.ControlPlane()
    cp.add_cluster("gold", endpoints=[0, 1, 2])
    cp.add_cluster("canary", policy=POLICY_MAGLEV, endpoints=[3, 4])
    cp.add_service("checkout", rules=[Rule(0, "fast", "gold"),
                                      Rule(0, None, "canary")])
    cp.add_endpoint("gold", 5)
    cp.set_weight("gold", 5, 2.5)
    cp.set_policy("gold", POLICY_RR)
    cp.upsert_rule("checkout", 1, "beta", "canary")
    cp.drain_endpoint("gold", 5)
    cp.reap()                                    # no consumers: removes it
    cp.remove_endpoint("canary", 4)
    cp.remove_rule("checkout", 1, "beta")
    cp.remove_service("checkout")
    cp.remove_cluster("canary")
    cp.remove_cluster("gold")
    for i, wire in enumerate(cp.journal):
        for err in check_plan_wire(wire):
            findings.append(Finding("plan-law-violation", f"plan[{i}]", err))
        try:
            control.unpack_plan(wire)
        except ValueError as e:
            findings.append(Finding("plan-unpack-rejected", f"plan[{i}]",
                                    str(e)))
    if not cp.journal:
        findings.append(Finding("plan-sweep-empty", "plans",
                                "ControlPlane op sweep produced no plans"))
    return findings


def _sweep_state():
    """One 3-lane cluster per registered policy (rule: feature 0 == enum
    routes to it), so every lowering is live and a newly registered
    policy is swept automatically."""
    from repro_torch.core import policy_defs
    from repro_torch.core.routing_table import (Cluster, Rule, ServiceConfig,
                                                build_state)

    services, clusters = [], []
    for p in policy_defs.REGISTRY:
        eps = [(3 * p.enum + j) % SWEEP_I for j in range(3)]
        clusters.append(Cluster(f"c_{p.name}", endpoints=eps, policy=p.enum))
        services.append(ServiceConfig(
            f"s_{p.name}", rules=[Rule(0, str(p.enum), f"c_{p.name}")]))
    state, _ = build_state(services, clusters, "cpu")
    return state


def _lowering_smoke_findings():
    """Run the plain admission and the sidecar's host lowering once per
    registered policy, on the CPU."""
    from repro_torch.analysis.lint import Finding
    from repro_torch.core import policy_defs
    from repro_torch.core.routing_table import (MAX_EPS_PER_CLUSTER,
                                                N_FEATURES, fnv1a)
    from repro_torch.core.sidecar import HostRouter
    from repro_torch.kernels import route_match

    findings = []
    state = _sweep_state()
    E = state.ep_load.shape[0]
    R = 8 * len(policy_defs.REGISTRY)
    g = torch.Generator().manual_seed(7)
    # feature 0 == the policy enum routes to that policy's cluster
    svc = torch.arange(R, dtype=torch.int32) % len(policy_defs.REGISTRY)
    feats = torch.zeros((R, N_FEATURES), dtype=torch.int32)
    feats[:, 0] = torch.tensor([fnv1a(str(int(s))) for s in svc],
                               dtype=torch.int32)
    rid = torch.arange(R, dtype=torch.int32)
    rnd = torch.randint(0, 1 << 30, (R,), generator=g, dtype=torch.int32)
    gum = -torch.log(-torch.log(torch.rand((R, MAX_EPS_PER_CLUSTER),
                                           generator=g).clamp_min(1e-30)))
    free = torch.ones((SWEEP_I, 4), dtype=torch.int32)
    res = route_match.admit(rid, svc, feats,
                            torch.ones((R,), dtype=torch.int32),
                            state, free, rnd, gum)
    ep = res.endpoint.numpy()
    if ep.min(initial=0) < -1 or ep.max(initial=0) >= E:
        findings.append(Finding(
            "plain-endpoint-oob", "route_match.admit",
            f"plain admission endpoint outside [-1, {E - 1}]: "
            f"[{ep.min()}, {ep.max()}]"))
    if not (res.cluster >= 0).any():
        findings.append(Finding(
            "plain-no-route", "route_match.admit",
            "policy-per-cluster sweep batch routed nothing"))

    hr = HostRouter(state, seed=3)
    routed = 0
    for r in range(R):
        c = hr.match(int(svc[r]), feats[r].numpy())
        if c < 0:
            continue
        e, _ = hr.select(c, feats[r].numpy())
        if e >= 0:
            routed += 1
            if not 0 <= e < E:
                findings.append(Finding(
                    "host-endpoint-oob", "sidecar.HostRouter",
                    f"host lowering picked endpoint {e} outside "
                    f"[0, {E - 1}]"))
            hr.release(e)
    if routed == 0:
        findings.append(Finding(
            "host-no-route", "sidecar.HostRouter",
            "host lowering routed nothing in the per-policy sweep"))
    if np.asarray(hr.t.ep_load).any():
        findings.append(Finding(
            "host-load-leak", "sidecar.HostRouter",
            "ep_load nonzero after releasing every pick "
            "(admits != releases)"))
    return findings


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis")
    ap.add_argument("--fast", action="store_true",
                    help="skip the (slow) kernel sweep")
    ap.add_argument("--report", action="store_true",
                    help="print the import-graph dead-module report")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the kernel sweep runs")
    ap.add_argument("--kernel-build", default="bounds",
                    choices=("bounds", "plain"),
                    help="the kernels' bounds-checking build, or the normal "
                    "build (for a run under compute-sanitizer)")
    args = ap.parse_args(argv)

    from repro_torch.analysis import lint as _lint

    sections: list[tuple[str, list]] = []
    sections.append(("registry", _registry_findings()))
    if not args.fast:
        from repro_torch.analysis import kernel_sweep
        from repro_torch.kernels import _build
        if args.device == "cuda" and args.kernel_build == "bounds":
            _build.use_bounds_check()
        findings, info = kernel_sweep.kernel_findings(args.device)
        print(f"[  kernels] {info['cases']} cases on {args.device} through "
              f"the {info['build']}; launches "
              + " ".join(f"{k}={v}" for k, v in info["launches"].items()))
        sections.append(("kernels", findings))
    report, lint_findings = _lint.lint_all()
    sections.append(("lint", lint_findings))
    sections.append(("plans", _plan_ops_findings()))
    sections.append(("lowerings", _lowering_smoke_findings()))

    total = 0
    for name, findings in sections:
        status = "ok" if not findings else f"{len(findings)} finding(s)"
        print(f"[{name:>9}] {status}")
        for f in findings:
            print(f"    {f}")
        total += len(findings)
    print(f"[   import] {len(report['datapath'])} datapath modules, "
          f"{len(report['dead'])} dead seed modules (report-only)")
    if args.report:
        for mod in report["dead"]:
            print(f"    dead: {mod}")
    if total:
        print(f"FAILED: {total} finding(s)")
        return 1
    print("verified: all sections clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())

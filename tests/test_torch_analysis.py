"""The port's analysis gate (``analysis/lint.py``, ``analysis/__main__.py``,
``analysis/kernel_sweep.py``) against the JAX reference's, on the CPU.

* The AST lints are clean on the port; each fires on a planted snippet
  (the reference's mutation style), and not on its sanctioned form.
* The import report lists the port's dead seed modules, and a planted
  datapath import of one fails the containment check.
* ``registry``, ``plans`` and ``lowerings`` give the same findings (none)
  as the reference's sections; a broken registry is caught.
* ``python -m repro_torch.analysis --fast --device cpu`` exits 0, and the
  kernels section's cases run clean through the plain versions.

Tolerance: exact (finding codes).
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import pytest

from repro.analysis import __main__ as JA
from repro.analysis import lint as JL
from repro.analysis import verifier as JV
from repro_torch.analysis import __main__ as TA
from repro_torch.analysis import kernel_sweep
from repro_torch.analysis import lint as TL
from repro_torch.core import policy_defs

ROOT = Path(__file__).resolve().parents[1]


def _codes(findings):
    return sorted(f.code for f in findings)


def test_port_lints_clean():
    assert TL.lint_sources() == []
    report, findings = TL.lint_all()
    assert findings == []
    assert len(report["datapath"]) > 30


def test_reference_and_port_lint_alike_on_their_trees():
    """Both trees lint clean: the port adds no finding the reference's own
    tree does not have."""
    assert _codes(JL.lint_sources()) == _codes(TL.lint_sources()) == []


# (module, planted source, finding code or None)
PLANTS = {
    "np_random": ("repro_torch.core.x", "import numpy as np\n"
                  "x = np.random.rand(3)\n", "nondet-in-datapath"),
    "np_seeded": ("repro_torch.core.x", "import numpy as np\n"
                  "r = np.random.RandomState(0)\n", None),
    "wall_clock": ("repro_torch.kernels.x", "import time\n"
                   "t = time.perf_counter()\n", "nondet-in-datapath"),
    "clock_exempt": ("repro_torch.kernels._build", "import time\n"
                     "t = time.perf_counter()\n", None),
    "clock_outside_datapath": ("repro_torch.runtime.x", "import time\n"
                               "t = time.time()\n", None),
    "stdlib_random": ("repro_torch.core.x", "import random\n"
                      "x = random.random()\n", "nondet-in-datapath"),
    "torch_rand": ("repro_torch.core.x", "import torch\n"
                   "x = torch.rand(3)\n", "nondet-in-datapath"),
    "torch_randint": ("repro_torch.kernels.x", "import torch\n"
                      "x = torch.randint(0, 9, (3,))\n",
                      "nondet-in-datapath"),
    "torch_multinomial": ("repro_torch.core.x", "import torch\n"
                          "x = torch.multinomial(p, 2)\n",
                          "nondet-in-datapath"),
    "torch_seeded": ("repro_torch.core.x", "import torch\n"
                     "x = torch.randn(3, generator=g)\n", None),
    "enum_literal": ("repro_torch.core.x", "if policy == 3:\n    pass\n",
                     "enum-literal-bypass"),
    "enum_attr_literal": ("repro_torch.kernels.x",
                          "ok = state.cluster_policy != 2\n",
                          "enum-literal-bypass"),
    "enum_ordering": ("repro_torch.core.x", "ok = policy < 6\n", None),
    "enum_in_policy_defs": ("repro_torch.core.policy_defs",
                            "ok = policy == 3\n", None),
    "policy_two_hooks": ("repro_torch.launch.x",
                         "p = PolicyDef('x', 9, 'none', f, g)\n",
                         "policy-missing-hook"),
    "policy_three_hooks": ("repro_torch.launch.x",
                           "p = PolicyDef('x', 9, 'none', f, g, h)\n", None),
    "policy_keywords": ("repro_torch.core.x",
                        "p = PolicyDef('x', 9, 'none', kernel_offset=f, "
                        "staged_offset=g)\n", "policy-missing-hook"),
    "policy_splat": ("repro_torch.core.x", "p = PolicyDef(**kw)\n", None),
}


@pytest.mark.parametrize("name", list(PLANTS))
def test_lint_fires_on_planted_snippets(name):
    mod, src, code = PLANTS[name]
    got = TL.lint_module(mod, src)
    assert _codes(got) == ([code] if code else [])
    if code:
        assert got[0].where == f"{mod}:2" or got[0].where == f"{mod}:1"


def test_import_report_lists_the_dead_seed_modules():
    report, findings = TL.import_report()
    assert report["dead"] == list(TL.KNOWN_DEAD) \
        == ["repro_torch.launch.prefill_decode"]
    assert findings == []
    mods = report["modules"]
    assert mods["repro_torch.core.interpose"]["status"] == "datapath"
    assert mods["repro_torch.models.model"]["status"] == "legacy-imported"
    assert mods["repro_torch.convert"]["status"] == "other"
    assert "repro_torch.workload.hops" in report["datapath"]


def test_datapath_import_of_a_dead_module_fails_containment():
    report, findings = TL.import_report(extra={
        "repro_torch.core.planted":
            "from repro_torch.launch import prefill_decode\n"})
    assert _codes(findings) == ["datapath-imports-dead"]
    assert findings[0].where == "repro_torch.core.planted"
    assert "prefill_decode" in findings[0].detail
    # an import from outside the datapath is report-only
    _, findings = TL.import_report(extra={
        "repro_torch.tools_planted":
            "from repro_torch.launch import prefill_decode\n"})
    assert findings == []


def test_sections_match_the_reference():
    """registry, plans and lowerings: the same findings (none) on both."""
    assert _codes(TA._registry_findings()) == _codes(JV.check_registry()) \
        == []
    assert _codes(TA._plan_ops_findings()) == _codes(JA._plan_ops_findings()) \
        == []
    assert _codes(TA._lowering_smoke_findings()) \
        == _codes(JA._lowering_smoke_findings()) == []


@pytest.mark.parametrize("broken", ["hook", "merge", "dup_enum"])
def test_registry_section_catches_a_broken_policy(broken, monkeypatch):
    p = policy_defs.REGISTRY[0]
    bad = {"hook": dataclasses.replace(p, host_pick=None),
           "merge": dataclasses.replace(p, shard_merge="sum"),
           "dup_enum": dataclasses.replace(p, name="rr2")}[broken]
    monkeypatch.setattr(policy_defs, "REGISTRY",
                        policy_defs.REGISTRY + (bad,))
    code = {"hook": "policy-missing-hook", "merge": "policy-bad-merge",
            "dup_enum": "policy-dup-enum"}[broken]
    assert code in _codes(TA._registry_findings())


def test_plans_section_catches_a_rejected_plan(monkeypatch):
    from repro_torch.core import control

    def reject(wire):
        raise ValueError("planted")
    monkeypatch.setattr(control, "unpack_plan", reject)
    got = TA._plan_ops_findings()
    assert got and set(_codes(got)) == {"plan-unpack-rejected"}


def test_kernel_section_rehearses_clean_on_the_cpu():
    findings, info = kernel_sweep.kernel_findings("cpu")
    assert findings == []
    assert info["cases"] >= 20 and info["build"] == "plain versions (CPU)"
    assert sum(info["launches"].values()) == 0      # no kernel on the CPU


def test_gate_fast_exits_zero_on_the_cpu(capsys):
    assert TA.main(["--fast", "--device", "cpu", "--report"]) == 0
    out = capsys.readouterr().out
    for section in ("registry", "lint", "plans", "lowerings"):
        assert f"{section:>9}] ok" in out
    assert "dead: repro_torch.launch.prefill_decode" in out
    assert "verified: all sections clean" in out


def test_gate_runs_as_a_module():
    p = subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                        "--fast", "--device", "cpu"], cwd=ROOT,
                       capture_output=True, text=True, timeout=120,
                       env={"PYTHONPATH": str(ROOT / "src"),
                            "PATH": "/usr/bin:/bin"})
    assert p.returncode == 0, p.stdout + p.stderr
    assert "verified: all sections clean" in p.stdout

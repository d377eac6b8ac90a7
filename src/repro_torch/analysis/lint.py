"""Repo-wide AST lints over the port (twin of ``repro/analysis/lint.py``).

This pass reads the *source*: hazards of a datapath module (wall-clock or
unseeded randomness, a policy enum compared as a bare integer literal, a
``PolicyDef`` registered without all its lowering hooks) and the
repo-structure question no run can answer: which seed modules are dead
weight and whether the datapath has started importing them.

Scopes
------
* **datapath** (``DATAPATH``): ``repro_torch.kernels`` +
  ``repro_torch.core``, the code every serving tick runs.  The
  nondeterminism and enum-literal lints run here.  ``kernels/_build.py``
  is exempt from the wall-clock lint: it times the kernel build, which is
  measurement, not datapath.
* **import graph**: every module under ``src/repro_torch``.  The model
  side (``models``, ``configs``, the model launcher and the training legs
  once they are ported) is *expected* to be unreachable from the serving
  datapath; the report marks such modules dead rather than deleting them,
  and the gate fails only if a datapath module *newly imports* one
  (``datapath-imports-dead``).

Nondeterminism in PyTorch's idiom: besides the reference's module-level
``np.random.*`` draws, ``time.*`` and stdlib ``random.*``, a
``torch.rand`` / ``randn`` / ``randint`` / ``randperm`` / ``multinomial``
/ ``bernoulli`` / ``normal`` call without ``generator=`` draws from
torch's hidden global generator.

The reference's ``scatter-missing-mode`` lint has no source-level
counterpart here: torch indexing has no out-of-bounds ``mode`` to spell
(it raises on the CPU and device-asserts on the card), and the CUDA
kernels index raw memory the AST cannot see.  Their bounds are checked on
the card instead, by ``python -m repro_torch.analysis``'s ``kernels``
section (``compute-sanitizer`` where it runs, else the kernels' bounds-
checking build, ``csrc/bounds.cuh``).
"""

from __future__ import annotations

import ast
import dataclasses
import os

SRC_ROOT = os.path.join(os.path.dirname(__file__), "..", "..")
PACKAGE = "repro_torch"

#: the per-tick datapath: the strictest lints
DATAPATH = ("repro_torch.kernels", "repro_torch.core")

#: the serving datapath the import-graph reachability starts from
DATAPATH_ROOTS = (
    "repro_torch.kernels", "repro_torch.core", "repro_torch.runtime",
    "repro_torch.workload", "repro_torch.launch.serve",
    "repro_torch.launch.mesh", "repro_torch.analysis",
    "repro_torch.device",
)

#: seed (model-side) packages and modules that MAY be dead: reported,
#: never deleted; a datapath import of a dead one is the failing event
SEED_LEGACY = (
    "repro_torch.models", "repro_torch.optim", "repro_torch.data",
    "repro_torch.sharding", "repro_torch.configs", "repro_torch.roofline",
    "repro_torch.launch.train", "repro_torch.launch.dryrun",
    "repro_torch.launch.prefill_decode", "repro_torch.runtime.train_loop",
    "repro_torch.runtime.checkpoint",
)

#: the seed modules the report marks dead (nothing of the serving
#: datapath imports them); a datapath import of one is the failing event
KNOWN_DEAD = ("repro_torch.launch.prefill_decode",)

#: wall-clock exemptions inside the datapath (measurement code):
#: ``kernels/_build.py`` times the nvcc run it starts
CLOCK_EXEMPT = ("repro_torch.kernels._build",)

#: seeded constructors: a deterministic host PRNG is fine, module-level
#: draws are not
SEEDED_RNG_CTORS = {"RandomState", "default_rng", "Generator",
                    "SeedSequence"}

#: torch samplers that draw from the global generator unless given one
TORCH_SAMPLERS = {"rand", "randn", "randint", "randperm", "multinomial",
                  "bernoulli", "normal"}

#: names whose comparison against a bare int literal bypasses policy_defs
ENUM_NAMES = {"policy", "cluster_policy", "enum"}

#: ``PolicyDef``'s fields: the metadata, then the lowering hooks (the
#: port's three: the plain tile path, the staged chain, the sidecar; the
#: reference's fourth, the numpy oracle, stays with the reference)
POLICY_META = ("name", "enum", "shard_merge")
POLICY_HOOKS = ("kernel_offset", "staged_offset", "host_pick")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One diagnostic.  ``code`` is the stable machine-matchable name (what
    the mutation tests assert on); ``where`` locates it (module:line)."""

    code: str
    where: str
    detail: str

    def __str__(self):
        return f"[{self.code}] {self.where}: {self.detail}"


def _module_name(path: str) -> str:
    rel = os.path.relpath(path, SRC_ROOT).replace(os.sep, "/")
    mod = rel[:-3].replace("/", ".")
    return mod[:-9] if mod.endswith(".__init__") else mod


def _iter_modules():
    root = os.path.join(SRC_ROOT, PACKAGE)
    for dirpath, _dirs, files in sorted(os.walk(root)):
        for f in sorted(files):
            if f.endswith(".py"):
                path = os.path.join(dirpath, f)
                yield _module_name(path), path


def _in(mod: str, prefixes) -> bool:
    return any(mod == p or mod.startswith(p + ".") for p in prefixes)


class _ModuleLinter(ast.NodeVisitor):
    def __init__(self, mod: str, findings: list):
        self.mod = mod
        self.findings = findings
        self.datapath = _in(mod, DATAPATH)

    def flag(self, code, node, detail):
        self.findings.append(Finding(
            code, f"{self.mod}:{getattr(node, 'lineno', '?')}", detail))

    # ---- nondeterminism -------------------------------------------------- #

    def _check_nondet(self, call: ast.Call):
        f = call.func
        if not isinstance(f, ast.Attribute):
            return
        base = f.value
        if isinstance(base, ast.Attribute) and isinstance(base.value,
                                                          ast.Name):
            root, mid = base.value.id, base.attr
            if root in ("np", "numpy") and mid == "random" \
                    and f.attr not in SEEDED_RNG_CTORS:
                self.flag("nondet-in-datapath", call,
                          f"module-level np.random.{f.attr}() draws from "
                          "hidden global state — pass a seeded Generator/"
                          "RandomState in")
        elif isinstance(base, ast.Name):
            if base.id == "time" and self.mod not in CLOCK_EXEMPT:
                self.flag("nondet-in-datapath", call,
                          f"wall-clock time.{f.attr}() inside a datapath "
                          "module — clocks belong to the serving loop and "
                          "the measurement code, not the step")
            if base.id == "random" and f.attr not in ("Random",
                                                      "SystemRandom"):
                self.flag("nondet-in-datapath", call,
                          f"stdlib random.{f.attr}() draws from hidden "
                          "global state — use a seeded instance")
            if base.id == "torch" and f.attr in TORCH_SAMPLERS \
                    and not any(k.arg == "generator" for k in call.keywords):
                self.flag("nondet-in-datapath", call,
                          f"torch.{f.attr}() without generator= draws from "
                          "torch's global generator — pass a seeded "
                          "torch.Generator")

    # ---- enum literals --------------------------------------------------- #

    def _check_enum_literal(self, node: ast.Compare):
        sides = [node.left] + list(node.comparators)
        names = [s for s in sides
                 if (isinstance(s, ast.Name) and s.id in ENUM_NAMES)
                 or (isinstance(s, ast.Attribute) and s.attr in ENUM_NAMES)]
        lits = [s for s in sides if isinstance(s, ast.Constant)
                and isinstance(s.value, int)
                and not isinstance(s.value, bool)]
        if names and lits and not any(
                isinstance(op, (ast.Lt, ast.LtE, ast.Gt, ast.GtE))
                for op in node.ops):
            self.flag("enum-literal-bypass", node,
                      "policy enum compared against a bare integer "
                      "literal — route through policy_defs (POLICY_* / "
                      "PolicyDef.enum) so renumbering cannot silently "
                      "reroute traffic")

    # ---- PolicyDef registration ------------------------------------------ #

    def _check_policy_def(self, call: ast.Call):
        f = call.func
        name = f.id if isinstance(f, ast.Name) else \
            f.attr if isinstance(f, ast.Attribute) else None
        if name != "PolicyDef":
            return
        kw = {k.arg for k in call.keywords}
        # dataclass field order: the metadata fields, then the hooks
        covered = max(len(call.args) - len(POLICY_META), 0) \
            + len(kw & set(POLICY_HOOKS))
        if covered < len(POLICY_HOOKS) and not any(k.arg is None
                                                   for k in call.keywords):
            self.flag("policy-missing-hook", call,
                      f"PolicyDef registration covers only {covered}/"
                      f"{len(POLICY_HOOKS)} lowering hooks "
                      f"({', '.join(POLICY_HOOKS)})")

    def visit_Call(self, node: ast.Call):
        if self.datapath:
            self._check_nondet(node)
        self._check_policy_def(node)
        self.generic_visit(node)

    def visit_Compare(self, node: ast.Compare):
        if self.datapath and self.mod != "repro_torch.core.policy_defs":
            self._check_enum_literal(node)
        self.generic_visit(node)


def lint_module(mod: str, source: str) -> list[Finding]:
    """The AST lints over one module's source, as if it were ``mod``."""
    findings: list[Finding] = []
    _ModuleLinter(mod, findings).visit(ast.parse(source, filename=mod))
    return findings


def lint_sources() -> list[Finding]:
    """Run every AST lint over ``src/repro_torch``."""
    findings: list[Finding] = []
    for mod, path in _iter_modules():
        with open(path, encoding="utf-8") as fh:
            findings += lint_module(mod, fh.read())
    return findings


# --------------------------------------------------------------------------- #
# Import graph: dead seed modules + datapath containment
# --------------------------------------------------------------------------- #


def _imports_of(source: str, mod: str) -> set[str]:
    tree = ast.parse(source, filename=mod)
    pkg = mod.rsplit(".", 1)[0] if "." in mod else mod
    out: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:                      # relative import
                parts = pkg.split(".")
                parts = parts[:len(parts) - (node.level - 1)]
                base = ".".join(parts + ([base] if base else []))
            out.add(base)
            out.update(f"{base}.{a.name}" for a in node.names)
    return {m for m in out if _in(m, (PACKAGE,))}


def import_graph(extra: dict[str, str] | None = None) -> dict[str, set[str]]:
    """``module -> set(imported repro_torch modules)`` over
    ``src/repro_torch``; ``extra`` maps module names to sources that
    replace or add to the tree's (the mutation tests plant imports so)."""
    sources = {}
    for mod, path in _iter_modules():
        with open(path, encoding="utf-8") as fh:
            sources[mod] = fh.read()
    sources.update(extra or {})
    graph = {}
    for mod, src in sources.items():
        deps = set()
        for imp in _imports_of(src, mod):
            # resolve "from pkg import name" where name is an attr
            while imp and imp not in sources:
                imp = imp.rsplit(".", 1)[0] if "." in imp else ""
            if imp and imp != mod:
                deps.add(imp)
        graph[mod] = deps
    return graph


def _reachable(graph, roots):
    seen, stack = set(), [r for r in graph if _in(r, roots)]
    while stack:
        m = stack.pop()
        if m in seen:
            continue
        seen.add(m)
        stack.extend(graph.get(m, ()))
    return seen


def import_report(extra: dict[str, str] | None = None
                  ) -> tuple[dict, list[Finding]]:
    """The dead-module report and its failing subset.

    Returns ``(report, findings)``: the report maps every module to its
    status (``datapath`` / ``dead-seed`` / ``legacy-imported`` /
    ``other``); findings carry only ``datapath-imports-dead``, an import
    edge from live datapath code into a module that is dead, or was when
    this gate was written (``KNOWN_DEAD``: an import makes a module live,
    so the edge that revives one is found against that list).  Dead
    modules themselves are informational.  ``extra``: see
    ``import_graph``."""
    graph = import_graph(extra)
    live = _reachable(graph, DATAPATH_ROOTS)
    report, findings = {"modules": {}, "dead": [], "datapath": []}, []
    for mod in sorted(graph):
        legacy = _in(mod, SEED_LEGACY)
        if mod in live and not legacy:
            status = "datapath"
            report["datapath"].append(mod)
        elif legacy:
            status = "dead-seed" if mod not in live else "legacy-imported"
            if mod not in live:
                report["dead"].append(mod)
        else:
            status = "other"
        report["modules"][mod] = {
            "status": status, "imports": sorted(graph[mod])}
    dead = set(report["dead"]) | set(KNOWN_DEAD)
    for mod in sorted(live):
        if _in(mod, SEED_LEGACY):
            continue
        for h in sorted(graph.get(mod, set()) & dead):
            findings.append(Finding(
                "datapath-imports-dead", mod,
                f"datapath module imports dead seed module {h!r} — either "
                "revive it intentionally (move it out of the legacy list) "
                "or drop the import"))
    return report, findings


def lint_all() -> tuple[dict, list[Finding]]:
    """AST lints + import containment.  Returns (report, findings)."""
    report, graph_findings = import_report()
    return report, lint_sources() + graph_findings

"""Dry run on the meta device (twin of ``repro/launch/dryrun.py``).

For every (architecture × input shape) cell, on the single-pod (16, 16)
mesh and the 2-pod (2, 16, 16) mesh:

    state, inputs = abstract_state(...), input_specs(...)   # meta tensors
    step          = build_train_step / build_prefill_step / build_decode_step
    traced        = the port's step run once on the meta device:
                    FLOPs (``roofline.analysis.trace_step_flops``) and the
                    bytes it keeps beside its arguments
    report        = ``roofline.analysis.analyze_traced(cfg, shape, ms, ...)``

The meta device carries shapes and dtypes and no data, so nothing is
allocated and nothing is launched: the kernel wrappers take their plain
versions there, which compute only the output shapes.  The dry run never
touches CUDA; it is meta by nature, as the reference's placeholder
devices are, and takes no ``--device``.

Per device, on the cell's ``MeshSpec`` (``sharding/specs.py``):

* argument bytes: every parameter, AdamW moment, cache and input leaf at
  the per-device shape its spec gives (``MeshSpec.local_shape``);
* temp bytes: for a training cell, the tensors saved for the backward
  (``torch.autograd.graph.saved_tensors_hooks``, each storage once,
  arguments excluded, the backward's own recompute excluded); for
  prefill and decode, the peak of the intermediate storages alive at
  once, each kernel wrapper counted by its output only (a kernel keeps
  its tiles on chip; its plain version would materialise what the kernel
  does not).  Divided evenly over the chips, the reference's analytic
  rule for activations (``roofline/analysis.py::analytic_memory_bytes``);
* output bytes: the step's outputs that are not its arguments (the port
  updates parameters, moments and caches in place), over the chips;
* ``fits_hbm``: their sum against the card's memory.

The port's step is one program on one device whatever the mesh: the
trace does not depend on the mesh, so a sweep traces a cell once and
reports it on each mesh.  Reports go to ``build/dryrun/`` as JSON, and
the sweep is resumable: ``python -m repro_torch.launch.dryrun --arch X
--shape Y [--multi-pod]`` runs one cell, ``--all`` sweeps everything.

Not ported yet (ROADMAP.md item 14): the ``exp_fsdp`` variant and the
expert-parallel relay (``ep_relay`` is false in every report), and the
collectives' term (``collective_s`` is null).
"""

from __future__ import annotations

import argparse
import json
import time
import traceback
import weakref
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import (ASSIGNED_ARCHS, SHAPES, get_config,
                                 shape_applicable)
from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.roofline import analysis as RA
from repro_torch.runtime import train_loop
from repro_torch.sharding.specs import MeshSpec
from repro_torch.tree import items, leaves, map_tree

OUT_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"
META = torch.device("meta")
VARIANTS = ("", "serve_tp", "mb4")


def sds(shape, dtype) -> torch.Tensor:
    """A meta tensor: the ``ShapeDtypeStruct`` stand-in."""
    return torch.empty(tuple(shape), dtype=dtype, device=META)


# --------------------------------------------------------------------------- #
# Input specs (meta tensors; zero allocation)
# --------------------------------------------------------------------------- #


def input_specs(cfg, shape) -> dict:
    """Abstract inputs for the step function of a given shape kind."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        batch = {"tokens": sds((B, S), torch.int32),
                 "labels": sds((B, S), torch.int32)}
        if cfg.is_encdec:
            batch["enc_frames"] = sds((B, cfg.enc_frames, cfg.d_model),
                                      torch.float32)
        return {"batch": batch}
    if shape.kind == "prefill":
        out = {"tokens": sds((B, S), torch.int32)}
        if cfg.is_encdec:
            out["enc_frames"] = sds((B, cfg.enc_frames, cfg.d_model),
                                    torch.float32)
        return out
    # decode: one new token against a seq_len cache
    return {"token": sds((B, 1), torch.int32),
            "lengths": sds((B,), torch.int32)}


def abstract_state(cfg, shape, moment_dtype=torch.float32) -> dict:
    """Abstract params / optimizer / cache trees, built on the meta device
    by the port's own ``init_params`` / ``init_cache``."""
    params = M.init_params(cfg, torch.Generator(), None, META)
    out = {"params": params}
    if shape.kind == "train":
        out["opt"] = _init_opt(moment_dtype, params)
        out["bias"] = sds((max(cfg.moe.n_experts, 1),), torch.float32)
    else:
        out["cache"] = M.init_cache(cfg, shape.global_batch, shape.seq_len,
                                    device=META)
    return out


def _init_opt(moment_dtype, params) -> adamw.AdamWState:
    z = lambda p: sds(p.shape, moment_dtype)
    return adamw.AdamWState(step=sds((), torch.int32),
                            m=map_tree(z, params), v=map_tree(z, params))


# --------------------------------------------------------------------------- #
# Step builders
# --------------------------------------------------------------------------- #


def _check_variant(variant: str) -> None:
    if variant == "exp_fsdp":
        raise NotImplementedError(
            "the exp_fsdp variant places parameters on several devices: "
            "not ported yet (ROADMAP.md item 14)")
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; the port runs "
                         f"{VARIANTS}")


def build_train_step(cfg, ms, shape, moment_dtype, variant=""):
    """The port's train step (``runtime/train_loop.make_train_step``) with
    the reference's schedule (warmup 100 of 10 000 steps) and AdamW
    defaults; ``mb4`` accumulates over 4 microbatches."""
    _check_variant(variant)
    tcfg = train_loop.TrainConfig(
        steps=10_000, warmup=100, opt=adamw.AdamWConfig(),
        microbatch=4 if variant.startswith("mb") else 0)
    return train_loop.make_train_step(cfg, tcfg)


def build_prefill_step(cfg, ms, shape):
    @torch.no_grad()
    def serve_prefill(params, cache, tokens, enc_frames=None):
        return M.prefill(cfg, params, tokens, cache, enc_frames=enc_frames)

    return serve_prefill


def build_decode_step(cfg, ms, shape):
    @torch.no_grad()
    def serve_step(params, cache, token, lengths):
        return M.decode_step(cfg, params, token, lengths, cache)

    return serve_step


# --------------------------------------------------------------------------- #
# What a step keeps beside its arguments
# --------------------------------------------------------------------------- #


def _tensors(tree) -> list:
    return [t for t in leaves(tree) if isinstance(t, torch.Tensor)]


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class _StepMemory(TorchDispatchMode):
    """Counts, over one step on meta tensors, the bytes of the storages it
    makes (each once, the arguments' excluded): ``saved``, the most that
    autograd holds for a backward at once (saved during a forward; with
    microbatches, one microbatch's); ``peak``, the most alive at once,
    where a kernel wrapper's plain version (``opaque``) counts by its
    output only."""

    def __init__(self, args):
        super().__init__()
        self.args = frozenset(_key(t) for t in _tensors(args))
        self.known = set(self.args)
        self.saved_keys: set = set()
        self.saved = self.saved_live = self.live = self.peak = 0
        self._depth = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not self._depth:
            for t in _tensors(out):
                self._made(t)
        return out

    def _made(self, t: torch.Tensor) -> None:
        key = _key(t)
        if key in self.known:
            return
        n = t.untyped_storage().nbytes()
        self.known.add(key)
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(t.untyped_storage(), self._freed, key, n)

    def _freed(self, key: int, n: int) -> None:
        self.known.discard(key)
        if key in self.saved_keys:
            self.saved_keys.discard(key)
            self.saved_live -= n
        self.live -= n

    def pack(self, t: torch.Tensor) -> torch.Tensor:
        """The saved-tensor hook: forward saves only (a backward's
        recompute saves and frees its own within one node)."""
        key = _key(t)
        if torch._C._current_graph_task_id() == -1 and key in self.known \
                and key not in self.saved_keys and key not in self.args:
            self.saved_keys.add(key)
            self.saved_live += t.untyped_storage().nbytes()
            self.saved = max(self.saved, self.saved_live)
        return t

    def opaque(self, fn):
        def call(*a, **k):
            self._depth += 1
            try:
                out = fn(*a, **k)
            finally:
                self._depth -= 1
            for t in _tensors(out):
                self._made(t)
            return out
        return call


def trace_step(step, args) -> dict:
    """Run ``step(*args)`` once on meta tensors: its FLOPs and the bytes it
    keeps beside its arguments (whole step, all chips).  Returns
    ``flops``, ``saved_bytes``, ``peak_bytes``, ``output_bytes`` and
    ``trace_s``."""
    mem = _StepMemory(args)
    outs = []

    def run(*a):
        outs.append(step(*a))

    # the plain versions ``kernels/ops.py`` calls on a non-CUDA tensor,
    # each counted by its output only while the step runs
    plain = [(m, getattr(m, name)) for m, name in
             ((_fa, "flash_attention"), (_da, "decode_attention"),
              (_ssd, "ssd_scan"))]
    t0 = time.perf_counter()
    try:
        for m, fn in plain:
            setattr(m, fn.__name__, mem.opaque(fn))
        with mem, torch.autograd.graph.saved_tensors_hooks(mem.pack,
                                                           lambda t: t):
            flops = RA.trace_step_flops(run, *args)
    finally:
        for m, fn in plain:
            setattr(m, fn.__name__, fn)
    trace_s = time.perf_counter() - t0
    out_bytes = sum(t.untyped_storage().nbytes()
                    for t in {_key(t): t for t in _tensors(outs)
                              if _key(t) not in mem.args}.values())
    return {"flops": flops, "saved_bytes": mem.saved,
            "peak_bytes": mem.peak, "output_bytes": out_bytes,
            "trace_s": trace_s}


# --------------------------------------------------------------------------- #
# One cell
# --------------------------------------------------------------------------- #


def _local_bytes(ms: MeshSpec, pairs) -> int:
    """Per-device bytes of (tensor, spec) pairs."""
    total = 0
    for t, spec in pairs:
        n = 1
        for d in ms.local_shape(t.shape, spec):
            n *= d
        total += n * t.element_size()
    return total


def _pairs(tree, specs) -> list:
    """(leaf, spec) for a tree and its spec tree of the same structure."""
    out = []
    map_tree(lambda t, s: out.append((t, s)), tree, specs)
    return out


def _argument_bytes(cfg, shape, ms: MeshSpec, state, inputs) -> int:
    p_specs = ms.param_specs(state["params"])
    pairs = _pairs(state["params"], p_specs)
    if shape.kind == "train":
        opt = state["opt"]
        pairs += _pairs(opt.m, p_specs) + _pairs(opt.v, p_specs)
        pairs += [(opt.step, ()), (state["bias"], ())]
        batch = inputs["batch"]
    else:
        pairs += _pairs(state["cache"], ms.cache_pspecs(cfg, state["cache"]))
        batch = inputs
    pairs += [(t, ms.batch_spec(name, t.shape)) for name, t in items(batch)]
    return _local_bytes(ms, pairs)


def _moment_dtype(cfg, multi_pod: bool, moment_dtype_str: str = "auto"):
    """bf16 moments for the ≥200 B-parameter archs on one pod, f32
    otherwise (the reference's "auto" rule)."""
    if moment_dtype_str == "auto":
        big = cfg.param_count() > 2e11 and not multi_pod
        return torch.bfloat16 if big else torch.float32
    return getattr(torch, moment_dtype_str)


def _step_and_args(cfg, shape, ms, state, inputs, moment_dtype, variant):
    if shape.kind == "train":
        fn = build_train_step(cfg, ms, shape, moment_dtype, variant)
        return fn, (state["params"], state["opt"], state["bias"],
                    inputs["batch"])
    _check_variant(variant)
    if shape.kind == "prefill":
        fn = build_prefill_step(cfg, ms, shape)
        args = (state["params"], state["cache"], inputs["tokens"])
        if cfg.is_encdec:
            args += (inputs["enc_frames"],)
        return fn, args
    fn = build_decode_step(cfg, ms, shape)
    return fn, (state["params"], state["cache"], inputs["token"],
                inputs["lengths"])


def trace_cell_for(cfg, shape, ms: MeshSpec, *, moment_dtype=None,
                   variant: str = "", traces: dict | None = None) -> dict:
    """Trace one cell of ``cfg`` × ``shape`` on the mesh of ``ms`` and
    return its report (``roofline.analysis.analyze_traced`` plus the
    trace's own keys).  ``moment_dtype`` None: the "auto" rule (a mesh
    with a ``pod`` axis is multi-pod).  ``traces``: a dict the caller
    keeps to reuse a trace across meshes (the step does not depend on
    the mesh)."""
    multi_pod = "pod" in ms.mesh.axis_names
    if moment_dtype is None:
        moment_dtype = _moment_dtype(cfg, multi_pod)
    state = abstract_state(cfg, shape, moment_dtype)
    inputs = input_specs(cfg, shape)
    key = (cfg, shape.name, variant, moment_dtype)
    traced = None if traces is None else traces.get(key)
    if traced is None:
        fn, args = _step_and_args(cfg, shape, ms, state, inputs,
                                  moment_dtype, variant)
        traced = trace_step(fn, args)
        if traces is not None:
            traces[key] = traced
    n_chips = ms.mesh.size
    train = shape.kind == "train"
    report = RA.analyze_traced(cfg, shape, ms, {
        "flops": traced["flops"],
        "argument_bytes": _argument_bytes(cfg, shape, ms, state, inputs),
        "output_bytes": traced["output_bytes"] / n_chips,
        "temp_bytes": (traced["saved_bytes"] if train
                       else traced["peak_bytes"]) / n_chips,
        "temp_rule": ("saved for backward / chips" if train else
                      "peak of live intermediates / chips"),
    })
    report.update({
        "trace_s": round(traced["trace_s"], 2),
        "moment_dtype": str(moment_dtype).removeprefix("torch.")
        if train else None,
        "ep_relay": False,
    })
    return report


def trace_cell(arch: str, shape_name: str, multi_pod: bool,
               moment_dtype_str: str = "auto", variant: str = "",
               traces: dict | None = None) -> dict:
    """One (arch × shape × mesh) cell on the production mesh.

    ``variant``: "serve_tp" = pure-TP serving params (replicated over dp;
    each dp slice is an XLB instance lane), "mb4" = 4 microbatches;
    "exp_fsdp" raises ``NotImplementedError`` (ROADMAP.md item 14)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        return {"skipped": reason}
    ms = MeshSpec(make_production_mesh(multi_pod=multi_pod),
                  params_tp_only=(variant == "serve_tp"))
    report = trace_cell_for(
        cfg, shape, ms, variant=variant, traces=traces,
        moment_dtype=_moment_dtype(cfg, multi_pod, moment_dtype_str))
    report.update({"arch": arch, "shape": shape_name,
                   "mesh": "2x16x16" if multi_pod else "16x16",
                   "variant": variant or "baseline"})
    return report


# --------------------------------------------------------------------------- #
# Sweep driver (JSON-cached, resumable)
# --------------------------------------------------------------------------- #


def cell_path(arch, shape_name, multi_pod, variant="") -> Path:
    mesh = "2x16x16" if multi_pod else "16x16"
    suffix = f"__{variant}" if variant else ""
    return OUT_DIR / f"{arch}__{shape_name}__{mesh}{suffix}.json"


def run_cell(arch, shape_name, multi_pod, force=False, variant="",
             traces: dict | None = None) -> dict:
    path = cell_path(arch, shape_name, multi_pod, variant)
    if path.exists() and not force:
        return json.loads(path.read_text())
    mesh = "2x16x16" if multi_pod else "16x16"
    print(f"=== dry-run {arch} × {shape_name} × {mesh} {variant} ===",
          flush=True)
    try:
        report = trace_cell(arch, shape_name, multi_pod, variant=variant,
                            traces=traces)
        if "skipped" in report:
            print(f"skipped: {report['skipped']}")
        else:
            m, r = report["memory_analysis"], report["roofline"]
            print(f"{m['total_GiB']} GiB a device (fits_hbm="
                  f"{m['fits_hbm']}); {r['dominant']}-bound, "
                  f"{r['step_lower_bound_s']:.4g} s a step (prediction "
                  f"from the H100's data-sheet peaks); traced in "
                  f"{report['trace_s']} s", flush=True)
    except Exception as e:      # recorded in the cell's report
        report = {"arch": arch, "shape": shape_name, "mesh": mesh,
                  "error": f"{type(e).__name__}: {e}",
                  "trace": traceback.format_exc()[-2000:]}
        print(f"FAILED: {report['error']}", flush=True)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(report, indent=1))
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--variant", default="")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else ASSIGNED_ARCHS
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = [args.multi_pod] if not args.both_meshes else [False, True]
    cells = [(a, s, mp) for a in archs for s in shapes for mp in meshes]

    traces: dict = {}
    failures = 0
    rows = []
    t0 = time.perf_counter()
    for a, s, mp in cells:
        rep = run_cell(a, s, mp, force=args.force, variant=args.variant,
                       traces=traces)
        if "error" in rep:
            failures += 1
        rows.append(_row(a, s, mp, rep))
    print("\n| arch | shape | mesh | GiB a device | fits_hbm | dominant | "
          "bound s | useful / traced FLOPs |\n| --- | --- | --- | --- | "
          "--- | --- | --- | --- |")
    print("\n".join(rows))
    print(f"\n{len(cells)} cells, {failures} failures, "
          f"{time.perf_counter() - t0:.1f} s (predictions from the H100's "
          "data-sheet peaks)")
    return failures


def _row(arch, shape, multi_pod, rep) -> str:
    """One markdown row of the sweep's table."""
    mesh = "2x16x16" if multi_pod else "16x16"
    if "skipped" in rep or "error" in rep:
        what = (f"skipped: {rep['skipped']}" if "skipped" in rep
                else f"error: {rep['error']}")
        return f"| {arch} | {shape} | {mesh} | {what} | | | | |"
    m, r = rep["memory_analysis"], rep["roofline"]
    return (f"| {arch} | {shape} | {mesh} | {m['total_GiB']} | "
            f"{m['fits_hbm']} | {r['dominant']} | "
            f"{r['step_lower_bound_s']:.4g} | "
            f"{r['useful_flops_ratio']:.3f} |")


if __name__ == "__main__":
    raise SystemExit(main())

"""Dry run on the meta device (twin of ``repro/launch/dryrun.py``).

For every (architecture × input shape) cell, on the single-pod (16, 16)
mesh and the 2-pod (2, 16, 16) mesh:

    state, inputs = abstract_state(...), input_specs(...)   # meta tensors
    step          = build_train_step / build_prefill_step / build_decode_step
                    under ``make_ctx`` (the reference's: training cells
                    with block remat, the expert-parallel relay where
                    the tokens divide over the mesh)
    traced        = the port's step run once on the meta device:
                    FLOPs (``roofline.analysis.trace_step_flops``) and the
                    bytes it keeps beside its arguments
    collectives   = the same step on DTensors of meta tensors over a fake
                    process group of the mesh's ranks: every collective
                    rank 0 issues, with its operand bytes and group (by
                    kind, by mesh axis and by call site)
    report        = ``roofline.analysis.analyze_traced(cfg, shape, ms, ...)``

The meta device carries shapes and dtypes and no data, so nothing is
allocated and nothing is launched: the kernel wrappers take their plain
versions there, which compute only the output shapes.  The dry run never
touches CUDA; it is meta by nature, as the reference's placeholder
devices are, and takes no ``--device``.  (Its fake mesh says "cuda" so
that DTensor picks the collectives it picks on the cards, ``all_to_all``
rather than gloo's all-gather stand-in; no tensor is on it.)

Per device, on the cell's ``MeshSpec`` (``sharding/specs.py``):

* argument bytes: every parameter, AdamW moment, cache and input leaf at
  the per-device shape its spec gives (``MeshSpec.local_shape``);
* temp bytes: for a training cell, the tensors saved for the backward
  (``torch.autograd.graph.saved_tensors_hooks``, each storage once,
  arguments excluded, the backward's own recompute excluded); under block
  remat that is what the checkpoints keep, each block's inputs, plus the
  most one block's recompute saves (measured by running that block once
  apart, uncounted); for prefill and decode, the peak of the
  intermediate storages alive at once, each kernel wrapper counted by
  its output only (a kernel keeps its tiles on chip; its plain version
  would materialise what the kernel does not).  Divided evenly over the
  chips, the reference's analytic rule for activations
  (``roofline/analysis.py::analytic_memory_bytes``);
* output bytes: the step's outputs that are not its arguments (the port
  updates parameters, moments and caches in place), over the chips;
* ``fits_hbm``: their sum against the card's memory;
* collective wire bytes: each collective of the sharded trace by the
  reference's formulas (``roofline.analysis.wire_bytes``).

The one-program trace does not depend on the mesh, so a sweep traces a
cell once and reports it on each mesh; the collective trace is made per
mesh.  Reports go to ``build/dryrun/`` as JSON, and the sweep is
resumable: ``python -m repro_torch.launch.dryrun --arch X --shape Y
[--multi-pod] [--variant serve_tp|mb4|exp_fsdp]`` runs one cell,
``--all`` sweeps everything.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import math
import os
import sys
import time
import traceback
import weakref
from pathlib import Path

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)

from repro_torch.configs import (ASSIGNED_ARCHS, SHAPES, get_config,
                                 shape_applicable)
from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import transformer as tfm
from repro_torch.models.transformer import RunCtx
from repro_torch.optim import adamw
from repro_torch.roofline import analysis as RA
from repro_torch.runtime import train_loop
from repro_torch.sharding.specs import LogicalMesh, MeshSpec
from repro_torch.tree import items, leaves, map_tree

OUT_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"
META = torch.device("meta")
VARIANTS = ("", "serve_tp", "mb4", "exp_fsdp")


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
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; the port runs "
                         f"{VARIANTS}")


def _ep_applies(cfg, ms: MeshSpec, shape, use_ep: bool = True) -> bool:
    """The reference's rule for the expert-parallel relay: MoE, not
    decode, the routed rows and the experts dividing over the mesh."""
    tok_axes = ms.dp + (ms.tp,)
    n_sh = math.prod(ms.mesh.shape[a] for a in tok_axes)
    T = shape.global_batch * shape.seq_len
    return bool(use_ep and cfg.moe.enabled and shape.kind != "decode"
                and T * cfg.moe.top_k % n_sh == 0
                and cfg.moe.n_experts % ms.mesh.shape[ms.tp] == 0)


def make_ctx(cfg, ms: MeshSpec, shape, *, use_ep=True, explicit_fsdp=False,
             remat: str | None = None) -> RunCtx:
    """The reference's ``make_ctx``: ``ms.constrain`` as the shard hook,
    block remat for training (``remat`` overrides), the sort dispatch,
    the model axis as ``tp_size`` and, where ``_ep_applies`` and ``ms``
    is over a ``DeviceMesh``, the expert-parallel relay over every mesh
    axis (a ``LogicalMesh`` has no ranks to relay between: the
    one-program trace runs the one-device dispatch)."""
    ep = None
    if ms.device_mesh is not None and _ep_applies(cfg, ms, shape, use_ep):
        ep = (ms.device_mesh, ms.dp + (ms.tp,))
    if remat is None:
        remat = "block" if shape.kind == "train" else "none"
    return RunCtx(shard=ms.constrain, remat=remat, moe_method="sort", ep=ep,
                  tp_size=ms.mesh.shape[ms.tp], explicit_fsdp=explicit_fsdp)


def build_train_step(cfg, ms, shape, moment_dtype, variant="",
                     remat: str | None = None):
    """The port's train step (``runtime/train_loop.make_train_step``)
    under ``make_ctx`` (``exp_fsdp``: the expert weights gathered inside
    the relay), with the reference's schedule (warmup 100 of 10 000
    steps) and AdamW defaults; ``mb4`` accumulates over 4 microbatches."""
    _check_variant(variant)
    tcfg = train_loop.TrainConfig(
        steps=10_000, warmup=100, opt=adamw.AdamWConfig(),
        microbatch=4 if variant.startswith("mb") else 0)
    ctx = make_ctx(cfg, ms, shape, explicit_fsdp=(variant == "exp_fsdp"),
                   remat=remat)
    return train_loop.make_train_step(cfg, ctx, tcfg)


def build_prefill_step(cfg, ms, shape):
    ctx = make_ctx(cfg, ms, shape)

    @torch.no_grad()
    def serve_prefill(params, cache, tokens, enc_frames=None):
        return M.prefill(cfg, params, tokens, cache, enc_frames=enc_frames,
                         ctx=ctx)

    return serve_prefill


def build_decode_step(cfg, ms, shape):
    ctx = make_ctx(cfg, ms, shape)

    @torch.no_grad()
    def serve_step(params, cache, token, lengths):
        return M.decode_step(cfg, params, token, lengths, cache, ctx=ctx)

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
    microbatches, one microbatch's; under block remat the blocks' inputs
    the checkpoints hold, plus ``recompute``, the most one block's
    recompute saves); ``peak``, the most alive at once, where a kernel
    wrapper's plain version (``opaque``) counts by its output only."""

    def __init__(self, args):
        super().__init__()
        self.args = frozenset(_key(t) for t in _tensors(args))
        self.known = set(self.args)
        self.saved_keys: set = set()
        self.saved = self.saved_live = self.live = self.peak = 0
        self.recompute = 0
        self._depth = 0
        self._paused = False
        self._blocks: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not self._depth:
            for t in _tensors(out):
                self._made(t)
        return out

    def _made(self, t: torch.Tensor) -> None:
        key = _key(t)
        if key in self.known or self._paused:
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

    def remat(self, checkpoint):
        """``transformer.checkpoint_block`` counted: the checkpoint keeps
        the block's inputs (counted as saved until they are freed), and
        the block's backward first recomputes what it saves; that is
        measured once a block shape by running the block apart, with
        every mode off, under a hook that only counts."""
        def call(fn, *args):
            for t in _tensors(args):
                self.pack(t)
            key = tuple((tuple(t.shape), t.dtype) for t in _tensors(args))
            if key not in self._blocks:
                self._blocks[key] = self._block_saves(fn, args)
            self.recompute = max(self.recompute, self._blocks[key])
            return checkpoint(fn, *args)
        return call

    def _block_saves(self, fn, args) -> int:
        inputs = {_key(t) for t in _tensors(args)} | self.args
        seen: dict = {}

        def count(t):
            k = _key(t)
            if k not in inputs:
                seen[k] = t.untyped_storage().nbytes()
            return t

        self._paused = True               # the opaque wrappers count nothing
        try:
            with _disable_current_modes(), torch.enable_grad(), \
                    torch.autograd.graph.saved_tensors_hooks(count,
                                                             lambda t: t):
                fn(*args)
        finally:
            self._paused = False
        return sum(seen.values())

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
    # each counted by its output only while the step runs, and the block
    # checkpoint, counted as what it keeps
    patched = [(m, name, getattr(m, name)) for m, name in
               ((_fa, "flash_attention"), (_fa, "flash_attention_chunked"),
                (_da, "decode_attention"), (_ssd, "ssd_scan"),
                (tfm, "checkpoint_block"))]
    t0 = time.perf_counter()
    try:
        for m, name, fn in patched:
            setattr(m, name, mem.remat(fn) if m is tfm else mem.opaque(fn))
        with mem, torch.autograd.graph.saved_tensors_hooks(mem.pack,
                                                           lambda t: t):
            flops = RA.trace_step_flops(run, *args)
    finally:
        for m, name, fn in patched:
            setattr(m, name, fn)
    trace_s = time.perf_counter() - t0
    out_bytes = sum(t.untyped_storage().nbytes()
                    for t in {_key(t): t for t in _tensors(outs)
                              if _key(t) not in mem.args}.values())
    return {"flops": flops, "saved_bytes": mem.saved + mem.recompute,
            "peak_bytes": mem.peak, "output_bytes": out_bytes,
            "trace_s": trace_s}


# --------------------------------------------------------------------------- #
# The collectives of the sharded step
# --------------------------------------------------------------------------- #


#: functional collectives (op name → the reference's HLO kind)
COLLECTIVES = {"all_gather_into_tensor": "all-gather",
               "reduce_scatter_tensor": "reduce-scatter",
               "all_reduce": "all-reduce",
               "all_to_all_single": "all-to-all",
               "shard_dim_alltoall": "all-to-all"}


@functools.lru_cache(maxsize=None)
def _port_file(filename: str) -> str | None:
    """``filename`` relative to the port's package, None for a file
    outside it or for this module."""
    path = Path(filename).resolve()
    pkg = Path(__file__).resolve().parents[1]
    if not path.is_relative_to(pkg) or path == Path(__file__).resolve():
        return None
    return str(path.relative_to(pkg))


def _site() -> str:
    """Where a collective comes from: ``phase file:line function`` of the
    innermost frame of the port outside this module (phase ``fwd``, or
    ``bwd`` with the autograd node being run, whose frame is the step's
    backward call unless the node runs the port's code: a recompute or a
    custom backward)."""
    f = sys._getframe(2)
    while f is not None and _port_file(f.f_code.co_filename) is None:
        f = f.f_back
    where = ("?" if f is None else f"{_port_file(f.f_code.co_filename)}:"
             f"{f.f_lineno} {f.f_code.co_name}")
    if torch._C._current_graph_task_id() == -1:
        return f"fwd {where}"
    node = torch._C._current_autograd_node()
    return f"bwd {'?' if node is None else node.name()} {where}"


class _Collectives(TorchDispatchMode):
    """Every functional collective rank 0 issues: its kind, the bytes of
    its operand and its group's size, summed as the reference's
    ``parse_hlo`` sums wire bytes (``RA.wire_bytes``); also by call site
    (``sites``: {``_site()``: {kind: wire bytes}}) and by the mesh axis
    its group spans (``axes``: {kind: {axis: wire bytes}}; ``groups``
    names each group's axis)."""

    def __init__(self, groups: dict):
        super().__init__()
        self.kinds = {k: {"bytes": 0.0, "count": 0}
                      for k in sorted(set(COLLECTIVES.values()))}
        self.ops = {k: 0.0 for k in COLLECTIVES}
        self.sites: dict = {}
        self.groups = groups
        self.axes = {k: {} for k in self.kinds}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            # let DTensor run first: the collectives it lowers to come
            # back through this mode on the local tensors
            return NotImplemented
        name = func.__name__.split(".")[0]
        ns = func.namespace
        if name in COLLECTIVES and ns in ("_c10d_functional", "_dtensor"):
            t = args[0]
            if name == "all_gather_into_tensor":
                g = args[1]
            elif name == "reduce_scatter_tensor":
                g = args[2]
            else:
                from torch.distributed.distributed_c10d import \
                    _resolve_process_group
                g = _resolve_process_group(args[-1]).size()
            kind = COLLECTIVES[name]
            wire = RA.wire_bytes(kind, t.numel() * t.element_size(), g)
            self.kinds[kind]["bytes"] += wire
            self.kinds[kind]["count"] += 1
            self.ops[name] += wire
            site = self.sites.setdefault(_site(), {})
            site[kind] = site.get(kind, 0.0) + wire
            axis = self.groups.get(args[-1], args[-1])
            self.axes[kind][axis] = self.axes[kind].get(axis, 0.0) + wire
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def fake_world(n: int):
    """A fake process group of ``n`` ranks (this process is rank 0; the
    collectives return without moving anything), torn down on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry run's collective trace makes its own "
                           "process group; one is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _on_mesh(ms: MeshSpec, tree, specs):
    """``tree`` (meta tensors) as DTensors of rank 0's shards of
    ``specs`` on ``ms.device_mesh``: nothing moves, nothing is made."""
    from torch.distributed.tensor import DTensor

    def one(t, spec):
        loc = torch.empty(ms.local_shape(t.shape, spec), dtype=t.dtype,
                          device=META)
        return DTensor.from_local(loc, ms.device_mesh, ms.placements(spec),
                                  run_check=False, shape=t.shape,
                                  stride=t.stride())
    return map_tree(one, tree, specs)


def trace_collectives(cfg, shape, mesh, *, params_tp_only=False,
                      moment_dtype=torch.float32, variant="",
                      remat: str | None = None) -> dict:
    """The cell's step on DTensors over a fake process group of
    ``mesh``'s ranks (a ``LogicalMesh``; its data axes as one), under
    ``make_ctx`` with
    ``MeshSpec.constrain`` placing every hook and the expert-parallel
    relay where it applies (``remat``: the training step's, as
    ``build_train_step`` takes it).  Returns ``kinds`` {kind: {"bytes":
    wire bytes a device, "count"}}, ``ops`` (wire bytes by op: the relay's
    ``all_to_all_single`` apart from DTensor's ``shard_dim_alltoall``),
    ``sites`` (wire bytes by call site and kind, ``_site()``), ``axes``
    (wire bytes by kind and the mesh axis of the group: ``data`` = the
    FSDP weight gathers and gradient reductions, ``model`` = tensor and
    sequence parallelism), ``reshape_gathers`` (the views
    ``layers.reshape`` replicated first, and their wire bytes),
    ``collective_bytes`` and ``collective_trace_s``."""
    from torch.distributed.device_mesh import DeviceMesh
    t0 = time.perf_counter()
    state = abstract_state(cfg, shape, moment_dtype)
    inputs = input_specs(cfg, shape)
    # every rule takes the data axes together (``MeshSpec.dp``), so they
    # are one axis of their product here: the same layouts, and one
    # collective over the pod x data ranks where DTensor would issue one
    # an axis in turn (its planner over three axes also takes minutes a
    # cell); the reference's HLO groups the same ranks
    dp = math.prod(n for a, n in mesh.shape.items() if a != "model")
    flat = LogicalMesh((dp, mesh.shape["model"]))
    with fake_world(mesh.size):
        dm = DeviceMesh("cuda", torch.arange(mesh.size).reshape(
            dp, flat.shape["model"]), mesh_dim_names=flat.axis_names,
            _init_backend=True)
        ms = MeshSpec(dm, params_tp_only=params_tp_only)
        import torch.distributed as dist
        groups = {dm.get_group(a).group_name: a for a in flat.axis_names}
        groups[dist.group.WORLD.group_name] = "+".join(flat.axis_names)
        p_specs = ms.param_specs(state["params"])
        params = _on_mesh(ms, state["params"], p_specs)
        batch_of = lambda tree: {k: _on_mesh(ms, t, ms.batch_spec(k, t.shape))
                                 for k, t in tree.items()}
        if shape.kind == "train":
            opt = state["opt"]
            rep = lambda t: _on_mesh(ms, t, ())
            opt = adamw.AdamWState(rep(opt.step),
                                   _on_mesh(ms, opt.m, p_specs),
                                   _on_mesh(ms, opt.v, p_specs))
            fn = build_train_step(cfg, ms, shape, moment_dtype, variant,
                                  remat)
            args = (params, opt, rep(state["bias"]),
                    batch_of(inputs["batch"]))
        else:
            cache = _on_mesh(ms, state["cache"],
                             ms.cache_pspecs(cfg, state["cache"]))
            inp = batch_of(inputs)
            if shape.kind == "prefill":
                fn = build_prefill_step(cfg, ms, shape)
                args = (params, cache, inp["tokens"]) + (
                    (inp["enc_frames"],) if cfg.is_encdec else ())
            else:
                fn = build_decode_step(cfg, ms, shape)
                args = (params, cache, inp["token"], inp["lengths"])
        mode = _Collectives(groups)
        L.RESHAPE_GATHERS.clear()
        with mode:
            fn(*args)
    return {"kinds": mode.kinds, "ops": mode.ops, "sites": mode.sites,
            "axes": mode.axes,
            "reshape_gathers": {
                "views": dict(L.RESHAPE_GATHERS),
                "bytes": sum(sum(v.values()) for k, v in mode.sites.items()
                             if k.endswith(" _dt_reshape"))},
            "collective_bytes": sum(k["bytes"] for k in mode.kinds.values()),
            "collective_trace_s": time.perf_counter() - t0}


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


def _step_and_args(cfg, shape, ms, state, inputs, moment_dtype, variant,
                   remat=None):
    if shape.kind == "train":
        fn = build_train_step(cfg, ms, shape, moment_dtype, variant, remat)
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
                   variant: str = "", traces: dict | None = None,
                   remat: str | None = None) -> dict:
    """Trace one cell of ``cfg`` × ``shape`` on the mesh of ``ms`` and
    return its report (``roofline.analysis.analyze_traced`` plus the
    trace's own keys).  ``moment_dtype`` None: the "auto" rule (a mesh
    with a ``pod`` axis is multi-pod).  ``traces``: a dict the caller
    keeps to reuse the one-program trace across meshes (it does not
    depend on the mesh).  ``remat``: the training cell's remat where not
    ``make_ctx``'s ("block").  The collectives come from a second trace
    over a fake process group of the mesh's ranks (a one-device mesh has
    none)."""
    multi_pod = "pod" in ms.mesh.axis_names
    if moment_dtype is None:
        moment_dtype = _moment_dtype(cfg, multi_pod)
    state = abstract_state(cfg, shape, moment_dtype)
    inputs = input_specs(cfg, shape)
    key = (cfg, shape.name, variant, moment_dtype, remat)
    traced = None if traces is None else traces.get(key)
    if traced is None:
        fn, args = _step_and_args(cfg, shape, ms, state, inputs,
                                  moment_dtype, variant, remat)
        traced = trace_step(fn, args)
        if traces is not None:
            traces[key] = traced
    n_chips = ms.mesh.size
    coll = {"kinds": {}, "collective_bytes": 0.0, "collective_trace_s": 0.0}
    if n_chips > 1:
        coll = trace_collectives(cfg, shape, ms.mesh,
                                 params_tp_only=ms.params_tp_only,
                                 moment_dtype=moment_dtype, variant=variant,
                                 remat=remat)
    train = shape.kind == "train"
    report = RA.analyze_traced(cfg, shape, ms, {
        "flops": traced["flops"],
        "argument_bytes": _argument_bytes(cfg, shape, ms, state, inputs),
        "output_bytes": traced["output_bytes"] / n_chips,
        "temp_bytes": (traced["saved_bytes"] if train
                       else traced["peak_bytes"]) / n_chips,
        "temp_rule": ("saved for backward (under block remat: the "
                      "blocks' inputs + one block's recompute) / chips"
                      if train and (remat or "block") == "block" else
                      "saved for backward / chips" if train else
                      "peak of live intermediates / chips"),
        "collectives": coll,
    })
    report.update({
        "trace_s": round(traced["trace_s"], 2),
        "collective_trace_s": round(coll["collective_trace_s"], 2),
        "moment_dtype": str(moment_dtype).removeprefix("torch.")
        if train else None,
        "remat": (remat or "block") if train else "none",
        "ep_relay": _ep_applies(cfg, ms, shape),
        # wire bytes a device by mesh axis, by call site (the largest
        # first), and of the views ``layers.reshape`` replicated
        "collective_axes": coll.get("axes", {}),
        "collective_sites": dict(sorted(
            coll.get("sites", {}).items(),
            key=lambda kv: -sum(kv[1].values()))),
        "reshape_gathers": coll.get("reshape_gathers"),
    })
    return report


def trace_cell(arch: str, shape_name: str, multi_pod: bool,
               moment_dtype_str: str = "auto", variant: str = "",
               traces: dict | None = None) -> dict:
    """One (arch × shape × mesh) cell on the production mesh.

    ``variant``: "serve_tp" = pure-TP serving params (replicated over dp;
    each dp slice is an XLB instance lane), "mb4" = 4 microbatches,
    "exp_fsdp" = the expert weights all-gathered over the data axes
    inside the relay (training cells; the others run as the baseline)."""
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
                  f"{r['step_lower_bound_s']:.4g} s a step, collectives "
                  f"{r['collective_s']:.4g} s (predictions from the "
                  f"H100's data-sheet rates); traced in "
                  f"{report['trace_s']} + {report['collective_trace_s']}"
                  f" s", flush=True)
    except Exception as e:      # recorded in the cell's report
        report = {"arch": arch, "shape": shape_name, "mesh": mesh,
                  "error": f"{type(e).__name__}: {e}",
                  "trace": traceback.format_exc()[-2000:]}
        print(f"FAILED: {report['error']}", flush=True)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(report, indent=1))
    return report


def _run_group(arch, shape, meshes, force, variant) -> list:
    """One (arch × shape) on each of ``meshes``, reusing its one-program
    trace (a worker of ``main``'s pool)."""
    traces: dict = {}
    return [run_cell(arch, shape, mp, force=force, variant=variant,
                     traces=traces) for mp in meshes]


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
    groups = [(a, s) for a in archs for s in shapes]

    t0 = time.perf_counter()
    if len(groups) > 1:         # one worker process a CPU core
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor
        with ProcessPoolExecutor(
                min(len(os.sched_getaffinity(0)), len(groups)),
                mp_context=multiprocessing.get_context("spawn")) as ex:
            futs = [ex.submit(_run_group, a, s, meshes, args.force,
                              args.variant) for a, s in groups]
            reports = [f.result() for f in futs]
    else:
        reports = [_run_group(a, s, meshes, args.force, args.variant)
                   for a, s in groups]
    rows, failures = [], 0
    for (a, s), reps in zip(groups, reports):
        for mp, rep in zip(meshes, reps):
            failures += "error" in rep
            rows.append(_row(a, s, mp, rep))
    print("\n| arch | shape | mesh | GiB a device | fits_hbm | dominant | "
          "bound s | collective s | useful / traced FLOPs |\n| --- | --- | "
          "--- | --- | --- | --- | --- | --- | --- |")
    print("\n".join(rows))
    print(f"\n{len(rows)} cells, {failures} failures, "
          f"{time.perf_counter() - t0:.1f} s (predictions from the H100's "
          "data-sheet peaks)")
    return failures


def _row(arch, shape, multi_pod, rep) -> str:
    """One markdown row of the sweep's table."""
    mesh = "2x16x16" if multi_pod else "16x16"
    if "skipped" in rep or "error" in rep:
        what = (f"skipped: {rep['skipped']}" if "skipped" in rep
                else f"error: {rep['error']}")
        return f"| {arch} | {shape} | {mesh} | {what} | | | | | |"
    m, r = rep["memory_analysis"], rep["roofline"]
    return (f"| {arch} | {shape} | {mesh} | {m['total_GiB']} | "
            f"{m['fits_hbm']} | {r['dominant']} | "
            f"{r['step_lower_bound_s']:.4g} | {r['collective_s']:.4g} | "
            f"{r['useful_flops_ratio']:.3f} |")


if __name__ == "__main__":
    raise SystemExit(main())

"""Per-tensor sharding rules (DP / FSDP / TP / EP / SP) for every arch
(twin of ``repro/sharding/specs.py``), over a mesh that is only a shape.

Every rule is divisibility-checked per tensor (``fit_spec``): a dim takes
the first candidate axis (or axis tuple) that divides it; otherwise it
stays replicated.  This is what lets yi-34b (56 heads) or granite (kv=1)
share one rule set with the evenly-shaped archs.

Baseline layout (the reference's):

  params      matrix (…, A, B):  A → fsdp(dp axes), B → tp("model")
              out-projections (…, tp→dp) flipped (Megatron row-parallel)
              MoE expert stacks: E → tp (expert parallel, relay a2a owner)
              embed (V, D): V → dp, D → tp;  head (D, V): D → dp, V → tp
  batch       (B, …): B → dp
  cache       (n,B,S,K,hd): B → dp, S → tp (KV-sequence sharding)
  ssm state   (n,B,nh,hd,N): B → dp, nh → tp

A spec is ``PartitionSpec``'s own form, a tuple with one entry per
leading dim: None, an axis name, or a tuple of axis names, trailing Nones
dropped.  A ``MeshSpec``'s mesh is a ``LogicalMesh`` (axis names and
sizes, no devices: the dry run's per-device shapes, ``local_shape``) or a
``torch.distributed.device_mesh.DeviceMesh``, whose axis names and sizes
then give the ``LogicalMesh``.  Over a ``DeviceMesh`` the reference's
placing methods follow from the same specs: ``named`` turns a spec into
DTensor placements (a ``Placed``: the mesh and one placement a mesh
axis), ``constrain`` redistributes a DTensor to a rule's layout, and
``params_shardings`` / ``cache_shardings`` / ``batch_shardings`` give a
``Placed`` a leaf.  A tensor dim over two axes (``("pod", "data")``) is
split major to minor in the mesh's order, as JAX lays out
``P(("pod", "data"))``.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, NamedTuple, Sequence

from repro_torch.tree import items, map_tree, unflatten


@dataclasses.dataclass(frozen=True)
class LogicalMesh:
    """A mesh as a shape: ``shape`` {axis name: size} (a tuple of sizes is
    taken with ``axis_names``), ``axis_names`` in mesh order."""

    shape: Any
    axis_names: tuple = ("data", "model")

    def __post_init__(self):
        shape = self.shape
        if not isinstance(shape, dict):
            shape = tuple(shape)
            if len(shape) != len(self.axis_names):
                raise ValueError(f"mesh shape {shape} for axes "
                                 f"{self.axis_names}")
            shape = dict(zip(self.axis_names, shape))
        elif tuple(shape) != tuple(self.axis_names):
            raise ValueError(f"mesh axes {tuple(shape)} are not "
                             f"{tuple(self.axis_names)}")
        object.__setattr__(self, "shape", dict(shape))
        object.__setattr__(self, "axis_names", tuple(self.axis_names))

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())


class Placed(NamedTuple):
    """Where a tensor lives on a ``DeviceMesh``: the port's
    ``NamedSharding``, one DTensor placement a mesh axis."""

    mesh: Any
    placements: tuple


def _is_device_mesh(mesh) -> bool:
    return hasattr(mesh, "mesh_dim_names") and hasattr(mesh, "get_group")


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (False where torch has no
    ``torch.distributed``)."""
    import torch
    if not torch.distributed.is_available():
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def axis_size(mesh, cand) -> int:
    axes = cand if isinstance(cand, tuple) else (cand,)
    return math.prod(mesh.shape[a] for a in axes)


def fit_spec(mesh, shape: Sequence[int], prefs: Sequence[Sequence],
             ) -> tuple:
    """Per-dim: first candidate axis(-tuple) that divides the dim and is not
    already used; else replicated."""
    used: set = set()
    out = []
    for dim, cands in zip(shape, prefs):
        chosen = None
        for cand in cands:
            if cand is None:
                break
            axes = cand if isinstance(cand, tuple) else (cand,)
            if any(a in used for a in axes):
                continue
            sz = axis_size(mesh, cand)
            if sz > 1 and dim % sz == 0:
                # 1-tuples unwrapped, as the reference's PartitionSpecs
                chosen = axes[0] if len(axes) == 1 else cand
                used.update(axes)
                break
        out.append(chosen)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """A mesh + the role assignment of its axes.

    ``params_tp_only``: serving layout — parameters live only on the model
    axis and are REPLICATED across dp (each dp slice is an XLB instance
    lane holding a full TP copy).  Kills the per-token FSDP weight
    all-gather that dominates decode; only viable when params/tp fit HBM.
    """

    mesh: Any
    params_tp_only: bool = False
    device_mesh: Any = None

    def __post_init__(self):
        if _is_device_mesh(self.mesh):
            dm = self.mesh
            object.__setattr__(self, "device_mesh", dm)
            object.__setattr__(self, "mesh", LogicalMesh(
                tuple(dm.shape), tuple(dm.mesh_dim_names)))

    @property
    def dp(self) -> tuple:
        """Data-parallel axes — everything that isn't the model axis."""
        return tuple(a for a in self.mesh.axis_names if a != "model")

    @property
    def param_dp(self) -> tuple:
        return () if self.params_tp_only else self.dp

    @property
    def tp(self) -> str:
        return "model"

    def local_shape(self, shape: Sequence[int], spec: tuple) -> tuple:
        """The per-device shape ``spec`` gives ``shape`` on this mesh
        (every sharded dim divides: ``fit_spec`` chose it so)."""
        out = list(shape)
        for i, axes in enumerate(spec):
            if axes is not None:
                out[i] //= axis_size(self.mesh, axes)
        return tuple(out)

    # ------------------------------------------------------------------ #
    # Placing on a DeviceMesh
    # ------------------------------------------------------------------ #
    def placements(self, spec: tuple) -> tuple:
        """DTensor placements of ``spec``: ``Shard(d)`` on each mesh axis
        that shards tensor dim d, ``Replicate()`` on the rest.  A dim over
        several axes takes them major to minor in the mesh's order (the
        only order DTensor's placements express; every rule here names
        them so)."""
        from torch.distributed.tensor import Replicate, Shard
        names = self.mesh.axis_names
        out = [Replicate()] * len(names)
        for d, axes in enumerate(spec):
            if axes is None:
                continue
            pos = [names.index(a) for a in
                   (axes if isinstance(axes, tuple) else (axes,))]
            if pos != sorted(pos):
                raise ValueError(f"spec {spec}: axes {axes} are not in the "
                                 f"mesh's order {names}")
            for i in pos:
                out[i] = Shard(d)
        return tuple(out)

    def named(self, spec: tuple) -> Placed:
        """``spec`` on this ``DeviceMesh`` (the reference's
        ``NamedSharding``)."""
        if self.device_mesh is None:
            raise ValueError("named() needs a MeshSpec over a DeviceMesh; "
                             "a LogicalMesh has no devices")
        return Placed(self.device_mesh, self.placements(spec))

    def constrain(self, x, kind: str):
        """The reference's layout rule ``kind`` applied to ``x``: a
        DTensor is redistributed to it (differentiably; the collectives
        are DTensor's), anything else comes back unchanged, as does a
        kind or rank no rule names."""
        if not is_dtensor(x):
            return x
        spec = self.activation_spec(kind, tuple(x.shape))
        if spec is None:
            return x
        return x.redistribute(self.device_mesh, self.placements(spec))

    def activation_spec(self, kind: str, shape: tuple):
        """The spec of the reference's ``constrain`` rule ``kind`` for an
        activation of ``shape``; None where no rule applies."""
        dp, tp = self.dp, self.tp
        if kind == "resid":                    # (B,S,D)
            if shape[1] == 1:                  # decode token
                return fit_spec(self.mesh, shape, [(dp,), (), (tp,)])
            return fit_spec(self.mesh, shape, [(dp,), (tp,), ()])
        if kind == "logits":                   # (B,S,V) / (B,V)
            if len(shape) == 3:
                return fit_spec(self.mesh, shape, [(dp,), (), (tp,)])
            return fit_spec(self.mesh, shape, [(dp,), (tp,)])
        if kind == "heads" and len(shape) == 5:        # q (B,S,K,G,hd)
            # head-shard only when the score slab can shard K or G, else
            # sequence-shard (the "scores" and "resid" layouts)
            ts = axis_size(self.mesh, tp)
            if shape[2] % ts == 0 or shape[3] % ts == 0:
                return fit_spec(self.mesh, shape,
                                [(dp,), (), (tp,), (tp,), ()])
            return fit_spec(self.mesh, shape, [(dp,), (tp,), (), (), ()])
        if kind == "kv_full" and len(shape) == 4:      # K/V: batch-only
            return fit_spec(self.mesh, shape, [(dp,), (), (), ()])
        if kind == "attn_in" and len(shape) == 3:      # x before q/k/v
            return fit_spec(self.mesh, shape, [(dp,), (), ()])
        if kind == "heads4" and len(shape) == 4:       # (B,S,H,d): H→tp
            return fit_spec(self.mesh, shape, [(dp,), (), (tp,), ()])
        if kind == "scores4" and len(shape) == 4:      # (B,H,CQ,Skv)
            return fit_spec(self.mesh, shape, [(dp,), (tp,), (), ()])
        if kind == "scores" and len(shape) == 5:       # (B,K,G,CQ,Skv)
            return fit_spec(self.mesh, shape,
                            [(dp,), (tp,), (tp,), (tp,), ()])
        return None

    def params_shardings(self, params) -> Any:
        """A ``Placed`` a leaf of ``params``, from ``param_specs``."""
        return map_tree(lambda t, s: self.named(s), params,
                        self.param_specs(params))

    def cache_shardings(self, cfg, cache) -> Any:
        """A ``Placed`` a leaf of ``cache``, from ``cache_pspecs``."""
        return map_tree(lambda t, s: self.named(s), cache,
                        self.cache_pspecs(cfg, cache))

    def batch_shardings(self, batch) -> Any:
        """A ``Placed`` a leaf of ``batch``, from ``batch_spec``."""
        return unflatten(batch, [self.named(self.batch_spec(k, t.shape))
                                 for k, t in items(batch)])

    # ------------------------------------------------------------------ #
    # Parameters
    # ------------------------------------------------------------------ #
    def param_spec(self, path: str, shape: Sequence[int]) -> tuple:
        dp, tp = self.param_dp, self.tp
        r = len(shape)
        none = [()] * r

        def tail(rules):                      # apply rules to trailing dims
            prefs = list(none)
            for off, cands in rules.items():
                prefs[off] = cands
            return fit_spec(self.mesh, shape, prefs)

        if re.search(r"moe/(w_in|w_gate)$", path):
            return tail({r - 3: (tp,), r - 2: (dp,)})
        if re.search(r"moe/w_out$", path):
            return tail({r - 3: (tp,), r - 1: (dp,)})
        if re.search(r"moe/router$", path):
            return tail({r - 2: (dp,)})
        if path.endswith("embed"):
            return tail({r - 2: (dp,), r - 1: (tp,)})
        if path.endswith("head"):
            return tail({r - 2: (dp,), r - 1: (tp,)})
        if re.search(r"(wo|w_out|w_uk|w_uv)$", path) and r >= 2:
            # row-parallel: contraction dim → tp, output dim → dp(fsdp)
            return tail({r - 2: (tp,), r - 1: (dp,)})
        if path.endswith("conv_w"):
            return tail({r - 1: (tp,)})
        if re.search(r"(A_log|dt_bias|/D|norm)", path) or r <= 1 + (
                0 if "blocks" not in path else 1):
            # scalars / per-head vectors / norm scales: replicate
            return ()
        if r >= 2:
            # column-parallel default: input dim → fsdp, output dim → tp
            return tail({r - 2: (dp,), r - 1: (tp,)})
        return ()

    def param_specs(self, params) -> Any:
        """A spec per leaf of ``params``, in its structure (the
        reference's ``params_shardings`` without the ``NamedSharding``):
        each leaf's "/"-joined key path through ``param_spec``."""
        return unflatten(params, [self.param_spec(path, leaf.shape)
                                  for path, leaf in items(params)])

    # ------------------------------------------------------------------ #
    # Batch / cache
    # ------------------------------------------------------------------ #
    def batch_spec(self, name: str, shape: Sequence[int]) -> tuple:
        # tokens/labels (B,S): B→dp; enc_frames (B,F,D): B→dp
        return fit_spec(self.mesh, shape,
                        [(self.dp,)] + [()] * (len(shape) - 1))

    # Cache specs are built structurally, mirroring model.init_cache.
    # Each leaf kind has an explicit (B-dim offset, seq/head-dim offset)
    # rule; dims that don't divide fall back via fit_spec (long_500k's
    # batch=1 → the sequence dim picks up the whole (dp+tp) mesh instead:
    # full sequence-parallel decode).
    def _kv_spec(self, shape) -> tuple:        # (..., B, S, K, hd)
        dp, tp = self.dp, self.tp
        r = len(shape)
        prefs = [()] * r
        b_off = max(r - 4, 0)
        prefs[b_off] = (dp,)
        prefs[b_off + 1] = (tp, dp + (tp,), dp)
        return fit_spec(self.mesh, shape, prefs)

    def _mla_spec(self, shape) -> tuple:       # (..., B, S, r) latent cache
        dp, tp = self.dp, self.tp
        r = len(shape)
        prefs = [()] * r
        prefs[r - 3] = (dp,)
        prefs[r - 2] = (tp, dp + (tp,), dp)
        return fit_spec(self.mesh, shape, prefs)

    def _ssm_spec(self, shape) -> tuple:       # (..., B, nh, hd, N)
        dp, tp = self.dp, self.tp
        r = len(shape)
        prefs = [()] * r
        prefs[r - 4] = (dp,)
        prefs[r - 3] = (tp,)
        return fit_spec(self.mesh, shape, prefs)

    def _conv_spec(self, shape) -> tuple:      # (..., B, C, W-1)
        dp, tp = self.dp, self.tp
        r = len(shape)
        prefs = [()] * r
        prefs[r - 3] = (dp,)
        prefs[r - 2] = (tp,)
        return fit_spec(self.mesh, shape, prefs)

    def cache_pspecs(self, cfg, cache) -> Any:
        """A spec tree matching ``models/model.py::init_cache(cfg, ...)``."""
        from repro_torch.models.ssm import SSMState  # no import cycle

        def attn_cache_spec(c):
            if "ckv" in c:                     # MLA latent
                return {"ckv": self._mla_spec(c["ckv"].shape),
                        "krope": self._mla_spec(c["krope"].shape)}
            return {k: self._kv_spec(c[k].shape) for k in ("k", "v")}

        if cfg.family == "ssm":
            return SSMState(ssm=self._ssm_spec(cache.ssm.shape),
                            conv=self._conv_spec(cache.conv.shape))
        if cfg.is_hybrid:
            return {
                "attn": attn_cache_spec(cache["attn"]),
                "ssm": SSMState(ssm=self._ssm_spec(cache["ssm"].ssm.shape),
                                conv=self._conv_spec(cache["ssm"].conv.shape)),
            }
        out = {"blocks": {}}
        blocks = cache["blocks"]
        out["blocks"] = {"self": attn_cache_spec(blocks["self"])}
        for extra in ("cross_k", "cross_v"):
            if extra in blocks:
                out["blocks"][extra] = self._kv_spec(blocks[extra].shape)
        if "first" in cache:
            out["first"] = [{"self": attn_cache_spec(c["self"])}
                            for c in cache["first"]]
        return out

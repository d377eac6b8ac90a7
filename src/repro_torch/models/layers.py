"""Shared layer primitives (twin of ``repro/models/layers.py``).

Params are nested dicts of tensors with per-layer weights stacked on a
leading axis; weights keep the reference's ``x @ W`` layout.  Normalization
statistics are computed in fp32.
"""

from __future__ import annotations

import collections
import math

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.sharding.specs import is_dtensor

Params = dict


class Draw:
    """Makes the leaves of a seeded init, each a new tensor in ``dtype`` on
    ``device`` unless a leaf names its own dtype.  ``dense`` and ``embed``
    draw in f32 on the generator's device (a CPU generator gives the same
    weights on every device; a CUDA generator keeps a full-width init off
    the host) and cast into the leaf.  On the meta device nothing is
    drawn: each leaf is returned as made (shape and dtype only)."""

    def __init__(self, generator: torch.Generator, dtype, device):
        self.generator, self.dtype, self.device = generator, dtype, device
        self.meta = torch.device(device).type == "meta"

    def leaf(self, shape, dtype=None) -> torch.Tensor:
        """The (uninitialised) tensor one leaf is made in."""
        return torch.empty(tuple(shape), dtype=dtype or self.dtype,
                           device=self.device)

    def dense(self, shape, scale: float | None = None, dtype=None):
        """Truncated-normal (±3σ) fan-in init.  A weight of three or more
        axes (the experts' ``(E, D, F)``) is drawn one slab of its leading
        axis at a time, so the f32 draw never holds more than one expert."""
        out = self.leaf(shape, dtype)
        if self.meta:
            return out
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
        for part in (out if out.dim() >= 3 else [out]):
            w = torch.empty(part.shape, dtype=torch.float32,
                            device=self.generator.device)
            torch.nn.init.trunc_normal_(w, 0.0, 1.0, -3.0, 3.0,
                                        generator=self.generator)
            part.copy_(w * std)
        return out

    def embed(self, shape):
        if self.meta:
            return self.leaf(shape)
        w = torch.randn(tuple(shape), generator=self.generator,
                        dtype=torch.float32, device=self.generator.device)
        return self.leaf(shape).copy_(w * 0.02)

    def ones(self, shape, dtype=None):
        return self.leaf(shape, dtype).fill_(1)

    def zeros(self, shape, dtype=None):
        return self.leaf(shape, dtype).zero_()

    def const(self, array):
        """An f32 leaf holding ``array`` (numpy)."""
        a = torch.as_tensor(np.asarray(array, np.float32))
        out = self.leaf(a.shape, torch.float32)
        return out if self.meta else out.copy_(a)


class _StackDraw(Draw):
    """Draws layer after layer straight into (n, ...) leaves: the k-th
    leaf layer ``i`` makes is slice ``i`` of the k-th stacked tensor."""

    def __init__(self, generator, dtype, device, n: int):
        super().__init__(generator, dtype, device)
        self.n, self.stacks, self.i, self.k = n, [], 0, 0

    def leaf(self, shape, dtype=None) -> torch.Tensor:
        if self.i == 0:
            self.stacks.append(torch.empty(
                (self.n,) + tuple(shape), dtype=dtype or self.dtype,
                device=self.device))
        out = self.stacks[self.k][self.i]
        if out.shape != tuple(shape):
            raise ValueError(f"layer {self.i} leaf {self.k}: {tuple(shape)} "
                             f"where layer 0 made {tuple(out.shape)}")
        self.k += 1
        return out


def stacked(n: int, layer, generator, dtype, device) -> Params:
    """``n`` draws of ``layer(draw)`` stacked on a leading axis.  Each leaf
    is allocated once at (n, ...) and filled in place, layer by layer and
    leaf by leaf (the draws keep that order): a full-width init holds the
    stack and one expert's f32 draw, never a second copy of a layer."""
    draw = _StackDraw(generator, dtype, device, n)
    tree = None
    for i in range(n):
        draw.i, draw.k = i, 0
        lp = layer(draw)
        if i == 0:
            tree = lp
        if draw.k != len(draw.stacks):
            raise ValueError(f"layer {i} made {draw.k} leaves, layer 0 "
                             f"{len(draw.stacks)}")
    stacks = {id(s): s for s in draw.stacks}

    def lift(t):        # layer 0's leaves are views of their stacks
        if isinstance(t, dict):
            return {k: lift(v) for k, v in t.items()}
        return stacks[id(t._base)]
    return lift(tree)


#: each DTensor view that ``reshape`` replicated first, by
#: "(global shape) -> (view)": forward and backward both count
RESHAPE_GATHERS: collections.Counter = collections.Counter()


def _dt_reshape(x, shape):
    from torch.distributed.tensor import Replicate, Shard
    try:
        return x.reshape(shape)
    except RuntimeError:
        # a view of the global shape that DTensor refuses on this layout,
        # or whose local shapes it gets wrong (an uneven split); any
        # other error is the caller's
        torch.empty(x.shape, device="meta").reshape(shape)
    RESHAPE_GATHERS[f"{tuple(x.shape)} -> {tuple(shape)}"] += 1
    # keep the leading dim's shards while the view's leading dim takes
    # them all, else replicate
    n, keep = 1, []
    for q in x.placements:
        if isinstance(q, Shard) and q.dim == 0 and \
                shape[0] % (n * x.device_mesh.size(len(keep))) == 0:
            n *= x.device_mesh.size(len(keep))
            keep.append(q)
        else:
            keep.append(Replicate())
    return x.redistribute(x.device_mesh, keep).reshape(shape)


class _DTReshape(torch.autograd.Function):
    """A DTensor's reshape whose backward views the gradient back the
    same careful way (the gradient's layout is the backward's choice)."""

    @staticmethod
    def forward(ctx, x, shape):
        ctx.shape = x.shape
        return _dt_reshape(x, shape)

    @staticmethod
    def backward(ctx, g):
        return _dt_reshape(g, ctx.shape), None


def reshape(x, *shape):
    """``x.reshape(*shape)``.  A DTensor whose layout that view cannot
    keep (a dim split or merged across its mesh axes unevenly, which
    DTensor refuses, or takes and then gets the local shapes wrong,
    where GSPMD would pad: 56 heads over 16 ranks) is
    first replicated on every dim but a sharded leading one (the batch,
    as far as the view's leading dim divides over its axes), then
    viewed; its gradient likewise.  Each such gather is counted in
    ``RESHAPE_GATHERS``, and the dry run reports its bytes."""
    if not is_dtensor(x):
        return x.reshape(*shape)
    return _DTReshape.apply(x, shape)


def _local_part(cache, values, placements):
    """(the cache's local tensor, ``values`` as this rank's part laid out
    as ``placements`` (a plain tensor counts as the same on every rank),
    the cache's global offset on this rank)."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh = cache.device_mesh
    if not isinstance(values, DTensor):
        values = DTensor.from_local(values, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    v = values.redistribute(mesh, placements).to_local()
    _, off = compute_local_shape_and_global_offset(cache.shape, mesh,
                                                   cache.placements)
    return cache.to_local(), v, off


def write_prefix(cache, values) -> None:
    """``cache[:, :n] = values`` in place (n = values.shape[1] <= the
    cache's length), in the cache's dtype.  A DTensor cache (batch and
    sequence sharded as ``MeshSpec.cache_pspecs`` says) is written rank
    by rank, into each rank's own slice; no tensor is gathered but the
    values, to the cache's layout."""
    if not is_dtensor(cache):
        cache[:, :values.shape[1]] = values.to(cache.dtype)
        return
    from torch.distributed.tensor import Replicate, Shard
    n = values.shape[1]
    want = list(cache.placements) if n == cache.shape[1] else [
        Replicate() if isinstance(q, Shard) and q.dim == 1 else q
        for q in cache.placements]
    loc, v, off = _local_part(cache, values, want)
    if n == cache.shape[1]:
        loc.copy_(v.to(loc.dtype))
        return
    m = max(0, min(loc.shape[1], n - off[1]))
    loc[:, :m] = v[:, off[1]:off[1] + m].to(loc.dtype)


def write_rows(cache, lengths, rows) -> None:
    """``cache[b, lengths[b]] = rows[b]`` in place, in the cache's dtype;
    an index past the cache raises (the CPU) or device-asserts (CUDA).  A
    DTensor cache is written rank by rank: the rank whose sequence slice
    holds ``lengths[b]`` writes it, the others write back what is
    there."""
    if not is_dtensor(cache):
        b = torch.arange(cache.shape[0], device=cache.device)
        cache.index_put_((b, lengths.to(torch.int64)), rows.to(cache.dtype))
        return
    from torch.distributed.tensor import Replicate, Shard
    batch = [q if isinstance(q, Shard) and q.dim == 0 else Replicate()
             for q in cache.placements]
    loc, r, off = _local_part(cache, rows, batch)
    _, L, _ = _local_part(cache, lengths, batch)
    pos = L.to(torch.int64) - off[1]
    ok = (pos >= 0) & (pos < loc.shape[1])
    pos = pos.clamp(0, loc.shape[1] - 1)
    b = torch.arange(loc.shape[0], device=loc.device)
    keep = ok.reshape(-1, *[1] * (r.dim() - 1))
    loc.index_put_((b, pos), torch.where(keep, r.to(loc.dtype), loc[b, pos]))


def rms_norm(x, scale, eps: float = 1e-5):
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale.to(torch.float32)).to(x.dtype)


def gated_rms_norm(x, gate, scale, eps: float = 1e-5):
    """Mamba-2 gated RMSNorm: norm(x * silu(gate))."""
    g = torch.nn.functional.silu(gate.to(torch.float32)).to(x.dtype)
    return rms_norm(x * g, scale, eps)


def rope_frequencies(head_dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd) or (..., S, hd); positions: broadcastable to
    (..., S)."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)            # (hd/2,)
    angles = positions.to(torch.float32)[..., None] * freqs  # (..., S, hd/2)
    if x.ndim == angles.ndim + 1:                            # head axis
        angles = angles[..., None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoid_positions(n_pos: int, d_model: int) -> torch.Tensor:
    """Fixed sinusoidal embeddings (whisper encoder), (n_pos, d_model) f32
    on the CPU: computed in f64 with numpy and cast, as the reference
    computes them."""
    pos = np.arange(n_pos)[:, None]
    dim = np.arange(d_model // 2)[None, :]
    ang = pos * (1.0 / (10000 ** (2 * dim / d_model)))
    return torch.from_numpy(
        np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
        .astype(np.float32))


def init_ffn(draw: Draw, d_model: int, d_ff: int, act: str) -> Params:
    p = {"w_in": draw.dense((d_model, d_ff)),
         "w_out": draw.dense((d_ff, d_model))}
    if act == "swiglu":
        p["w_gate"] = draw.dense((d_model, d_ff))
    return p


def ffn(params: Params, x, act: str):
    h = ops.dense(x, params["w_in"])
    if act == "swiglu":
        h = torch.nn.functional.silu(ops.dense(x, params["w_gate"])) * h
    elif act == "gelu":         # jax.nn.gelu's default: the tanh form
        h = torch.nn.functional.gelu(h, approximate="tanh")
    else:
        raise ValueError(f"unknown activation {act!r}")
    return ops.dense(h, params["w_out"])

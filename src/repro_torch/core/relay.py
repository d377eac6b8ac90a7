"""Socket relay: payload redirection between "sockets" (twin of
``repro/core/relay.py``).

A p-sock relays a message straight into the TX queue of the chosen
i-sock; on the device that is a capacity-bounded counting-sort dispatch:
payload rows move to their destination's buffer slot in one scatter.

Across a shard mesh (``sharded_apply``) the relay hop is an explicit
``all_to_all`` over the mesh's axis: one controller over every shard, or
one rank a shard (``launch/mesh.py``).  Across the ranks of a ``DeviceMesh`` (``ep_relay``, the MoE's
expert-parallel relay) every rank runs the same body on its own rows and
the hop is a differentiable ``all_to_all`` of
``torch.distributed._functional_collectives``.

Three interchangeable dispatch methods (the tests cross-check them):
  * ``sort``    - counting-sort positions + scatter.  Default.
  * ``cumsum``  - one-hot cumsum positions (GShard-style rank).
  * ``einsum``  - dense one-hot dispatch/combine einsum, the oracle.

``positions_sort`` stays plain PyTorch on every device: it is the oracle
of the relay kernel (``kernels/relay_dispatch.py``), which the staged
admission chain and the MoE dispatch (``models/moe.py``, through
``relay_dispatch_at``) call through ``ops.relay_slots``.  Rows beyond a
destination's capacity are dropped (``ok`` False) and counted in
``overflow_frac``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch


class RelayMeta(NamedTuple):
    """Bookkeeping produced by dispatch, consumed by combine."""

    idx: torch.Tensor        # (N,) destination id per payload row
    slot: torch.Tensor       # (N,) i32 slot within the destination pool
    ok: torch.Tensor         # (N,) bool row fit inside capacity (per-SOURCE
    #                          quota under sharded_apply)
    load: torch.Tensor       # (E,) i32 rows destined per backend, pre-drop
    #                          (GLOBAL, summed over the shards, from
    #                          sharded_apply)
    overflow_frac: torch.Tensor  # () f32 fraction of rows dropped


# --------------------------------------------------------------------------- #
# Slot assignment ("which position in the destination's connection pool")
# --------------------------------------------------------------------------- #


def positions_sort(idx, n_dest: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Counting-sort rank: stable position of each row within its
    destination.  Returns (slot (N,) i32, load (n_dest,) i32); ids outside
    [0, n_dest) count no load (``jnp.bincount(length=)``)."""
    idx = idx.to(torch.int64)
    N = idx.shape[0]
    order = torch.argsort(idx, stable=True)
    sorted_idx = idx[order]
    inside = (idx >= 0) & (idx < n_dest)
    load = torch.zeros((n_dest,), dtype=torch.int64, device=idx.device)
    load.index_add_(0, idx.clamp(0, max(n_dest - 1, 0)), inside.long())
    starts = torch.cumsum(load, 0) - load
    # dropped rows sit at the sentinel n_dest: their rank is never
    # consumed, but the gather must stay inside ``starts``
    pos_sorted = torch.arange(N, device=idx.device) \
        - starts[sorted_idx.clamp(0, n_dest - 1)]
    slot = torch.empty_like(pos_sorted).index_put_((order,), pos_sorted)
    return slot.to(torch.int32), load.to(torch.int32)


def positions_cumsum(idx, n_dest: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One-hot cumsum rank (GShard form).  O(N·E) memory."""
    oh = _one_hot(idx, n_dest, torch.int64)                  # (N, E)
    ranks = torch.cumsum(oh, dim=0) - oh                     # rank before self
    slot = (ranks * oh).sum(dim=-1)
    return slot.to(torch.int32), oh.sum(dim=0).to(torch.int32)


def _one_hot(idx, n: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: an id outside [0, n) gives a zero row."""
    lanes = torch.arange(n, device=idx.device)
    return (idx.to(torch.int64)[:, None] == lanes).to(dtype)


_POSITIONS = {"sort": positions_sort, "cumsum": positions_cumsum}


# --------------------------------------------------------------------------- #
# Dispatch / combine (single device)
# --------------------------------------------------------------------------- #


def relay_dispatch(x, idx, n_dest: int, capacity: int,
                   method: str = "sort") -> tuple[torch.Tensor, RelayMeta]:
    """Scatter payload rows x (N, D) into per-destination pools
    (n_dest, capacity, D).  Rows beyond ``capacity``, and rows whose
    destination lies outside [0, n_dest), are dropped (ok False)."""
    slot, load = _POSITIONS[method](idx, n_dest)
    return relay_dispatch_at(x, idx, slot, load, n_dest, capacity)


def relay_dispatch_at(x, idx, slot, load, n_dest: int,
                      capacity: int) -> tuple[torch.Tensor, RelayMeta]:
    """``relay_dispatch`` at slots already assigned: ``(slot, load)`` as
    ``positions_sort`` or the relay kernel (``ops.relay_slots``) gives
    them.  The MoE dispatch takes them from ``ops.relay_slots``; this
    module does not call ``ops`` itself, which would close an import
    cycle through ``kernels/relay_dispatch.py``."""
    ok = slot < capacity
    i = idx.to(torch.int64)
    inside = (i >= 0) & (i < n_dest)
    write_slot = torch.where(ok & inside, slot.to(torch.int64), capacity)
    buf = torch.zeros((n_dest, capacity + 1, x.shape[1]), dtype=x.dtype,
                      device=x.device)                      # dump row = C
    buf.index_put_((i.clamp(0, n_dest - 1), write_slot), x)
    overflow = 1.0 - ok.to(torch.float32).mean()
    return buf[:, :capacity], RelayMeta(idx, slot, ok, load, overflow)


def relay_combine(buf, meta: RelayMeta, weights=None) -> torch.Tensor:
    """Gather rows back from pools (E, C, D) to payload order (N, D).

    ``weights``: optional (N,) scale.  Dropped rows come back as zeros."""
    E, C = buf.shape[:2]
    i = meta.idx.to(torch.int64).clamp(0, E - 1)
    s = meta.slot.to(torch.int64).clamp(0, C - 1)
    rows = torch.where(meta.ok[:, None], buf[i, s], 0)
    if weights is not None:
        rows = rows * weights[:, None].to(rows.dtype)
    return rows


# --------------------------------------------------------------------------- #
# Dense-einsum oracle (GShard): slowest, simplest
# --------------------------------------------------------------------------- #


def relay_dispatch_einsum(x, idx, n_dest: int, capacity: int):
    slot, load = positions_cumsum(idx, n_dest)
    ok = slot < capacity
    e_oh = _one_hot(idx, n_dest, x.dtype)                       # (N, E)
    c_oh = _one_hot(slot.clamp(max=capacity - 1), capacity, x.dtype)
    d_onehot = e_oh[:, :, None] * c_oh[:, None, :] \
        * ok[:, None, None].to(x.dtype)                         # (N, E, C)
    buf = torch.einsum("nec,nd->ecd", d_onehot, x)
    overflow = 1.0 - ok.to(torch.float32).mean()
    return buf, RelayMeta(idx, slot, ok, load, overflow), d_onehot


def relay_combine_einsum(buf, d_onehot, weights=None):
    out = torch.einsum("nec,ecd->nd", d_onehot.to(buf.dtype), buf)
    if weights is not None:
        out = out * weights[:, None].to(out.dtype)
    return out


# --------------------------------------------------------------------------- #
# Instance-parallel relay: an explicit all_to_all over a shard mesh
# --------------------------------------------------------------------------- #


def sharded_apply(xs, idxs, weights, n_dest: int, capacity: int, mesh,
                  axis: str, backend_fn, backend_params):
    """Relay every shard's rows over the mesh axis ``axis`` to the owners
    of their destinations, apply ``backend_fn(params_j, pool)`` on each
    owner j, and relay the results back: the reference's ``shard_map``
    body, over the shards this process holds (``mesh.held``: all M of a
    ``ShardMesh``, the rank's own of a ``RankShardMesh``).

    ``xs``: per held shard rows (L, N_loc, D) (or a list of L (N_loc,
    D)); ``idxs``: their global destination ids (L, N_loc); ``weights``:
    (L, N_loc) scales or None; ``backend_params``: per held shard its
    parameters, shard j's for its ``n_dest // M`` destinations
    (destination b lives on shard ``b // (n_dest // M)``); ``n_dest % M ==
    0``.  The backend gets (n_dest // M, M * capacity, D) and returns
    (n_dest // M, M * capacity, D').  Returns (out (L, N_loc, D'), meta).

    Meta across the shards: ``idx``/``slot``/``ok`` are per-source (L,
    N_loc): each source shard owns ``capacity`` slots at every destination,
    so a row is dropped against its own shard's quota (a destination
    absorbs up to ``M * capacity`` rows in all); ``overflow_frac`` is the
    mean of the per-source drop fractions; ``load`` is the GLOBAL pre-drop
    row count per destination, as single-shard dispatch on the
    concatenated rows gives it."""
    M = mesh.shape[axis]
    if n_dest % M:
        raise ValueError(f"n_dest ({n_dest}) must divide over the {M}-way "
                         f"mesh axis {axis!r}")
    E_loc = n_dest // M
    # local dispatch into per-destination pools, per-source capacity
    bufs, metas = zip(*(relay_dispatch(x, i, n_dest, capacity)
                        for x, i in zip(xs, idxs)))
    # relay hop: shard m's pools (M, E_loc, C, D) split by owner; owner j
    # receives (M, E_loc, C, D), its leading axis the source shard
    recv = mesh.all_to_all(torch.stack([b.reshape(M, E_loc, capacity, -1)
                                        for b in bufs]))
    outs = [backend_fn(p, r.transpose(0, 1).reshape(E_loc, M * capacity, -1))
            for p, r in zip(backend_params, recv)]
    # reverse relay: owner j's results (E_loc, M*C, D') split by source
    back = mesh.all_to_all(torch.stack([
        o.reshape(E_loc, M, capacity, -1).transpose(0, 1) for o in outs]))
    load = mesh.psum(torch.stack([m.load for m in metas]))
    overflow = mesh.psum(torch.stack([m.overflow_frac for m in metas])) / M
    ws = [None] * len(metas) if weights is None else weights
    out = torch.stack([
        relay_combine(b.reshape(n_dest, capacity, -1),
                      m._replace(load=load, overflow_frac=overflow), w)
        for b, m, w in zip(back, metas, ws)])
    stack = lambda f: torch.stack([getattr(m, f) for m in metas])  # noqa
    return out, RelayMeta(stack("idx"), stack("slot"), stack("ok"), load,
                          overflow)


# --------------------------------------------------------------------------- #
# Expert-parallel relay across the ranks of a DeviceMesh
# --------------------------------------------------------------------------- #


def _fc():
    import torch.distributed._functional_collectives as fc
    return fc


def ep_body(x, idx, weights, w_in, w_gate, w_out, *, n_dest: int,
            capacity: int, model_group, model_size: int, dp_groups: tuple,
            backend_fn, slots_fn, gather: bool):
    """One rank's relay: the reference's ``sharded_apply`` body inside its
    ``shard_map``, on this rank's local tensors.

    x (N_loc, D) rows, idx (N_loc,) global destination ids, weights
    (N_loc,) combine scales; ``w_in`` / ``w_gate`` / ``w_out`` this rank's
    ``n_dest // model_size`` experts (with ``gather``, also a slice of
    their D / D dims over the data axes, all-gathered here over
    ``dp_groups``, the minor axis first).  ``slots_fn(idx, n_dest)`` gives
    (slot, load) (``ops.relay_slots``: the relay kernel on the card).  A
    row is dropped against its own rank's ``capacity`` at each
    destination.  Returns (out (N_loc, D'), overflow_frac (), load (E,)):
    the load summed and the overflow averaged over the model group and
    the data groups (the reference's ``psum`` / ``pmean``)."""
    fc = _fc()
    if gather:
        for g in reversed(dp_groups):
            w_in = fc.all_gather_tensor_autograd(w_in, 1, g)
            w_gate = fc.all_gather_tensor_autograd(w_gate, 1, g)
            w_out = fc.all_gather_tensor_autograd(w_out, 2, g)
    M, D = model_size, x.shape[1]
    E_loc = n_dest // M
    slot, load = slots_fn(idx, n_dest)
    buf, meta = relay_dispatch_at(x, idx, slot, load, n_dest, capacity)
    # relay hop: chunk j of (M * E_loc * C, D) (destinations j * E_loc ...)
    # goes to model rank j, which receives one chunk a source rank
    recv = fc.all_to_all_single_autograd(
        buf.reshape(n_dest * capacity, D), None, None, model_group)
    pool = recv.reshape(M, E_loc, capacity, D).transpose(0, 1) \
        .reshape(E_loc, M * capacity, D)
    out = backend_fn({"w_in": w_in, "w_gate": w_gate, "w_out": w_out}, pool)
    # reverse relay: the results back to their source ranks
    out = out.reshape(E_loc, M, capacity, -1).transpose(0, 1) \
        .reshape(n_dest * capacity, -1)
    back = fc.all_to_all_single_autograd(out, None, None, model_group)
    load = fc.wait_tensor(fc.all_reduce(meta.load, "sum", model_group))
    ovf = fc.wait_tensor(fc.all_reduce(meta.overflow_frac, "sum",
                                       model_group)) / M
    for g in dp_groups:
        load = fc.wait_tensor(fc.all_reduce(load, "sum", g))
        ovf = fc.wait_tensor(fc.all_reduce(ovf, "sum", g)) / g.size()
    rows = relay_combine(back.reshape(n_dest, capacity, -1), meta, weights)
    return rows, ovf, load


def ep_relay(x, idx, weights, params: dict, *, mesh, tok_axes: tuple,
             n_dest: int, capacity: int, backend_fn, slots_fn,
             explicit_fsdp: bool = False):
    """The expert-parallel relay over the ``DeviceMesh`` ``mesh``: the
    rows x (N, D), ids and weights sharded over ``tok_axes`` (major to
    minor in the mesh's order; ``"model"`` among them), the experts of
    ``params`` (``w_in`` / ``w_gate`` (E, D, F), ``w_out`` (E, F, D))
    over ``"model"`` and, with ``explicit_fsdp``, their D / D dims over
    the data axes of ``tok_axes``; ``ep_body`` on each rank's shards
    (``local_map``).  Plain tensors count as the same on every rank.
    Returns (out (N, D') sharded as the rows, overflow_frac, load (E,)),
    the last two the same on every rank: DTensors, or plain tensors (the
    rows gathered) where every argument was plain."""
    from repro_torch.kernels.ops import _local_map
    from repro_torch.sharding.specs import is_dtensor
    from torch.distributed.tensor import Partial, Replicate, Shard
    names = mesh.mesh_dim_names
    order = [n for n in names if n in tok_axes]
    if tuple(order) != tuple(tok_axes):
        raise ValueError(f"tok_axes {tok_axes} must be axes of the mesh "
                         f"{names}, in its order")
    dp_axes = tuple(a for a in tok_axes if a != "model")
    gather = explicit_fsdp and bool(dp_axes)
    rows = [Shard(0) if n in tok_axes else Replicate() for n in names]
    rep = [Replicate() for _ in names]

    def experts(dim: int, grad: bool = False) -> list:
        # without the gather, each data rank's rows give a part of the
        # experts' gradient: summed over the data axes
        return [Shard(0) if n == "model" else
                Shard(dim) if gather and n in dp_axes else
                Partial() if grad and n in dp_axes else Replicate()
                for n in names]

    M = mesh["model"].size()
    if n_dest % M:
        raise ValueError(f"n_dest ({n_dest}) must divide over the {M}-way "
                         f"model axis")
    body = functools.partial(
        ep_body, n_dest=n_dest, capacity=capacity,
        model_group=mesh.get_group("model"), model_size=M,
        dp_groups=tuple(mesh.get_group(a) for a in dp_axes),
        backend_fn=backend_fn, slots_fn=slots_fn, gather=gather)
    args = [x, idx, weights, params["w_in"], params["w_gate"],
            params["w_out"]]
    out, ovf, load = _local_map(
        body, args, (rows, rows, rows, experts(1), experts(1), experts(2)),
        (rows, rep, rep), mesh, in_grad_placements=(
            rows, rows, rows, experts(1, True), experts(1, True),
            experts(2, True)))
    if not any(map(is_dtensor, args)):       # plain in, plain out
        return out.full_tensor(), ovf.to_local(), load.to_local()
    return out, ovf, load

"""Request map: stream-id rewriting and response re-ordering (twin of
``repro/core/request_map.py``).

Requests admitted into instance pools get an internal id (instance,
slot); the original request id is stored per slot, and responses return
to request order with one inverse gather.  This is the staged chain: the
engine's fused path commits the pool inside the admission kernel
(``ops.admit_commit``) and never calls ``scatter_to_pool``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import ops


class SlotAssignment(NamedTuple):
    instance: torch.Tensor   # (R,) i32 target instance (-1 unroutable)
    slot: torch.Tensor       # (R,) i32 slot within instance (-1 held)
    ok: torch.Tensor         # (R,) bool admitted


def allocate_slots(instance, free_mask) -> SlotAssignment:
    """Assign each request a free slot on its chosen instance.

    instance: (R,) int (may be -1); free_mask: (I, C) bool, True = free.
    Requests keep arrival order within an instance (the k-th request of an
    instance takes its k-th free slot, lowest slot first); requests beyond
    the free-slot count are held (ok False).
    """
    I, C = free_mask.shape
    instance = instance.to(torch.int64)
    routable = instance >= 0
    inst = torch.where(routable, instance, 0)
    rank, _ = ops.relay_slots(torch.where(routable, inst, I), I + 1)
    free = free_mask.to(torch.bool)
    order = torch.argsort((~free).to(torch.int32), dim=1, stable=True)
    n_free = free.sum(dim=1)
    instc = inst.clamp(0, I - 1)
    rank = rank.to(torch.int64)
    ok = routable & (rank < n_free[instc])
    slot = torch.where(ok, order[instc, rank.clamp(0, C - 1)], -1)
    return SlotAssignment(torch.where(routable, instance, -1)
                          .to(torch.int32), slot.to(torch.int32), ok)


def scatter_to_pool(pool_val, assign: SlotAssignment, values):
    """Write per-request values into (I, C, ...) pool arrays at (inst,
    slot); un-admitted rows go to a dump cell and are dropped, so they
    never collide with a real slot write."""
    I, C = pool_val.shape[:2]
    rest = pool_val.shape[2:]
    cell = torch.where(assign.ok, assign.instance.to(torch.int64) * C
                       + assign.slot.to(torch.int64), I * C)
    flat = torch.cat([pool_val.reshape(I * C, *rest),
                      pool_val.new_zeros((1, *rest))])
    flat.index_put_((cell,), values.to(pool_val.dtype))
    return flat[:I * C].reshape(pool_val.shape)


def gather_responses(pool_val, assign: SlotAssignment, fill=0):
    """Inverse map: read back per-request values from the pool (response
    re-ordering; un-admitted requests get ``fill``)."""
    i = torch.where(assign.ok, assign.instance.to(torch.int64), 0)
    s = torch.where(assign.ok, assign.slot.to(torch.int64), 0)
    out = pool_val[i, s]
    mask = assign.ok.reshape((-1,) + (1,) * (out.dim() - 1))
    return torch.where(mask, out, torch.as_tensor(fill, dtype=out.dtype,
                                                  device=out.device))

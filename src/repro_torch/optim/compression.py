"""Int8 error-feedback gradient compression for the slow cross-pod hop
(twin of ``repro/optim/compression.py``).

Per-tensor symmetric int8 with an f32 residual carried to the next step,
which keeps the compression unbiased over steps (the EF-SGD lineage).
``cross_pod_allreduce`` is the slow hop of a two-stage all-reduce: the
int8 payload summed as int32 over the ranks of the ``pod`` group.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.tree import leaves, map_tree, unflatten


class EFState(NamedTuple):
    residual: Any      # tree like the grads, f32


def init(grads_like) -> EFState:
    return EFState(map_tree(
        lambda g: torch.zeros(g.shape, dtype=torch.float32,
                              device=g.device), grads_like))


def quantize(g: torch.Tensor, res: torch.Tensor):
    """(int8 values, f32 scale, new residual) of g + res."""
    x = g.to(torch.float32) + res
    scale = torch.clamp_min(torch.max(torch.abs(x)), 1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale, x - q.to(torch.float32) * scale


def compress_pytree(grads, ef: EFState):
    """→ (int8 tree, scales tree, new EFState).  The collective payload is
    the int8 tree and one f32 scale a tensor."""
    out = [quantize(g, r) for g, r in zip(leaves(grads),
                                          leaves(ef.residual))]
    q, s, r = (unflatten(grads, [o[i] for o in out]) for i in range(3))
    return q, s, EFState(r)


def decompress_pytree(q, s):
    return map_tree(lambda qi, si: qi.to(torch.float32) * si, q, s)


def cross_pod_allreduce(grads, ef: EFState, axis: str = "pod", *,
                        group=None):
    """The mean of ``grads`` over the pod group with an int8 payload (the
    reference's, inside its ``shard_map``): each rank quantises its
    gradients with error feedback, the int8 values are summed as int32
    (exact), the scales take their max, and each leaf comes back as
    sum x scale / n in f32.  ``group``: the pod axis' process group, or
    a ``DeviceMesh`` with an ``axis`` dimension; None is the default
    group.  Returns (the reduced grads, the new EFState)."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as fc
    if hasattr(group, "get_group"):
        group = group.get_group(axis)
    group = group or dist.group.WORLD
    q, s, ef = compress_pytree(grads, ef)
    n = dist.get_world_size(group)
    q32 = map_tree(lambda x: fc.wait_tensor(fc.all_reduce(
        x.to(torch.int32), "sum", group)), q)
    s = map_tree(lambda x: fc.wait_tensor(fc.all_reduce(x, "max", group)),
                 s)
    return map_tree(lambda qi, si: qi.to(torch.float32) * si / n, q32,
                    s), ef

"""Int8 error-feedback gradient compression for the slow cross-pod hop
(twin of ``repro/optim/compression.py``).

Per-tensor symmetric int8 with an f32 residual carried to the next step,
which keeps the compression unbiased over steps (the EF-SGD lineage).
``cross_pod_allreduce`` needs a second device: it is not ported yet
(ROADMAP.md item 14).
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


def cross_pod_allreduce(grads, ef: EFState, axis: str = "pod"):
    """The int8 all-reduce over the pod axis: needs a mesh of more than
    one device, which the port does not build yet."""
    raise NotImplementedError(
        "cross_pod_allreduce: a collective over more than one device is "
        "not ported yet (ROADMAP.md item 14)")

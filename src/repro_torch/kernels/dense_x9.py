"""The decode's float32 matrix products ``y = x @ W`` as nine exact bf16
products on the tensor cores (``csrc/dense_x9.cu``).

Replaces no TPU kernel: the JAX package leaves these products to XLA.
Each f32 value splits into three bf16 values, ``hi = bf16(v)``, ``mid =
bf16(v - hi)``, ``lo = bf16(v - hi - mid)``, whose sum is ``v`` exactly
(for values in bf16's normal range); a product of two bf16 values is
exact in f32, so the nine products of x's planes with W's sum to ``x @
W`` with no rounding but the f32 accumulation's.

``split_planes`` is the split (W's planes, ``(..., 3, K, N)`` bf16, laid
out like W), ``dense_x9`` the plain nine-product version (f32 matmuls of
the planes, small products first, as the kernel sums them),
``dense_x9_cuda`` the kernel's wrapper.  ``X9Weight`` carries an f32
weight (or a stack of them) with its planes through a params tree:
indexing and ``unbind`` slice both, so ``transformer._layer`` and
``_unstack`` take it as they take a tensor.  ``with_planes`` gives a
params tree planes where the kernel can take them: the self-attention's
projections (``attn``: ``wq``, ``wk``, ``wv``, ``wo``), the dense FFN's
(``ffn``: ``w_in``, ``w_gate``, ``w_out``) and the ``head``, each f32, 2-D
after the stacked axis, of at least ``MIN_ELEMS`` elements, not a
DTensor, with ``K % 4 == 0`` and ``N % 8 == 0`` (TMA's 16-byte strides).
``kernels/ops.py::dense`` decides per call which one runs.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.sharding.specs import is_dtensor

#: (x plane, W plane) of the nine products, the order the kernel sums
#: them in: the smallest first, hi x hi last
ORDER = ((2, 2), (2, 1), (1, 2), (2, 0), (1, 1), (0, 2), (1, 0), (0, 1),
         (0, 0))
#: the least elements of a matrix that gets planes
MIN_ELEMS = 1 << 20
#: the most rows of x a call takes (a decode's batch of lanes)
MAX_ROWS = 256
#: the params-tree names read through ``ops.dense``: weights under these
#: parents, and the top-level head
WEIGHTS = {"attn": ("wq", "wk", "wv", "wo"),
           "ffn": ("w_in", "w_gate", "w_out")}
#: the kernel's tile (rows, columns) and stage depth (csrc/dense_x9.cu)
TILE_M, TILE_N, STAGE_K = 128, 128, 32
#: elements a plane chunk is split in at a time (bounds the temporaries)
_CHUNK = 1 << 24


def split_planes(w: torch.Tensor) -> torch.Tensor:
    """(..., K, N) f32 -> (..., 3, K, N) bf16: hi, mid and lo, whose sum is
    ``w`` exactly for values in bf16's normal range (zeros stay zeros)."""
    hi = w.to(torch.bfloat16)
    r = w - hi.float()
    mid = r.to(torch.bfloat16)
    lo = (r - mid.float()).to(torch.bfloat16)
    return torch.stack([hi, mid, lo], dim=-3)


def fill_planes(w: torch.Tensor, out: torch.Tensor) -> None:
    """``split_planes(w)`` written into ``out`` in place, a chunk of rows
    of one matrix at a time."""
    K, N = w.shape[-2:]
    rows = max(1, _CHUNK // N)
    with torch.no_grad():
        for src, dst in zip(w.reshape(-1, K, N), out.reshape(-1, 3, K, N)):
            for k in range(0, K, rows):
                dst[:, k:k + rows] = split_planes(src[k:k + rows])


def dense_x9(x: torch.Tensor, planes: torch.Tensor) -> torch.Tensor:
    """The plain version: x (..., K) f32 split into planes, the nine
    products with ``planes`` (3, K, N) summed as f32 matmuls in
    ``ORDER``.  Returns (..., N) f32."""
    xp = split_planes(x.unsqueeze(-1)).squeeze(-1)       # (..., 3, K)
    y = None
    for a, b in ORDER:
        term = xp[..., a, :].float() @ planes[b].float()
        y = term if y is None else y + term
    return y


def grid_blocks(M: int, K: int, N: int, sms: int) -> int:
    """Blocks of a launch: one an SM, or one a stage where there are
    fewer stages of work."""
    work = (math.ceil(M / TILE_M) * math.ceil(N / TILE_N)
            * math.ceil(K / STAGE_K))
    return min(sms, work)


def dense_x9_cuda(x: torch.Tensor, planes: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/dense_x9.cu``: x (..., K) f32 on the card against
    ``planes`` (3, K, N) bf16, contiguous; returns (..., N) f32, the
    product split over the SMs and its split tiles summed by a second
    kernel in a fixed order.  Raises on a dtype, shape or layout the
    kernel does not take, if the library cannot be built or the launch
    fails."""
    if x.dtype != torch.float32 or planes.dtype != torch.bfloat16:
        raise ValueError(f"dense_x9 takes f32 x and bf16 planes, got "
                         f"{x.dtype}, {planes.dtype}")
    K, N = planes.shape[-2:]
    if planes.dim() != 3 or planes.shape[0] != 3 or x.shape[-1] != K:
        raise ValueError(f"planes must be (3, K, N) with K = x's last axis "
                         f"{x.shape[-1]}, got {tuple(planes.shape)}")
    if K % 4 or N % 8 or not planes.is_contiguous():
        raise ValueError(f"dense_x9 reads x and the planes with TMA: K % 4 "
                         f"== 0, N % 8 == 0 and contiguous planes; got K="
                         f"{K}, N={N}")
    x2 = x.reshape(-1, K).contiguous()
    M = x2.shape[0]
    dev = x.device
    _build.check_device(dev, planes)
    for name, t in (("x", x2), ("planes", planes)):
        _build.check_16_byte("dense_x9's TMA", name, t)
    lib = _build.library(dev)
    G = grid_blocks(M, K, N, _build.sm_count(dev))
    y = torch.empty((M, N), dtype=torch.float32, device=dev)
    ws = torch.empty((2 * G * TILE_M * TILE_N,), dtype=torch.float32,
                     device=dev)
    p = _build.ptr
    err = lib.xlb_dense_x9(p(x2), p(planes), p(y), p(ws), M, K, N, G,
                           _build.stream(dev))
    _build.check(err, "dense_x9")
    return y.reshape(*x.shape[:-1], N)


class X9Weight:
    """An f32 weight ``w`` (K, N), or a stack (L, K, N), with its bf16
    planes (3, K, N) or (L, 3, K, N).  ``w`` stays the parameter; the
    planes are derived from it (``refresh`` splits it again, in place,
    after an in-place update of ``w``)."""

    __slots__ = ("w", "planes", "version")

    def __init__(self, w: torch.Tensor, planes: torch.Tensor):
        self.w, self.planes = w, planes
        self.version = w._version

    def __getitem__(self, i) -> X9Weight:
        return X9Weight(self.w[i], self.planes[i])

    def unbind(self, dim: int = 0) -> list:
        if dim != 0:
            raise ValueError("an X9Weight unbinds its stacked axis only")
        return [X9Weight(w, p) for w, p in zip(self.w.unbind(0),
                                               self.planes.unbind(0))]

    def refresh(self) -> bool:
        """Split ``w`` again where it changed in place since the planes
        were made; whether it did."""
        if self.w._version == self.version:
            return False
        if self.planes.device.type != "meta":
            fill_planes(self.w, self.planes)
        self.version = self.w._version
        return True


def eligible(w) -> bool:
    """Whether the matrix (or each matrix of the stack) ``w`` gets
    planes."""
    if not isinstance(w, torch.Tensor) or w.dtype != torch.float32 \
            or w.dim() < 2 or is_dtensor(w):
        return False
    K, N = w.shape[-2:]
    return K * N >= MIN_ELEMS and K % 4 == 0 and N % 8 == 0


def _planed(w: torch.Tensor, roots: list) -> X9Weight:
    planes = torch.empty((*w.shape[:-2], 3, *w.shape[-2:]),
                         dtype=torch.bfloat16, device=w.device)
    if w.device.type != "meta":
        fill_planes(w, planes)
    roots.append(X9Weight(w, planes))
    return roots[-1]


def _walk(tree, roots: list, stacked: bool):
    """``tree`` with planes on the weights ``WEIGHTS`` names, 2-D after
    the stacked axis where ``stacked``."""
    if isinstance(tree, list):
        return [_walk(t, roots, stacked) for t in tree]
    if not isinstance(tree, dict):
        return tree
    out = {}
    for k, v in tree.items():
        names = WEIGHTS.get(k, ())
        if isinstance(v, dict) and names:
            v = {n: _planed(t, roots) if n in names and eligible(t)
                 and t.dim() == 2 + stacked else t for n, t in v.items()}
        else:
            v = _walk(v, roots, stacked)
        out[k] = v
    return out


def with_planes(params: dict) -> tuple[dict, list]:
    """(``params`` with an ``X9Weight`` in place of each weight that gets
    planes, the X9Weights made).  The blocks' stacks and deepseek's
    ``first`` layers are walked, the encoder and the embedding are not; a
    leaf of the tree is shared, never copied.  On the meta device only
    shapes are made."""
    roots: list = []
    out = dict(params)
    if "blocks" in out:
        out["blocks"] = _walk(out["blocks"], roots, True)
    if "first" in out:
        out["first"] = _walk(out["first"], roots, False)
    if eligible(out.get("head")) and out["head"].dim() == 2:
        out["head"] = _planed(out["head"], roots)
    return out, roots

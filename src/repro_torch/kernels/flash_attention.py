"""GQA prefill attention, causal or not (twin of
``repro/kernels/flash_attention.py``; semantics of
``repro/kernels/ref.py::flash_attention_ref``).

``flash_attention`` here is the plain PyTorch version (the full score
matrix); ``flash_attention_cuda`` launches ``csrc/flash_attention.cu``
(online softmax over KV tiles): for bf16 a tensor-core kernel (wgmma, TMA),
for f32 an FMA kernel on the CUDA cores; at hd 16 (the smoke configs) the
FMA kernel in both dtypes.  ``kernels/ops.py`` picks one by
the tensors' device.  Both compute the reference function: the Pallas
kernel's skip of KV blocks with ``qi * block_q < ki * block_k`` drops
valid keys when ``block_q > block_k``, and neither port version has it.

``flash_attention_vjp`` is the gradient the training path takes (through
the autograd Function in ``kernels/ops.py``): the reference has no
backward kernel, and its gradient is JAX's autodiff of the plain
``models/attention.py::sdpa``, so this recomputes that function in plain
PyTorch from the saved inputs, ``VJP_Q_CHUNK`` query rows at a time (or
the caller's ``q_chunk``), and returns its vector-Jacobian product.
``flash_attention_chunked`` is the plain forward over query chunks.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
#: head dims the kernels are built for
HEAD_DIMS = (16, 32, 64, 128)
#: head dims whose bf16 calls run on the tensor cores (the rest: FMAs)
TC_HEAD_DIMS = (32, 64, 128)
#: query rows the backward recomputes at a time: one (B, H, 512, S) f32
#: score slab alive (the reference's ``q_chunk`` up to S 8192)
VJP_Q_CHUNK = 512


def flash_attention(q, k, v, *, causal: bool = True) -> torch.Tensor:
    """q: (B, S, H, hd); k/v: (B, S, K, hd) with H = K * G.  Returns
    (B, S, H, hd) in q's dtype; scores (scaled by 1/sqrt(hd)), softmax
    and sums in f32."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(B, S, K, H // K, hd).to(torch.float32)
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k.to(torch.float32)) * scale
    if causal:
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", w, v.to(torch.float32))
    return out.reshape(B, S, H, hd).to(q.dtype)


def attention_rows(q, k, v, offset: int, *, causal: bool):
    """The reference's ``sdpa`` over query rows ``offset`` on: q
    (B, CQ, H, hd) against k/v (B, Skv, K, hd).  Scores in the inputs'
    dtype, then scaled, masked (key position > query position, with
    ``causal``) and softmaxed in f32; the weights cast back to v's dtype
    for the sum (``repro/models/attention.py::sdpa``'s ``block``)."""
    B, CQ, H, hd = q.shape
    K = k.shape[2]
    qg = q.reshape(B, CQ, K, H // K, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k).float() * (
        1.0 / math.sqrt(hd))
    if causal:
        qpos = offset + torch.arange(CQ, device=q.device)[:, None]
        kpos = torch.arange(k.shape[1], device=q.device)[None, :]
        s = s.masked_fill(kpos > qpos, NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", w.to(v.dtype), v)
    return out.reshape(B, CQ, H, v.shape[-1])


def flash_attention_chunked(q, k, v, q_chunk: int, *, causal: bool):
    """``attention_rows`` over ``q_chunk`` query rows at a time (causal
    rows read only the keys they see): the reference's ``sdpa`` with
    ``q_chunk``, one (B, H, q_chunk, S) f32 score slab alive at once."""
    S = q.shape[1]
    return torch.cat([
        attention_rows(q[:, i:i + q_chunk],
                       k[:, :i + q_chunk] if causal else k,
                       v[:, :i + q_chunk] if causal else v, i,
                       causal=causal)
        for i in range(0, S, q_chunk)], dim=1)


def flash_attention_vjp(q, k, v, dout, *, causal: bool,
                        q_chunk: int = VJP_Q_CHUNK):
    """(dq, dk, dv) of ``attention_rows`` over all of q at ``dout``, in
    the inputs' dtypes: recomputed under autograd ``q_chunk`` query rows
    at a time (causal rows read only the keys they see), dk and dv summed
    over the chunks in f32."""
    S = q.shape[1]
    dq = torch.empty_like(q)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    for i in range(0, S, q_chunk):
        j = min(i + q_chunk, S)
        n = j if causal else k.shape[1]
        with torch.enable_grad():
            qc, kc, vc = (t.detach().requires_grad_()
                          for t in (q[:, i:j], k[:, :n], v[:, :n]))
            out = attention_rows(qc, kc, vc, i, causal=causal)
            gq, gk, gv = torch.autograd.grad(out, (qc, kc, vc),
                                             dout[:, i:j])
        dq[:, i:j] = gq
        dk[:, :n] += gk
        dv[:, :n] += gv
    return dq, dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_cuda(q, k, v, *, causal: bool = True) -> torch.Tensor:
    """Launch ``csrc/flash_attention.cu`` on the tensors' CUDA device; same
    contract and result as ``flash_attention``.  Inputs are read through
    their strides (last axis contiguous).

    bf16 at hd in ``TC_HEAD_DIMS`` runs on the tensor cores
    (``flash_kernel_wgmma``: P rounded to bf16 before P V, sums in f32)
    and reads q, k and v with TMA: 16-byte aligned bases and strides of
    16-byte multiples.  f32, and bf16 at hd 16, run as f32 FMAs
    (``flash_kernel``): TF32 tensor cores would miss the f32 tolerance of
    2e-5.  The kernel is picked by (dtype, hd) before the launch; none
    falls back to another or to the plain version.  Raises on a shape,
    dtype, head dim or layout the kernels do not take, if the library
    cannot be built or the launch fails."""
    B, S, H, hd = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[:2] != (B, S) \
            or k.shape[3] != hd:
        raise ValueError(f"k and v must be (B, S, K, hd) = ({B}, {S}, K, "
                         f"{hd}), got {tuple(k.shape)}, {tuple(v.shape)}")
    K = k.shape[2]
    if S == 0 or H % K or hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention takes S > 0, H a multiple of K "
                         f"and hd in {HEAD_DIMS}; got S={S}, H={H}, K={K}, "
                         f"hd={hd}")
    if q.dtype not in _build.DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"q, k and v must share one of "
                         f"{list(_build.DTYPE_CODES)}, got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("the last axis of q, k and v must be contiguous")
    if q.dtype == torch.bfloat16 and hd in TC_HEAD_DIMS:
        for name, t in (("q", q), ("k", k), ("v", v)):
            _build.check_16_byte("bf16 flash_attention's TMA", name, t)
    dev = q.device
    _build.check_device(dev, k, v)
    lib = _build.library(dev)
    out = torch.empty((B, S, H, hd), dtype=q.dtype, device=dev)
    p = _build.ptr
    err = lib.xlb_flash_attention(
        p(q), p(k), p(v), p(out), B, S, H, K, hd,
        _build.DTYPE_CODES[q.dtype], int(causal),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3], 1.0 / math.sqrt(hd), _build.stream(dev))
    _build.check(err, "flash_attention")
    return out

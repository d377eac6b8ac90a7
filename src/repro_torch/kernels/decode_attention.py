"""One-token GQA decode attention against a KV cache (twin of
``repro/kernels/decode_attention.py``; semantics of
``repro/kernels/ref.py::decode_attention_ref``).

``decode_attention`` here is the plain PyTorch version;
``decode_attention_cuda`` launches ``csrc/decode_attention.cu``.
``kernels/ops.py`` picks one by the tensors' device.  Query head ``h``
reads KV head ``h // G``; the new token of sequence ``b`` sits at
position ``lengths[b]`` (already written into the cache) and attends to
every key at ``kpos <= lengths[b]``.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
#: head dims the kernel is built for (any number of query heads per KV
#: head: the kernel walks them in passes)
HEAD_DIMS = (16, 32, 64, 128)
#: a split of the key axis is a multiple of this many keys, itself a
#: multiple of the keys one block walks per step (4 warps x 32 /
#: (hd * size / 16) rows x 4 rows in flight: 16 to 128)
_TILE = 128
_BLOCKS_PER_SM = 4  # blocks that keep enough bytes in flight on an SM


def decode_attention(q, k_cache, v_cache, lengths) -> torch.Tensor:
    """q: (B, H, hd); k/v_cache: (B, S, K, hd); lengths: (B,).  Returns
    (B, H, hd) in q's dtype; scores (scaled by 1/sqrt(hd)), softmax and
    sums in f32."""
    B, H, hd = q.shape
    S, K = k_cache.shape[1], k_cache.shape[2]
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(B, K, H // K, hd).to(torch.float32)
    s = torch.einsum("bkgh,bskh->bkgs", qg,
                     k_cache.to(torch.float32)) * scale
    kpos = torch.arange(S, device=q.device)
    mask = kpos[None, :] <= lengths.to(kpos.dtype)[:, None]     # (B, S)
    s = torch.where(mask[:, None, None], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskh->bkgh", w, v_cache.to(torch.float32))
    return out.reshape(B, H, hd).to(q.dtype)


def _splits(pairs: int, S: int, sms: int) -> tuple[int, int]:
    """(keys per split, number of splits) of the key axis: enough blocks
    for _BLOCKS_PER_SM per SM where the (sequence, KV head) pairs alone are
    fewer, splits a multiple of _TILE keys."""
    want = _BLOCKS_PER_SM * sms
    n = 1 if pairs >= want else min(-(-want // pairs), -(-S // _TILE))
    split_len = -(-S // (n * _TILE)) * _TILE
    return split_len, -(-S // split_len)


def decode_attention_cuda(q, k_cache, v_cache, lengths) -> torch.Tensor:
    """Launch ``csrc/decode_attention.cu`` on the tensors' CUDA device; same
    contract and result as ``decode_attention``.  The caches are read in
    place through their strides, in 16-byte loads: their last axis must be
    contiguous, their base 16-byte aligned and their strides multiples of
    16 bytes.  Raises on a shape, dtype, head dim or layout the kernel does
    not take, if the library cannot be built or the launch fails."""
    B, H, hd = q.shape
    if k_cache.dim() != 4 or k_cache.shape != v_cache.shape \
            or k_cache.shape[0] != B or k_cache.shape[3] != hd:
        raise ValueError(f"caches must be (B, S, K, hd) = (B, S, K, {hd}), "
                         f"got {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)}")
    S, K = k_cache.shape[1], k_cache.shape[2]
    if S == 0 or H % K or hd not in HEAD_DIMS:
        raise ValueError(f"decode_attention takes S > 0, H a multiple of K "
                         f"and hd in {HEAD_DIMS}; got S={S}, H={H}, K={K}, "
                         f"hd={hd}")
    if q.dtype not in _build.DTYPE_CODES or k_cache.dtype != q.dtype \
            or v_cache.dtype != q.dtype:
        raise ValueError(f"q and caches must share one of "
                         f"{list(_build.DTYPE_CODES)}, got {q.dtype}, "
                         f"{k_cache.dtype}, {v_cache.dtype}")
    if k_cache.stride(3) != 1 or v_cache.stride(3) != 1:
        raise ValueError("the caches' last axis must be contiguous")
    for name, c in (("k_cache", k_cache), ("v_cache", v_cache)):
        _build.check_16_byte("decode_attention", name, c)
    if lengths.shape != (B,):
        raise ValueError(f"lengths must be ({B},), got {tuple(lengths.shape)}")
    dev = q.device
    _build.check_device(dev, k_cache, v_cache, lengths)
    lib = _build.library(dev)
    qc = q.contiguous()
    lens = lengths.to(torch.int32).contiguous()
    split_len, n_split = _splits(B * K, S, _build.sm_count(dev))
    G = H // K
    out = torch.empty((B, H, hd), dtype=q.dtype, device=dev)
    n_part = B * K * n_split * G if n_split > 1 else 0
    part_acc = torch.empty((n_part * hd,), dtype=torch.float32, device=dev)
    part_ml = torch.empty((n_part * 2,), dtype=torch.float32, device=dev)
    p = _build.ptr
    err = lib.xlb_decode_attention(
        p(qc), p(k_cache), p(v_cache), p(lens), p(out), p(part_acc),
        p(part_ml), B, H, K, S, hd, _build.DTYPE_CODES[q.dtype],
        qc.stride(0), qc.stride(1), k_cache.stride(0), k_cache.stride(1),
        k_cache.stride(2), v_cache.stride(0), v_cache.stride(1),
        v_cache.stride(2), split_len, n_split, 1.0 / math.sqrt(hd),
        _build.stream(dev))
    _build.check(err, "decode_attention")
    return out

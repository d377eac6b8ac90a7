"""GQA attention for one-token decode (twin of the GQA parts of
``repro/models/attention.py``).

Weights are flat on the head axis (``wq: (D, H*hd)``); caches are
``(B, S, K, hd)`` per layer.  Attention is plain fp32 matmul + softmax,
as the reference's ``sdpa`` computes it; there is no attention kernel on
this path.  Unlike the reference, ``gqa_decode`` writes the new K/V into
the cache in place (the engine owns the cache; no copy per step).
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import Params, apply_rope, dense_init

NEG_INF = -1e30


def init_gqa(generator, cfg: ModelConfig, dtype, device) -> Params:
    D, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {"wq": dense_init((D, H * hd), generator, dtype, device),
            "wk": dense_init((D, K * hd), generator, dtype, device),
            "wv": dense_init((D, K * hd), generator, dtype, device),
            "wo": dense_init((H * hd, D), generator, dtype, device)}


def init_gqa_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                   device) -> Params:
    K, hd = cfg.n_kv_heads, cfg.head_dim
    z = lambda: torch.zeros((batch, max_len, K, hd), dtype=dtype,
                            device=device)
    return {"k": z(), "v": z()}


def make_decode_mask(lengths, Skv: int):
    """Decode: new token at position ``lengths`` attends to kpos <= lengths."""
    kpos = torch.arange(Skv, device=lengths.device)[None, :]
    return (kpos <= lengths[:, None])[:, None, None]      # (B,1,1,Skv)


def _sdpa_masked(q, k, v, scale, mask):
    """q:(B,Sq,H,hd) k/v:(B,Skv,K,hd), fp32 softmax under an explicit
    (B,1,Sq,Skv) mask."""
    B, Sq, H, hd = q.shape
    K = k.shape[2]
    qg = q.reshape(B, Sq, K, H // K, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg, k).to(torch.float32)
    scores = scores * scale
    scores = torch.where(mask[:, :, None], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", w.to(v.dtype), v)
    return out.reshape(B, Sq, H, v.shape[-1])


def gqa_decode(cfg: ModelConfig, p: Params, x, lengths, cache: Params):
    """One-token decode. x:(B,1,D); cache k/v:(B,S,K,hd); lengths:(B,).

    Writes K/V at ``lengths`` in place; an index past the cache raises
    (the CPU) or device-asserts (CUDA) — the completion rule keeps active
    lengths <= max_len - 2, so it never happens on the serving path.
    """
    B = x.shape[0]
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(B, 1, H, hd)
    k = (x @ p["wk"]).reshape(B, 1, K, hd)
    v = (x @ p["wv"]).reshape(B, 1, K, hd)
    pos = lengths[:, None]
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    b = torch.arange(B, device=x.device)
    idx = lengths.to(torch.int64)
    cache["k"].index_put_((b, idx), k[:, 0].to(cache["k"].dtype))
    cache["v"].index_put_((b, idx), v[:, 0].to(cache["v"].dtype))
    mask = make_decode_mask(lengths, cache["k"].shape[1])
    scale = 1.0 / math.sqrt(hd)
    out = _sdpa_masked(q, cache["k"], cache["v"], scale, mask)
    return out.reshape(B, 1, H * hd) @ p["wo"], cache

"""GQA attention for prefill and one-token decode (twin of the GQA parts of
``repro/models/attention.py``).

Weights are flat on the head axis (``wq: (D, H*hd)``); caches are
``(B, S, K, hd)`` per layer.  Prefill attention runs through
``ops.flash_attention`` and decode attention through
``ops.decode_attention``: the hand-written kernels on the card, their
plain versions on the CPU.  Unlike the reference, the caches are written
in place (the caller owns them; no copy per step or per layer).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import Params, apply_rope, dense_init


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


def _qkv(cfg: ModelConfig, p: Params, x, positions):
    """Projections and rope: q (B, S, H, hd), k/v (B, S, K, hd)."""
    B, S, _ = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(B, S, H, hd)
    k = (x @ p["wk"]).reshape(B, S, K, hd)
    v = (x @ p["wv"]).reshape(B, S, K, hd)
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def gqa_full(cfg: ModelConfig, p: Params, x, positions, *,
             cache: Params | None = None):
    """Full-sequence causal self-attention (prefill).  x: (B, S, D);
    positions broadcastable to (B, S).  With ``cache``, K/V are written
    into it at offset 0 (in place, when S fits, as the reference's
    ``dynamic_update_slice`` does).  Returns (out, cache)."""
    B, S, _ = x.shape
    q, k, v = _qkv(cfg, p, x, positions)
    out = ops.flash_attention(q, k, v, causal=True)
    if cache is not None and S <= cache["k"].shape[1]:
        cache["k"][:, :S] = k.to(cache["k"].dtype)
        cache["v"][:, :S] = v.to(cache["v"].dtype)
    return out.reshape(B, S, -1) @ p["wo"], cache


def gqa_decode(cfg: ModelConfig, p: Params, x, lengths, cache: Params):
    """One-token decode. x:(B,1,D); cache k/v:(B,S,K,hd); lengths:(B,).

    Writes K/V at ``lengths`` in place; an index past the cache raises
    (the CPU) or device-asserts (CUDA) — the completion rule keeps active
    lengths <= max_len - 2, so it never happens on the serving path.
    """
    B = x.shape[0]
    q, k, v = _qkv(cfg, p, x, lengths[:, None])
    b = torch.arange(B, device=x.device)
    idx = lengths.to(torch.int64)
    cache["k"].index_put_((b, idx), k[:, 0].to(cache["k"].dtype))
    cache["v"].index_put_((b, idx), v[:, 0].to(cache["v"].dtype))
    out = ops.decode_attention(q[:, 0], cache["k"], cache["v"], lengths)
    return out.reshape(B, 1, -1) @ p["wo"], cache

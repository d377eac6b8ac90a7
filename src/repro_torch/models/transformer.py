"""Block composition for decode (twin of the dense parts of
``repro/models/transformer.py``).  The reference scans over layers with
``lax.scan``; here a Python loop walks the stacked layer params."""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import Params, ffn, init_ffn, rms_norm


def _init_attn_layer(generator, cfg: ModelConfig, dtype, device) -> Params:
    ones = lambda: torch.ones((cfg.d_model,), dtype=dtype, device=device)
    return {"norm1": ones(),
            "attn": attn.init_gqa(generator, cfg, dtype, device),
            "norm2": ones(),
            "ffn": init_ffn(generator, cfg.d_model, cfg.d_ff, cfg.ffn_act,
                            dtype, device)}


def _attn_layer_decode(cfg: ModelConfig, lp: Params, x, lengths, cache):
    h, kv = attn.gqa_decode(cfg, lp["attn"],
                            rms_norm(x, lp["norm1"], cfg.norm_eps), lengths,
                            cache["self"])
    x = x + h
    h = ffn(lp["ffn"], rms_norm(x, lp["norm2"], cfg.norm_eps), cfg.ffn_act)
    return x + h, {"self": kv}


def _layer(tree, i: int):
    """Layer ``i`` of a tree stacked on a leading layer axis."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def stack_decode(cfg: ModelConfig, stacked: Params, x, lengths, caches):
    """Decode through every stacked layer in turn.  ``caches`` is stacked
    the same way and updated in place (layer ``i`` writes a view of it).
    Returns (x, caches)."""
    for i in range(cfg.n_layers):
        x, _ = _attn_layer_decode(cfg, _layer(stacked, i), x, lengths,
                                  _layer(caches, i))
    return x, caches

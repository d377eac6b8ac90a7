"""Block composition for prefill and decode (twin of the dense and ssm
parts of ``repro/models/transformer.py``).  The reference scans over
layers with ``lax.scan``; here a Python loop walks the stacked layer
params, and the stacked caches are updated in place layer by layer."""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import Params, ffn, init_ffn, rms_norm


def _ones(cfg: ModelConfig, dtype, device):
    return torch.ones((cfg.d_model,), dtype=dtype, device=device)


def _init_attn_layer(generator, cfg: ModelConfig, dtype, device) -> Params:
    return {"norm1": _ones(cfg, dtype, device),
            "attn": attn.init_gqa(generator, cfg, dtype, device),
            "norm2": _ones(cfg, dtype, device),
            "ffn": init_ffn(generator, cfg.d_model, cfg.d_ff, cfg.ffn_act,
                            dtype, device)}


def _init_mamba_layer(generator, cfg: ModelConfig, dtype, device) -> Params:
    """A mamba block, with a dense FFN where ``d_ff > 0`` (the reduced
    configs have one; mamba2-2.7b does not)."""
    p = {"norm1": _ones(cfg, dtype, device),
         "mamba": ssm_mod.init_mamba(generator, cfg, dtype, device)}
    if cfg.d_ff > 0:
        p["norm2"] = _ones(cfg, dtype, device)
        p["ffn"] = init_ffn(generator, cfg.d_model, cfg.d_ff, cfg.ffn_act,
                            dtype, device)
    return p


def _ffn_residual(cfg: ModelConfig, lp: Params, x):
    if "ffn" not in lp:
        return x
    return x + ffn(lp["ffn"], rms_norm(x, lp["norm2"], cfg.norm_eps),
                   cfg.ffn_act)


def _attn_layer_full(cfg: ModelConfig, lp: Params, x, positions, cache):
    h, _ = attn.gqa_full(cfg, lp["attn"],
                         rms_norm(x, lp["norm1"], cfg.norm_eps), positions,
                         cache=cache["self"])
    return _ffn_residual(cfg, lp, x + h)


def _attn_layer_decode(cfg: ModelConfig, lp: Params, x, lengths, cache):
    h, _ = attn.gqa_decode(cfg, lp["attn"],
                           rms_norm(x, lp["norm1"], cfg.norm_eps), lengths,
                           cache["self"])
    return _ffn_residual(cfg, lp, x + h)


def _mamba_layer_full(cfg: ModelConfig, lp: Params, x):
    h, st = ssm_mod.mamba_mixer(cfg, lp["mamba"],
                                rms_norm(x, lp["norm1"], cfg.norm_eps))
    return _ffn_residual(cfg, lp, x + h), st


def _mamba_layer_decode(cfg: ModelConfig, lp: Params, x, state):
    h, st = ssm_mod.mamba_decode(cfg, lp["mamba"],
                                 rms_norm(x, lp["norm1"], cfg.norm_eps),
                                 state)
    return _ffn_residual(cfg, lp, x + h), st


def _layer(tree, i: int):
    """Layer ``i`` of a tree stacked on a leading layer axis."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(_layer(v, i) for v in tree))
    return tree[i]


def _store(stacked: ssm_mod.SSMState, i: int, st: ssm_mod.SSMState):
    stacked.ssm[i].copy_(st.ssm)
    stacked.conv[i].copy_(st.conv)


def stack_prefill(cfg: ModelConfig, stacked: Params, x, positions, caches):
    """Prefill through every stacked layer in turn.  Attention layers write
    their K/V into ``caches`` at offset 0; mamba layers store their final
    SSM state and conv window.  Returns (x, caches), updated in place."""
    for i in range(cfg.n_layers):
        lp = _layer(stacked, i)
        if cfg.attn_free:
            x, st = _mamba_layer_full(cfg, lp, x)
            _store(caches, i, st)
        else:
            x = _attn_layer_full(cfg, lp, x, positions, _layer(caches, i))
    return x, caches


def stack_decode(cfg: ModelConfig, stacked: Params, x, lengths, caches):
    """Decode through every stacked layer in turn.  ``caches`` is stacked
    the same way and updated in place (attention layers write a view of
    it).  Returns (x, caches)."""
    for i in range(cfg.n_layers):
        lp = _layer(stacked, i)
        if cfg.attn_free:
            x, st = _mamba_layer_decode(cfg, lp, x, _layer(caches, i))
            _store(caches, i, st)
        else:
            x = _attn_layer_decode(cfg, lp, x, lengths, _layer(caches, i))
    return x, caches

"""Block composition for prefill and decode (twin of
``repro/models/transformer.py`` without the encoder-decoder parts).

  dense / vlm       block = [attn + dense FFN]                  × L
  moe (deepseek)    [MLA attn + dense FFN] × first_dense (unstacked,
                    ``model.py``), block = [MLA attn + MoE FFN] × the rest
  moe (arctic)      block = [attn + MoE ∥ dense residual]       × L
  ssm (mamba2)      block = [mamba mixer (+ FFN where d_ff > 0)] × L
  hybrid (jamba)    block = one period of ``attn_period`` layers: mamba
                    but attention at ``attn_pos``, the FFN MoE on odd
                    layers                                      × L / period

The reference scans over blocks with ``lax.scan``; here a Python loop
walks the stacked block params, and the stacked caches are updated in
place block by block.  Prefill and decode return the blocks' MoE metrics
merged as the reference's ``stack_apply`` merges them (None for an arch
without MoE layers)."""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import Draw, Params, ffn, init_ffn, rms_norm


def _is_moe_layer(cfg: ModelConfig, i: int) -> bool:
    m = cfg.moe
    return (m.enabled and i >= m.first_dense
            and i % m.moe_every == m.moe_offset)


def _init_ffn_part(draw: Draw, cfg: ModelConfig, is_moe: bool) -> Params:
    if is_moe:
        return {"moe": moe_mod.init_moe(draw, cfg)}
    return {"ffn": init_ffn(draw, cfg.d_model, cfg.d_ff, cfg.ffn_act)}


def _init_attn_layer(draw: Draw, cfg: ModelConfig,
                     is_moe: bool = False) -> Params:
    return {"norm1": draw.ones((cfg.d_model,)),
            "attn": attn.init_attn(draw, cfg),
            "norm2": draw.ones((cfg.d_model,)),
            **_init_ffn_part(draw, cfg, is_moe)}


def _init_mamba_layer(draw: Draw, cfg: ModelConfig, with_ffn: bool,
                      is_moe: bool = False) -> Params:
    p = {"norm1": draw.ones((cfg.d_model,)),
         "mamba": ssm_mod.init_mamba(draw, cfg)}
    if with_ffn:
        p["norm2"] = draw.ones((cfg.d_model,))
        p.update(_init_ffn_part(draw, cfg, is_moe))
    return p


def _init_jamba_period(draw: Draw, cfg: ModelConfig) -> Params:
    """One period: mamba at every position but ``attn_pos``, attention
    there; the FFN is MoE where ``_is_moe_layer`` says (the parity of a
    position is that of its global layer)."""
    return {f"pos{i}": (_init_attn_layer(draw, cfg, _is_moe_layer(cfg, i))
                        if i == cfg.attn_pos else
                        _init_mamba_layer(draw, cfg, True,
                                          _is_moe_layer(cfg, i)))
            for i in range(cfg.attn_period)}


# --------------------------------------------------------------------------- #
# Layer apply
# --------------------------------------------------------------------------- #


def _apply_ffn(cfg: ModelConfig, lp: Params, x):
    if "moe" in lp:
        return moe_mod.moe_ffn(cfg, lp["moe"], x)
    return ffn(lp["ffn"], x, cfg.ffn_act), None


def _ffn_residual(cfg: ModelConfig, lp: Params, x):
    """x + the layer's FFN (dense or MoE) of norm2(x), and its metrics;
    x itself for a mamba layer without an FFN."""
    if "norm2" not in lp:
        return x, None
    h, metrics = _apply_ffn(cfg, lp, rms_norm(x, lp["norm2"], cfg.norm_eps))
    return x + h, metrics


def _attn_layer_full(cfg: ModelConfig, lp: Params, x, positions, cache):
    h, _ = attn.attn_full(cfg, lp["attn"],
                          rms_norm(x, lp["norm1"], cfg.norm_eps), positions,
                          cache=cache)
    return _ffn_residual(cfg, lp, x + h)


def _attn_layer_decode(cfg: ModelConfig, lp: Params, x, lengths, cache):
    h, _ = attn.attn_decode(cfg, lp["attn"],
                            rms_norm(x, lp["norm1"], cfg.norm_eps), lengths,
                            cache)
    return _ffn_residual(cfg, lp, x + h)


def _mamba_layer_full(cfg: ModelConfig, lp: Params, x):
    h, st = ssm_mod.mamba_mixer(cfg, lp["mamba"],
                                rms_norm(x, lp["norm1"], cfg.norm_eps))
    x, metrics = _ffn_residual(cfg, lp, x + h)
    return x, st, metrics


def _mamba_layer_decode(cfg: ModelConfig, lp: Params, x, state):
    h, st = ssm_mod.mamba_decode(cfg, lp["mamba"],
                                 rms_norm(x, lp["norm1"], cfg.norm_eps),
                                 state)
    x, metrics = _ffn_residual(cfg, lp, x + h)
    return x, st, metrics


def _mean_metrics(ms) -> moe_mod.MoEMetrics:
    """Means of the scalars and the sum of the loads of a non-empty list."""
    n = len(ms)
    return moe_mod.MoEMetrics(
        aux_loss=sum(m.aux_loss for m in ms) / n,
        z_loss=sum(m.z_loss for m in ms) / n,
        overflow_frac=sum(m.overflow_frac for m in ms) / n,
        load=sum(m.load for m in ms))


def _merge_metrics(cfg: ModelConfig, ms, device):
    """The metrics of one block's MoE layers; zeros for a block without
    one (the stack's means count it, as the reference's do)."""
    ms = [m for m in ms if m is not None]
    if not ms:
        return moe_mod.MoEMetrics.zero(cfg.moe.n_experts, device)
    return _mean_metrics(ms)


def _layer(tree, i: int):
    """Layer ``i`` of a tree stacked on a leading layer axis."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(_layer(v, i) for v in tree))
    return tree[i]


def _store(dst: ssm_mod.SSMState, st: ssm_mod.SSMState):
    """Copy a layer's new state into its views of the stacked cache."""
    for t, s in zip(dst, st):
        t.copy_(s)


def _n_blocks(stacked: Params) -> int:
    t = stacked
    while isinstance(t, dict):
        t = next(iter(t.values()))
    return t.shape[0]


def _hybrid_block(cfg: ModelConfig, bp: Params, x, cache, *, positions=None,
                  lengths=None):
    """One jamba period (prefill with ``positions``, decode with
    ``lengths``): attention at ``attn_pos`` on ``cache["attn"]``, the
    mamba layers on ``cache["ssm"]``, indexed by their position with the
    attention position skipped."""
    ms = []
    for pos in range(cfg.attn_period):
        lp = bp[f"pos{pos}"]
        if pos == cfg.attn_pos:
            if lengths is None:
                x, m = _attn_layer_full(cfg, lp, x, positions, cache["attn"])
            else:
                x, m = _attn_layer_decode(cfg, lp, x, lengths, cache["attn"])
        else:
            state = _layer(cache["ssm"],
                           pos if pos < cfg.attn_pos else pos - 1)
            if lengths is None:
                x, st, m = _mamba_layer_full(cfg, lp, x)
            else:
                x, st, m = _mamba_layer_decode(cfg, lp, x, state)
            _store(state, st)
        ms.append(m)
    return x, ms


def _block(cfg: ModelConfig, bp: Params, x, cache, *, positions=None,
           lengths=None):
    """One block of any family; returns (x, the MoE layers' metrics)."""
    if cfg.is_hybrid:
        return _hybrid_block(cfg, bp, x, cache, positions=positions,
                             lengths=lengths)
    if cfg.attn_free:
        if lengths is None:
            x, st, m = _mamba_layer_full(cfg, bp, x)
        else:
            x, st, m = _mamba_layer_decode(cfg, bp, x, cache)
        _store(cache, st)
        return x, [m]
    if lengths is None:
        x, m = _attn_layer_full(cfg, bp, x, positions, cache["self"])
    else:
        x, m = _attn_layer_decode(cfg, bp, x, lengths, cache["self"])
    return x, [m]


def _stack(cfg: ModelConfig, stacked: Params, x, caches, **kw):
    per_block = []
    for i in range(_n_blocks(stacked)):
        x, ms = _block(cfg, _layer(stacked, i), x, _layer(caches, i), **kw)
        if cfg.moe.enabled:
            per_block.append(_merge_metrics(cfg, ms, x.device))
    return x, caches, _mean_metrics(per_block) if per_block else None


def stack_prefill(cfg: ModelConfig, stacked: Params, x, positions, caches):
    """Prefill through every stacked block in turn.  Attention layers write
    their K/V (or MLA latents) into ``caches`` at offset 0; mamba layers
    store their final SSM state and conv window.  Returns (x, caches,
    metrics), the caches updated in place."""
    return _stack(cfg, stacked, x, caches, positions=positions)


def stack_decode(cfg: ModelConfig, stacked: Params, x, lengths, caches):
    """Decode through every stacked block in turn; ``caches`` is stacked
    the same way and updated in place.  Returns (x, caches, metrics)."""
    return _stack(cfg, stacked, x, caches, lengths=lengths)

"""Block composition for training, prefill and decode (twin of
``repro/models/transformer.py``).

  dense / vlm       block = [attn + dense FFN]                  × L
  moe (deepseek)    [MLA attn + dense FFN] × first_dense (unstacked,
                    ``model.py``), block = [MLA attn + MoE FFN] × the rest
  moe (arctic)      block = [attn + MoE ∥ dense residual]       × L
  ssm (mamba2)      block = [mamba mixer (+ FFN where d_ff > 0)] × L
  hybrid (jamba)    block = one period of ``attn_period`` layers: mamba
                    but attention at ``attn_pos``, the FFN MoE on odd
                    layers                                      × L / period
  audio (whisper)   encoder block = [full attn + gelu FFN]      × n_enc,
                    decoder block = [causal attn + cross-attn + gelu FFN]
                                                                × L

The reference scans over blocks with ``lax.scan``; here a Python loop
walks the stacked block params (``unbind``: one gradient per stack, not
one per layer), and in prefill and decode the stacked caches are updated
in place block by block.  Training (``stack_train``) passes no cache,
keeps no state and writes nothing in place.  Every mode returns the
blocks' MoE metrics merged as the reference's ``stack_apply`` merges
them (None for an arch without MoE layers).

A ``RunCtx`` carries the reference's per-call knobs through every layer:
``remat="block"`` runs each block of a stack under
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` of its
scan body), ``moe_method`` and ``ep`` / ``explicit_fsdp`` reach
``moe.moe_ffn``, ``q_chunk`` (or ``_auto_q_chunk``'s rule) and
``tp_size`` (``_expand_kv``) reach the attention, and ``shard(x, kind)``
is called at each of the reference's places (``"resid"`` around every
residual add of the full-sequence layers; none in decode, as there)."""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import Draw, Params, ffn, init_ffn, rms_norm


def Identity(x, kind=None):
    """The default ``shard``: every tensor left where it is."""
    return x


@dataclasses.dataclass(frozen=True)
class RunCtx:
    """Per-call runtime knobs threaded through the stack (the reference's
    eight fields and defaults).

    ``shard``: (x, kind) -> x, a layout constraint at the reference's
    places (``sharding/specs.py::MeshSpec.constrain`` redistributes a
    DTensor, and leaves any other tensor as it is).  ``remat``: "none" |
    "block".  ``moe_method``: "sort" | "cumsum" | "einsum".  ``ep``:
    (DeviceMesh, token axes) for the expert-parallel relay.
    ``scan_unroll`` is accepted and has no effect: the port walks the
    blocks in a Python loop and has no scan to unroll.  ``q_chunk``: query
    rows a chunk of the plain attention, 0 = ``_auto_q_chunk``'s rule.
    ``tp_size``: the model axis' size (``_expand_kv``).
    ``explicit_fsdp``: the expert weights gathered over the data axes
    inside the relay's body."""

    shard: Callable = Identity
    remat: str = "none"
    moe_method: str = "sort"
    ep: Optional[tuple] = None
    scan_unroll: int = 1
    q_chunk: int = 0
    tp_size: int = 1
    explicit_fsdp: bool = False


DEFAULT_CTX = RunCtx()


def _auto_q_chunk(ctx: RunCtx, Sq: int) -> int:
    """Query rows a chunk of the plain attention: ``ctx.q_chunk`` if set,
    else the reference's rule (``attention.q_chunk_for``: none below
    4096, 512 up to 8192, then 256)."""
    return attn.q_chunk_for(Sq, ctx.q_chunk)


def _expand_kv(cfg: ModelConfig, ctx: RunCtx) -> int:
    """GQA→MHA expansion (to a tp-multiple head count) when neither K nor
    G divides the model axis, so the attention shards by heads end to end
    (``attention.gqa_full``).  Returns the target head count, 0 = off."""
    tp = ctx.tp_size
    if tp <= 1 or cfg.mla is not None or cfg.n_heads == 0:
        return 0
    K, H = cfg.n_kv_heads, cfg.n_heads
    G = H // max(K, 1)
    if K % tp == 0 or G % tp == 0:
        return 0
    return -(-H // tp) * tp


def _is_moe_layer(cfg: ModelConfig, i: int) -> bool:
    m = cfg.moe
    return (m.enabled and i >= m.first_dense
            and i % m.moe_every == m.moe_offset)


def _init_ffn_part(draw: Draw, cfg: ModelConfig, is_moe: bool) -> Params:
    if is_moe:
        return {"moe": moe_mod.init_moe(draw, cfg)}
    return {"ffn": init_ffn(draw, cfg.d_model, cfg.d_ff, cfg.ffn_act)}


def _init_attn_layer(draw: Draw, cfg: ModelConfig, is_moe: bool = False,
                     cross: bool = False) -> Params:
    """An attention layer; with ``cross`` (whisper's decoder) also the
    cross-attention's norm ``norm_x`` and projections ``cross``."""
    p = {"norm1": draw.ones((cfg.d_model,)),
         "attn": attn.init_attn(draw, cfg),
         "norm2": draw.ones((cfg.d_model,)),
         **_init_ffn_part(draw, cfg, is_moe)}
    if cross:
        p["norm_x"] = draw.ones((cfg.d_model,))
        p["cross"] = attn.init_gqa(draw, cfg)
    return p


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


def _apply_ffn(cfg: ModelConfig, lp: Params, x, ctx: RunCtx):
    if "moe" in lp:
        return moe_mod.moe_ffn(cfg, lp["moe"], x, method=ctx.moe_method,
                               ep=ctx.ep, explicit_fsdp=ctx.explicit_fsdp)
    return ffn(lp["ffn"], x, cfg.ffn_act), None


def _residual(shard, x, h):
    """x + h with the reference's two ``"resid"`` constraints: on the
    layer's output before the add (a row-parallel all-reduce becomes a
    reduce-scatter onto the sequence-sharded residual) and on the sum."""
    return shard(x + shard(h, "resid"), "resid")


def _ffn_residual(cfg: ModelConfig, lp: Params, x, ctx: RunCtx,
                  shard=Identity):
    """x + the layer's FFN (dense or MoE) of norm2(x), and its metrics;
    x itself for a mamba layer without an FFN."""
    if "norm2" not in lp:
        return x, None
    h, metrics = _apply_ffn(cfg, lp, rms_norm(x, lp["norm2"], cfg.norm_eps),
                            ctx)
    return _residual(shard, x, h), metrics


def _attn_layer_full(cfg: ModelConfig, lp: Params, x, positions, cache,
                     ctx: RunCtx = DEFAULT_CTX, *, enc_out=None,
                     cross_cache=None, causal: bool = True):
    """Self-attention over the sequence (causal, or not in the encoder),
    then with ``enc_out`` the cross-attention to it (K/V written into
    ``cross_cache``'s ``"k"`` / ``"v"`` where given), then the FFN."""
    h, _ = attn.attn_full(cfg, lp["attn"],
                          rms_norm(x, lp["norm1"], cfg.norm_eps), positions,
                          cache=cache, causal=causal, shard=ctx.shard,
                          q_chunk=_auto_q_chunk(ctx, x.shape[1]),
                          expand_kv=_expand_kv(cfg, ctx))
    x = _residual(ctx.shard, x, h)
    if enc_out is not None:
        h, _ = attn.gqa_full(cfg, lp["cross"],
                             rms_norm(x, lp["norm_x"], cfg.norm_eps),
                             positions, kv_x=enc_out, cache=cross_cache)
        x = _residual(ctx.shard, x, h)
    return _ffn_residual(cfg, lp, x, ctx, ctx.shard)


def _attn_layer_decode(cfg: ModelConfig, lp: Params, x, lengths, cache,
                       ctx: RunCtx = DEFAULT_CTX, *, cross=None):
    """One-token self-attention on ``cache``, then with ``cross`` (the
    stored encoder K/V) the cross-attention, then the FFN."""
    h, _ = attn.attn_decode(cfg, lp["attn"],
                            rms_norm(x, lp["norm1"], cfg.norm_eps), lengths,
                            cache)
    x = x + h
    if cross is not None:
        x = x + attn.gqa_cross_decode(
            cfg, lp["cross"], rms_norm(x, lp["norm_x"], cfg.norm_eps),
            *cross)
    return _ffn_residual(cfg, lp, x, ctx)


def _mamba_layer_full(cfg: ModelConfig, lp: Params, x, ctx: RunCtx):
    h, st = ssm_mod.mamba_mixer(cfg, lp["mamba"],
                                rms_norm(x, lp["norm1"], cfg.norm_eps))
    x, metrics = _ffn_residual(cfg, lp, _residual(ctx.shard, x, h), ctx,
                               ctx.shard)
    return x, st, metrics


def _mamba_layer_decode(cfg: ModelConfig, lp: Params, x, state,
                        ctx: RunCtx):
    h, st = ssm_mod.mamba_decode(cfg, lp["mamba"],
                                 rms_norm(x, lp["norm1"], cfg.norm_eps),
                                 state)
    x, metrics = _ffn_residual(cfg, lp, x + h, ctx)
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


def _unstack(tree) -> list:
    """The layers of a params tree stacked on a leading axis, each leaf
    split by one ``unbind``: under autograd the stack then takes one
    gradient (the layers' stacked), not one full-size gradient a layer."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v) for k, v in tree.items()}
        n = len(next(iter(parts.values())))
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    return list(tree.unbind(0))


def _store(dst: ssm_mod.SSMState, st: ssm_mod.SSMState):
    """Copy a layer's new state into its views of the stacked cache."""
    for t, s in zip(dst, st):
        t.copy_(s)


def _hybrid_block(cfg: ModelConfig, bp: Params, x, cache, ctx: RunCtx, *,
                  positions=None, lengths=None):
    """One jamba period (train or prefill with ``positions``, decode with
    ``lengths``): attention at ``attn_pos`` on ``cache["attn"]``, the
    mamba layers on ``cache["ssm"]``, indexed by their position with the
    attention position skipped; ``cache`` None in training."""
    ms = []
    for pos in range(cfg.attn_period):
        lp = bp[f"pos{pos}"]
        if pos == cfg.attn_pos:
            if lengths is None:
                x, m = _attn_layer_full(cfg, lp, x, positions,
                                        cache and cache["attn"], ctx)
            else:
                x, m = _attn_layer_decode(cfg, lp, x, lengths, cache["attn"],
                                          ctx)
        elif cache is None:
            x, _, m = _mamba_layer_full(cfg, lp, x, ctx)
        else:
            state = _layer(cache["ssm"],
                           pos if pos < cfg.attn_pos else pos - 1)
            if lengths is None:
                x, st, m = _mamba_layer_full(cfg, lp, x, ctx)
            else:
                x, st, m = _mamba_layer_decode(cfg, lp, x, state, ctx)
            _store(state, st)
        ms.append(m)
    return x, ms


def _block(cfg: ModelConfig, bp: Params, x, cache, ctx: RunCtx, *,
           positions=None, lengths=None, enc_out=None,
           encoder: bool = False):
    """One block of any family; returns (x, the MoE layers' metrics).
    ``cache`` None: training (or the encoder), nothing stored."""
    if cfg.is_hybrid:
        return _hybrid_block(cfg, bp, x, cache, ctx, positions=positions,
                             lengths=lengths)
    if cfg.attn_free:
        if lengths is None:
            x, st, m = _mamba_layer_full(cfg, bp, x, ctx)
        else:
            x, st, m = _mamba_layer_decode(cfg, bp, x, cache, ctx)
        if cache is not None:
            _store(cache, st)
        return x, [m]
    if lengths is not None:
        cross = (cache["cross_k"], cache["cross_v"]) \
            if "cross_k" in cache else None
        x, m = _attn_layer_decode(cfg, bp, x, lengths, cache["self"], ctx,
                                  cross=cross)
        return x, [m]
    cross_cache = None
    if cache is not None and "cross_k" in cache:
        cross_cache = {"k": cache["cross_k"], "v": cache["cross_v"]}
    x, m = _attn_layer_full(cfg, bp, x, positions, cache and cache["self"],
                            ctx, enc_out=enc_out, cross_cache=cross_cache,
                            causal=not encoder)
    return x, [m]


def checkpoint_block(fn, *args):
    """``fn(*args)`` under ``torch.utils.checkpoint`` (non-reentrant): the
    forward keeps only what the block is called with, and the backward
    runs the block's forward again.  The forward draws no random numbers,
    so the RNG state is not saved and restored (which also keeps the meta
    device of the dry run off any CUDA RNG)."""
    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False, preserve_rng_state=False)


def _stack(cfg: ModelConfig, stacked: Params, x, caches, ctx: RunCtx, **kw):
    """Every stacked block in turn; with ``remat="block"`` and autograd
    recording (training), each block under ``checkpoint_block``."""
    remat = ctx.remat == "block" and caches is None \
        and torch.is_grad_enabled()
    per_block = []
    for i, bp in enumerate(_unstack(stacked)):
        if remat:
            x, ms = checkpoint_block(
                functools.partial(_block, cfg, cache=None, ctx=ctx, **kw),
                bp, x)
        else:
            cache = None if caches is None else _layer(caches, i)
            x, ms = _block(cfg, bp, x, cache, ctx, **kw)
        if cfg.moe.enabled:
            per_block.append(_merge_metrics(cfg, ms, x.device))
    return x, caches, _mean_metrics(per_block) if per_block else None


def stack_train(cfg: ModelConfig, stacked: Params, x, positions,
                ctx: RunCtx = DEFAULT_CTX, *, enc_out=None,
                encoder: bool = False):
    """The training forward through every stacked block: no cache, no
    state kept, nothing written in place (autograd may save any tensor).
    ``encoder``: whisper's encoder blocks (attention not causal);
    ``enc_out``: the encoder's output the decoder blocks attend to.
    Returns (x, metrics)."""
    x, _, metrics = _stack(cfg, stacked, x, None, ctx, positions=positions,
                           enc_out=enc_out, encoder=encoder)
    return x, metrics


def stack_prefill(cfg: ModelConfig, stacked: Params, x, positions, caches,
                  ctx: RunCtx = DEFAULT_CTX, *, enc_out=None):
    """Prefill through every stacked block in turn.  Attention layers write
    their K/V (or MLA latents) into ``caches`` at offset 0, and with
    ``enc_out`` (whisper) the cross-attention's K/V into ``cross_k`` /
    ``cross_v``; mamba layers store their final SSM state and conv window.
    Returns (x, caches, metrics), the caches updated in place."""
    return _stack(cfg, stacked, x, caches, ctx, positions=positions,
                  enc_out=enc_out)


def stack_decode(cfg: ModelConfig, stacked: Params, x, lengths, caches,
                 ctx: RunCtx = DEFAULT_CTX):
    """Decode through every stacked block in turn; ``caches`` is stacked
    the same way and updated in place.  Returns (x, caches, metrics)."""
    return _stack(cfg, stacked, x, caches, ctx, lengths=lengths)

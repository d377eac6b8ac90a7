"""Model factory (twin of ``repro/models/model.py``): seeded init, cache
init, whisper's encoder, the training forward and loss, prefill and one
decode step for the dense, vlm, moe, ssm, hybrid and audio families.
``vlm`` (chameleon-34b) is a dense decoder, as in the reference: its VQ
image tokens arrive inside the text vocabulary.  ``audio``
(whisper-large-v3) is an encoder-decoder whose conv frontend is a stub:
callers pass precomputed frame embeddings (B, F, D).

Every entry point takes the reference's ``ctx`` (``transformer.RunCtx``,
``DEFAULT_CTX`` when not given: no remat, the sort dispatch, no
constraint), and calls ``ctx.shard`` where the reference does:
``"resid"`` on the embeddings (and the encoder's input), ``"logits"`` on
the training and decode logits.  Where the params are DTensors (placed
by ``sharding/specs.py``), each entry point runs under DTensor's
``implicit_replication``: the plain constants the forward makes
(positions, rope tables, masks) count as the same on every rank;
``on_mesh(params)`` is that context, for a caller's backward.
"""

from __future__ import annotations

import contextlib
import functools

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import (Draw, Params, rms_norm,
                                       sinusoid_positions, stacked)
from repro_torch.models.transformer import DEFAULT_CTX, RunCtx
from repro_torch.sharding.specs import is_dtensor

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid", "audio")


def _dtype(cfg: ModelConfig, dtype):
    return dtype if dtype is not None else _DTYPES[cfg.dtype]


def n_scan_blocks(cfg: ModelConfig) -> int:
    """Stacked blocks: periods for the hybrid family, else the layers past
    the unstacked ``first_dense`` ones."""
    if cfg.is_hybrid:
        if cfg.n_layers % cfg.attn_period:
            raise ValueError(f"{cfg.name}: {cfg.n_layers} layers are not "
                             f"whole periods of {cfg.attn_period}")
        return cfg.n_layers // cfg.attn_period
    return cfg.n_layers - cfg.moe.first_dense


def _block_init(cfg: ModelConfig):
    if cfg.family == "ssm":
        return lambda d: tfm._init_mamba_layer(d, cfg, cfg.d_ff > 0)
    if cfg.is_hybrid:
        return lambda d: tfm._init_jamba_period(d, cfg)
    return lambda d: tfm._init_attn_layer(d, cfg, cfg.family == "moe",
                                          cross=cfg.is_encdec)


def init_params(cfg: ModelConfig, generator: torch.Generator, dtype=None,
                device="cuda") -> Params:
    """The port's own seeded init (the reference's layout: ``embed``,
    ``head``, ``norm_f``, ``blocks`` stacked on a leading block axis,
    deepseek's unstacked ``first`` list of dense layers, and whisper's
    ``enc``: its stacked encoder ``blocks`` and ``norm_f``).  Draws come from
    ``generator`` on its own device: a CPU generator gives the same weights
    on any device, a CUDA one keeps a full-width init on the card.  The
    stack is filled in place (``layers.stacked``).  On the card unless
    ``device="cpu"``; raises without a GPU."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet "
            "(ROADMAP.md item 12); the port runs " + ", ".join(FAMILIES))
    device = resolve_device(device)
    dtype = _dtype(cfg, dtype)
    D, Vp = cfg.d_model, cfg.vocab_padded
    draw = Draw(generator, dtype, device)
    p = {"embed": draw.embed((Vp, D)), "head": draw.dense((D, Vp)),
         "norm_f": draw.ones((D,)),
         "blocks": stacked(n_scan_blocks(cfg), _block_init(cfg), generator,
                           dtype, device)}
    if cfg.moe.first_dense:
        p["first"] = [tfm._init_attn_layer(draw, cfg)
                      for _ in range(cfg.moe.first_dense)]
    if cfg.is_encdec:
        p["enc"] = {"blocks": stacked(
            cfg.n_enc_layers, lambda d: tfm._init_attn_layer(d, cfg),
            generator, dtype, device), "norm_f": draw.ones((D,))}
    return p


def _stack_zeros(tree, n: int):
    """``tree`` (dicts and ``SSMState``s of tensors) as zeros stacked
    ``n`` deep on a new leading axis."""
    if isinstance(tree, dict):
        return {k: _stack_zeros(v, n) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(_stack_zeros(v, n) for v in tree))
    return torch.zeros((n,) + tree.shape, dtype=tree.dtype,
                       device=tree.device)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device="cuda"):
    """The reference's cache layout, zeros:
    - ssm: an ``SSMState`` of (L, B, nh, hd, N) f32 states and
      (L, B, conv_dim, W-1) conv windows (``max_len`` unused);
    - hybrid: ``{"attn": {"k", "v"}, "ssm": SSMState}`` stacked over the
      periods, the states also over the ``attn_period - 1`` mamba layers
      of a period;
    - the rest: ``{"blocks": {"self": ...}}`` stacked over the blocks, a
      layer's ``{"k", "v"}`` (B, max_len, K, hd) or, with MLA,
      ``{"ckv", "krope"}``; plus ``"first"``, one unstacked
      ``{"self": ...}`` per leading dense layer; whisper's blocks also
      hold the encoder's K/V, ``"cross_k"`` / ``"cross_v"``
      (B, enc_frames, K, hd).
    On the card unless ``device="cpu"``; raises without a GPU."""
    device = resolve_device(device)
    dtype = _dtype(cfg, dtype)
    if cfg.attn_free:
        return _stack_zeros(ssm_mod.init_ssm_state(cfg, batch, dtype, device),
                            cfg.n_layers)
    kv = attn.init_attn_cache(cfg, batch, max_len, dtype, device)
    nb = n_scan_blocks(cfg)
    if cfg.is_hybrid:
        st = ssm_mod.init_ssm_state(cfg, batch, dtype, device)
        return _stack_zeros({"attn": kv,
                             "ssm": _stack_zeros(st, cfg.attn_period - 1)},
                            nb)
    per = {"self": kv}
    if cfg.is_encdec:
        shape = (batch, cfg.enc_frames, cfg.n_kv_heads, cfg.head_dim)
        per["cross_k"] = torch.zeros(shape, dtype=dtype, device=device)
        per["cross_v"] = torch.zeros(shape, dtype=dtype, device=device)
    cache = {"blocks": _stack_zeros(per, nb)}
    if cfg.moe.first_dense:
        cache["first"] = [
            {"self": attn.init_attn_cache(cfg, batch, max_len, dtype,
                                          device)}
            for _ in range(cfg.moe.first_dense)]
    return cache


def on_mesh(params):
    """``implicit_replication`` where ``params`` are DTensors, else a
    context that does nothing."""
    if not is_dtensor(params["embed"]):
        return contextlib.nullcontext()
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication
    if DTensor._op_dispatcher._allow_implicit_replication:
        # already on: the context's exit would turn it off, not restore it
        return contextlib.nullcontext()
    return implicit_replication()


def _meshed(fn):
    """``fn(cfg, params, ...)`` under ``on_mesh(params)``."""
    @functools.wraps(fn)
    def call(cfg, params, *a, **k):
        with on_mesh(params):
            return fn(cfg, params, *a, **k)
    return call


def _blocks(cfg: ModelConfig, cache):
    return cache if cfg.attn_free or cfg.is_hybrid else cache["blocks"]


def _logits(cfg: ModelConfig, params: Params, x):
    """fp32 logits (B, Vp) of the last position of x (B, S, D)."""
    x = rms_norm(x[:, -1], params["norm_f"], cfg.norm_eps)
    return ops.dense(x, params["head"]).to(torch.float32)


@functools.lru_cache(maxsize=None)
def _sinusoid_on(n_pos: int, d_model: int, device: torch.device):
    """``sinusoid_positions`` on ``device``, copied there once: a captured
    training step must not copy from pageable host memory."""
    return sinusoid_positions(n_pos, d_model).to(device)


@_meshed
def encode(cfg: ModelConfig, params: Params, enc_frames,
           ctx: RunCtx = DEFAULT_CTX):
    """Whisper's encoder: enc_frames (B, F, D), the conv frontend's
    precomputed embeddings (a stub, as in the reference), plus the fixed
    sinusoid, through the encoder blocks (attention not causal, rope on q
    and k as the reference's self-attention applies it) → (B, F, D)."""
    F_, D = enc_frames.shape[1:]
    x = enc_frames.to(params["embed"].dtype)
    x = x + _sinusoid_on(F_, D, x.device)[None].to(x.dtype)
    x = ctx.shard(x, "resid")
    positions = torch.arange(F_, device=x.device)[None]
    x, _ = tfm.stack_train(cfg, params["enc"]["blocks"], x, positions, ctx,
                           encoder=True)
    return rms_norm(x, params["enc"]["norm_f"], cfg.norm_eps)


def _embed(cfg: ModelConfig, params: Params, tokens, enc_frames,
           ctx: RunCtx):
    """(token embeddings, positions, the encoder's output or None)."""
    x = ctx.shard(params["embed"][tokens.to(torch.int64)], "resid")
    positions = torch.arange(tokens.shape[1], device=x.device)[None]
    enc_out = encode(cfg, params, enc_frames, ctx) if cfg.is_encdec \
        else None
    return x, positions, enc_out


@_meshed
def forward(cfg: ModelConfig, params: Params, tokens, *, enc_frames=None,
            ctx: RunCtx = DEFAULT_CTX):
    """The training forward over whole sequences, tokens (B, S) int (and
    whisper's ``enc_frames`` (B, F, D)): no cache, nothing written in
    place, differentiable through B7 and B8.  Returns (logits (B, S, Vp)
    fp32, ``MoEMetrics``; zeros of (max(E, 1),) loads without MoE
    layers, as the reference's)."""
    x, positions, enc_out = _embed(cfg, params, tokens, enc_frames, ctx)
    for lp in params.get("first", []):
        x, _ = tfm._attn_layer_full(cfg, lp, x, positions, None, ctx)
    x, metrics = tfm.stack_train(cfg, params["blocks"], x, positions, ctx,
                                 enc_out=enc_out)
    if metrics is None:
        metrics = moe_mod.MoEMetrics.zero(max(cfg.moe.n_experts, 1),
                                          x.device)
    x = rms_norm(x, params["norm_f"], cfg.norm_eps)
    return ctx.shard((x @ params["head"]).to(torch.float32),
                     "logits"), metrics


@_meshed
def loss_fn(cfg: ModelConfig, params: Params, batch: dict, *,
            ctx: RunCtx = DEFAULT_CTX, aux_coef: float = 0.01,
            z_coef: float = 1e-4):
    """batch: tokens (B, S) int, labels (B, S) int (-1 = masked)
    [, enc_frames (B, F, D)].  The masked mean token cross-entropy plus
    ``aux_coef`` x the MoE balancing loss and ``z_coef`` x the router
    z-loss.  Returns (loss, metrics dict: loss, ce, aux, z, overflow,
    expert_load)."""
    logits, m = forward(cfg, params, batch["tokens"],
                        enc_frames=batch.get("enc_frames"), ctx=ctx)
    labels = batch["labels"].to(torch.int64)
    mask = (labels >= 0).to(torch.float32)
    logp = torch.log_softmax(logits, dim=-1)
    ce = -logp.gather(-1, labels.clamp_min(0)[..., None])[..., 0]
    ce = torch.sum(ce * mask) / torch.clamp_min(torch.sum(mask), 1.0)
    loss = ce + aux_coef * m.aux_loss + z_coef * m.z_loss
    return loss, {"loss": loss, "ce": ce, "aux": m.aux_loss,
                  "z": m.z_loss, "overflow": m.overflow_frac,
                  "expert_load": m.load}


@_meshed
def prefill(cfg: ModelConfig, params: Params, tokens, cache, *,
            enc_frames=None, return_metrics: bool = False,
            ctx: RunCtx = DEFAULT_CTX):
    """Run the prompt tokens (B, S) int from position 0, writing K/V (or
    MLA latents) and the final SSM states into ``cache`` in place; whisper
    encodes ``enc_frames`` (B, F, D) first and stores each decoder layer's
    cross-attention K/V.  Returns (last-token logits (B, Vp) fp32, cache),
    and with ``return_metrics`` the blocks' merged ``MoEMetrics`` (None
    without MoE layers) as a third item."""
    x, positions, enc_out = _embed(cfg, params, tokens, enc_frames, ctx)
    if cfg.moe.first_dense:
        for lp, c in zip(params["first"], cache["first"]):
            x, _ = tfm._attn_layer_full(cfg, lp, x, positions, c["self"],
                                        ctx)
    x, _, metrics = tfm.stack_prefill(cfg, params["blocks"], x, positions,
                                      _blocks(cfg, cache), ctx,
                                      enc_out=enc_out)
    out = (_logits(cfg, params, x), cache)
    return out + (metrics,) if return_metrics else out


@_meshed
def decode_step(cfg: ModelConfig, params: Params, token, lengths, cache, *,
                ctx: RunCtx = DEFAULT_CTX):
    """One decode step.  token (B, 1) int; lengths (B,) int — the position
    each sequence writes at.  Returns (logits (B, Vp) fp32, cache), the
    cache updated in place."""
    x = params["embed"][token.to(torch.int64)]            # (B, 1, D)
    if cfg.moe.first_dense:
        for lp, c in zip(params["first"], cache["first"]):
            x, _ = tfm._attn_layer_decode(cfg, lp, x, lengths, c["self"],
                                          ctx)
    x, _, _ = tfm.stack_decode(cfg, params["blocks"], x, lengths,
                               _blocks(cfg, cache), ctx)
    return ctx.shard(_logits(cfg, params, x), "logits"), cache

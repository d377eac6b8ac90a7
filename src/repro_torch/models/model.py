"""Model factory for serving (twin of ``repro/models/model.py`` without the
encoder-decoder and training parts): seeded init, cache init, prefill and
one decode step for the dense, vlm, moe, ssm and hybrid families.
``vlm`` (chameleon-34b) is a dense decoder, as in the reference: its VQ
image tokens arrive inside the text vocabulary.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import Draw, Params, rms_norm, stacked

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid")


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
    return lambda d: tfm._init_attn_layer(d, cfg, cfg.family == "moe")


def init_params(cfg: ModelConfig, generator: torch.Generator, dtype=None,
                device="cuda") -> Params:
    """The port's own seeded init (the reference's layout: ``embed``,
    ``head``, ``norm_f``, ``blocks`` stacked on a leading block axis, and
    deepseek's unstacked ``first`` list of dense layers).  Draws come from
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
      ``{"self": ...}`` per leading dense layer.
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
    cache = {"blocks": _stack_zeros({"self": kv}, nb)}
    if cfg.moe.first_dense:
        cache["first"] = [
            {"self": attn.init_attn_cache(cfg, batch, max_len, dtype,
                                          device)}
            for _ in range(cfg.moe.first_dense)]
    return cache


def _blocks(cfg: ModelConfig, cache):
    return cache if cfg.attn_free or cfg.is_hybrid else cache["blocks"]


def _logits(cfg: ModelConfig, params: Params, x):
    """fp32 logits (B, Vp) of the last position of x (B, S, D)."""
    x = rms_norm(x[:, -1], params["norm_f"], cfg.norm_eps)
    return (x @ params["head"]).to(torch.float32)


def prefill(cfg: ModelConfig, params: Params, tokens, cache, *,
            return_metrics: bool = False):
    """Run the prompt tokens (B, S) int from position 0, writing K/V (or
    MLA latents) and the final SSM states into ``cache`` in place.
    Returns (last-token logits (B, Vp) fp32, cache), and with
    ``return_metrics`` the blocks' merged ``MoEMetrics`` (None without MoE
    layers) as a third item."""
    S = tokens.shape[1]
    x = params["embed"][tokens.to(torch.int64)]           # (B, S, D)
    positions = torch.arange(S, device=x.device)[None]
    if cfg.moe.first_dense:
        for lp, c in zip(params["first"], cache["first"]):
            x, _ = tfm._attn_layer_full(cfg, lp, x, positions, c["self"])
    x, _, metrics = tfm.stack_prefill(cfg, params["blocks"], x, positions,
                                      _blocks(cfg, cache))
    out = (_logits(cfg, params, x), cache)
    return out + (metrics,) if return_metrics else out


def decode_step(cfg: ModelConfig, params: Params, token, lengths, cache):
    """One decode step.  token (B, 1) int; lengths (B,) int — the position
    each sequence writes at.  Returns (logits (B, Vp) fp32, cache), the
    cache updated in place."""
    x = params["embed"][token.to(torch.int64)]            # (B, 1, D)
    if cfg.moe.first_dense:
        for lp, c in zip(params["first"], cache["first"]):
            x, _ = tfm._attn_layer_decode(cfg, lp, x, lengths, c["self"])
    x, _, _ = tfm.stack_decode(cfg, params["blocks"], x, lengths,
                               _blocks(cfg, cache))
    return _logits(cfg, params, x), cache

"""Model factory for serving (twin of the dense, vlm and ssm parts of
``repro/models/model.py``): seeded init, cache init, prefill and one
decode step.  ``vlm`` (chameleon-34b) is a dense decoder, as in the
reference: its VQ image tokens arrive inside the text vocabulary.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import Params, dense_init, embed_init, rms_norm

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_LAYER_INIT = {"dense": tfm._init_attn_layer, "vlm": tfm._init_attn_layer,
               "ssm": tfm._init_mamba_layer}


def _dtype(cfg: ModelConfig, dtype):
    return dtype if dtype is not None else _DTYPES[cfg.dtype]


def _stacked(cfg: ModelConfig, layer, generator, dtype, device):
    """``cfg.n_layers`` draws of ``layer`` stacked on a leading axis, each
    leaf allocated once at (L, ...) and filled layer by layer: a
    full-width init holds the stack and one layer, never two copies of the
    blocks.  The draws keep their order (layer by layer, leaf by leaf)."""
    L = cfg.n_layers

    def alloc(t):
        if isinstance(t, dict):
            return {k: alloc(v) for k, v in t.items()}
        return torch.empty((L,) + t.shape, dtype=t.dtype, device=t.device)

    def put(dst, src, i):
        if isinstance(src, dict):
            for k, v in src.items():
                put(dst[k], v, i)
        else:
            dst[i].copy_(src)

    blocks = None
    for i in range(L):
        lp = layer(generator, cfg, dtype, device)
        if blocks is None:
            blocks = alloc(lp)
        put(blocks, lp, i)
        del lp
    return blocks


def init_params(cfg: ModelConfig, generator: torch.Generator, dtype=None,
                device="cuda") -> Params:
    """The port's own seeded init (the reference's layout: ``embed``,
    ``head``, ``norm_f`` and ``blocks`` stacked on a leading layer axis).
    Draws come from ``generator`` on its own device: a CPU generator gives
    the same weights on any device, a CUDA one keeps a full-width init on
    the card.  On the card unless ``device="cpu"``; raises without a GPU."""
    if cfg.family not in _LAYER_INIT:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet "
            "(ROADMAP.md item 12); the port runs "
            + ", ".join(sorted(_LAYER_INIT)))
    device = resolve_device(device)
    dtype = _dtype(cfg, dtype)
    D, Vp = cfg.d_model, cfg.vocab_padded
    layer = _LAYER_INIT[cfg.family]
    return {
        "embed": embed_init((Vp, D), generator, dtype, device),
        "head": dense_init((D, Vp), generator, dtype, device),
        "norm_f": torch.ones((D,), dtype=dtype, device=device),
        "blocks": _stacked(cfg, layer, generator, dtype, device),
    }


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device="cuda"):
    """Dense: ``{"blocks": {"self": {"k", "v"}}}``, (L, B, max_len, K, hd)
    each.  ssm: an ``SSMState`` of (L, B, nh, hd, N) f32 states and
    (L, B, conv_dim, W-1) conv windows (``max_len`` unused: the state does
    not grow).  On the card unless ``device="cpu"``; raises without a
    GPU."""
    device = resolve_device(device)
    dtype = _dtype(cfg, dtype)
    L = cfg.n_layers
    if cfg.attn_free:
        one = ssm_mod.init_ssm_state(cfg, batch, dtype, device)
        return ssm_mod.SSMState(*(torch.zeros((L,) + t.shape, dtype=t.dtype,
                                              device=device) for t in one))
    one = attn.init_gqa_cache(cfg, batch, max_len, dtype, device)
    return {"blocks": {"self": {k: torch.zeros((L,) + v.shape,
                                               dtype=v.dtype, device=device)
                                for k, v in one.items()}}}


def _blocks(cfg: ModelConfig, cache):
    return cache if cfg.attn_free else cache["blocks"]


def _logits(cfg: ModelConfig, params: Params, x):
    """fp32 logits (B, Vp) of the last position of x (B, S, D)."""
    x = rms_norm(x[:, -1], params["norm_f"], cfg.norm_eps)
    return (x @ params["head"]).to(torch.float32)


def prefill(cfg: ModelConfig, params: Params, tokens, cache):
    """Run the prompt tokens (B, S) int from position 0, writing K/V (dense)
    or the final SSM state (ssm) into ``cache`` in place.  Returns
    (last-token logits (B, Vp) fp32, cache)."""
    S = tokens.shape[1]
    x = params["embed"][tokens.to(torch.int64)]           # (B, S, D)
    positions = torch.arange(S, device=x.device)[None]
    x, _ = tfm.stack_prefill(cfg, params["blocks"], x, positions,
                             _blocks(cfg, cache))
    return _logits(cfg, params, x), cache


def decode_step(cfg: ModelConfig, params: Params, token, lengths, cache):
    """One decode step.  token (B, 1) int; lengths (B,) int — the position
    each sequence writes at.  Returns (logits (B, Vp) fp32, cache), the
    cache updated in place."""
    x = params["embed"][token.to(torch.int64)]            # (B, 1, D)
    x, _ = tfm.stack_decode(cfg, params["blocks"], x, lengths,
                            _blocks(cfg, cache))
    return _logits(cfg, params, x), cache

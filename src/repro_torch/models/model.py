"""Model factory for serving (twin of the dense parts of
``repro/models/model.py``): seeded init, KV cache init and one decode step.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import Params, dense_init, embed_init, rms_norm

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dtype(cfg: ModelConfig, dtype):
    return dtype if dtype is not None else _DTYPES[cfg.dtype]


def _stack(layers: list):
    if isinstance(layers[0], dict):
        return {k: _stack([l[k] for l in layers]) for k in layers[0]}
    return torch.stack(layers)


def init_params(cfg: ModelConfig, generator: torch.Generator, dtype=None,
                device="cuda") -> Params:
    """The port's own seeded init (the reference's layout: ``embed``,
    ``head``, ``norm_f`` and ``blocks`` stacked on a leading layer axis).
    Draws come from ``generator`` on the CPU, so a seed gives the same
    weights on any device.  On the card unless ``device="cpu"``; raises
    without a GPU."""
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r} is not ported")
    device = resolve_device(device)
    dtype = _dtype(cfg, dtype)
    D, Vp = cfg.d_model, cfg.vocab_padded
    return {
        "embed": embed_init((Vp, D), generator, dtype, device),
        "head": dense_init((D, Vp), generator, dtype, device),
        "norm_f": torch.ones((D,), dtype=dtype, device=device),
        "blocks": _stack([tfm._init_attn_layer(generator, cfg, dtype, device)
                          for _ in range(cfg.n_layers)]),
    }


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device="cuda"):
    """``{"blocks": {"self": {"k", "v"}}}`` stacked on the layer axis:
    (L, B, max_len, K, hd) each.  On the card unless ``device="cpu"``;
    raises without a GPU."""
    device = resolve_device(device)
    one = attn.init_gqa_cache(cfg, batch, max_len, _dtype(cfg, dtype),
                              device)
    return {"blocks": {"self": {k: torch.zeros((cfg.n_layers,) + v.shape,
                                               dtype=v.dtype, device=device)
                                for k, v in one.items()}}}


def decode_step(cfg: ModelConfig, params: Params, token, lengths, cache):
    """One decode step.  token (B, 1) int; lengths (B,) int — the position
    each sequence writes at.  Returns (logits (B, Vp) fp32, cache), the
    cache updated in place."""
    x = params["embed"][token.to(torch.int64)]            # (B, 1, D)
    x, _ = tfm.stack_decode(cfg, params["blocks"], x, lengths,
                            cache["blocks"])
    x = rms_norm(x, params["norm_f"], cfg.norm_eps)
    logits = (x[:, -1] @ params["head"]).to(torch.float32)
    return logits, cache

"""Shared layer primitives (twin of ``repro/models/layers.py``).

Params are nested dicts of tensors with per-layer weights stacked on a
leading axis; weights keep the reference's ``x @ W`` layout.  Normalization
statistics are computed in fp32.
"""

from __future__ import annotations

import math

import torch

Params = dict


def dense_init(shape, generator: torch.Generator, dtype, device,
               scale: float | None = None) -> torch.Tensor:
    """Truncated-normal (±3σ) fan-in init, drawn in f32 on the generator's
    device (a CPU generator gives the same weights on every device; a CUDA
    generator keeps a full-width init off the host)."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    w = torch.empty(shape, dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -3.0, 3.0, generator=generator)
    return (w * std).to(device=device, dtype=dtype)


def embed_init(shape, generator: torch.Generator, dtype, device):
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device) * 0.02
    return w.to(device=device, dtype=dtype)


def rms_norm(x, scale, eps: float = 1e-5):
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale.to(torch.float32)).to(x.dtype)


def gated_rms_norm(x, gate, scale, eps: float = 1e-5):
    """Mamba-2 gated RMSNorm: norm(x * silu(gate))."""
    g = torch.nn.functional.silu(gate.to(torch.float32)).to(x.dtype)
    return rms_norm(x * g, scale, eps)


def rope_frequencies(head_dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd) or (..., S, hd); positions: broadcastable to
    (..., S)."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)            # (hd/2,)
    angles = positions.to(torch.float32)[..., None] * freqs  # (..., S, hd/2)
    if x.ndim == angles.ndim + 1:                            # head axis
        angles = angles[..., None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def init_ffn(generator, d_model: int, d_ff: int, act: str, dtype,
             device) -> Params:
    p = {"w_in": dense_init((d_model, d_ff), generator, dtype, device),
         "w_out": dense_init((d_ff, d_model), generator, dtype, device)}
    if act == "swiglu":
        p["w_gate"] = dense_init((d_model, d_ff), generator, dtype, device)
    return p


def ffn(params: Params, x, act: str):
    h = x @ params["w_in"]
    if act == "swiglu":
        h = torch.nn.functional.silu(x @ params["w_gate"]) * h
    else:
        raise ValueError(f"unknown activation {act!r}")
    return h @ params["w_out"]

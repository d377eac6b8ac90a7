"""Mamba-2 (SSD, state-space duality) mixer (twin of
``repro/models/ssm.py``).  [arXiv:2405.21060]

Training and prefill run the chunked SSD through ``ops.ssd_scan`` (the
hand-written kernel on the card, its plain version on the CPU;
differentiable, the backward recomputing the plain scan), which also
returns the final state for decode; decode is the single-token
recurrence in plain PyTorch, as in the reference (which has no kernel
there).

Layout: x:(B,S,nh,hd), B/C:(B,S,G,N) groups broadcast over heads,
dt:(B,S,nh) post-softplus, A:(nh,) negative.
Decode state: ssm (B,nh,hd,N) f32 + rolling conv window (B,conv_dim,W-1).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import Draw, Params, gated_rms_norm, reshape


class SSMState(NamedTuple):
    ssm: torch.Tensor     # (B, nh, hd, N) f32
    conv: torch.Tensor    # (B, conv_dim, W-1) model dtype


def init_mamba(draw: Draw, cfg: ModelConfig) -> Params:
    """The reference's init: seeded dense weights; A in [1, 16]
    log-uniform and dt in [1e-3, 0.1] from the same numpy draws as the
    reference (``RandomState(0)`` and ``(1)``), dt bias the inverse
    softplus of dt."""
    s: SSMConfig = cfg.ssm
    D = cfg.d_model
    di, nh = s.d_inner(D), s.n_heads(D)
    conv_dim = di + 2 * s.n_groups * s.d_state
    a0 = np.exp(np.random.RandomState(0).uniform(np.log(1.0), np.log(16.0),
                                                 nh))
    dt0 = np.exp(np.random.RandomState(1).uniform(np.log(1e-3), np.log(0.1),
                                                  nh))
    dt_bias = dt0 + np.log(-np.expm1(-dt0))
    return {
        "w_in": draw.dense((D, 2 * di + 2 * s.n_groups * s.d_state + nh)),
        "conv_w": draw.dense((s.conv_width, conv_dim),
                             scale=1.0 / np.sqrt(s.conv_width)),
        "conv_b": draw.zeros((conv_dim,)),
        "A_log": draw.const(np.log(a0)),
        "D": draw.ones((nh,), torch.float32),
        "dt_bias": draw.const(dt_bias),
        "norm": draw.ones((di,)),
        "w_out": draw.dense((di, D)),
    }


def init_ssm_state(cfg: ModelConfig, batch: int, dtype,
                   device) -> SSMState:
    s = cfg.ssm
    di, nh = s.d_inner(cfg.d_model), s.n_heads(cfg.d_model)
    conv_dim = di + 2 * s.n_groups * s.d_state
    return SSMState(
        ssm=torch.zeros((batch, nh, s.head_dim, s.d_state),
                        dtype=torch.float32, device=device),
        conv=torch.zeros((batch, conv_dim, s.conv_width - 1), dtype=dtype,
                         device=device))


def _split_proj(cfg: ModelConfig, h):
    """The input projection's (z, xBC, dt) parts along the last axis."""
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    gn = 2 * s.n_groups * s.d_state
    nh = s.n_heads(cfg.d_model)
    z, xBC, dt = torch.split(h, [di, di + gn, nh], dim=-1)
    return z, xBC, dt


def _causal_conv(xBC, w, b):
    """Depthwise causal conv1d from a zero window.  xBC:(B,S,C); w:(W,C).
    Returns (silu(y), the last W-1 inputs (B, C, W-1))."""
    B, S, C = xBC.shape
    W = w.shape[0]
    pad = torch.zeros((B, W - 1, C), dtype=xBC.dtype, device=xBC.device)
    xp = torch.cat([pad, xBC], dim=1)                       # (B,S+W-1,C)
    y = sum(xp[:, i:i + S, :] * w[i][None, None, :] for i in range(W))
    y = y + b[None, None, :]
    new_state = xp[:, -(W - 1):, :].transpose(1, 2)
    return F.silu(y.to(torch.float32)).to(xBC.dtype), new_state


def _heads(cfg: ModelConfig, xBC, lead):
    """Split the conv output into x (lead, nh, hd) and the group
    projections B, C broadcast over the heads (lead, nh, N); with one
    group all three are views."""
    s = cfg.ssm
    di, nh, N, G = s.d_inner(cfg.d_model), s.n_heads(cfg.d_model), \
        s.d_state, s.n_groups
    xs, Bm, Cm = torch.split(xBC, [di, G * N, G * N], dim=-1)
    rep = nh // G
    bcast = lambda t: reshape(reshape(t, *lead, G, 1, N)
                              .expand(*lead, G, rep, N), *lead, nh, N)
    return reshape(xs, *lead, nh, s.head_dim), bcast(Bm), bcast(Cm)


def mamba_mixer(cfg: ModelConfig, p: Params, x):
    """Full-sequence SSD mixer (train / prefill) from a zero state, as the
    reference runs both.  x:(B,S,D).  Returns (out, SSMState): the final
    state that decode continues from (training drops it)."""
    s = cfg.ssm
    B, S, _ = x.shape
    di = s.d_inner(cfg.d_model)
    z, xBC, dt = _split_proj(cfg, x @ p["w_in"])
    xBC, conv_state = _causal_conv(xBC, p["conv_w"], p["conv_b"])
    xs, Bm, Cm = _heads(cfg, xBC, (B, S))
    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"][None, None])
    A = -torch.exp(p["A_log"])                              # (nh,)
    y, h_last = ops.ssd_scan(xs * dt[..., None].to(xs.dtype),
                             dt * A[None, None], Bm, Cm,
                             chunk=min(s.chunk, S), return_state=True)
    y = y + xs * p["D"][None, None, :, None].to(xs.dtype)
    y = gated_rms_norm(reshape(y, B, S, di), z, p["norm"], cfg.norm_eps)
    return y @ p["w_out"], SSMState(ssm=h_last, conv=conv_state)


def mamba_decode(cfg: ModelConfig, p: Params, x, state: SSMState):
    """Single-token recurrent step.  x:(B,1,D) → (out (B,1,D), state)."""
    s = cfg.ssm
    B = x.shape[0]
    di = s.d_inner(cfg.d_model)
    z, xBC, dt = _split_proj(cfg, x[:, 0] @ p["w_in"])
    win = torch.cat([state.conv, xBC[:, :, None]], dim=-1)   # (B, C, W)
    conv = torch.einsum("bcw,wc->bc", win, p["conv_w"]) + p["conv_b"]
    xBC_t = F.silu(conv.to(torch.float32)).to(xBC.dtype)
    xs, Bm, Cm = _heads(cfg, xBC_t, (B,))
    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"][None])   # (B, nh)
    A = -torch.exp(p["A_log"])
    a = torch.exp(dt * A[None])
    upd = torch.einsum("bh,bhp,bhn->bhpn", dt, xs.to(torch.float32),
                       Bm.to(torch.float32))
    new_ssm = a[..., None, None] * state.ssm + upd
    y = torch.einsum("bhpn,bhn->bhp", new_ssm, Cm.to(torch.float32))
    y = y.to(xs.dtype) + xs * p["D"][None, :, None].to(xs.dtype)
    y = gated_rms_norm(reshape(y, B, di), z, p["norm"], cfg.norm_eps)
    return (y @ p["w_out"])[:, None, :], \
        SSMState(ssm=new_ssm, conv=win[:, :, 1:])

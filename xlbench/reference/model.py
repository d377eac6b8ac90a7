"""The plain reference of the served model: a dense decoder with grouped
query attention, written from its equations in plain PyTorch over whole
sequences (no cache, no kernels, no batching of lanes).

x = embed[tokens]; each layer adds attention(rms_norm(x)) and then
ffn(rms_norm(x)); logits = rms_norm(x) @ head.  RMSNorm in float32 with
eps from the file; rotary embedding on q and k over the whole head, the
two halves rotated as pairs (frequencies theta^(-2i/hd)); query head h
reads key/value head h // (H / K); scores scaled by 1/sqrt(hd), causal;
the FFN SwiGLU, (silu(x W_gate) * (x W_in)) W_out, or GELU in its tanh
form, gelu(x W_in) W_out.  Matrix products are float32 with TF32 off
unless the caller runs the control.
"""

from __future__ import annotations

import contextlib
import math

import torch


def rms_norm(x, scale, eps):
    var = x.pow(2).mean(dim=-1, keepdim=True)
    return x * torch.rsqrt(var + eps) * scale


def rope(x, theta):
    """x (B, S, heads, hd) at positions 0..S-1."""
    S, hd = x.shape[1], x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                        device=x.device) / hd))
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    a, b = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """float32 products as stated (TF32 off), or in TF32 (the control)."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def ffn(act: str, f: dict, i: int, h):
    """Layer i's FFN activations (before W_out)."""
    up = h @ f["w_in"][i]
    if act == "swiglu":
        return torch.nn.functional.silu(h @ f["w_gate"][i]) * up
    if act == "gelu":
        c = math.sqrt(2.0 / math.pi)
        return 0.5 * up * (1.0 + torch.tanh(c * (up + 0.044715 * up ** 3)))
    raise ValueError(f"no reference for the activation {act!r}")


def forward(m: dict, params: dict, tokens) -> torch.Tensor:
    """Logits (B, S, padded vocab) in float32 of tokens (B, S)."""
    L, H, K, hd = m["n_layers"], m["n_heads"], m["n_kv_heads"], m["head_dim"]
    eps, theta = m["norm_eps"], m["rope_theta"]
    B, S = tokens.shape
    blk = params["blocks"]
    x = params["embed"][tokens.long()].float()
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    for i in range(L):
        h = rms_norm(x, blk["norm1"][i], eps)
        a = blk["attn"]
        q = rope((h @ a["wq"][i]).view(B, S, H, hd), theta)
        k = rope((h @ a["wk"][i]).view(B, S, K, hd), theta)
        v = (h @ a["wv"][i]).view(B, S, K, hd)
        k = k.repeat_interleave(H // K, dim=2)
        v = v.repeat_interleave(H // K, dim=2)
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
        s = s.masked_fill(~causal, float("-inf"))
        o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)
        x = x + o.reshape(B, S, H * hd) @ a["wo"][i]
        h = rms_norm(x, blk["norm2"][i], eps)
        f = blk["ffn"]
        x = x + ffn(m["ffn_act"], f, i, h) @ f["w_out"][i]
    return rms_norm(x, params["norm_f"], eps) @ params["head"]

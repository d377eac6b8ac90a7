"""GQA and MLA attention for training, prefill and one-token decode, and
whisper's cross-attention (twin of ``repro/models/attention.py``).

Weights are flat on the head axis (``wq: (D, H*hd)``); GQA caches are
``(B, S, K, hd)`` per layer, MLA caches the latent ``ckv (B, S, r)`` and
the shared rope key ``krope (B, S, dr)``.  GQA self-attention over a
whole sequence (causal, or not in whisper's encoder) runs through
``ops.flash_attention`` and GQA decode attention through
``ops.decode_attention``: the hand-written kernels on the card, their
plain versions on the CPU.  MLA is plain PyTorch on every device, as the
reference computes it in plain jnp: neither kernel takes its 192-wide q/k
with a 128-wide v, or the absorbed latent-space decode.  Whisper's cross
prefill (decoder queries against the encoder's frames, no rope) is plain
PyTorch too: the flash kernel, like the TPU one, takes q and k/v of one
length, and there are 448 queries against 1500 frames; it is recomputed
in the backward rather than saved.  Cross decode is one query against
every frame, so it runs through ``ops.decode_attention`` with
``lengths = F - 1``.  Unlike the reference, the caches are written in
place (the caller owns them; no copy per step or per layer).

The full-sequence paths take the reference's layout knobs: ``shard``
(``RunCtx.shard``, called at the reference's ``"heads"``, ``"kv_full"``,
``"heads4"`` and ``"scores4"`` places), ``q_chunk`` (query rows a chunk
of the plain attention: the CPU's and the meta device's forward, and the
backward's recompute of B7; the kernel on the card keeps its own tiles,
and computes the same function) and ``expand_kv`` (GQA expanded to MHA,
zero-padded to a head count the model axis divides).  The reference's
``"scores"`` slab of GQA lives inside B7 here: on DTensors
``ops.flash_attention`` runs the kernel on each rank's heads
(``local_map``), which is the layout that rule asks for.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.models.layers import (Draw, Params, apply_rope, reshape,
                                       write_prefix, write_rows)

NEG_INF = -1e30


def _no_shard(x, kind=None):
    return x


def init_gqa(draw: Draw, cfg: ModelConfig) -> Params:
    D, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {"wq": draw.dense((D, H * hd)), "wk": draw.dense((D, K * hd)),
            "wv": draw.dense((D, K * hd)), "wo": draw.dense((H * hd, D))}


def init_mla(draw: Draw, cfg: ModelConfig) -> Params:
    m, D, H = cfg.mla, cfg.d_model, cfg.n_heads
    p = {"w_dkv": draw.dense((D, m.kv_lora_rank + m.qk_rope_head_dim)),
         "w_uk": draw.dense((m.kv_lora_rank, H * m.qk_nope_head_dim)),
         "w_uv": draw.dense((m.kv_lora_rank, H * m.v_head_dim)),
         "wo": draw.dense((H * m.v_head_dim, D))}
    if m.q_lora_rank:
        p["w_dq"] = draw.dense((D, m.q_lora_rank))
        p["w_uq"] = draw.dense((m.q_lora_rank, H * m.qk_head_dim))
    else:
        p["w_uq"] = draw.dense((D, H * m.qk_head_dim))
    return p


def init_attn(draw: Draw, cfg: ModelConfig) -> Params:
    return init_mla(draw, cfg) if cfg.mla is not None else init_gqa(draw, cfg)


def init_gqa_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                   device) -> Params:
    K, hd = cfg.n_kv_heads, cfg.head_dim
    z = lambda: torch.zeros((batch, max_len, K, hd), dtype=dtype,
                            device=device)
    return {"k": z(), "v": z()}


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                   device) -> Params:
    m = cfg.mla
    z = lambda w: torch.zeros((batch, max_len, w), dtype=dtype,
                              device=device)
    return {"ckv": z(m.kv_lora_rank), "krope": z(m.qk_rope_head_dim)}


def init_attn_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                    device) -> Params:
    init = init_mla_cache if cfg.mla is not None else init_gqa_cache
    return init(cfg, batch, max_len, dtype, device)


def _qkv(cfg: ModelConfig, p: Params, x, positions, kv_x=None):
    """Projections: q (B, Sq, H, hd) from x, k/v (B, Skv, K, hd) from
    ``kv_x`` (x itself where None); rope on q and k for self-attention
    only, as the reference."""
    B, Sq, _ = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    src = x if kv_x is None else kv_x
    Skv = src.shape[1]
    q = reshape(ops.dense(x, p["wq"]), B, Sq, H, hd)
    k = reshape(ops.dense(src, p["wk"]), B, Skv, K, hd)
    v = reshape(ops.dense(src, p["wv"]), B, Skv, K, hd)
    if kv_x is not None:
        return q, k, v
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def _cross_sdpa(q, k, v):
    """q (B, Sq, H, hd) against every frame of k/v (B, F, K, hd): the
    reference's ``sdpa`` without a mask, in plain PyTorch.  Where a
    gradient is wanted (training) it is checkpointed: the backward
    recomputes the (B, H, Sq, F) f32 scores from q, k and v instead of
    keeping them (it draws no random numbers: no RNG state is saved,
    which a captured training step could not read).  Serving, whose
    weights take no gradient, calls it plainly."""
    if any(t.requires_grad for t in (q, k, v)):
        return torch.utils.checkpoint.checkpoint(
            fa.attention_rows, q, k, v, 0, use_reentrant=False,
            preserve_rng_state=False, causal=False)
    return fa.attention_rows(q, k, v, 0, causal=False)


def _expand_heads(q, k, v, heads: int):
    """GQA→MHA: each K/V head repeated for its G query heads, then q, k
    and v zero-padded to ``heads`` heads where that is more (the
    reference's ``sdpa`` with ``expand_kv``)."""
    H, K = q.shape[2], k.shape[2]
    if K < H:
        k = k.repeat_interleave(H // K, dim=2)
        v = v.repeat_interleave(H // K, dim=2)
    if heads > H:
        pad = (0, 0, 0, heads - H)
        q, k, v = (F.pad(t, pad) for t in (q, k, v))
    return q, k, v


def gqa_full(cfg: ModelConfig, p: Params, x, positions, *,
             causal: bool = True, kv_x=None, cache: Params | None = None,
             shard=None, q_chunk: int = 0, expand_kv: int = 0):
    """Full-sequence attention (train / prefill / encoder / cross).
    x: (B, S, D); positions broadcastable to (B, S).  Self-attention
    (``kv_x`` None) ropes q and k and runs ``ops.flash_attention``,
    causal or not, its plain version over ``q_chunk``-row query chunks
    where that divides S; with ``expand_kv`` the K/V heads are repeated
    to MHA and every head zero-padded to ``expand_kv`` heads, the padding
    dropped after.  Cross-attention (``kv_x`` (B, F, D), the encoder's
    output) takes k/v from it, no rope, no mask, in plain PyTorch.  With
    ``cache``, the K/V are written into its ``"k"`` / ``"v"`` at offset 0
    (in place, when they fit, as the reference's ``dynamic_update_slice``
    does).  Returns (out, cache)."""
    B, S, _ = x.shape
    q, k, v = _qkv(cfg, p, x, positions, kv_x)
    if kv_x is None:
        con = shard or _no_shard
        qa, ka, va = _expand_heads(q, k, v, expand_kv) if expand_kv \
            else (q, k, v)
        Hx, K = qa.shape[2], ka.shape[2]
        qa = reshape(con(reshape(qa, B, S, K, Hx // K, -1), "heads"),
                     B, S, Hx, -1)
        chunked = q_chunk and S > q_chunk and S % q_chunk == 0
        if chunked:
            ka, va = con(ka, "kv_full"), con(va, "kv_full")
        out = ops.flash_attention(qa, ka, va, causal=causal,
                                  q_chunk=q_chunk if chunked else 0)
        out = out[:, :, :cfg.n_heads] if Hx != cfg.n_heads else out
    else:
        out = _cross_sdpa(q, k, v)
    n = k.shape[1]
    if cache is not None and n <= cache["k"].shape[1]:
        write_prefix(cache["k"], k)
        write_prefix(cache["v"], v)
    return ops.dense(reshape(out, B, S, -1), p["wo"]), cache


def gqa_decode(cfg: ModelConfig, p: Params, x, lengths, cache: Params):
    """One-token decode. x:(B,1,D); cache k/v:(B,S,K,hd); lengths:(B,).

    Writes K/V at ``lengths`` in place; an index past the cache raises
    (the CPU) or device-asserts (CUDA) — the completion rule keeps active
    lengths <= max_len - 2, so it never happens on the serving path.
    """
    B = x.shape[0]
    q, k, v = _qkv(cfg, p, x, lengths[:, None])
    write_rows(cache["k"], lengths, k[:, 0])
    write_rows(cache["v"], lengths, v[:, 0])
    out = ops.decode_attention(q[:, 0], cache["k"], cache["v"], lengths)
    return ops.dense(reshape(out, B, 1, -1), p["wo"]), cache


def gqa_cross_decode(cfg: ModelConfig, p: Params, x, cross_k, cross_v):
    """Cross-attention decode (whisper): x (B, 1, D) against the encoder
    K/V the prefill stored, (B, F, K, hd), every frame valid: through
    ``ops.decode_attention`` with ``lengths = F - 1``."""
    B = x.shape[0]
    q = reshape(x @ p["wq"], B, cfg.n_heads, cfg.head_dim)
    lengths = torch.full((B,), cross_k.shape[1] - 1, dtype=torch.int32,
                         device=x.device)
    out = ops.decode_attention(q, cross_k, cross_v, lengths)
    return reshape(out, B, 1, -1) @ p["wo"]


# --------------------------------------------------------------------------- #
# MLA (DeepSeek-V2)
# --------------------------------------------------------------------------- #


def q_chunk_for(S: int, q_chunk: int = 0) -> int:
    """Query rows a chunk of the plain full-sequence attention (GQA's
    plain version and recompute, MLA): ``q_chunk`` where given, else none
    below 4096, 512 up to 8192, then 256 (the reference's
    ``transformer._auto_q_chunk``; the port's twin of it calls this): at
    S = 4096 with 128 heads an unchunked f32 score slab would be 16 GiB a
    pair of sequences."""
    if q_chunk:
        return q_chunk
    if S < 4096:
        return 0
    return 512 if S <= 8192 else 256


def _mla_sdpa(q_nope, q_rope, k_nope, k_rope, v, scale: float,
              q_chunk: int = 0, shard=None):
    """Causal attention with the decoupled-rope split scores, over query
    chunks of ``q_chunk`` rows where that divides S.  q_nope/k_nope
    (B, S, H, dn); q_rope (B, S, H, dr); k_rope (B, S, dr) shared by the
    heads; v (B, S, H, dv).  Scores and softmax in f32.  Under autograd
    each chunk is checkpointed, as the reference's: the backward
    recomputes one chunk's f32 score slab instead of keeping every
    chunk's."""
    con = shard or _no_shard
    Sq, Skv = q_nope.shape[1], k_nope.shape[1]

    def block(qn, qr, off: int):
        s = torch.einsum("bqhd,bshd->bhqs", qn, k_nope).float()
        s = s + torch.einsum("bqhd,bsd->bhqs", qr, k_rope).float()
        s = con(s, "scores4") * scale
        qpos = off + torch.arange(qn.shape[1], device=qn.device)[:, None]
        kpos = torch.arange(Skv, device=qn.device)[None, :]
        s = s.masked_fill(kpos > qpos, NEG_INF)
        w = torch.softmax(s, dim=-1)
        return torch.einsum("bhqs,bshd->bqhd", w.to(v.dtype), v)

    q_nope, q_rope = con(q_nope, "heads4"), con(q_rope, "heads4")
    if q_chunk and Sq > q_chunk and Sq % q_chunk == 0:
        k_nope = con(k_nope, "heads4")      # full S, head-sharded: fixed
        run = block
        if torch.is_grad_enabled():
            run = functools.partial(torch.utils.checkpoint.checkpoint, block,
                                    use_reentrant=False,
                                    preserve_rng_state=False)
        return torch.cat([run(q_nope[:, i:i + q_chunk],
                              q_rope[:, i:i + q_chunk], i)
                          for i in range(0, Sq, q_chunk)], dim=1)
    return block(q_nope, q_rope, 0)


def _mla_q(cfg: ModelConfig, p: Params, x, positions):
    m = cfg.mla
    B, S, _ = x.shape
    hq = x @ p["w_dq"] if "w_dq" in p else x
    q = reshape(hq @ p["w_uq"], B, S, cfg.n_heads, m.qk_head_dim)
    q_nope, q_rope = q.split([m.qk_nope_head_dim, m.qk_rope_head_dim], -1)
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def _mla_latent(cfg: ModelConfig, p: Params, x, positions):
    """The latent ``ckv`` (B, S, r) and the roped shared key (B, S, dr)."""
    m = cfg.mla
    ckv, k_rope = (x @ p["w_dkv"]).split(
        [m.kv_lora_rank, m.qk_rope_head_dim], -1)
    k_rope = apply_rope(k_rope[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0]
    return ckv, k_rope


def _mla_scale(cfg: ModelConfig) -> float:
    return 1.0 / math.sqrt(cfg.mla.qk_head_dim)


def mla_full(cfg: ModelConfig, p: Params, x, positions, *,
             cache: Params | None = None, shard=None, q_chunk: int = 0):
    """Full-sequence MLA (prefill): k/v materialised from the latent, the
    queries chunked by ``q_chunk`` rows.  With ``cache``, the latent and
    the rope key are written into it at offset 0 (in place).  Returns
    (out, cache)."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.n_heads
    q_nope, q_rope = _mla_q(cfg, p, x, positions)
    ckv, k_rope = _mla_latent(cfg, p, x, positions)
    k_nope = reshape(ckv @ p["w_uk"], B, S, H, m.qk_nope_head_dim)
    v = reshape(ckv @ p["w_uv"], B, S, H, m.v_head_dim)
    out = _mla_sdpa(q_nope, q_rope, k_nope, k_rope, v, _mla_scale(cfg),
                    q_chunk, shard)
    out = ops.dense(reshape(out, B, S, H * m.v_head_dim), p["wo"])
    if cache is not None:
        write_prefix(cache["ckv"], ckv)
        write_prefix(cache["krope"], k_rope)
    return out, cache


def mla_decode(cfg: ModelConfig, p: Params, x, lengths, cache: Params):
    """Absorbed MLA decode: W_UK folded into the query and W_UV applied
    after the weighted sum, so scores and values stay in the latent space
    of the (B, S, r) + (B, S, dr) cache.  Writes the new latent and rope
    key at ``lengths`` in place.  Returns (out, cache)."""
    m = cfg.mla
    B = x.shape[0]
    H = cfg.n_heads
    q_nope, q_rope = _mla_q(cfg, p, x, lengths[:, None])
    w_uk = reshape(p["w_uk"], m.kv_lora_rank, H, m.qk_nope_head_dim)
    q_lat = torch.einsum("bqhd,rhd->bqhr", q_nope, w_uk)
    ckv_new, krope_new = _mla_latent(cfg, p, x, lengths[:, None])
    ckv, krope = cache["ckv"], cache["krope"]
    write_rows(ckv, lengths, ckv_new[:, 0])
    write_rows(krope, lengths, krope_new[:, 0])
    s_lat = torch.einsum("bqhr,bsr->bhqs", q_lat, ckv).float()
    s_rope = torch.einsum("bqhd,bsd->bhqs", q_rope, krope).float()
    kpos = torch.arange(ckv.shape[1], device=x.device)
    mask = (kpos[None, :] <= lengths[:, None])[:, None, None]
    scores = torch.where(mask, (s_lat + s_rope) * _mla_scale(cfg), NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out_lat = torch.einsum("bhqs,bsr->bqhr", w.to(ckv.dtype), ckv)
    w_uv = reshape(p["w_uv"], m.kv_lora_rank, H, m.v_head_dim)
    out = torch.einsum("bqhr,rhd->bqhd", out_lat, w_uv)
    return ops.dense(reshape(out, B, 1, H * m.v_head_dim), p["wo"]), cache


# --------------------------------------------------------------------------- #
# The entry points of the blocks
# --------------------------------------------------------------------------- #


def attn_full(cfg: ModelConfig, p: Params, x, positions, *, cache=None,
              causal: bool = True, shard=None, q_chunk: int = 0,
              expand_kv: int = 0):
    """Self-attention over a whole sequence; MLA is causal only (no
    encoder has it) and takes no ``expand_kv`` (its heads shard)."""
    if cfg.mla is not None:
        return mla_full(cfg, p, x, positions, cache=cache, shard=shard,
                        q_chunk=q_chunk)
    return gqa_full(cfg, p, x, positions, causal=causal, cache=cache,
                    shard=shard, q_chunk=q_chunk, expand_kv=expand_kv)


def attn_decode(cfg: ModelConfig, p: Params, x, lengths, cache: Params):
    if cfg.mla is not None:
        return mla_decode(cfg, p, x, lengths, cache)
    return gqa_decode(cfg, p, x, lengths, cache)

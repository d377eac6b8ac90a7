"""Roofline analysis of the port's dry run (twin of
``repro/roofline/analysis.py``).

Three terms per (arch × shape × mesh) cell, in seconds a step,
predicted from the H100's data-sheet rates (``roofline/constants.py``):

  compute    = traced FLOPs per device / BF16_OPS_PS
  memory     = analytic HBM bytes per device / MEM_BPS
  collective = traced collective wire bytes per device / LINK_BPS

The reference reads its FLOPs from XLA's optimized HLO (``parse_hlo``).
The port has no compiled program to read: ``trace_step_flops`` runs the
port's own step on the meta device under ``FlopCounterMode`` and counts
the matmul, bmm and convolution FLOPs it issues, the backward's included
(and so the block remat's second forward and the recompute of B7's and
B8's backward, as the reference's HLO holds its remat).  The collectives
come from the port's step on DTensors over a fake process group of the
mesh's ranks (``launch/dryrun.py::trace_collectives``): each functional
collective rank 0 issues, turned into wire bytes by the reference's
formulas (``wire_bytes``) and timed at one NVLink direction's rate.
That rate is the one of the links inside an 8-GPU node: the links
between nodes are slower and not modelled, so ``collective_s`` is a
lower bound for a mesh past 8 cards.

``model_flops`` (6·N·T dense / 6·N_active·T MoE + attention) is the
useful-work yardstick, ``analytic_memory_bytes`` / ``cache_bytes`` the
traffic model: both are the reference's arithmetic in the reference's
order, so their results are equal as floats.
"""

from __future__ import annotations

import math
from typing import Optional

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.roofline.constants import (BF16_OPS_PS, HBM_BYTES,
                                            LINK_BPS, MEM_BPS)

COLLECTIVE_NOTE = ("wire bytes a device of the sharded trace's "
                   "collectives at NVLink's 450e9 B/s a direction; links "
                   "between 8-GPU nodes are slower and not modelled")


def wire_bytes(kind: str, operand_bytes: float, group: int) -> float:
    """Bytes a device puts on the wire for one collective whose operand
    (the local input) is ``operand_bytes``, over ``group`` ranks: the
    reference's ``parse_hlo`` formulas, which take the result's bytes b
    (all-gather b(g-1)/g with b = operand x g, all-reduce 2b(g-1)/g,
    reduce-scatter b(g-1) with b = operand / g, all-to-all b(g-1)/g,
    permute b)."""
    g = group
    if kind == "all-gather":
        return operand_bytes * g * (g - 1) / g
    if kind == "all-reduce":
        return 2.0 * operand_bytes * (g - 1) / g
    if kind == "reduce-scatter":
        return operand_bytes / g * (g - 1)
    if kind == "all-to-all":
        return operand_bytes * (g - 1) / g
    return float(operand_bytes)


# --------------------------------------------------------------------------- #
# Traced FLOPs
# --------------------------------------------------------------------------- #


def trace_step_flops(step, *args) -> float:
    """The matmul / bmm / convolution FLOPs of ``step(*args)``, the
    backward's included, counted by ``torch.utils.flop_counter`` as the
    step issues them.  Give it meta tensors (``launch/dryrun.py`` does):
    the kernel wrappers then run their plain versions, which on meta
    compute shapes only, and nothing is allocated or launched."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        step(*args)
    return float(counter.get_total_flops())


# --------------------------------------------------------------------------- #
# Analytic useful-work + memory-traffic models
# --------------------------------------------------------------------------- #


def attn_layers(cfg: ModelConfig) -> int:
    if cfg.family == "ssm":
        return 0
    if cfg.is_hybrid:
        return cfg.n_layers // cfg.attn_period
    return cfg.n_layers


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """6·N·T (train) / 2·N·T (inference) + attention score/value FLOPs."""
    B, S = shape.global_batch, shape.seq_len
    N = cfg.active_param_count()
    La = attn_layers(cfg)
    H, hd = max(cfg.n_heads, 1), max(cfg.head_dim, 1)
    if cfg.mla is not None:
        hd = cfg.mla.qk_head_dim
    if shape.kind == "train":
        T = B * S
        attn = La * 2.0 * B * S * S * H * hd          # causal fwd (÷2) ×QK,AV
        if cfg.is_encdec:
            F = cfg.enc_frames
            attn += cfg.n_enc_layers * 4.0 * B * F * F * H * hd
            attn += La * 4.0 * B * S * F * H * hd     # cross
        return 6.0 * N * T + 3.0 * attn               # bwd ≈ 2× fwd
    if shape.kind == "prefill":
        T = B * S
        return 2.0 * N * T + La * 2.0 * B * S * S * H * hd
    # decode: one token, full-cache attention reads
    if cfg.mla is not None:
        r = cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim
        attn = La * 2.0 * B * S * cfg.n_heads * (r + cfg.mla.kv_lora_rank)
    else:
        attn = La * 4.0 * B * S * H * hd
    ssm = 0.0
    if cfg.ssm is not None:
        s = cfg.ssm
        nh = s.n_heads(cfg.d_model)
        n_ssm = (cfg.n_layers - La) if cfg.is_hybrid else cfg.n_layers
        ssm = n_ssm * 6.0 * B * nh * s.head_dim * s.d_state
    return 2.0 * N * B + attn + ssm


def analytic_memory_bytes(cfg: ModelConfig, shape: ShapeConfig,
                          n_chips: int, moment_bytes: int = 4,
                          param_shards: Optional[int] = None) -> float:
    """Per-device HBM traffic per step (documented approximation):

      train   : params 2R+1W (fwd+bwd use, update write) + grads 1W+1R +
                moments 2R+2W + remat boundary activations (2W+2R)
      prefill : params 1R + boundary activations + cache 1W
      decode  : params 1R + cache 1R (+ small writes)
    """
    P = cfg.param_count()
    pb = 2 * P / (param_shards or n_chips)      # bf16 local param bytes
    B, S = shape.global_batch, shape.seq_len
    D, L = cfg.d_model, cfg.n_layers
    if shape.kind == "train":
        act = 2 * B * S * D * L / n_chips       # bf16 boundary residuals
        mom = 2 * moment_bytes * P / n_chips
        return 3 * pb + 2 * pb + 2 * mom + 4 * act
    if shape.kind == "prefill":
        act = 2 * B * S * D * L / n_chips
        cache = cache_bytes(cfg, shape) / n_chips
        return pb + 2 * act + cache
    cache = cache_bytes(cfg, shape) / n_chips
    return pb + cache


def cache_bytes(cfg: ModelConfig, shape: ShapeConfig) -> float:
    B, S = shape.global_batch, shape.seq_len
    La = attn_layers(cfg)
    if cfg.mla is not None:
        per_tok = cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim
    else:
        per_tok = 2 * cfg.n_kv_heads * cfg.head_dim
    kv = 2.0 * La * B * S * per_tok             # bf16
    ssm = 0.0
    if cfg.ssm is not None:
        s = cfg.ssm
        nh = s.n_heads(cfg.d_model)
        n_ssm = (cfg.n_layers - La) if cfg.is_hybrid else cfg.n_layers
        ssm = 4.0 * n_ssm * B * nh * s.head_dim * s.d_state
    if cfg.is_encdec:
        kv += 2.0 * La * B * cfg.enc_frames * per_tok * 2
    return kv + ssm


# --------------------------------------------------------------------------- #
# Entry point used by dryrun.py
# --------------------------------------------------------------------------- #


def trip_hint(cfg: ModelConfig) -> int:
    from repro_torch.models.model import n_scan_blocks
    return n_scan_blocks(cfg)


def analyze_traced(cfg: ModelConfig, shape: ShapeConfig, ms,
                   traced: dict) -> dict:
    """The report of one traced cell on the mesh of ``ms``
    (``sharding/specs.py::MeshSpec``).  ``traced``: ``flops`` (the whole
    step's, from ``trace_step_flops``) and the per-device
    ``argument_bytes``, ``output_bytes`` and ``temp_bytes`` the dry run
    counted, with ``temp_rule`` saying how.  The traced FLOPs are divided
    evenly over the chips.  Every time in it is a prediction from the
    data-sheet peaks, not a measurement."""
    n_chips = math.prod(ms.mesh.shape.values())
    flops_dev = traced["flops"] / n_chips
    param_shards = (ms.mesh.shape[ms.tp]
                    if getattr(ms, "params_tp_only", False) else None)
    mem_dev = analytic_memory_bytes(cfg, shape, n_chips,
                                    param_shards=param_shards)
    mf = model_flops(cfg, shape)

    compute_s = flops_dev / BF16_OPS_PS
    memory_s = mem_dev / MEM_BPS
    terms = {"compute": compute_s, "memory": memory_s}
    coll = traced.get("collectives")
    collective_s = None
    if coll is not None:
        collective_s = coll["collective_bytes"] / LINK_BPS
        terms["collective"] = collective_s
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    useful_frac = (mf / n_chips / BF16_OPS_PS) / bound if bound else 0.0

    arg, out, temp = (traced["argument_bytes"], traced["output_bytes"],
                      traced["temp_bytes"])
    per_dev_bytes = arg + out + temp
    return {
        "n_chips": n_chips,
        "memory_analysis": {
            "argument_GiB": round(arg / 2**30, 3),
            "output_GiB": round(out / 2**30, 3),
            "temp_GiB": round(temp / 2**30, 3),
            "total_GiB": round(per_dev_bytes / 2**30, 3),
            "fits_hbm": bool(per_dev_bytes < HBM_BYTES),
            "hbm_GiB": round(HBM_BYTES / 2**30, 3),
            "temp_rule": traced["temp_rule"],
        },
        "traced": {
            "flops_per_device": flops_dev,
            "flops": traced["flops"],
            "recompute_included": shape.kind == "train",
            "trip_hint": trip_hint(cfg),
        },
        "roofline": {
            "compute_s": compute_s,
            "memory_s": memory_s,
            "collective_s": collective_s,
            "collective_note": COLLECTIVE_NOTE,
            "collectives": None if coll is None else coll["kinds"],
            "collective_bytes_per_device": None if coll is None
            else coll["collective_bytes"],
            "dominant": dominant,
            "step_lower_bound_s": bound,
            "model_flops": mf,
            "model_flops_per_device": mf / n_chips,
            "useful_flops_ratio": (mf / n_chips) / flops_dev if flops_dev
            else None,
            "roofline_fraction": useful_frac,
            "analytic_hbm_bytes_per_device": mem_dev,
        },
    }

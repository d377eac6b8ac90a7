"""Mixture-of-Experts FFN driven by the XLB relay (twin of
``repro/models/moe.py``, single-device branch).

Token → expert routing is L7 load balancing: the router's logits are the
route match, gate-greedy top-k the balancing policy, an expert's capacity
its connection pool, and the dispatch the socket relay.  With the default
``method="sort"`` the slot of each routed row in its expert's pool comes
from ``ops.relay_slots``: the relay kernel (``csrc/relay.cu``) on the
card, its plain version (the counting sort ``positions_sort``) on the
CPU.  The scatter into (E, C + 1, D) pools, the expert FFNs (three
``torch.bmm``) and the combine are plain PyTorch, as the reference
computes them in jnp outside any kernel.  ``cumsum`` and ``einsum`` are
the reference's other two dispatches, kept as its oracles.

The assigned shapes: deepseek-v2 (2 shared + 160 routed experts, top-6,
first layer dense), arctic (128 routed, top-2, a dense residual MLP in
parallel), jamba (16 routed, top-2, on odd layers).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core import relay
from repro_torch.kernels import ops
from repro_torch.models.layers import Draw, Params, ffn, init_ffn


class MoEMetrics(NamedTuple):
    aux_loss: torch.Tensor       # load-balancing loss (Switch-style)
    z_loss: torch.Tensor         # router logit z-loss
    overflow_frac: torch.Tensor  # dropped-row fraction (pool exhaustion)
    load: torch.Tensor           # (E,) rows routed per expert (pre-drop)

    @staticmethod
    def zero(n_experts: int, device) -> "MoEMetrics":
        z = torch.zeros((), device=device)
        return MoEMetrics(z, z, z, torch.zeros((n_experts,),
                                               dtype=torch.int32,
                                               device=device))


def init_moe(draw: Draw, cfg: ModelConfig) -> Params:
    m = cfg.moe
    D, E, Fe = cfg.d_model, m.n_experts, m.d_ff_expert
    p = {"router": draw.dense((D, E), dtype=torch.float32),
         "w_in": draw.dense((E, D, Fe)),
         "w_gate": draw.dense((E, D, Fe)),
         "w_out": draw.dense((E, Fe, D))}
    if m.n_shared_experts:
        p["shared"] = init_ffn(draw, D, m.n_shared_experts * Fe, cfg.ffn_act)
    if m.dense_residual:
        p["residual"] = init_ffn(draw, D, cfg.d_ff, cfg.ffn_act)
    return p


def capacity_for(n_tokens: int, cfg: ModelConfig) -> int:
    """Connection-pool size per expert for ``n_tokens`` routed tokens: a
    multiple of 8, at least 8."""
    m = cfg.moe
    c = math.ceil(n_tokens * m.top_k * m.capacity_factor / m.n_experts)
    return max(8, -(-c // 8) * 8)


def _expert_ffn(w: Params, pool):
    """pool (E, C, D) → (E, C, D): each expert's swiglu FFN."""
    h = torch.bmm(pool, w["w_in"])
    g = F.silu(torch.bmm(pool, w["w_gate"]))
    return torch.bmm(h * g, w["w_out"])


def route(cfg: ModelConfig, p: Params, xf, router_bias=None):
    """Router: f32 logits → (top-k weights (T, k), expert ids (T, k) i32,
    aux, z).  Ties break toward the lower expert id, as ``lax.top_k``
    breaks them (a stable descending sort; ``torch.topk`` promises no
    order on CUDA).  ``router_bias`` (E,) shifts the selection only; the
    combine weights are the unbiased gates, renormalised."""
    m = cfg.moe
    logits = xf.float() @ p["router"].float()                # (T, E)
    gates = torch.softmax(logits, dim=-1)
    sel = gates if router_bias is None else gates + router_bias[None, :]
    idx = torch.sort(sel, dim=-1, descending=True,
                     stable=True).indices[:, :m.top_k]        # (T, k)
    weights = gates.gather(-1, idx)
    weights = weights / (weights.sum(-1, keepdim=True) + 1e-9)
    # Switch aux loss: E * sum_e f_e * P_e
    me = gates.mean(0)
    flat = idx.reshape(-1)      # a fixed-size count: meta tensors take it
    ce = torch.zeros((m.n_experts,), dtype=torch.int64, device=flat.device) \
        .scatter_add_(0, flat, torch.ones_like(flat)).float() \
        .div(xf.shape[0])
    aux = m.n_experts * torch.sum(me * ce)
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return weights, idx.to(torch.int32), aux, z


def moe_ffn(cfg: ModelConfig, p: Params, x, *, method: str = "sort",
            ep=None, router_bias=None) -> tuple[torch.Tensor, MoEMetrics]:
    """MoE FFN on one device.  x: (B, S, D) → (out (B, S, D), metrics).

    The routed rows (token-major, k a token) go to per-expert pools of
    ``capacity_for(B * S)`` slots; rows past an expert's capacity are
    dropped and counted in ``overflow_frac``.  ``ep`` (the expert-parallel
    relay over a mesh) is not ported: it raises."""
    if ep is not None:
        raise NotImplementedError(
            "moe_ffn: the expert-parallel relay (ep) is not ported yet "
            "(ROADMAP.md item 12, with the multi-device work of item 14)")
    m = cfg.moe
    B, S, D = x.shape
    T, k = B * S, m.top_k
    xf = x.reshape(T, D)
    weights, idx, aux, z = route(cfg, p, xf, router_bias)
    x_rep = xf.repeat_interleave(k, dim=0)                  # (N, D) t-major
    idx_flat, w_flat = idx.reshape(-1), weights.reshape(-1)
    cap = capacity_for(T, cfg)
    if method == "einsum":
        buf, meta, d_oh = relay.relay_dispatch_einsum(x_rep, idx_flat,
                                                      m.n_experts, cap)
        out_flat = relay.relay_combine_einsum(_expert_ffn(p, buf), d_oh,
                                              w_flat)
    else:
        if method == "sort":
            slot, load = ops.relay_slots(idx_flat, m.n_experts)
            buf, meta = relay.relay_dispatch_at(x_rep, idx_flat, slot, load,
                                                m.n_experts, cap)
        else:
            buf, meta = relay.relay_dispatch(x_rep, idx_flat, m.n_experts,
                                             cap, method=method)
        out_flat = relay.relay_combine(_expert_ffn(p, buf), meta, w_flat)
    out = out_flat.reshape(T, k, D).sum(1).reshape(B, S, D)
    if "shared" in p:
        out = out + ffn(p["shared"], x, cfg.ffn_act)
    if "residual" in p:
        out = out + ffn(p["residual"], x, cfg.ffn_act)
    return out, MoEMetrics(aux, z, meta.overflow_frac, meta.load)

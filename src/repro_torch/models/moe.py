"""Mixture-of-Experts FFN driven by the XLB relay (twin of
``repro/models/moe.py``).

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

With ``ep=(mesh, tok_axes)`` the dispatch is the expert-parallel relay
(``core/relay.py::ep_relay``): the routed rows sharded over the mesh
axes ``tok_axes``, each rank dispatches its own into per-expert pools
through ``ops.relay_slots``, one ``all_to_all`` along ``model`` carries
each pool to the rank that owns its experts, and a second brings the
results back.  The router and the shared / residual FFNs run on whatever
the caller hands in (DTensors placed by ``sharding/specs.py``, or plain
tensors, the same on every rank).

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
from repro_torch.models.layers import Draw, Params, ffn, init_ffn, reshape
from repro_torch.sharding.specs import is_dtensor


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


def _expert_counts(flat, n: int):
    """Rows routed to each of ``n`` experts: a fixed-size count (meta
    tensors take it, unlike the data-sized ``bincount``); on a DTensor
    each rank counts its own rows and the sum is left pending over the
    axes they are sharded on."""
    if is_dtensor(flat):
        from torch.distributed.tensor import Partial, Replicate, Shard
        pl = [Partial() if isinstance(q, Shard) else Replicate()
              for q in flat.placements]
        return ops._local_map(lambda f: _expert_counts(f, n), [flat],
                              (list(flat.placements),), pl)
    return torch.zeros((n,), dtype=torch.int64, device=flat.device) \
        .scatter_add_(0, flat, torch.ones_like(flat))


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
    ce = _expert_counts(idx.reshape(-1), m.n_experts).float() \
        .div(xf.shape[0])
    aux = m.n_experts * torch.sum(me * ce)
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return weights, idx.to(torch.int32), aux, z


def _dispatch(p: Params, x_rep, idx_flat, w_flat, n: int, cap: int,
              method: str, experts=None):
    """The one-device dispatch → expert FFNs → combine of the routed rows:
    (out rows (N, D), overflow_frac, load).  ``experts`` (lo, hi): only
    those experts' pools run (``p``'s expert weights hold just them); the
    other rows come back as zeros."""
    if method == "einsum":
        buf, meta, d_oh = relay.relay_dispatch_einsum(x_rep, idx_flat, n,
                                                      cap)
    elif method == "sort":
        slot, load = ops.relay_slots(idx_flat, n)
        buf, meta = relay.relay_dispatch_at(x_rep, idx_flat, slot, load, n,
                                            cap)
    else:
        buf, meta = relay.relay_dispatch(x_rep, idx_flat, n, cap,
                                         method=method)
    if experts is None:
        out = _expert_ffn(p, buf)
    else:
        lo, hi = experts
        out = torch.zeros_like(buf)
        out[lo:hi] = _expert_ffn(p, buf[lo:hi])
    if method == "einsum":
        rows = relay.relay_combine_einsum(out, d_oh, w_flat)
    else:
        rows = relay.relay_combine(out, meta, w_flat)
    return rows, meta.overflow_frac, meta.load


def _dispatch_on_mesh(p: Params, x_rep, idx_flat, w_flat, n: int, cap: int,
                      method: str):
    """The one-device dispatch with the rows on a ``DeviceMesh`` and no
    expert-parallel relay: the rows, ids and weights replicated on every
    rank (gathered), the experts split over ``model`` as their spec
    places them, each model rank running its own experts' pools
    (``local_map``); the combined rows are summed over ``model``
    (``Partial``) for the caller's next layout to reduce."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = x_rep.device_mesh
    names = mesh.mesh_dim_names
    M = mesh["model"].size() if "model" in names else 1
    if n % M:
        M = 1
    rep = [Replicate()] * len(names)
    wpl = [Shard(0) if a == "model" and M > 1 else Replicate()
           for a in names]
    out = [Partial() if a == "model" and M > 1 else Replicate()
           for a in names]
    rank = mesh.get_local_rank("model") if M > 1 else 0
    E_loc = n // M

    def body(x, i, w, w_in, w_gate, w_out):
        return _dispatch({"w_in": w_in, "w_gate": w_gate, "w_out": w_out},
                         x, i, w, n, cap, method,
                         (rank * E_loc, (rank + 1) * E_loc) if M > 1
                         else None)

    # each model rank uses the rows for its own experts only: the rows'
    # and the combine weights' gradients are summed over ``model``
    return ops._local_map(body, [x_rep, idx_flat, w_flat, p["w_in"],
                                 p["w_gate"], p["w_out"]],
                          (rep, rep, rep, wpl, wpl, wpl), (out, rep, rep),
                          in_grad_placements=(out, rep, out, wpl, wpl, wpl))


def moe_ffn(cfg: ModelConfig, p: Params, x, *, method: str = "sort",
            ep=None, router_bias=None, explicit_fsdp: bool = False,
            ) -> tuple[torch.Tensor, MoEMetrics]:
    """MoE FFN.  x: (B, S, D) → (out (B, S, D), metrics).

    The routed rows (token-major, k a token) go to per-expert pools of
    ``capacity_for(B * S)`` slots; rows past an expert's capacity are
    dropped and counted in ``overflow_frac``.  ``method``: "sort" (the
    relay kernel's slots), "cumsum" or "einsum".

    ``ep=(mesh, tok_axes)``: the expert-parallel relay over the
    ``DeviceMesh`` ``mesh``, the rows sharded over ``tok_axes`` (which
    must hold ``"model"``, the expert owners' axis), each rank's pools
    ``capacity_for(B * S // ranks)`` deep (``core/relay.py::ep_relay``;
    the sort dispatch whatever ``method``, as the reference's).
    ``explicit_fsdp``: the expert weights sharded over the data axes too
    and gathered inside the relay's body."""
    m = cfg.moe
    B, S, D = x.shape
    T, k = B * S, m.top_k
    xf = reshape(x, T, D)
    weights, idx, aux, z = route(cfg, p, xf, router_bias)
    # token-major copies of each row, one per choice: (N, D)
    x_rep = reshape(xf[:, None].expand(T, k, D), T * k, D)
    idx_flat, w_flat = idx.reshape(-1), weights.reshape(-1)
    if ep is not None:
        mesh, tok_axes = ep
        if mesh is None or "model" not in tok_axes:
            raise ValueError(f"ep=(mesh, tok_axes) needs a DeviceMesh and "
                             f"'model' among the token axes, got {ep!r}")
        shards = 1
        for a in tok_axes:
            shards *= mesh[a].size()
        out_flat, overflow, load = relay.ep_relay(
            x_rep, idx_flat, w_flat, {n: p[n] for n in
                                      ("w_in", "w_gate", "w_out")},
            mesh=mesh, tok_axes=tuple(tok_axes), n_dest=m.n_experts,
            capacity=capacity_for(T // shards, cfg),
            backend_fn=_expert_ffn, slots_fn=ops.relay_slots,
            explicit_fsdp=explicit_fsdp)
    elif is_dtensor(x_rep):
        out_flat, overflow, load = _dispatch_on_mesh(
            p, x_rep, idx_flat, w_flat, m.n_experts, capacity_for(T, cfg),
            method)
    else:
        out_flat, overflow, load = _dispatch(
            p, x_rep, idx_flat, w_flat, m.n_experts, capacity_for(T, cfg),
            method)
    out = reshape(reshape(out_flat, T, k, D).sum(1), B, S, D)
    if "shared" in p:
        out = out + ffn(p["shared"], x, cfg.ffn_act)
    if "residual" in p:
        out = out + ffn(p["residual"], x, cfg.ffn_act)
    return out, MoEMetrics(aux, z, overflow, load)

"""AdamW (twin of ``repro/optim/adamw.py``).

bf16 parameters with f32 moments: the update is computed in f32 and cast
on write into the parameter's dtype, so no f32 master copy is kept.
Global-norm clipping; the least-request router-bias update for MoE (the
XLB policy as an optimizer-side state).  Unlike the reference, ``apply``
updates the parameters and moments in place (the reference returns new
arrays): a full-width model keeps one copy of its training state.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.tree import leaves, map_tree


class AdamWState(NamedTuple):
    step: torch.Tensor      # () int32
    m: Any                  # tree like the params, f32
    v: Any


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def init(params) -> AdamWState:
    """Step 0 and f32 zero moments on each parameter's device."""
    zeros32 = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
    dev = leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=map_tree(zeros32, params), v=map_tree(zeros32, params))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over the leaves of their f32 squared sums."""
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in leaves(tree)))


@torch.no_grad()
def apply(params, grads, state: AdamWState, cfg: AdamWConfig,
          lr_scale=1.0):
    """One AdamW step at ``cfg.lr * lr_scale``, the gradients clipped to a
    global norm of ``cfg.clip_norm``.  Writes the new parameters and
    moments into ``params``, ``state.m`` and ``state.v`` (each leaf
    computed in f32, the parameter cast back to its dtype).  Returns
    (params, the new ``AdamWState``, {"grad_norm", "lr"})."""
    step = state.step + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    stepf = step.to(torch.float32)
    # the bases as scalars: no host tensor is made, so a captured step
    # records no copy from the host
    b1c = 1.0 - torch.pow(cfg.b1, stepf)
    b2c = 1.0 - torch.pow(cfg.b2, stepf)
    lr = cfg.lr * lr_scale
    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state.m),
                          leaves(state.v)):
        g = g.to(torch.float32) * scale
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * torch.square(g))
        pf = p.to(torch.float32)
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps) \
            + cfg.weight_decay * pf
        p.copy_((pf - lr * delta).to(p.dtype))
    return params, AdamWState(step, state.m, state.v), \
        {"grad_norm": gnorm, "lr": lr}


def update_router_bias(bias: torch.Tensor, load: torch.Tensor,
                       rate: float = 1e-3) -> torch.Tensor:
    """Aux-loss-free balancing: move each expert's selection bias by
    ``rate`` against the sign of its load's excess over the mean (the
    least-request policy as a slowly varying bias).  ``load``: (E,) rows
    routed this step."""
    load = load.to(torch.float32)
    return bias - rate * torch.sign(load - load.mean())

"""Content-based routing: the eBPF filter/route managers (twin of
``repro/core/router.py``).

The bounded per-request rule-chain walk becomes one match over a whole
request batch: the route kernel on the card (``ops.route_match``, whose
match stage ``csrc/match.cuh`` the admission kernel shares), its plain
PyTorch version on the CPU.  Byte-level protocol parsing stays on the
host ingress: requests arrive with an int32 feature vector of hashed L7
fields.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops


def match_cluster(state, svc, features) -> torch.Tensor:
    """Resolve the destination cluster of each request.

    svc: (B,) int service (virtual-IP) id; features: (B, N_FEATURES) int.
    Returns (B,) int32 cluster id, -1 (NO_ROUTE) where no rule matched.
    First match over the service's priority-ordered chain (the control
    plane emits rules most-specific-first).

    A service id indexes the tables as a JAX gather does: a negative id
    wraps once, then ids clamp into [0, S-1].  The route kernel's
    least-request endpoint is not used here: ``policies.select`` picks
    under each cluster's own policy.
    """
    S = state.svc_rule_start.shape[0]
    svc = torch.where(svc < 0, svc + S, svc)       # the kernel clamps the rest
    cluster, _ = ops.route_match(svc, features, state)
    return cluster

"""The datapath seam (twin of ``repro/core/balancer.py``): the ``Balancer``
protocol every serving engine implements, and the shared wire types
``RequestBatch`` (host-ingress output) and ``PoolState`` (per-(instance,
slot) connection state)."""

from __future__ import annotations

from typing import Any, NamedTuple, Protocol, runtime_checkable

import torch


class RequestBatch(NamedTuple):
    """Host-ingress output: fixed-size admission batch (pad with req_id=-1)."""

    req_id: torch.Tensor     # (R,) int32, -1 = padding
    svc: torch.Tensor        # (R,) int32 virtual-IP/service id
    features: torch.Tensor   # (R, N_FEATURES) int32 hashed L7 fields
    token: torch.Tensor      # (R,) int32 first prompt token
    msg_bytes: torch.Tensor  # (R,) int32 payload size (traffic metrics)

    def pack(self, out: torch.Tensor | None = None) -> torch.Tensor:
        """The five fields as one (R, 4 + F) int32 tensor (into ``out``
        where given): req_id, svc, token, msg_bytes, then the features;
        what crosses to the device in one copy."""
        cols = [c.reshape(c.shape[0], -1).to(torch.int32)
                for c in (self.req_id, self.svc, self.token, self.msg_bytes,
                          self.features)]
        return torch.cat(cols, dim=1, out=out)

    @staticmethod
    def unpack(d: torch.Tensor) -> "RequestBatch":
        """The batch ``pack`` laid out in ``d``, as views of it."""
        return RequestBatch(req_id=d[:, 0], svc=d[:, 1], features=d[:, 4:],
                            token=d[:, 2], msg_bytes=d[:, 3])


class PoolState(NamedTuple):
    """Per-(instance, slot) live-connection state."""

    req_id: torch.Tensor      # (I, C) int32, -1 = free
    endpoint: torch.Tensor    # (I, C) int32 (for load release)
    svc: torch.Tensor         # (I, C) int32
    length: torch.Tensor      # (I, C) int32
    token: torch.Tensor       # (I, C) int32 last emitted/fed token
    active: torch.Tensor      # (I, C) bool

    @staticmethod
    def init(I: int, C: int, device) -> "PoolState":
        full = lambda v: torch.full((I, C), v, dtype=torch.int32,
                                    device=device)
        return PoolState(req_id=full(-1), endpoint=full(-1), svc=full(0),
                         length=full(0), token=full(0),
                         active=torch.zeros((I, C), dtype=torch.bool,
                                            device=device))


@runtime_checkable
class Balancer(Protocol):
    """Structural type every serving engine implements."""

    def init_state(self, routing, dtype=None) -> Any:
        """Build the engine state for one fleet around a routing snapshot."""
        ...

    def admit(self, state, reqs: RequestBatch) -> Any:
        """Route + balance + commit one admission batch into the pools."""
        ...

    def step(self, params, state) -> tuple[Any, dict]:
        """One decode step for every lane + completion handling."""
        ...

    def make_jitted(self, donate: bool = True):
        """Fused ``serve_step(params, state, reqs) -> (state, out)``;
        ``out`` holds the tick's ``emitted``, ``done``, ``req_id`` and
        ``active``, and ``packed``, the four in one int32 array: what the
        host reads of a tick."""
        ...

    def get_routing(self, state):
        """The live RoutingState this engine's datapath reads."""
        ...

    def apply_refresh(self, state, plan) -> Any:
        """Splice a committed control-plane transaction (a
        ``control.RefreshPlan``) into the live engine state."""
        ...


ENGINE_KINDS = ("xlb", "istio", "cilium")


def make_balancer(kind: str, cfg, n_instances: int, slots: int,
                  max_len: int, **kw) -> Balancer:
    """Factory over the three architectures: the only place a caller ever
    names an engine class."""
    if kind == "xlb":
        from repro_torch.core.interpose import Engine
        return Engine(cfg, n_instances, slots, max_len, **kw)
    if kind == "istio":
        from repro_torch.core.sidecar import IstioEngine
        return IstioEngine(cfg, n_instances, slots, max_len, **kw)
    if kind == "cilium":
        from repro_torch.core.sidecar import CiliumEngine
        return CiliumEngine(cfg, n_instances, slots, max_len, **kw)
    raise ValueError(f"unknown engine kind {kind!r}; "
                     f"choose from {ENGINE_KINDS}")

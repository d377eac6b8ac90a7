"""Sidecar baselines: the architectures XLB replaces (twin of
``repro/core/sidecar.py``; paper Fig. 1 a/b).

Both baselines implement the ``Balancer`` protocol of the XLB engine over
I x C instance pools but place the LB where Istio and Cilium place the
proxy:

  * ``IstioEngine``  - a per-instance proxy: every instance lane has its
    own KV cache and its own decode launch; the host router inspects every
    response and re-launches per-instance work each step.  Overheads kept:
    per-hop host↔device copies, per-instance dispatch, duplicate routing
    work.
  * ``CiliumEngine`` - a global proxy: one decode launch for all lanes, but
    routing and admission still run on the host, so each step still pays
    one host round trip and the Python LB.

Routing, balancing, slot allocation and all bookkeeping stay host numpy
(``HostRouter`` with its own ``np.random.RandomState``): that is what the
baselines measure, so none of it is moved to the device.  The decode runs
the port's ``models.decode_step`` on the engine's device (the card unless
``device="cpu"``), as the reference jits it: on the card a captured CUDA
graph a KV cache (one per instance for Istio, one for Cilium's I x C
lanes; ``runtime/graphs.py::StaticDecode``), the host tokens and lengths
copied into its static inputs and its argmax copied back.  A
control-plane refresh (``apply_refresh``) runs the same splice as the XLB
engine on CPU tensors over the host tables.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import control, policy_defs
from repro_torch.core.balancer import PoolState, RequestBatch
from repro_torch.core.routing_table import (MAX_SERVICES, FlowMetrics,
                                            RoutingState)
from repro_torch.device import resolve_device
from repro_torch.kernels.completion import RX_BYTES_PER_TOKEN, health_update
from repro_torch.models import model as M
from repro_torch.runtime.graphs import StaticDecode


def _host(t: torch.Tensor) -> np.ndarray:
    """A tensor (any device) as a private host numpy copy."""
    return t.detach().cpu().numpy().copy()


class HostRouter:
    """The user-space LB logic of the proxy (numpy, per-request Python):
    the proxy's routing tables as host numpy arrays.  ``refresh`` adopts
    a new routing state (the caller migrates the mutable state through
    the plan first)."""

    def __init__(self, routing: RoutingState, seed: int = 0):
        self.t = RoutingState(*[_host(a) for a in routing])
        self.rng = np.random.RandomState(seed)

    def refresh(self, routing: RoutingState) -> None:
        self.t = RoutingState(*[_host(a) for a in routing])

    def match(self, svc: int, features: np.ndarray) -> int:
        t = self.t
        start, count = int(t.svc_rule_start[svc]), int(t.svc_rule_count[svc])
        for r in range(start, start + count):
            exp = int(t.rule_value[r])
            if exp == -1 or exp == int(features[int(t.rule_field[r])]):
                return int(t.rule_cluster[r])
        return -1

    def select(self, cluster: int,
               features: np.ndarray | None = None) -> tuple[int, int]:
        t = self.t
        start, count = (int(t.cluster_ep_start[cluster]),
                        int(t.cluster_ep_count[cluster]))
        # the drain mask gates selection under every policy; a cluster
        # whose endpoints are all draining is unroutable
        if count == 0:
            return -1, -1
        window = t.ep_drained[start:start + count]
        if window.any():
            elig = [start + j for j in range(count) if not window[j]]
            if not elig:
                return -1, -1
        else:
            elig = list(range(start, start + count))
        pol = int(t.cluster_policy[cluster])
        pdef = policy_defs.BY_ENUM.get(pol, policy_defs.BY_ENUM[0])
        feats = (np.zeros((1,), np.int32) if features is None
                 else np.asarray(features, np.int32))
        ep = int(pdef.host_pick(self, cluster, elig, feats))
        t.ep_load[ep] += 1
        return ep, int(t.ep_instance[ep])

    def release(self, ep: int) -> None:
        if ep >= 0:
            self.t.ep_load[ep] -= 1


class SidecarState(NamedTuple):
    """Host-resident engine state: the shape contract of ``EngineState``,
    with every field the host proxy touches as numpy on the host."""

    router: HostRouter
    pool: PoolState          # numpy arrays, mutated in place
    caches: Any              # one KV cache per instance (istio) | one
    metrics: FlowMetrics     # numpy int64 arrays, mutated in place


def _np_pool(I: int, C: int) -> PoolState:
    return PoolState(
        req_id=np.full((I, C), -1, np.int32),
        endpoint=np.full((I, C), -1, np.int32),
        svc=np.zeros((I, C), np.int32),
        length=np.zeros((I, C), np.int32),
        token=np.zeros((I, C), np.int32),
        active=np.zeros((I, C), bool),
    )


def _np_metrics() -> FlowMetrics:
    return FlowMetrics(
        tx_bytes=np.zeros((MAX_SERVICES,), np.int64),
        rx_bytes=np.zeros((MAX_SERVICES,), np.int64),
        requests=np.zeros((MAX_SERVICES,), np.int64),
        no_route_match=np.zeros((), np.int64),
        overflow=np.zeros((), np.int64),
    )


@dataclasses.dataclass
class SidecarEngine:
    """Host-interposed serving engine (mode: 'istio' | 'cilium')."""

    cfg: ModelConfig
    n_instances: int
    slots: int
    max_len: int
    mode: str = "istio"
    eos: int = 1
    device: Any = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.device.type == "cuda":
            # the reference decodes in full f32; TF32 would drift the logits
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.decode = StaticDecode(self.cfg, self.device)

    # ------------------------------------------------------------------ #
    def init_state(self, routing: RoutingState, dtype=None) -> SidecarState:
        I, C = self.n_instances, self.slots
        dtype = dtype or torch.float32
        if self.mode == "istio":
            # one cache and one decode launch PER instance (per-svc proxy)
            caches = [M.init_cache(self.cfg, C, self.max_len, dtype,
                                   self.device) for _ in range(I)]
        else:
            caches = M.init_cache(self.cfg, I * C, self.max_len, dtype,
                                  self.device)
        return SidecarState(HostRouter(routing), _np_pool(I, C), caches,
                            _np_metrics())

    # ------------------------------------------------------------------ #
    def admit(self, state: SidecarState, reqs: RequestBatch) -> SidecarState:
        """Host-side routing + slot allocation (per-request Python)."""
        router, pool, m = state.router, state.pool, state.metrics
        req_id, svc, feats, tok, nbytes = (
            _host(x) for x in (reqs.req_id, reqs.svc, reqs.features,
                               reqs.token, reqs.msg_bytes))
        for r in range(len(req_id)):
            if req_id[r] < 0:
                continue
            cluster = router.match(int(svc[r]), feats[r])
            if cluster < 0:
                m.no_route_match[...] += 1
                continue
            ep, inst = router.select(cluster, feats[r])
            if inst < 0:
                continue
            free = np.where(~pool.active[inst])[0]
            if len(free) == 0:                   # held (pool exhausted)
                router.release(ep)
                m.overflow[...] += 1
                continue
            s = int(free[0])
            pool.req_id[inst, s] = req_id[r]
            pool.endpoint[inst, s] = ep
            pool.svc[inst, s] = svc[r]
            pool.length[inst, s] = 0
            pool.token[inst, s] = tok[r]
            pool.active[inst, s] = True
            if svc[r] < MAX_SERVICES:
                m.requests[svc[r]] += 1
                m.tx_bytes[svc[r]] += nbytes[r]
        return state

    # ------------------------------------------------------------------ #
    def step(self, params, state: SidecarState) -> tuple[SidecarState, dict]:
        """One decode step for all lanes, host-mediated."""
        I, C = self.n_instances, self.slots
        router, pool, m = state.router, state.pool, state.metrics
        if self.mode == "istio":
            nxt = np.zeros((I, C), np.int32)
            for i in range(I):                   # per-instance launch
                nxt[i] = self.decode(params, pool.token[i], pool.length[i],
                                     state.caches[i])
        else:                                    # one global round trip
            nxt = self.decode(params, pool.token.reshape(-1),
                              pool.length.reshape(-1),
                              state.caches).reshape(I, C)

        # vectorised host bookkeeping: the measured cost is the per-request
        # Python routing and (istio) the per-instance launches
        pre_req = pool.req_id.copy()             # ids serviced this tick
        act = pool.active.copy()
        pool.length[act] += 1
        pool.token[act] = nxt[act]
        np.add.at(m.rx_bytes, np.maximum(pool.svc[act], 0),
                  RX_BYTES_PER_TOKEN)
        done = act & ((nxt == self.eos) | (pool.length >= self.max_len - 1))
        # health EWMAs on the same integer observations as the fused
        # kernel (occupancy before release, completions per endpoint)
        E = router.t.ep_load.shape[0]
        occ0 = router.t.ep_load.astype(np.int32).copy()
        cnt = np.zeros((E,), np.int32)
        eps = pool.endpoint[done]
        np.add.at(cnt, eps[(eps >= 0) & (eps < E)], 1)
        ewl, ewt = health_update(torch.from_numpy(router.t.ep_inflight_ewma),
                                 torch.from_numpy(router.t.ep_tput_ewma),
                                 torch.from_numpy(occ0),
                                 torch.from_numpy(cnt))
        router.t.ep_inflight_ewma[...] = ewl.numpy()
        router.t.ep_tput_ewma[...] = ewt.numpy()
        for ep in pool.endpoint[done]:           # release load counters
            router.release(int(ep))
        pool.active[done] = False
        pool.req_id[done] = -1
        pool.endpoint[done] = -1
        pool.length[done] = 0
        out = {"emitted": nxt, "done": done, "req_id": pre_req,
               "active": int(act.sum() - done.sum())}
        out["packed"] = np.concatenate(
            [np.asarray(out[k], np.int32).reshape(-1)
             for k in ("emitted", "done", "req_id", "active")])
        return state, out

    # ------------------------------------------------------------------ #
    def make_jitted(self, donate: bool = True):
        """Protocol parity with ``Engine.make_jitted``: the same
        ``serve_step`` signature, with admission a host round trip."""

        def serve_step(params, state: SidecarState, reqs: RequestBatch):
            if np.any(_host(reqs.req_id) >= 0):
                state = self.admit(state, reqs)
            return self.step(params, state)

        return serve_step

    # ------------------------------------------------------------------ #
    # control-plane seam (Balancer protocol)
    # ------------------------------------------------------------------ #
    def get_routing(self, state: SidecarState) -> RoutingState:
        return state.router.t

    def apply_refresh(self, state: SidecarState,
                      plan: control.RefreshPlan) -> SidecarState:
        """Adopt a committed transaction: the XLB engine's splice on CPU
        tensors over the router's tables, then the host pool's endpoint
        references remapped in place."""
        live = RoutingState(*[torch.from_numpy(np.asarray(a))
                              for a in state.router.t])
        state.router.refresh(control.apply_plan(live, plan))
        pe = state.pool.endpoint
        pe[...] = control.remap_endpoints(plan, torch.from_numpy(pe)).numpy()
        return state


@dataclasses.dataclass
class IstioEngine(SidecarEngine):
    """Per-instance sidecar proxy (paper Fig. 1a)."""

    mode: str = "istio"


@dataclasses.dataclass
class CiliumEngine(SidecarEngine):
    """Shared global proxy (paper Fig. 1b)."""

    mode: str = "cilium"

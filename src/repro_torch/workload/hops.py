"""Service hops: one service fleet behind any balancer, and the chain
runs over a line of them (twin of the service wrapper and chain runs in
the reference's ``benchmarks/common.py``: ``build_cp``, ``build_routing``,
``request_batch``, ``HopStats``, ``Service``, ``make_service``, ``warm``,
``run_chain``, ``run_graph``, ``run_chain_scenario``).

The per-service application is the dense LM ``xlb-service-model``; a
request occupies a slot for ``tokens_per_req`` decode steps.  When a
request completes at hop k it is submitted at hop k + 1 (the host moves an
opaque id and never inspects a payload).  All three architectures run
through ONE ``Service`` built on the ``Balancer`` protocol, with routing
from a per-fleet ``ControlPlane``: the chain runs never branch on the
mode.

Unlike the reference, nothing is built at import: ``cfg``, ``params`` and
``device`` are arguments (defaults: the reduced ``xlb-service-model``
config the reference serves, weights drawn from a CPU generator seeded
with 42, the card), so importing this module never touches a device.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.core.balancer import RequestBatch, make_balancer
from repro_torch.core.control import ControlPlane
from repro_torch.core.routing_table import (N_FEATURES, POLICY_LEAST_REQUEST,
                                            Cluster, Rule, ServiceConfig)
from repro_torch.device import resolve_device
from repro_torch.models import model as M

#: the seed of the default weights (the reference's ``PRNGKey(42)``)
PARAMS_SEED = 42


def default_config():
    """The reference's hop model: ``smoke_config(xlb-service-model)``."""
    return smoke_config(get_config("xlb-service-model"))


def default_params(cfg, device):
    """Weights of ``cfg`` from a CPU generator seeded with ``PARAMS_SEED``
    (the same values on any device), in f32 on ``device``."""
    return M.init_params(cfg, torch.Generator().manual_seed(PARAMS_SEED),
                         dtype=torch.float32, device=device)


def build_cp(n_instances: int, policy: int = POLICY_LEAST_REQUEST, *,
             lease_epochs: int = 0) -> ControlPlane:
    return ControlPlane(
        [ServiceConfig("svc", rules=[Rule(0, None, "pool")])],
        [Cluster("pool", endpoints=list(range(n_instances)),
                 policy=policy)], lease_epochs=lease_epochs)


def build_routing(n_instances: int, policy: int = POLICY_LEAST_REQUEST):
    return build_cp(n_instances, policy).snapshot()


def request_batch(req_ids, pad_to: int, vocab: int) -> RequestBatch:
    """The uniform admission batch, as a host (CPU tensor) batch."""
    rid = np.full((pad_to,), -1, np.int32)
    tok = np.zeros((pad_to,), np.int32)
    n = min(len(req_ids), pad_to)
    rid[:n] = req_ids[:n]
    tok[:n] = 3 + (np.asarray(req_ids[:n], np.int64) % (vocab - 3))
    t = torch.from_numpy
    return RequestBatch(
        req_id=t(rid), svc=torch.zeros((pad_to,), dtype=torch.int32),
        features=torch.zeros((pad_to, N_FEATURES), dtype=torch.int32),
        token=t(tok), msg_bytes=torch.full((pad_to,), 128,
                                           dtype=torch.int32))


@dataclasses.dataclass
class HopStats:
    completed: int = 0
    ticks: int = 0
    wall_s: float = 0.0


class Service:
    """One service fleet behind any Balancer (mode: xlb | istio | cilium).

    ``eos`` reaches the engine's completion path (``eos=-1`` makes requests
    purely length-driven).  ``fault`` is an optional
    ``runtime.serve_loop.FaultInjector`` applied to the pool before every
    step; ``shaper`` its per-request analogue
    (``workload.generators.ServiceTimeShaper``).  ``batch_fn(req_ids,
    pad_to)`` builds the admission batch (default: the uniform
    ``request_batch``; a ``Workload.request_batch`` gives per-flow feature
    entropy).  ``shards > 1`` runs the xlb engine's sharded admission on an
    M-way shard mesh on ``device``.  Per-request engine-tick samples land
    in ``submit_tick`` / ``admit_tick`` / ``done_tick``.

    ``cp`` supplies an external ControlPlane (default: a private one);
    ``consumer`` attaches the fleet through a ``transport.RemoteConsumer``
    instead, whose boot snapshot seeds the engine.  ``cfg`` / ``params`` /
    ``device``: the hop model, its weights (None draws
    ``default_params``) and where the engine runs (the card unless
    ``"cpu"``)."""

    def __init__(self, mode: str, n_instances: int, slots: int,
                 tokens_per_req: int, admit_batch: int = 16, eos: int = 1,
                 fault=None, shaper=None, policy: int = POLICY_LEAST_REQUEST,
                 shards: int = 1, batch_fn=None, cp=None, consumer=None, *,
                 cfg=None, params=None, device="cuda"):
        self.cfg = cfg if cfg is not None else default_config()
        self.device = resolve_device(device)
        self.params = (params if params is not None
                       else default_params(self.cfg, self.device))
        kw = {}
        if shards > 1:
            if mode != "xlb":
                raise ValueError("shards > 1 needs the in-graph engine "
                                 "(the sidecars route on the host)")
            from repro_torch.launch.mesh import make_shard_mesh
            kw = dict(shards=shards,
                      shard_mesh=make_shard_mesh(shards, device=self.device))
        self.eng = make_balancer(mode, self.cfg, n_instances, slots,
                                 max_len=tokens_per_req + 1, eos=eos,
                                 device=self.device, **kw)
        self.cp = cp if cp is not None else build_cp(n_instances, policy)
        self.consumer = consumer
        if consumer is not None:
            self.state = self.eng.init_state(consumer.boot_routing,
                                             dtype=torch.float32)
            consumer.bind(self)
        else:
            self.state = self.eng.init_state(self.cp.snapshot(),
                                             dtype=torch.float32)
            self.cp.attach(self)
        self.serve = self.eng.make_jitted(donate=False)
        self.admit_batch = admit_batch
        vocab = self.cfg.vocab
        self.batch_fn = batch_fn or (
            lambda ids, pad_to: request_batch(ids, pad_to, vocab))
        self.queue: list[int] = []
        self.dropped: list[int] = []        # gave up after max retries
        self._retries: dict[int, int] = {}
        self.stats = HopStats()
        self.fault = fault
        self.shaper = shaper
        self.tick_no = 0                    # absolute ticks (never reset:
        #                                     fault schedules key off it)
        self.submit_tick: dict[int, int] = {}
        self.admit_tick: dict[int, int] = {}
        self.done_tick: dict[int, int] = {}

    # control-plane consumer hooks (cp.attach) ------------------------- #
    @property
    def routing(self):
        return self.eng.get_routing(self.state)

    def apply_refresh(self, plan):
        self.state = self.eng.apply_refresh(self.state, plan)

    # ------------------------------------------------------------------ #
    def submit(self, req_ids):
        for r in req_ids:
            r = int(r)
            self.queue.append(r)
            self.submit_tick.setdefault(r, self.tick_no)

    def tick(self) -> list[int]:
        """One engine step. Returns req_ids completed this tick."""
        if self.consumer is not None:       # transport-attached: plans in,
            self.consumer.pump(self.tick_no)   # heartbeat + load out
        else:
            self.cp.heartbeat(self)         # liveness lease (core/control)
        if self.fault is not None:          # injected faults roll progress
            pool = self.fault.apply(self.state.pool, self.tick_no)
            if pool is not self.state.pool:  # back BEFORE the step
                self.state = self.state._replace(pool=pool)
        if self.shaper is not None:         # heavy-tailed service times:
            pool = self.shaper.apply(self.state.pool, self.tick_no)
            if pool is not self.state.pool:  # the same rollback, per req_id
                self.state = self.state._replace(pool=pool)
        self.tick_no += 1
        take = self.queue[: self.admit_batch]
        self.queue = self.queue[self.admit_batch:]
        reqs = self.batch_fn(take, self.admit_batch)   # host tensors: the
        t0 = time.perf_counter()                       # arrival gate is free
        self.state, out = self.serve(self.params, self.state, reqs)
        n = out["req_id"].shape[0] * out["req_id"].shape[1]
        host = out["packed"]                # one download of the tick
        if isinstance(host, torch.Tensor):  # (a sidecar's is host numpy)
            host = host.cpu().numpy()
        self.stats.wall_s += time.perf_counter() - t0
        self.stats.ticks += 1
        done, ids = host[n:2 * n] != 0, host[2 * n:3 * n]
        finished = [int(x) for x in ids[done & (ids >= 0)]]
        self.stats.completed += len(finished)
        now = self.tick_no - 1                   # tick this step ran at
        for r in finished:
            self.done_tick[r] = now
        # held / unroutable arrivals re-queue up to the 64-retry budget
        # ServeLoop uses; past it they land on ``dropped``
        serviced = set(int(x) for x in ids[ids >= 0])
        for r in serviced:
            self.admit_tick.setdefault(r, now)
        retry = []
        for r in take:
            if r in serviced:
                self._retries.pop(r, None)
                continue
            n_try = self._retries.get(r, 0) + 1
            if n_try < 64:
                self._retries[r] = n_try
                retry.append(r)
            else:
                self._retries.pop(r, None)
                self.dropped.append(r)
        self.queue = retry + self.queue
        return finished

    @property
    def busy(self) -> bool:
        """Work queued or a slot active: on the xlb engine one read of
        ``pool.active`` on its device (one sync), on a sidecar a host
        read."""
        return bool(self.queue) or bool(self.state.pool.active.any())


def make_service(mode: str, n_instances: int, slots: int,
                 tokens_per_req: int, admit_batch: int = 16, *, cfg=None,
                 params=None, device="cuda") -> Service:
    return Service(mode, n_instances, slots, tokens_per_req, admit_batch,
                   cfg=cfg, params=params, device=device)


def _model(cfg, params, device):
    """One (cfg, params, device) for every hop of a chain run."""
    cfg = cfg if cfg is not None else default_config()
    device = resolve_device(device)
    if params is None:
        params = default_params(cfg, device)
    return cfg, params, device


# --------------------------------------------------------------------------- #
# Chain runs
# --------------------------------------------------------------------------- #


def warm(*svcs):
    """One tick per service before the measured region (the reference pays
    its compiles there; here the first launches and the kernel build)."""
    for s in svcs:
        s.tick()
        s.stats = HopStats()
    return svcs[0] if len(svcs) == 1 else svcs


def run_chain(mode: str, *, chain_len: int, n_requests: int = 16,
              n_instances: int = 2, slots: int = 8, tokens_per_req: int = 2,
              max_ticks: int = 4000, cfg=None, params=None,
              device="cuda") -> dict:
    """Paper Fig 8: requests traverse a chain of services."""
    cfg, params, device = _model(cfg, params, device)
    hops = [make_service(mode, n_instances, slots, tokens_per_req, cfg=cfg,
                         params=params, device=device)
            for _ in range(chain_len)]
    warm(*hops)
    hops[0].submit(list(range(n_requests)))
    t0 = time.perf_counter()
    done_t = {}
    ticks = 0
    while any(h.busy for h in hops) and ticks < max_ticks:
        for i, h in enumerate(hops):
            if not h.busy:                       # event-driven: idle hops
                continue                         # launch nothing
            finished = h.tick()
            if i + 1 < len(hops):
                hops[i + 1].submit(finished)
            else:
                for r in finished:
                    done_t[r] = time.perf_counter()
        ticks += 1
    wall = time.perf_counter() - t0
    lat = [done_t[r] - t0 for r in done_t]
    return {"mode": mode, "chain": chain_len, "completed": len(done_t),
            "req_per_s": len(done_t) / wall if wall else 0.0,
            "avg_ms": 1e3 * float(np.mean(lat)) if lat else float("nan"),
            "wall_s": wall}


def run_graph(mode: str, graph, *, n_requests: int = 12, slots: int = 8,
              tokens_per_req: int = 2, max_ticks: int = 4000, cfg=None,
              params=None, device="cuda") -> dict:
    """Paper Fig 11/12: microservice application topologies.  One fleet
    per service of ``graph`` (a ``configs.ServiceGraph``) but the client,
    at most 8 instances each; the requests enter at the client's first
    callee and fan out along ``graph.edges``: a request that completes at
    a service is submitted to each of its callees, and is done at the
    first leaf it completes at."""
    cfg, params, device = _model(cfg, params, device)
    insts = {s: max(1, min(graph.instances.get(s, 1), 8))
             for s in graph.services}
    svcs = {s: make_service(mode, insts[s], slots, tokens_per_req, cfg=cfg,
                            params=params, device=device)
            for s in graph.services if s != graph.services[0]}
    warm(*svcs.values())
    out_edges = {}
    for a, b in graph.edges:
        out_edges.setdefault(a, []).append(b)
    entry = out_edges[graph.services[0]][0]     # client → first real service
    svcs[entry].submit(list(range(n_requests)))
    done_t = {}
    t0 = time.perf_counter()
    ticks = 0
    while any(s.busy for s in svcs.values()) and ticks < max_ticks:
        for name, s in svcs.items():
            if not s.busy:
                continue
            finished = s.tick()
            nxt = out_edges.get(name, [])
            for r in finished:
                if nxt:                          # fan out to callees
                    for callee in nxt:
                        svcs[callee].submit([r])
                else:
                    done_t[r] = time.perf_counter()
        ticks += 1
    wall = time.perf_counter() - t0
    lat = [done_t[r] - t0 for r in done_t]
    return {"mode": mode, "graph": graph.name, "completed": len(done_t),
            "req_per_s": len(done_t) / wall if wall else 0.0,
            "avg_ms": 1e3 * float(np.mean(lat)) if lat else float("nan"),
            "wall_s": wall}


def run_chain_scenario(mode: str, *, depth: int = 3, workload=None,
                       ops=None, label: str = "chain",
                       n_instances: int = 2, slots: int = 8,
                       tokens_per_req: int = 2, admit_batch: int = 8,
                       policy: int = POLICY_LEAST_REQUEST, shards: int = 1,
                       faults: dict | None = None, health_cfg=None,
                       epoch_interval: int = 6, max_ticks: int = 4000,
                       cfg=None, params=None, device="cuda",
                       on_tick=None) -> dict:
    """A generated request stream through a depth-D service chain, each
    hop behind its own balancer, with an optional live-ops scenario
    replayed mid-load.

    Latency is in deterministic engine ticks (``eos=-1``): end-to-end =
    submit at hop 0 → completion at hop D-1, per hop admit→done too.
    Returns ``{"result": ChainResult, "row": <scenario row>, "hops":
    [Service]}``; the row is schema-validated.  ``faults`` maps hop →
    FaultInjector.  ``health_cfg`` runs a per-hop ``HealthPolicy`` daemon,
    one epoch every ``epoch_interval`` global ticks.  ``on_tick(t)``, if
    given, runs at the end of every global tick (after the daemons): a
    caller's clock, for example."""
    from repro_torch.workload import (ChainRunner, PoissonArrivals,
                                      ScenarioDriver, Workload, percentiles,
                                      scenario_row)
    cfg, params, device = _model(cfg, params, device)
    if workload is None:
        workload = Workload(PoissonArrivals(rate=2.0, seed=11),
                            n_requests=24, vocab=cfg.vocab)
    faults = faults or {}
    hops = [Service(mode, n_instances, slots, tokens_per_req,
                    admit_batch=admit_batch, eos=-1, policy=policy,
                    shards=shards, fault=faults.get(k),
                    shaper=workload.shaper(tokens_per_req, hop=k),
                    batch_fn=workload.request_batch, cfg=cfg, params=params,
                    device=device)
            for k in range(depth)]
    warm(*hops)
    scenario = None
    if ops:
        scenario = ScenarioDriver([h.cp for h in hops], ops,
                                  max_instances=n_instances)
    policies = None
    if health_cfg is not None:
        from repro_torch.core.health import HealthPolicy
        policies = [HealthPolicy(h.cp, health_cfg, clusters=["pool"])
                    for h in hops]

    def tick_hook(t):
        if policies is not None and (t + 1) % epoch_interval == 0:
            for pol, h in zip(policies, hops):
                pol.epoch(h.routing)
        if on_tick is not None:
            on_tick(t)
    hook = tick_hook if policies is not None or on_tick is not None \
        else None
    res = ChainRunner(hops, workload, scenario=scenario, on_tick=hook,
                      max_ticks=max_ticks).run()
    arr = type(workload.arrivals).__name__.removesuffix("Arrivals").lower()
    extra = {"ops": len(ops or []),
             "txns": scenario.txns if scenario else 0,
             "rate": float(workload.arrivals.rate),
             "scale": float(workload.arrivals.scale),
             "per_hop_p99_ticks": [percentiles(res.hop_samples(k))["p99"]
                                   for k in range(depth)]}
    if shards > 1:
        extra["shards"] = shards
    if policies is not None:
        extra["health_txns"] = sum(p.commits for p in policies)
        ws = []
        for h in hops:
            hw = []
            for i in range(n_instances):
                try:
                    hw.append(round(float(
                        h.cp.endpoint_weight("pool", i)), 4))
                except KeyError:
                    hw.append(None)
            ws.append(hw)
        extra["end_weights"] = ws
    if workload.service is not None:
        extra["service"] = type(workload.service).__name__ \
            .removesuffix("ServiceTimes").lower()
    row = scenario_row(label, mode, depth=depth,
                       seed=workload.arrivals.seed, arrivals=arr,
                       n_requests=res.n_submitted, completed=res.completed,
                       dropped=res.dropped, ticks=res.ticks,
                       samples=res.samples(), **extra)
    return {"result": res, "row": row, "hops": hops}

"""The XLB serving engine (twin of ``repro/core/interpose.py``).

The engine owns ``I`` instance lanes × ``C`` decode slots.  Each serving
tick runs two things:

  * ``admit`` — content match → policy select → slot allocation → pool
    commit, one kernel launch (``ops.admit_commit``), only on ticks with
    arrivals;
  * ``step``  — one batched decode over every slot, the argmax, then the
    close path (done detect, load release, rx metrics, slot free, health
    EWMAs) as one kernel launch (``ops.complete``).

With ``shards`` > 1 both run sharded over the axis ``shard_axis`` of
``shard_mesh`` (``ops.admit_commit_sharded`` / ``ops.complete_sharded``):
the batch splits ``(R/M,)``, the pool ``(I/M,)`` (shard m owns rows
``[m·I/M, (m+1)·I/M)`` of the (I, C) pool), bit-exact against the
unsharded engine on the same batches.  On a one-process mesh
(``ShardMesh``) the engine holds the whole pool and decodes it.  On a rank
mesh (``RankShardMesh``, one rank a shard) each rank's engine holds its
(I/M, C) slice of the pool and the cache of those I/M·C rows, decodes
only them, takes its rows of every admission batch (every rank builds and
draws the whole batch, then slices it), and gathers what the host reads
of a tick (emitted tokens, done flags, serviced ids, the active count)
from every rank, so each rank's host sees the whole tick.  Routing and
metrics are replicated, equal on every rank after the psums.

``admit`` and ``step`` replace the state's tensors, never mutate them,
except the KV cache, which the decode writes in place.  ``make_jitted``'s
tick of an unsharded engine, or of one on a one-process mesh, is the
reference's ``jax.jit`` with the state donated (around its ``shard_map``
when sharded; around ``checkify`` under ``XLB_SANITIZE=1``): on the card
it replays captured CUDA graphs, and its state lives in static buffers
that each tick overwrites (``runtime/graphs.py::StaticTick``).  The
engine runs on the card unless the caller asks for the CPU
(``device="cpu"``), where every kernel wrapper runs its plain PyTorch
version and the tick runs without a graph.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.analysis.invariants import sanitize_enabled
from repro_torch.configs.base import ModelConfig
from repro_torch.core import control, policies
from repro_torch.core.balancer import PoolState, RequestBatch
from repro_torch.core.routing_table import FlowMetrics, RoutingState
from repro_torch.device import resolve_device
from repro_torch.kernels import dense_x9 as x9
from repro_torch.kernels import ops, shard_admit
from repro_torch.models import model as M
from repro_torch.runtime.graphs import StaticTick


class EngineState(NamedTuple):
    routing: RoutingState
    pool: PoolState
    cache: Any             # model KV cache, batch dim = I*C
    metrics: FlowMetrics


@dataclasses.dataclass
class Engine:
    """XLB serving engine for one service fleet.

    ``draws(R) -> (rnd, gumbel)`` supplies the host PRNG draws of one
    admission: ``rnd`` (R,) int32 in [0, 2**30) for the random policy and
    ``gumbel`` (R, 64) f32 for the weighted policy, from a
    ``torch.Generator`` on the engine's device seeded with 0 (as the
    reference seeds its key).  Tests replace the attribute to feed the
    reference's draws.
    """

    cfg: ModelConfig
    n_instances: int
    slots: int
    max_len: int
    eos: int = 1
    device: Any = "cuda"
    # kernel tuning overrides; None = the tuned plan (kernels/tune.py)
    block_r: int | None = None
    block_i: int | None = None
    fold: str | None = None
    # sharded admission and completion: with shards > 1 the admit batch
    # splits (R/M,) and the pool (I/M,) over ``shard_axis`` of
    # ``shard_mesh`` (launch/mesh.py::make_shard_mesh), the kernels run per
    # shard and one collective pass reconciles.  Requires n_instances %
    # shards == 0 and a mesh of exactly ``shards`` along the axis.
    shards: int = 1
    shard_mesh: Any = None
    shard_axis: str = "shard"

    def __post_init__(self):
        if self.shards > 1:
            if self.shard_mesh is None:
                raise ValueError("shards > 1 needs a shard_mesh "
                                 "(launch/mesh.py::make_shard_mesh)")
            mesh_m = self.shard_mesh.shape[self.shard_axis]
            if mesh_m != self.shards:
                raise ValueError(
                    f"shards={self.shards} but shard_mesh axis "
                    f"{self.shard_axis!r} is {mesh_m}-way — the datapath "
                    "would silently shard at the mesh width")
            if self.n_instances % self.shards:
                raise ValueError(f"n_instances ({self.n_instances}) must "
                                 f"divide over {self.shards} shards")
        self.device = resolve_device(self.device)
        if self.device.type == "cuda":
            # the reference decodes in full f32; TF32 would drift the logits
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        gen = torch.Generator(device=self.device)
        gen.manual_seed(0)
        self.draws = lambda R: policies.draws(gen, R)
        # id(params) -> (params, their serving tree, planes): one entry a
        # params object, kept as long as the engine, as the captured
        # programs that read its planes are
        self._planed: dict = {}
        self.plane_weights = 0      # weights (leaves) with planes
        self.plane_bytes = 0        # bytes of those planes

    def serving_params(self, params):
        """The params the decode reads: on the card, ``params`` with bf16
        planes beside each weight that ``kernels/dense_x9.py::
        with_planes`` picks (made at a params object's first call, before
        any capture, kept for that object, and split again in place where
        a weight was updated in place since), so that ``ops.dense`` can
        run its products on the tensor cores; elsewhere ``params``
        itself.  The f32 weights stay the parameters."""
        if self.device.type != "cuda":
            return params
        hit = self._planed.get(id(params))
        if hit is None:
            planed, roots = x9.with_planes(params)
            hit = self._planed[id(params)] = (params, planed, roots)
            self.plane_weights += len(roots)
            self.plane_bytes += sum(r.planes.nbytes for r in roots)
        for r in hit[2]:
            r.refresh()
        return hit[1]

    # ------------------------------------------------------------------ #
    @property
    def held_shards(self) -> tuple:
        """The shards this engine holds: all of them, or on a rank mesh
        the rank's own."""
        return (0,) if self.shards == 1 else tuple(self.shard_mesh.held)

    @property
    def first_instance(self) -> int:
        """The global index of the first instance lane this engine holds."""
        return self.held_shards[0] * (self.n_instances // self.shards)

    @property
    def held_instances(self) -> int:
        return len(self.held_shards) * (self.n_instances // self.shards)

    def _rank_mesh(self) -> bool:
        return len(self.held_shards) < self.shards

    # ------------------------------------------------------------------ #
    def init_state(self, routing: RoutingState, dtype=None) -> EngineState:
        return EngineState(
            routing=routing.to(self.device),
            pool=PoolState.init(self.held_instances, self.slots,
                                self.device),
            cache=M.init_cache(self.cfg, self.held_instances * self.slots,
                               self.max_len, dtype, self.device),
            metrics=FlowMetrics.zeros(self.device))

    def upload(self, reqs: RequestBatch) -> RequestBatch:
        """A host batch on the engine's device, in one copy: the five
        fields packed into one (R, 4 + F) int32 tensor."""
        if reqs.req_id.device == self.device:
            return reqs
        return RequestBatch.unpack(reqs.pack().to(self.device))

    # ------------------------------------------------------------------ #
    def admit(self, state: EngineState, reqs: RequestBatch,
              live=None, draws=None) -> EngineState:
        """One admission of the whole batch ``reqs``.  ``live`` (sharded
        engines): ``shard_admit.live_shards`` of the batch as the host
        built it, one entry a shard (``arrivals``); None reads it from
        ``reqs``.
        ``draws``: the batch's (rnd, gumbel), None draws them
        (``self.draws``)."""
        rstate, metrics = state.routing, state.metrics
        rnd, gumbel = draws if draws is not None \
            else self.draws(reqs.req_id.shape[0])
        if self.shards > 1:
            mesh, axis = self.shard_mesh, self.shard_axis
            if self._rank_mesh():        # this rank's rows of the batch
                rows = lambda x, fill=0: shard_admit.held_rows(  # noqa: E731
                    x, mesh, axis, fill)
                reqs = RequestBatch(
                    req_id=rows(reqs.req_id, -1), svc=rows(reqs.svc),
                    features=rows(reqs.features), token=rows(reqs.token),
                    msg_bytes=rows(reqs.msg_bytes))
                rnd, gumbel = rows(rnd), rows(gumbel)
            if live is not None:
                live = [live[m] for m in self.held_shards]
            res = ops.admit_commit_sharded(
                reqs, rstate, state.pool, rnd, gumbel, mesh=mesh, axis=axis,
                live=live, block_r=self.block_r, fold=self.fold)
        else:
            res = ops.admit_commit(reqs, rstate, state.pool, rnd, gumbel,
                                   block_r=self.block_r, fold=self.fold)
        rstate = rstate._replace(ep_load=res.ep_load, rr_cursor=res.rr_cursor,
                                 aff_key=res.aff_key, aff_ep=res.aff_ep)
        metrics = metrics._replace(
            requests=metrics.requests + res.svc_requests,
            tx_bytes=metrics.tx_bytes + res.svc_tx_bytes,
            no_route_match=metrics.no_route_match + res.no_route,
            overflow=metrics.overflow + res.held)   # per-ATTEMPT hold events
        return EngineState(rstate, res.pool, state.cache, metrics)

    # ------------------------------------------------------------------ #
    def step(self, params, state: EngineState) -> tuple[EngineState, dict]:
        pool = state.pool
        I, C = pool.req_id.shape
        B = I * C
        logits, cache = M.decode_step(self.cfg, self.serving_params(params),
                                      pool.token.reshape(B, 1),
                                      pool.length.reshape(B), state.cache)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32).reshape(I, C)
        args = (pool, nxt, state.routing.ep_load, state.metrics.rx_bytes,
                state.routing.ep_inflight_ewma, state.routing.ep_tput_ewma)
        tuning = dict(block_i=self.block_i, fold=self.fold)
        if self.shards > 1:
            res = ops.complete_sharded(*args, mesh=self.shard_mesh,
                                       axis=self.shard_axis, eos=self.eos,
                                       max_len=self.max_len, **tuning)
        else:
            res = ops.complete(*args, eos=self.eos, max_len=self.max_len,
                               **tuning)
        rstate = state.routing._replace(ep_load=res.ep_load,
                                        ep_inflight_ewma=res.ep_inflight_ewma,
                                        ep_tput_ewma=res.ep_tput_ewma)
        metrics = state.metrics._replace(rx_bytes=res.rx_bytes)
        out = {"emitted": nxt, "done": res.done,
               "req_id": pool.req_id,           # ids that produced this tick
               "active": res.pool.active.sum()}
        if self.shards > 1 and self._rank_mesh():
            out = self._gather_tick(out)
        # what the host reads of a tick, in one download: (3 I C + 1,)
        # int32, emitted | done | req_id | active
        out["packed"] = torch.cat(
            [out[k].reshape(-1).to(torch.int32)
             for k in ("emitted", "done", "req_id", "active")])
        return EngineState(rstate, res.pool, cache, metrics), out

    def _gather_tick(self, out: dict) -> dict:
        """What the host reads of a tick, from every rank, in one
        all_gather: (I, C) emitted / done / req_id in instance order and
        the summed active count."""
        i32 = torch.int32
        n = out["emitted"].numel()
        mine = torch.cat([out[k].reshape(-1).to(i32)
                          for k in ("emitted", "done", "req_id")]
                         + [out["active"].reshape(1).to(i32)])
        got = self.shard_mesh.all_gather(mine[None])        # (M, 3n + 1)
        cells = lambda k: got[:, k * n:(k + 1) * n].reshape(  # noqa: E731
            self.n_instances, self.slots)
        return {"emitted": cells(0), "done": cells(1) > 0,
                "req_id": cells(2), "active": got[:, 3 * n].sum()}

    # ------------------------------------------------------------------ #
    def arrivals(self, reqs: RequestBatch) -> tuple | None:
        """A tick's gates, decided from the batch as the caller built it
        (give it the host batch, CPU tensors, and they cost no device
        sync): None where no row is valid (the reference's ``lax.cond``
        on "any arrivals": the tick does not admit), else the live shards,
        whether each shard's rows hold a valid one (its per-shard
        ``lax.cond``; ``()`` unsharded)."""
        if not bool((reqs.req_id >= 0).any()):
            return None
        if self.shards == 1:
            return ()
        return tuple(shard_admit.live_shards(reqs.req_id, self.shards))

    def eager_step(self, params, state: EngineState, reqs: RequestBatch):
        """One serving tick, eagerly: admit (on ticks with arrivals) +
        decode step, each op issued from the host; the gates from
        ``arrivals``, and ``upload`` then copies the batch over once."""
        # every rank of a rank mesh builds the same batch, so every rank
        # admits on the same ticks and joins the same collectives
        live = self.arrivals(reqs)
        if live is not None:
            state = self.admit(state, self.upload(reqs), live)
        return self.step(params, state)

    def make_jitted(self, donate: bool = True):
        """One serving tick ``serve_step(params, state, reqs) -> (state,
        out)``: admit (on ticks with arrivals) + decode step.

        Unsharded or sharded over a one-process ``ShardMesh``, the tick
        is ``runtime/graphs.py::StaticTick``: on the card captured CUDA
        graphs at the engine's fixed shapes (the decode-only tick and the
        arrival tick, and sharded one arrival tick a set of live shards:
        the gates decided on the host from the batch, as ``eager_step``
        decides them), on the CPU the same body without a graph.  Its
        state lives in static buffers, and the state it returns is those
        buffers whatever ``donate`` says, as the reference's donated state
        is: a state kept across a tick is overwritten by it (the eager
        tick already writes the KV cache in place); clone what must
        survive.  Under ``XLB_SANITIZE=1`` (read here, as the reference
        reads it when it builds its program) it is the sanitizing
        ``StaticTick``, the reference's ``jax.jit(checkify.checkify(
        serve_step))``: the guards' verdicts stay on the device inside
        the program, the tick reads them once after it and raises on the
        first violated law, and a violated tick leaves the routing, pool
        and metrics as they were.  An engine on a rank mesh runs
        ``eager_step``, sanitized or not (its process group's collectives
        are outside a graph)."""
        if self.shards > 1 and self._rank_mesh():
            return self.eager_step
        return StaticTick(self, sanitize=sanitize_enabled())

    # ------------------------------------------------------------------ #
    # control-plane seam (Balancer protocol)
    # ------------------------------------------------------------------ #
    def get_routing(self, state: EngineState) -> RoutingState:
        return state.routing

    def apply_refresh(self, state: EngineState,
                      plan: control.RefreshPlan) -> EngineState:
        """Splice a committed transaction into the live state: one buffer
        swap of the tables (load counters migrate through the slot
        permutation) and a remap of the pool's endpoint references, so an
        in-flight connection releases its endpoint's new slot, never a
        new occupant of its old one."""
        routing = control.apply_plan(state.routing, plan)
        pool = state.pool._replace(
            endpoint=control.remap_endpoints(plan, state.pool.endpoint))
        return state._replace(routing=routing, pool=pool)

"""Public datapath wrappers (twin of ``repro/kernels/ops.py``).

Each wrapper checks where its tensors lie.  On a CUDA device it launches
the hand-written kernel (``csrc/``) or raises; on the CPU it runs the
plain PyTorch version, and on the meta device (the dry run) the plain
version too, which there computes shapes only.  There is no fallback
from one to the other.
``LAUNCHES`` counts the kernel launches of each wrapper, so a run can show
that its main path went through the kernels.  Under a CUDA graph capture
a wrapper's count runs but nothing launches: ``capture_launches`` takes
those counts out of the table, and ``count_replay`` adds them back on each
replay of the graph (``runtime/graphs.py``: the serving tick, the
sidecars' decode, the training step with its backward, the launcher's
decode step), so the table counts the launches that ran on the device.  ``flash_attention`` and
``ssd_scan`` are differentiable: their kernels run the forward, and the
backward recomputes the plain function (the reference's gradient is
JAX's autodiff of its plain functions; there is no backward kernel).

``relay_slots``, ``decode_attention``, ``flash_attention`` and
``ssd_scan`` also take DTensors (``torch.distributed.tensor``, the
tensors a ``sharding/specs.py::MeshSpec`` places on a ``DeviceMesh``):
a kernel reads raw memory, so it runs on each rank's local shard through
``local_map`` (the torch counterpart of the reference's ``shard_map``),
with the batch over the data axes and the heads over ``model`` where the
K/V heads divide it (else replicated over ``model``); the relay rank
takes its ids replicated, as it ranks over all of them.  Plain tensors
among a DTensor call's arguments count as replicated.

``dense`` is the models' projection product ``x @ W``: where the engine
gave the weight bf16 planes (``kernels/dense_x9.py``) and the call is a
decode's (f32 on the card, few rows, no gradient) it launches the
nine-product kernel, else it is ``x @ W`` itself.

The sharded wrappers (``admit_commit_sharded``, ``complete_sharded``)
count the launches of the kernels they run per shard (and the route and
relay kernels they run once a call) under those kernels' names.

The admission and completion wrappers take the reference's tuning
arguments: ``block_r`` (rows per tile, which also decides the first
affinity writer of a tile), ``block_i`` and ``fold``, each ``None`` for
the plan of ``kernels/tune.py`` (pins, cache, or a sweep at the first use
of a shape on the tensors' device).

Under ``XLB_SANITIZE=1`` ``admit``, ``admit_commit`` and ``complete`` run
the conservation laws of ``analysis/invariants.py`` on their outputs
(``guard``: the laws on the tensors' device, one host sync per call; in
the captured tick's body none, the tick reads its verdicts once after
the call) and raise on the first violation, on the tick that broke it.
With the variable unset they add no op and no sync.  The sharded
wrappers have no guard, as the reference's have none.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

from repro_torch.analysis.invariants import guard, sanitize_enabled
from repro_torch.core.balancer import PoolState, RequestBatch
from repro_torch.kernels import completion as _cp
from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import dense_x9 as _x9
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import relay_dispatch as _rd
from repro_torch.kernels import route_match as _rm
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.kernels import tune
from repro_torch.kernels.route_match import AdmitResult
from repro_torch.sharding.specs import is_dtensor

#: kernel launches per wrapper (incremented only where a kernel launches)
LAUNCHES = {"admit": 0, "admit_commit": 0, "complete": 0, "route_match": 0,
            "relay_slots": 0, "decode_attention": 0, "flash_attention": 0,
            "ssd_scan": 0, "dense_x9": 0}


@contextlib.contextmanager
def capture_launches():
    """Around a CUDA graph capture: yields a dict that is filled, on exit,
    with the launches the captured wrappers counted (what each replay of
    the graph launches), and puts ``LAUNCHES`` back as it was."""
    before, delta = dict(LAUNCHES), {}
    try:
        yield delta
    finally:
        delta.update({k: n - before[k] for k, n in LAUNCHES.items()
                      if n != before[k]})
        LAUNCHES.update(before)


def count_replay(delta: dict) -> None:
    """One replay of a captured graph: its launches into ``LAUNCHES``."""
    for k, n in delta.items():
        LAUNCHES[k] += n


#: the profiler ranges the backward recomputes of B7 and B8 run in
VJP_RANGES = {"flash_attention": "xlb::flash_attention_vjp",
              "ssd_scan": "xlb::ssd_scan_vjp"}


class AdmitCommitOut(NamedTuple):
    """Fused connect path: per-request decisions + updated LB state + the
    committed connection pool."""

    cluster: torch.Tensor       # (R,) i32 destination cluster (-1 = none)
    endpoint: torch.Tensor      # (R,) i32 global endpoint (-1 = unroutable)
    instance: torch.Tensor      # (R,) i32 instance lane (-1 = unroutable)
    slot: torch.Tensor          # (R,) i32 pool slot (-1 = held/unroutable)
    ok: torch.Tensor            # (R,) i32 1 = admitted into a pool slot
    ep_load: torch.Tensor       # (E,) i32 updated outstanding requests
    rr_cursor: torch.Tensor     # (CL,) i32 updated round-robin cursors
    svc_requests: torch.Tensor  # (S,) i32 admitted requests per service
    svc_tx_bytes: torch.Tensor  # (S,) i32 admitted payload bytes
    no_route: torch.Tensor      # () i32 valid requests with no rule match
    held: torch.Tensor          # () i32 routable requests without a slot
    aff_key: torch.Tensor       # (A,) i32 updated affinity cache
    aff_ep: torch.Tensor        # (A,) i32
    pool: PoolState             # (I, C) committed pool (active as bool)


class CompleteOut(NamedTuple):
    """Fused close path: freed pool + released counters + rx metrics +
    updated health EWMAs."""

    pool: PoolState             # (I, C) pool after completion (active bool)
    done: torch.Tensor          # (I, C) bool finished this step
    ep_load: torch.Tensor       # (E,) i32 counters after release
    rx_bytes: torch.Tensor      # (S,) i32 per-service rx metric
    done_cnt: torch.Tensor      # (E,) i32 completions this step
    ep_inflight_ewma: torch.Tensor  # (E,) f32
    ep_tput_ewma: torch.Tensor  # (E,) f32


def device_kind(t: torch.Tensor) -> str:
    """Where a wrapper's tensors lie: ``"cuda"``, ``"cpu"`` or ``"meta"``."""
    return t.device.type


def _on_cuda(t: torch.Tensor) -> bool:
    """True where the kernel launches.  Meta tensors (the dry run's: shapes
    and dtypes, no data) take the plain version, which on them computes
    only the output shapes; they never reach a launch."""
    kind = device_kind(t)
    if kind not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {t.device}")
    return kind == "cuda"


def _empty_admit(routing):
    """The admission result of an empty batch: no launch, state unchanged."""
    z = torch.zeros((0,), dtype=torch.int32, device=routing.ep_load.device)
    zs = torch.zeros_like(routing.svc_rule_start, dtype=torch.int32)
    zero = torch.zeros((), dtype=torch.int32, device=z.device)
    return (z, z, z, z, z, routing.ep_load,
            routing.rr_cursor % routing.cluster_ep_count.clamp_min(1),
            zs, zs, zero, zero, routing.aff_key, routing.aff_ep)


def admit(reqs: RequestBatch, routing, free_mask, rnd, gumbel, *,
          block_r: int | None = None,
          fold: str | None = None) -> AdmitResult:
    """Admission datapath without the pool write-back: match → balance →
    slot-allocate → metrics.  ``free_mask`` (I, C), nonzero = free.
    ``block_r`` / ``fold`` default to the tuned plan."""
    block_r, fold = tune.plan_admit(reqs.req_id.shape[0], free_mask.shape,
                                    block_r=block_r, fold=fold,
                                    device=reqs.req_id.device)
    if reqs.req_id.shape[0] == 0:         # empty batch: nothing to admit
        return AdmitResult(*_empty_admit(routing))
    if _on_cuda(reqs.req_id):
        res = _rm.admit_cuda(reqs.req_id, reqs.svc, reqs.features,
                             reqs.msg_bytes, None, routing, free_mask, None,
                             rnd, gumbel, block_r=block_r)
        LAUNCHES["admit"] += 1
    else:
        res = _rm.admit(reqs.req_id, reqs.svc, reqs.features,
                        reqs.msg_bytes, routing, free_mask, rnd, gumbel,
                        block_r=block_r)
    if sanitize_enabled():
        guard("admit", dict(load_before=routing.ep_load,
                            load_after=res.ep_load, ok=res.ok,
                            held=res.held, endpoint=res.endpoint))
    return res


def admit_commit(reqs: RequestBatch, routing, pool: PoolState, rnd,
                 gumbel, *, block_r: int | None = None,
                 fold: str | None = None) -> AdmitCommitOut:
    """Fused admission + in-kernel pool commit (no post-pass scatters)."""
    block_r, fold = tune.plan_admit(reqs.req_id.shape[0], pool.req_id.shape,
                                    block_r=block_r, fold=fold, commit=True,
                                    device=reqs.req_id.device)
    if reqs.req_id.shape[0] == 0:         # empty batch: pool passes through
        return AdmitCommitOut(*_empty_admit(routing), pool)
    fields = (pool.req_id, pool.endpoint, pool.svc, pool.length, pool.token)
    if _on_cuda(reqs.req_id):
        res = _rm.admit_cuda(reqs.req_id, reqs.svc, reqs.features,
                             reqs.msg_bytes, reqs.token, routing,
                             pool.active == 0, fields, rnd, gumbel,
                             block_r=block_r)
        LAUNCHES["admit_commit"] += 1
    else:
        res = _rm.admit_commit(reqs.req_id, reqs.svc, reqs.features,
                               reqs.msg_bytes, reqs.token, routing, *fields,
                               pool.active, rnd, gumbel, block_r=block_r)
    out = AdmitCommitOut(
        *res[:13], PoolState(res.pool_req_id, res.pool_endpoint,
                             res.pool_svc, res.pool_length, res.pool_token,
                             res.pool_active))
    if sanitize_enabled():
        guard("admit", dict(load_before=routing.ep_load,
                            load_after=out.ep_load, ok=out.ok,
                            held=out.held, endpoint=out.endpoint,
                            instance=out.instance, slot=out.slot,
                            req_id=reqs.req_id,
                            pool_req_id=out.pool.req_id,
                            pool_active=out.pool.active))
    return out


def admit_commit_sharded(reqs: RequestBatch, routing, pool: PoolState, rnd,
                         gumbel, *, mesh, axis: str = "shard",
                         live=None, block_r: int | None = None,
                         fold: str | None = None) -> AdmitCommitOut:
    """``admit_commit`` sharded over the mesh axis ``axis``
    (``launch/mesh.py``: ``ShardMesh``, every shard in this process, or
    ``RankShardMesh``, one rank a shard): the batch splits ``(R/M,)``, the
    pool ``(I/M,)``, the routing tables replicate, each shard runs the
    admission kernel without the commit (one launch per shard that holds a
    valid row, counted under ``"admit"``), one route-match launch for the
    rows this process holds, one relay launch for their pool commits, and
    one collective pass reconciles the state the datapath owns; bit-exact
    against ``admit_commit`` on the same batch
    (``kernels/shard_admit.py``).  ``reqs``, ``rnd``, ``gumbel`` and
    ``pool`` are what this process holds (``shard_admit.held_rows``).
    ``live``: ``shard_admit.live_shards`` of the held rows as the host
    built them (None reads it from ``reqs``).  The plan is made at the
    per-shard width R/M, as the reference's is; on a rank mesh every rank
    takes rank 0's."""
    from repro_torch.kernels import shard_admit as _sa
    M, L = mesh.shape[axis], len(mesh.held)
    R_loc = -(-max(reqs.req_id.shape[0], 1) // L)
    shape = (pool.req_id.shape[0] // L * M, pool.req_id.shape[1])
    block_r, fold = tune.plan_admit(R_loc, shape, block_r=block_r,
                                    fold=fold, commit=True,
                                    device=reqs.req_id.device)
    block_r = mesh.agree(("admit", R_loc, *shape), block_r)
    res = _sa.admit_commit_sharded(
        reqs.req_id, reqs.svc, reqs.features, reqs.msg_bytes, reqs.token,
        routing, *pool, rnd, gumbel, mesh=mesh, axis=axis, live=live,
        block_r=block_r)
    return AdmitCommitOut(*res[:13], PoolState(*res[13:]))


def _ewma_defaults(ep_load, ep_inflight_ewma, ep_tput_ewma):
    E = ep_load.shape[0]
    z = lambda: torch.zeros((E,), dtype=torch.float32, device=ep_load.device)
    return (z() if ep_inflight_ewma is None else ep_inflight_ewma,
            z() if ep_tput_ewma is None else ep_tput_ewma)


def complete(pool: PoolState, nxt, ep_load, rx_bytes, ep_inflight_ewma=None,
             ep_tput_ewma=None, *, eos: int, max_len: int,
             block_i: int | None = None,
             fold: str | None = None) -> CompleteOut:
    """Fused completion: done detect → load release → rx metrics → free →
    health EWMA update (None EWMAs → cold-start zeros).  ``block_i`` /
    ``fold`` are planned and recorded; every value runs the same launch
    (``kernels/tune.py``)."""
    tune.plan_complete(pool.req_id.shape, block_i=block_i, fold=fold,
                       device=nxt.device)
    ewl, ewt = ep_inflight_ewma, ep_tput_ewma
    if ewl is None or ewt is None:
        ewl, ewt = _ewma_defaults(ep_load, ewl, ewt)
    args = (*pool, nxt, ep_load, rx_bytes, ewl, ewt)
    if _on_cuda(nxt):
        res = _cp.complete_cuda(*args, eos=eos, max_len=max_len)
        LAUNCHES["complete"] += 1
    else:
        res = _cp.complete(*args, eos=eos, max_len=max_len)
    out = CompleteOut(
        PoolState(res.req_id, res.endpoint, res.svc, res.length, res.token,
                  res.active),
        res.done, res.ep_load, res.rx_bytes, res.done_cnt,
        res.inflight_ewma, res.tput_ewma)
    if sanitize_enabled():
        guard("complete", dict(load_before=ep_load, load_after=out.ep_load,
                               done_cnt=out.done_cnt, done=out.done,
                               active_after=out.pool.active,
                               req_id_after=out.pool.req_id))
    return out


def complete_sharded(pool: PoolState, nxt, ep_load, rx_bytes,
                     ep_inflight_ewma=None, ep_tput_ewma=None, *, mesh,
                     axis: str = "shard", eos: int, max_len: int,
                     block_i: int | None = None,
                     fold: str | None = None) -> CompleteOut:
    """``complete`` sharded over the mesh axis ``axis``: the pool splits
    ``(I/M,)`` (``pool`` and ``nxt`` are what this process holds), the
    (E,)/(S,) tables replicate, the completion kernel runs on each held
    slice (one launch per shard, counted under ``"complete"``),
    and the per-shard integer folds are psum-reconciled before ONE shared
    ``health_update`` on the global counts, so the EWMAs are bit-exact
    against ``complete`` on the whole pool (``kernels/shard_admit.py``)."""
    from repro_torch.kernels import shard_admit as _sa
    I, C = pool.req_id.shape
    tune.plan_complete((max(I // len(mesh.held), 1), C), block_i=block_i,
                       fold=fold, device=nxt.device)
    ewl, ewt = _ewma_defaults(ep_load, ep_inflight_ewma, ep_tput_ewma)
    res = _sa.complete_sharded(*pool, nxt, ep_load, rx_bytes, ewl, ewt,
                               mesh=mesh, axis=axis, eos=eos,
                               max_len=max_len)
    return CompleteOut(PoolState(*res[:6]), res.done, res.ep_load,
                       res.rx_bytes, res.done_cnt, res.inflight_ewma,
                       res.tput_ewma)


def route_match(svc, features, routing) -> tuple[torch.Tensor, torch.Tensor]:
    """Stateless route match: (cluster (R,), endpoint (R,)) i32 - the first
    matching rule and the least-loaded lane of its window, no drain mask.
    Any R; an empty batch returns empty outputs with no launch."""
    if features.shape[0] == 0:
        z = torch.zeros((0,), dtype=torch.int32, device=features.device)
        return z, z.clone()
    if _on_cuda(features):
        res = _rm.route_match_cuda(svc, features, routing)
        LAUNCHES["route_match"] += 1
        return res
    return _rm.route_match(svc, features, routing)


def _split(mesh, shape, batch: int | None, heads: int | None,
           shard_heads: bool = True) -> list:
    """Placements of a kernel's operand on ``mesh``: dim ``batch`` over
    the data axes (every axis but ``model``, major to minor) where their
    product divides it, dim ``heads`` over ``model`` with
    ``shard_heads`` where that divides it; replicated otherwise."""
    from torch.distributed.tensor import Replicate, Shard
    names = mesh.mesh_dim_names
    sizes = dict(zip(names, mesh.shape))
    dp = 1
    for n in names:
        if n != "model":
            dp *= sizes[n]
    out = []
    for n in names:
        if n == "model":
            ok = shard_heads and heads is not None \
                and shape[heads] % sizes[n] == 0
            out.append(Shard(heads) if ok else Replicate())
        else:
            ok = batch is not None and shape[batch] % dp == 0
            out.append(Shard(batch) if ok else Replicate())
    return out


def _local_map(fn, args, in_placements, out_placements, mesh=None,
               in_grad_placements=None):
    """``fn`` on each rank's local shards of ``args`` laid out as
    ``in_placements`` (redistributed there first; a plain tensor counts
    as replicated), its outputs DTensors of ``out_placements`` (a list of
    placements for one output, a tuple of lists for several), on
    ``mesh`` (the first DTensor's where None).  ``in_grad_placements``:
    the layout of each input's local gradient where it is not that
    input's own (a replicated input whose ranks each use a part of it
    leaves a ``Partial`` gradient)."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import local_map
    if mesh is None:
        mesh = next(a for a in args if is_dtensor(a)).device_mesh
    args = [a if is_dtensor(a) or not isinstance(a, torch.Tensor) else
            DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim,
                               run_check=False) for a in args]
    return local_map(fn, out_placements=out_placements,
                     in_placements=in_placements,
                     in_grad_placements=in_grad_placements or in_placements,
                     device_mesh=mesh, redistribute_inputs=True)(*args)


def _mesh_and_heads(tensors, kv):
    """The mesh of the first DTensor among ``tensors``, and whether the
    K/V heads ``kv`` divide over its ``model`` axis (then the heads
    shard)."""
    mesh = next(t for t in tensors if is_dtensor(t)).device_mesh
    tp = dict(zip(mesh.mesh_dim_names, mesh.shape)).get("model", 1)
    return mesh, kv % tp == 0


def relay_slots(idx, n_dest: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Counting-sort rank: (slot (N,), load (n_dest,)) i32, the stable rank
    of each row within its destination and the per-destination totals;
    rows at the sentinel ``n_dest`` take no rank and count no load.  Any
    N; N == 0 returns empty slots and zero loads with no launch."""
    if is_dtensor(idx):
        rep = _split(idx.device_mesh, idx.shape, None, None)
        return _local_map(lambda i: relay_slots(i, n_dest), [idx], (rep,),
                          (rep, rep))
    if idx.shape[0] == 0:
        z = lambda n: torch.zeros((n,), dtype=torch.int32, device=idx.device)
        return z(0), z(n_dest)
    if _on_cuda(idx):
        res = _rd.relay_slots_cuda(idx, n_dest)
        LAUNCHES["relay_slots"] += 1
        return res
    return _rd.relay_slots(idx, n_dest)


def decode_attention(q, k_cache, v_cache, lengths) -> torch.Tensor:
    """One-token GQA attention: q (B, H, hd) against caches (B, S, K, hd)
    at ``kpos <= lengths[b]``, scaled by 1/sqrt(hd) → (B, H, hd).  Any S;
    the caches are read in place on the card."""
    args = (q, k_cache, v_cache, lengths)
    if any(map(is_dtensor, args)):
        mesh, heads = _mesh_and_heads(args, k_cache.shape[2])
        pq = _split(mesh, q.shape, 0, 1, heads)
        pk = _split(mesh, k_cache.shape, 0, 2, heads)
        return _local_map(decode_attention, list(args),
                          (pq, pk, pk, _split(mesh, lengths.shape, 0, None)),
                          pq)
    if _on_cuda(q):
        res = _da.decode_attention_cuda(q, k_cache, v_cache, lengths)
        LAUNCHES["decode_attention"] += 1
        return res
    return _da.decode_attention(q, k_cache, v_cache, lengths)


def takes_x9(x, w) -> bool:
    """Whether ``dense(x, w)`` launches the nine-product kernel: ``w`` an
    ``X9Weight`` of one matrix, ``x`` an f32 tensor on the card with at
    most ``MAX_ROWS`` rows (a decode's lanes), no gradient recorded, and
    neither a DTensor."""
    if not isinstance(w, _x9.X9Weight) or is_dtensor(x) \
            or is_dtensor(w.w) or w.planes.dim() != 3:
        return False
    if x.device.type != "cuda" or x.dtype != torch.float32 or x.dim() == 0:
        return False
    if torch.is_grad_enabled() and (x.requires_grad or w.w.requires_grad):
        return False
    return x.numel() <= _x9.MAX_ROWS * x.shape[-1]


def dense(x, w):
    """``x @ w``: through ``csrc/dense_x9.cu`` (nine exact bf16 products
    on the tensor cores, f32 sums) where ``takes_x9``, else ``x @`` the
    weight as PyTorch computes it (the CPU, gradients, bf16 weights,
    prefill and training, DTensors, weights without planes: bitwise the
    plain product)."""
    if isinstance(w, _x9.X9Weight):
        if takes_x9(x, w):
            res = _x9.dense_x9_cuda(x, w.planes)
            LAUNCHES["dense_x9"] += 1
            return res
        w = w.w
    return x @ w


class _FlashAttention(torch.autograd.Function):
    """B7 with a gradient: the forward launches the kernel on CUDA tensors
    (the plain version on the CPU, over ``q_chunk``-row query chunks where
    given), the backward recomputes the plain attention from the saved
    inputs (``flash_attention_vjp``, ``q_chunk`` rows at a time) on
    either."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, q_chunk: int):
        if _on_cuda(q):
            out = _fa.flash_attention_cuda(q, k, v, causal=causal)
            LAUNCHES["flash_attention"] += 1
        elif q_chunk:
            out = _fa.flash_attention_chunked(q, k, v, q_chunk,
                                              causal=causal)
        else:
            out = _fa.flash_attention(q, k, v, causal=causal)
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.q_chunk = causal, q_chunk
        return out

    @staticmethod
    def backward(ctx, dout):
        with torch.profiler.record_function(VJP_RANGES["flash_attention"]):
            return (*_fa.flash_attention_vjp(
                *ctx.saved_tensors, dout, causal=ctx.causal,
                q_chunk=ctx.q_chunk or _fa.VJP_Q_CHUNK), None, None)


class _SSDScan(torch.autograd.Function):
    """B8 with a gradient: the forward launches the kernels on CUDA
    tensors (the plain version on the CPU), the backward recomputes the
    plain scan from the saved inputs (``ssd_scan_vjp``) on either."""

    @staticmethod
    def forward(ctx, xdt, a_log, Bm, Cm, chunk: int):
        if _on_cuda(xdt):
            y, h = _ssd.ssd_scan_cuda(xdt, a_log, Bm, Cm)
            LAUNCHES["ssd_scan"] += 1
        else:
            y, h = _ssd.ssd_scan(xdt, a_log, Bm, Cm, chunk)
        ctx.save_for_backward(xdt, a_log, Bm, Cm)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        with torch.profiler.record_function(VJP_RANGES["ssd_scan"]):
            if dy is None:
                dy = torch.zeros_like(ctx.saved_tensors[0])
            return (*_ssd.ssd_scan_vjp(*ctx.saved_tensors, ctx.chunk, dy,
                                       dh), None)


def flash_attention(q, k, v, *, causal: bool = True,
                    q_chunk: int = 0) -> torch.Tensor:
    """GQA prefill attention: q (B, S, H, hd), k/v (B, S, K, hd) →
    (B, S, H, hd), causal or not, scaled by 1/sqrt(hd).  Any S.
    ``q_chunk`` > 0: the plain version and the backward's recompute take
    that many query rows at a time (the kernel keeps its own tiles).
    Differentiable: the kernel runs the forward, the plain attention is
    recomputed for the backward."""
    if any(map(is_dtensor, (q, k, v))):
        mesh, heads = _mesh_and_heads((q, k, v), k.shape[2])
        pq = _split(mesh, q.shape, 0, 2, heads)
        pk = _split(mesh, k.shape, 0, 2, heads)
        return _local_map(
            lambda a, b, c: _FlashAttention.apply(a, b, c, causal, q_chunk),
            [q, k, v], (pq, pk, pk), pq)
    return _FlashAttention.apply(q, k, v, causal, q_chunk)


def ssd_scan(xdt, a_log, Bm, Cm, *, chunk: int,
             return_state: bool = False):
    """Mamba-2 SSD from a zero state: xdt (B, S, nh, hd), a_log (B, S, nh)
    f32, Bm/Cm (B, S, nh, N) → y (B, S, nh, hd), and with
    ``return_state`` also the final state (B, nh, hd, N) f32.  ``chunk``
    is clipped to S and must divide it, as the Pallas wrapper asserts.
    The plain version computes chunk by chunk; on the card ``chunk`` is
    only checked for divisibility (the kernels use chunks of their own,
    and the form is exact for any chunk).  One call is one count in
    ``LAUNCHES``, whatever number of passes it runs.  Differentiable: the
    kernels run the forward, the plain scan is recomputed for the
    backward.  On DTensors: the batch over the data axes and the heads
    over ``model``."""
    S = xdt.shape[1]
    chunk = min(chunk, S)
    if chunk <= 0 or S % chunk:
        raise ValueError(f"S = {S} is not a multiple of the chunk {chunk}")
    args = (xdt, a_log, Bm, Cm)
    if any(map(is_dtensor, args)):
        mesh, _ = _mesh_and_heads(args, 1)
        p4 = _split(mesh, xdt.shape, 0, 2)
        y, h = _local_map(
            lambda *a: _SSDScan.apply(*a, chunk), list(args),
            (p4, _split(mesh, a_log.shape, 0, 2), p4, p4),
            (p4, _split(mesh, (xdt.shape[0], xdt.shape[2]), 0, 1)))
    else:
        y, h = _SSDScan.apply(xdt, a_log, Bm, Cm, chunk)
    return (y, h) if return_state else y

"""Hot programs as captured CUDA graphs: the port's counterpart of the
reference's ``jax.jit`` around ``Engine.make_jitted``'s ``serve_step``
(``repro/core/interpose.py``), around the sidecars' decode
(``repro/core/sidecar.py``), around the training step with its state
donated (``repro/runtime/train_loop.py``) and around the model
launcher's decode step with its cache donated (``build_decode_step`` in
``repro/launch/dryrun.py``).

A body that reads and writes only *static* buffers (tensors allocated
once, outside any graph, whose addresses never change) runs through
``Graphs.run``.  On a CUDA device the first call of each key runs the
body eagerly on a side stream (the warm-up: the kernels' lazy build, the
autotuner's sweeps and cuBLAS's workspace happen there, and the call is a
real one), then captures it as a ``torch.cuda.CUDAGraph``; every later
call of the key replays the graph.  Before the capture the warm-up's
freed blocks go back to the device (``empty_cache``): the capture
allocates from its own pool, and a training step's temporaries would
otherwise be held twice.  On the CPU the body runs directly:
that is what the caller asked for, and every CPU test through it runs the
same static-buffer plumbing.  Nothing falls back: a body that syncs with
the host or takes a shape from the data fails its capture, which raises
``CaptureError``.

The graphs of one owner share one memory pool.  It holds only the
bodies' temporaries: each body ends by copying what outlives it into its
static buffers, and the graphs replay one at a time on one stream.

A key's first call is timed in three parts, kept over every key (host
seconds, ``setup_s`` their sum): ``warmup_s`` the eager call's launch,
``sync_s`` the wait for it to finish and the ``empty_cache``, and
``capture_s`` the capture.

``ops.LAUNCHES`` counts the launches that ran on the device: a capture
records the counts its body's wrappers made and restores the table, and
each replay adds them again (``ops.capture_launches`` /
``ops.count_replay``).

``StaticTick`` is the XLB engine's tick on static buffers (at the
engine's fixed shapes, the arrival tick and the decode-only tick, and on
a one-process sharded engine one arrival tick a set of live shards;
under ``XLB_SANITIZE=1`` the same programs with the guards' verdicts in
static buffers, read once after each call);
``StaticDecode`` the sidecars' decode (one program per KV cache);
``StaticTrainStep`` the training step (one program a batch layout);
``StaticModelDecode`` the launcher's greedy decode step (one program a
KV cache and params).
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable

import numpy as np
import torch
from torch.utils import _pytree

from repro_torch.analysis import invariants as INV
from repro_torch.core.balancer import RequestBatch
from repro_torch.kernels import ops
from repro_torch.models import model as M


def _same_layout(dst: torch.Tensor, src: torch.Tensor, what: str) -> None:
    if dst.shape != src.shape or dst.dtype != src.dtype:
        raise ValueError(
            f"{what}: {tuple(src.shape)} {src.dtype} does not fit the "
            f"static buffer {tuple(dst.shape)} {dst.dtype} (a captured "
            "program runs at fixed shapes)")


def _copy_in(mine, theirs, what: str) -> int:
    """Copy each leaf of ``theirs`` that is not the matching leaf of
    ``mine`` into it (shapes and dtypes must match); the leaves copied."""
    dsts, srcs = _pytree.tree_leaves(mine), _pytree.tree_leaves(theirs)
    if len(dsts) != len(srcs):
        raise ValueError(f"{what}: {len(srcs)} tensors where the static "
                         f"state has {len(dsts)}")
    n = 0
    with torch.no_grad():
        for i, (dst, src) in enumerate(zip(dsts, srcs)):
            if dst is not src:
                _same_layout(dst, src, f"{what} leaf {i}")
                dst.copy_(src)
                n += 1
    return n


def _write_back(mine, new, held=None) -> None:
    """Inside a body: copy what it returned into the static tensors it
    did not update in place.  ``held``: a 0-d bool on the device; where
    it is false each of those tensors keeps its value."""
    dsts = _pytree.tree_leaves(mine)
    static = {t.untyped_storage().data_ptr() for t in dsts}
    for dst, src in zip(dsts, _pytree.tree_leaves(new)):
        if src is dst:
            continue
        if src.untyped_storage().data_ptr() in static:
            raise RuntimeError("the body returned a view of its static "
                               "state; copying it back would race")
        dst.copy_(src if held is None else torch.where(held, src, dst))


class CaptureError(RuntimeError):
    """A body that ran eagerly could not be captured (it syncs with the
    host, copies from pageable host memory, or takes a shape from the
    data): it fails the same way at every call, so no caller retries it."""


class Graphs:
    """The captured programs of one owner on ``device``: one memory pool,
    one side stream, the graphs keyed by the caller.  ``keep`` objects are
    held for as long as the key's graph lives, so that the identity the
    key names (``id(params)``, ``id(cache)``) cannot be reused."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self._graphs: dict = {}
        self.setup_s = 0.0          # host seconds of warm-ups and captures
        self.warmup_s = self.sync_s = self.capture_s = 0.0     # its parts
        self._pool = torch.cuda.graph_pool_handle() if self.cuda else None
        self._stream = torch.cuda.Stream(device) if self.cuda else None

    def __len__(self) -> int:
        return len(self._graphs)

    def __contains__(self, key) -> bool:
        """Whether ``key``'s program is captured (its next call replays)."""
        return key in self._graphs

    def launches(self, key) -> dict:
        """The kernel launches each replay of ``key``'s program makes, by
        ``ops.LAUNCHES`` name (empty where nothing is captured)."""
        hit = self._graphs.get(key)
        return hit[1] if hit is not None else {}

    def run(self, key, body: Callable[[], None], keep=()) -> None:
        """``body()`` as the key's program: replayed where captured, else
        warmed up eagerly and captured (CUDA), or run directly (CPU)."""
        if not self.cuda:
            body()
            return
        hit = self._graphs.get(key)
        if hit is not None:
            graph, delta, _ = hit
            graph.replay()
            ops.count_replay(delta)
            return
        t0 = time.perf_counter()
        cur = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(cur)
        with torch.cuda.stream(self._stream):
            body()                               # the warm-up: a real call
        cur.wait_stream(self._stream)
        t1 = time.perf_counter()
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        t2 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        try:
            with ops.capture_launches() as delta:
                with torch.cuda.graph(graph, pool=self._pool,
                                      stream=self._stream):
                    body()
        except Exception as e:
            raise CaptureError(f"the capture failed: {type(e).__name__}: "
                               f"{e}") from e
        self._graphs[key] = (graph, delta, keep)
        t3 = time.perf_counter()
        self.warmup_s += t1 - t0
        self.sync_s += t2 - t1
        self.capture_s += t3 - t2
        self.setup_s += t3 - t0


class StaticTick:
    """``Engine.make_jitted``'s tick: admission on ticks with arrivals,
    then the decode step, on static buffers, for an unsharded engine or
    one sharded over a one-process ``ShardMesh`` (a rank mesh's
    collectives stay outside a graph: ``make_jitted`` gives it the eager
    tick).

    The engine state lives in persistent buffers: the first call clones
    the state it is handed (the KV cache, which the decode writes in
    place, is taken as it is) and every call returns that one
    ``EngineState``.  A state it did not produce (the first one, a
    control-plane splice, a fault's rollback, any ``_replace``) is copied
    in field by field, only the fields that are not the static tensors
    themselves; a state it produced costs nothing.  The shapes and dtypes
    must stay (``control.apply_plan`` keeps them; a one-process sharded
    engine holds the whole pool, so its state has the unsharded shapes).
    The gates (``engine.arrivals``) read the batch as the caller built
    it: give it host tensors and they cost no device sync.  Whether the
    tick admits at all is the reference's ``lax.cond`` on "any arrivals";
    on a sharded engine which shards hold a valid row is its per-shard
    ``lax.cond``, and the set is part of the program's key: a shard
    without arrivals launches no admission kernel, as in the eager tick.
    The batch is then packed into a pinned staging buffer and copied into
    the static request buffer, and the draws (``engine.draws``) into
    static draw buffers, before the replay.  Programs a (batch rows R,
    params) pair: the decode-only tick and the arrival tick, one a live
    set on a sharded engine (at most 2^M - 1; a batch filled from the
    front, as ``ServeLoop`` fills it, makes at most M).  The params'
    tensors are read in place: update them in place, or pass another
    params object (which captures anew).  The weights' bf16 planes
    (``Engine.serving_params``) are made at a params object's first call,
    before its capture, and split again before a call where a weight was
    updated in place; the programs keep them alive.

    ``sanitize`` (``make_jitted`` under ``XLB_SANITIZE=1``) is the
    reference's ``jax.jit(checkify.checkify(serve_step))``: the body runs
    under ``invariants.deferred``, so the guards the kernel wrappers call
    read nothing on the host; their verdicts go into a static bool buffer
    a program (its laws recorded at the program's first body), and the
    write-back of every state field the tick replaced is gated on "every
    law held" on the device, so a violated tick leaves ``routing``,
    ``pool`` and ``metrics`` as they were before it, as the reference's
    undonated checkified program leaves the caller's state (the KV cache,
    which the decode writes in place, stays as the eager tick leaves it).
    After each call, the warm-up or a replay on the card, the body itself
    on the CPU, the tick reads the buffer once (``verdict_reads``) and
    raises ``AssertionError`` naming the first violated law, in the
    guards' order, with the eager guard's text.  A program whose body
    calls no guard (the sharded wrappers have none, as the reference's)
    has an empty buffer and reads nothing.

    The outputs are static too: ``emitted``, ``done``, ``req_id``,
    ``active`` and ``packed`` are overwritten by the next tick.

    ``tracer`` (a ``runtime/trace.py::Tracer``, set through
    ``ServeLoop.tracer``; None: nothing timed) times each call's host
    phases before and after the program: ``static_tick.gate``,
    ``adopt``, ``draws``, ``stage`` (the wait on the last staging copy
    included), then ``replay``, or ``capture`` at a key's first call on
    the card, and sanitized ``verdict``; on the card it also counts in
    ``static_tick.dense_x9`` the nine-product kernel's launches that the
    call's program holds (``Graphs.launches``)."""

    def __init__(self, engine, sanitize: bool = False):
        if engine.shards > 1 and engine._rank_mesh():
            raise ValueError("a rank shard mesh's collectives cannot be "
                             "captured: its tick is engine.eager_step")
        self.eng = engine
        self.device = engine.device
        self.sanitize = sanitize
        self.graphs = Graphs(self.device)
        self.state = None
        self.out = None
        self.copied_in = 0          # fields copied in from foreign states
        self.verdict_reads = 0      # host reads of a verdict buffer
        self.laws_checked = 0       # the verdicts those reads brought back
        self.tracer = None
        self._reqs: dict = {}       # R -> (R, 4 + F) int32 static batch
        self._draws: dict = {}      # R -> static (rnd, gumbel)
        self._staging: dict = {}    # R -> pinned (R, 4 + F) host buffer
        self._staged = None         # event: the last staging copy is done
        self._laws: dict = {}       # key -> [(scope, laws)] of its guards
        self._verdicts: dict = {}   # key -> static (n laws,) bool buffer

    # ------------------------------------------------------------------ #
    def _adopt(self, state) -> None:
        """Make ``state`` the static state: clone it on the first call,
        later copy in each field that is not a static tensor."""
        if self.state is None:
            clone = lambda t: t.clone()  # noqa: E731
            self.state = state._replace(
                routing=type(state.routing)(*map(clone, state.routing)),
                pool=type(state.pool)(*map(clone, state.pool)),
                metrics=type(state.metrics)(*map(clone, state.metrics)))
            return
        if state is self.state:
            return
        for name in ("routing", "pool", "metrics", "cache"):
            mine, theirs = getattr(self.state, name), getattr(state, name)
            if mine is not theirs:
                self.copied_in += _copy_in(mine, theirs, f"state.{name}")

    def _draw(self, R: int) -> None:
        """The admission's draws into their static buffers."""
        rnd, gum = self.eng.draws(R)
        if R not in self._draws:
            self._draws[R] = (torch.empty_like(rnd, device=self.device),
                              torch.empty_like(gum, device=self.device))
        for dst, src in zip(self._draws[R], (rnd, gum)):
            _same_layout(dst, src, "draws")
            dst.copy_(src)

    def _stage(self, reqs: RequestBatch, R: int) -> None:
        """The admission batch into its static buffer."""
        if R not in self._reqs:
            F = reqs.features.shape[1]
            i32 = dict(dtype=torch.int32)
            self._reqs[R] = torch.empty((R, 4 + F), device=self.device,
                                        **i32)
            if self.device.type == "cuda":
                self._staging[R] = torch.empty((R, 4 + F), pin_memory=True,
                                               **i32)
        buf, stage = self._reqs[R], self._staging.get(R)
        if stage is None or reqs.req_id.device == self.device:
            buf.copy_(reqs.pack())
        else:
            # the host batch through one pinned buffer, its copy queued on
            # the stream; the buffer is refilled only once that copy ran
            if self._staged is None:
                self._staged = torch.cuda.Event()
            self._staged.synchronize()
            buf.copy_(reqs.pack(out=stage), non_blocking=True)
            self._staged.record()

    def _held(self, key, sink: list):
        """Inside a sanitized body: its guards' verdicts into the key's
        static buffer; "every law held" as a 0-d bool on the device, None
        where the body called no guard."""
        laws = [(scope, active) for scope, active, _ in sink]
        if key not in self._laws:
            self._laws[key] = laws
            self._verdicts[key] = torch.empty(
                (sum(len(a) for _, a in laws),), dtype=torch.bool,
                device=self.device)
        elif laws != self._laws[key]:
            raise RuntimeError("a program's body called other guards than "
                               "at its first call")
        if not laws:
            return None
        buf = self._verdicts[key]
        buf.copy_(torch.cat([v for *_, v in sink]))
        return buf.all()

    def _body(self, params, R: int | None, live, key) -> None:
        """The tick on the static buffers; what outlives it is copied
        back into them (sanitized: only where every law held)."""
        state = self.state
        with (INV.deferred() if self.sanitize
              else contextlib.nullcontext()) as sink:
            if R is not None:
                state = self.eng.admit(
                    state, RequestBatch.unpack(self._reqs[R]), live=live,
                    draws=self._draws[R])
            new, out = self.eng.step(params, state)
        held = self._held(key, sink) if self.sanitize else None
        if self.out is None:
            self.out = {k: torch.empty_like(v) for k, v in out.items()}
        for k, v in out.items():
            self.out[k].copy_(v)
        _write_back(self.state, new, held)

    def _check(self, key) -> None:
        """After a sanitized call: the key's verdicts read once; raise on
        the first violated law."""
        laws = self._laws[key]
        if not laws:
            return
        got = self._verdicts[key].tolist()
        self.verdict_reads += 1
        self.laws_checked += len(got)
        INV.raise_first(got, laws)

    def __call__(self, params, state, reqs: RequestBatch):
        tr = self.tracer
        if tr is not None:
            tr.open("static_tick.gate")
        live = self.eng.arrivals(reqs)      # decided on the host
        R = None if live is None else reqs.req_id.shape[0]
        if tr is not None:
            tr.next("static_tick.adopt")
        self._adopt(state)
        if R is not None:
            if tr is not None:
                tr.next("static_tick.draws")
            self._draw(R)
            if tr is not None:
                tr.next("static_tick.stage")
            self._stage(reqs, R)
        key = (R, live, id(params))
        # the weights' planes, made or refreshed before any capture, live
        # as long as the program that reads them
        planed = self.eng.serving_params(params)
        if tr is not None:
            tr.next("static_tick.capture" if self.graphs.cuda
                    and key not in self.graphs else "static_tick.replay")
        self.graphs.run(key, lambda: self._body(params, R, live, key),
                        keep=(params, planed))
        if tr is not None and self.graphs.cuda:
            tr.count("static_tick.dense_x9",
                     self.graphs.launches(key).get("dense_x9", 0))
        if self.sanitize:
            if tr is not None:
                tr.next("static_tick.verdict")
            self._check(key)
        if tr is not None:
            tr.close()
        return self.state, self.out


class StaticDecode:
    """A sidecar's decode launch on static buffers: host tokens and
    lengths copied in, one program a KV cache (one per instance for
    Istio, one for Cilium's I x C lanes; all sharing one pool), the argmax
    copied back."""

    def __init__(self, cfg, device: torch.device):
        self.cfg = cfg
        self.device = device
        self.graphs = Graphs(device)
        self._bufs: dict = {}       # id(cache) -> (tokens, lengths, nxt)

    def __call__(self, params, tokens: np.ndarray, lengths: np.ndarray,
                 cache) -> np.ndarray:
        key = id(cache)
        if key not in self._bufs:
            B = tokens.shape[0]
            z = lambda *s: torch.zeros(s, dtype=torch.int32,  # noqa: E731
                                       device=self.device)
            self._bufs[key] = (z(B, 1), z(B), z(B), cache)
        tok, lens, nxt, _ = self._bufs[key]
        tok.copy_(torch.from_numpy(np.ascontiguousarray(tokens, np.int32)
                                   ).reshape(-1, 1))
        lens.copy_(torch.from_numpy(np.ascontiguousarray(lengths, np.int32)))

        def body():
            logits, _ = M.decode_step(self.cfg, params, tok, lens, cache)
            nxt.copy_(torch.argmax(logits, dim=-1))

        self.graphs.run((key, id(params)), body, keep=(params, cache))
        return nxt.to("cpu", copy=True).numpy()    # not the static buffer


class StaticTrainStep:
    """``train_loop.make_train_step``'s step on static buffers, the
    reference's ``jax.jit(step_fn, donate_argnums=(0, 1, 2))``: called as
    the step is, ``(params, opt_state, router_bias, batch)`` → (params,
    opt_state, router_bias, metrics).

    The training state lives in persistent tensors.  The first call takes
    the parameters and AdamW's moments as it is handed them (the step
    updates them in place) and clones the step counter and the router
    bias, which the step returns as new tensors and the body copies back
    into the static ones.  A state it did not produce (a checkpoint's
    restore, a fresh init after a failure) is copied in leaf by leaf,
    only the leaves that are not the static tensors themselves; shapes
    and dtypes must stay.  The batch, a dict of host arrays or tensors,
    is copied into static buffers (a host batch through pinned staging
    buffers, its copies queued on the stream).  One program a batch
    layout (its keys, shapes and dtypes; the microbatch count is the
    step's own).  The state and the metrics (``loss``, ``grad_norm``,
    ``lr``, ``overflow``: static 0-d tensors) it returns are overwritten
    by the next step."""

    def __init__(self, step_fn: Callable, device: torch.device):
        self.step_fn = step_fn
        self.device = device
        self.graphs = Graphs(device)
        self.state = None           # (params, AdamWState, router bias)
        self.metrics = None
        self.copied_in = 0          # leaves copied in from foreign states
        self._batches: dict = {}    # layout -> (static batch, pinned)
        self._staged = None         # event: the last staging copy is done

    def _adopt(self, params, opt_state, router_bias) -> None:
        if self.state is None:
            self.state = (params,
                          opt_state._replace(step=opt_state.step.clone()),
                          router_bias.clone())
        else:
            self.copied_in += _copy_in(
                self.state, (params, opt_state, router_bias),
                "training state")

    def _load(self, batch: dict) -> tuple:
        """The batch into its layout's static buffers; the layout."""
        src = {k: v if isinstance(v, torch.Tensor)
               else torch.from_numpy(np.ascontiguousarray(v))
               for k, v in batch.items()}
        layout = tuple((k, tuple(t.shape), t.dtype) for k, t in src.items())
        if layout not in self._batches:
            empty = lambda t, **kw: torch.empty(  # noqa: E731
                t.shape, dtype=t.dtype, **kw)
            self._batches[layout] = (
                {k: empty(t, device=self.device) for k, t in src.items()},
                {k: empty(t, pin_memory=True) for k, t in src.items()}
                if self.device.type == "cuda" else None)
        static, pinned = self._batches[layout]
        host = [k for k, t in src.items() if t.device != self.device]
        if pinned is None or not host:
            for k, t in src.items():
                static[k].copy_(t)
            return layout
        # host arrays through the pinned buffers, refilled only once their
        # last copies ran
        if self._staged is None:
            self._staged = torch.cuda.Event()
        self._staged.synchronize()
        for k, t in src.items():
            if k in host:
                pinned[k].copy_(t)
                static[k].copy_(pinned[k], non_blocking=True)
            else:
                static[k].copy_(t)
        self._staged.record()
        return layout

    def _body(self, layout) -> None:
        *new, metrics = self.step_fn(*self.state, self._batches[layout][0])
        if self.metrics is None:
            self.metrics = {k: torch.empty_like(v) for k, v in
                            metrics.items()}
        for k, v in metrics.items():
            self.metrics[k].copy_(v)
        with torch.no_grad():
            _write_back(self.state, tuple(new))

    def __call__(self, params, opt_state, router_bias, batch: dict):
        self._adopt(params, opt_state, router_bias)
        layout = self._load(batch)
        self.graphs.run(layout, lambda: self._body(layout))
        return (*self.state, self.metrics)


class StaticModelDecode:
    """The model launcher's greedy decode on static buffers, the
    reference's ``jax.jit(build_decode_step(...), donate_argnums=(1,))``.
    A KV cache has static logits (B, Vp) f32, a token (B, 1) and lengths
    (B,) int32, set by ``load``; ``step`` is the argmax of the logits into
    the token, ``model.decode_step`` on it (the cache written in place),
    its logits written back and the lengths advanced by one, and returns
    the token buffer (overwritten by the next step).  One program a
    (cache, params) pair."""

    def __init__(self, cfg, device: torch.device):
        self.cfg = cfg
        self.device = device
        self.graphs = Graphs(device)
        self._bufs: dict = {}       # id(cache) -> (logits, token, lengths)

    def load(self, cache, logits: torch.Tensor, lengths) -> None:
        """The logits to take the next token from and the position each
        sequence writes at next, into ``cache``'s static buffers."""
        key = id(cache)
        if key not in self._bufs:
            B = logits.shape[0]
            i32 = dict(dtype=torch.int32, device=self.device)
            self._bufs[key] = (torch.empty_like(logits),
                               torch.zeros((B, 1), **i32),
                               torch.zeros((B,), **i32))
        mine, _, lens = self._bufs[key]
        _same_layout(mine, logits, "logits")
        mine.copy_(logits)
        lens.copy_(torch.as_tensor(lengths))

    def logits(self, cache) -> torch.Tensor:
        return self._bufs[id(cache)][0]

    def step(self, params, cache) -> torch.Tensor:
        logits, tok, lengths = self._bufs[id(cache)]

        def body():
            tok.copy_(torch.argmax(logits, dim=-1, keepdim=True))
            new, _ = M.decode_step(self.cfg, params, tok, lengths, cache)
            logits.copy_(new)
            lengths.add_(1)

        self.graphs.run((id(cache), id(params)), body, keep=(params, cache))
        return tok

"""One run of one cell: the program under test built from the cell's
configuration, driven by its traffic for a timed window, then judged
against the plain reference.

The entry the window drives is ``repro_torch``'s served path as a user
deploys it: ``runtime/serve_loop.py::ServeLoop.tick`` over a
``core/interpose.py::Engine`` whose ``make_jitted`` tick is the captured
``runtime/graphs.py::StaticTick``.  The benchmark builds the routing
tables from the configuration file through the program's control-plane
builder, makes the weights and the policy draws from the seed
(``seeded.py``), hands each call to ``ServeLoop.submit`` and reads what
the program shows a user: each request's stamps and tokens, the tick's
one download, and after the window its state.

Spans come only from this file's wrappers around the calls into each
layer (``ServeLoop._next_admission``, ``ServeLoop.serve_step``, the
download, ``ServeLoop.tick`` and the traffic generator); with ``--trace
1`` a steady slice of the window also runs under ``torch.profiler``.
"""

from __future__ import annotations

import array
import collections
import contextlib
import gc
import time
import types

import numpy as np
import torch

from xlbench import deploy, seeded
from xlbench.traffic.generator import Traffic

#: seconds of the window the profiler watches in a traced run
PROFILE_S = 0.3
#: least ticks of a profiled slice, and slices tried where the profiler
#: saw fewer launches than the program counted
PROFILE_MIN_TICKS, PROFILE_TRIES = 20, 3
#: the program's launch counters and the profiler's names of their kernels
KERNELS = {"admit_commit": ("admit_kernel",),
           "complete": ("complete_kernel",),
           "decode_attention": ("decode_kernel",)}


def program():
    """The modules of the program under test (imported only when a run
    starts)."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.core import routing_table as RT
    from repro_torch.core.interpose import Engine
    from repro_torch.kernels import ops, tune
    from repro_torch.runtime.serve_loop import Request, ServeLoop
    return types.SimpleNamespace(ModelConfig=ModelConfig, RT=RT,
                                 Engine=Engine, ops=ops, tune=tune,
                                 Request=Request, ServeLoop=ServeLoop)


def model_config(P, m: dict):
    keys = ("name", "family", "n_layers", "d_model", "n_heads", "n_kv_heads",
            "d_ff", "vocab", "head_dim", "ffn_act", "rope_theta", "norm_eps",
            "dtype")
    return P.ModelConfig(**{k: m[k] for k in keys})


def program_routing(P, lay, device):
    """The configuration's routing tables, compiled by the program's
    control-plane builder, and the table sizes."""
    RT = P.RT
    services = [RT.ServiceConfig(s, [RT.Rule(col, value, lay.clusters[c].name)
                                     for col, value, c in lay.rules[i]])
                for i, s in enumerate(lay.services)]
    clusters = [RT.Cluster(c.name, list(c.endpoints),
                           policy=RT.POLICY_NAMES[c.policy],
                           weights=list(c.weights)) for c in lay.clusters]
    state, ids = RT.build_state(services, clusters, device)
    if ids["services"] != lay.svc_id:
        raise RuntimeError(f"service ids {ids['services']} are not the "
                           f"file's order {lay.svc_id}")
    sizes = {"E": state.ep_load.shape[0], "S": state.svc_rule_start.shape[0],
             "CL": state.cluster_ep_count.shape[0],
             "A": state.aff_key.shape[0], "T": state.maglev_table.shape[1],
             "F": RT.N_FEATURES}
    return state, sizes


class Spans:
    """Host seconds by span name (``--trace 1`` only); inside the
    profiled slice the spans are profiler ranges instead."""

    def __init__(self):
        self.total = collections.Counter()
        self.profiling = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        if self.profiling:
            with torch.profiler.record_function(f"xlbench::{name}"):
                yield
            return
        t = time.perf_counter()
        try:
            yield
        finally:
            self.total[name] += time.perf_counter() - t


class Run:
    """One run: ``setup`` then ``window`` then ``collect``."""

    def __init__(self, cell: dict, cfg: dict, spec: dict, seed: int,
                 seconds: float, trace: bool, device="cuda",
                 t0: float | None = None):
        self.t0 = time.perf_counter() if t0 is None else t0
        self.cell, self.cfg, self.spec = cell, cfg, spec
        self.lay = deploy.layout(cfg)
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device = torch.device(device)
        self.P = P = program()
        self.m = self.cfg["model"]
        e, sl = self.cfg["engine"], self.cfg["serve_loop"]
        self.I, self.C = self.lay.lanes, e["slots"]
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        self.params = seeded.make_params(self.m, seed, self.device)
        routing, self.sizes = program_routing(P, self.lay, self.device)
        self.eng = P.Engine(model_config(P, self.m), self.I, self.C,
                            e["max_len"], eos=e["eos"], device=self.device)
        self.draws = seeded.Draws(seed, self.device)
        self.eng.draws = self.draws
        self.backoff_seed = seeded.subseed(seed, seeded.BACKOFF)
        self.loop = P.ServeLoop(
            self.eng, self.params, routing, admit_batch=sl["admit_batch"],
            dtype=torch.float32, max_retries=sl["max_retries"],
            backoff_base=sl["backoff_base"], backoff_cap=sl["backoff_cap"],
            backoff_seed=self.backoff_seed)
        self.tick_obj = self.loop.serve_step
        chk = self.spec["check"]
        self.grid_every = chk["grid_every"]
        self.grid_offset = int(seeded.rng(seed, seeded.SAMPLE)
                               .integers(0, self.grid_every))
        # what the check compares, recorded as the run goes
        self.batches: dict = {}          # tick -> rids of the batch, in order
        self.feats: dict = {}            # tick -> the batch's features
        self.grids: dict = {}            # tick -> (I*C,) ids that decoded
        self.active: list = []           # tick -> active slots after it
        # rid -> each call's service, headers, token and bytes as sent
        self.sent_svc, self.sent_token = array.array("q"), array.array("q")
        self.sent_bytes = array.array("q")
        self.sent_headers: list = []     # dicts of strings: never scanned
        self.requests: dict = {}         # rid -> the program's Request
        self.spans = Spans() if trace else None
        self.attempts = self.held = 0
        self.profile = None
        self.tick_ends: list = []        # host clock after each window tick
        # device ms of each tick's replay (CUDA events), in tick order
        self.replay_ms = array.array("d")
        self.gc_clock = GcClock()
        self.last_host = None
        self.last_taken: list = []
        self.traffic = Traffic(self.spec, seed, self.m["vocab"],
                               self.lay.svc_id, self.lay.lane_subset,
                               self._submit, seconds)
        self._instrument()

    # ------------------------------------------------------------------ #
    def _submit(self, rid, svc, headers, token, nbytes) -> None:
        r = self.P.Request(req_id=rid, service=svc, headers=headers,
                           prompt_token=token, msg_bytes=nbytes)
        self.sent_svc.append(svc)
        self.sent_headers.append(headers)
        self.sent_token.append(token)
        self.sent_bytes.append(nbytes)
        self.requests[rid] = r
        self.loop.submit(r)

    def sent(self, rid: int) -> tuple:
        """(service, headers, token, bytes) of call ``rid`` as sent."""
        return (self.sent_svc[rid], self.sent_headers[rid],
                self.sent_token[rid], self.sent_bytes[rid])

    def _instrument(self) -> None:
        """Wrap the loop's ingress and tick call: spans (traced), and the
        records the check compares; the tick's one download is made here
        and handed to the loop, which then copies nothing."""
        loop = self.loop
        ctx = self.spans if self.spans is not None else _nospan
        inner_next, inner_step = loop._next_admission, loop.serve_step
        n = self.I * self.C

        def next_admission():
            t = loop.ticks
            with ctx("ingress"):
                batch, taken = inner_next()
            k = len(taken)
            self.batches[t] = batch.req_id[:k].numpy().copy()
            if t % self.grid_every == self.grid_offset:
                self.feats[t] = batch.features[:k].numpy().copy()
            self.last_taken = taken
            return batch, taken

        def serve_step(params, state, reqs):
            with ctx("tick_call"):
                state, out = inner_step(params, state, reqs)
            with ctx("download"):
                host = out["packed"].cpu()
            h = host.numpy()
            t = loop.ticks
            self.active.append(int(h[3 * n]))
            if t % self.grid_every == self.grid_offset:
                self.grids[t] = h[2 * n:3 * n].copy()
            self.last_host = h
            out = dict(out)
            out["packed"] = host
            return state, out

        loop._next_admission = next_admission
        loop.serve_step = serve_step
        if self.device.type == "cuda":
            self._time_replays()

    def _time_replays(self) -> None:
        """CUDA events on the tick's stream around each call of the
        captured tick's one program (``Graphs.run``: a replay, after
        set-up); read after the tick's download, which has waited for
        both, so the reading adds no wait."""
        graphs = self.tick_obj.graphs
        inner_run, loop = graphs.run, self.loop
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        replay_ms = self.replay_ms

        def run(key, body, keep=()):
            a.record()
            inner_run(key, body, keep)
            b.record()

        inner_cpu = loop.serve_step

        def serve_step(params, state, reqs):
            out = inner_cpu(params, state, reqs)
            replay_ms.append(a.elapsed_time(b))
            return out

        graphs.run = run
        loop.serve_step = serve_step

    # ------------------------------------------------------------------ #
    def step(self) -> None:
        """One tick: the traffic due before it, the loop's tick, then the
        traffic's reaction to what finished."""
        loop, spans = self.loop, self.spans
        nd, nx = len(loop.done), len(loop.dropped)
        t = loop.ticks
        ctx = spans if spans is not None else _nospan
        with ctx("traffic"):
            self.traffic.before_tick(t, time.perf_counter())
        with ctx("loop_tick"):
            loop.tick()
        with ctx("traffic"):
            self._finish(t, loop.done[nd:], loop.dropped[nx:])
        if spans is not None and not spans.profiling:
            self.attempts += len(self.last_taken)
            self.held += sum(1 for r in self.last_taken
                             if r.req_id not in loop.inflight)

    def _finish(self, t, done, dropped) -> None:
        n, C = self.I * self.C, self.C
        ids = self.last_host[2 * n:3 * n]
        for r in done:
            lane = None
            if self.traffic.needs_lane(r.req_id):
                lane = int(np.flatnonzero(ids == r.req_id)[0]) // C
            self.traffic.finished(t, r.req_id, r.t_done, False, lane)
        for r in dropped:
            self.traffic.finished(t, r.req_id, r.t_done, True, None)

    def setup(self) -> None:
        """A tick with nothing submitted (the decode-only tick, captured
        on its first call), then the traffic until the cell is in its
        steady state (the arrival tick captured on its first call, the
        admission tile tuned)."""
        self.loop.tick()
        # what exists now (modules, weights, the program's state) stays
        # alive all run: out of the collector's scans, so that its full
        # collections cost the same from run to run; collected before the
        # traffic starts, so that no request waits on it
        gc.collect()
        gc.freeze()
        if self.spec["kind"] == "closed":
            while self.loop.ticks < self.spec["warmup_ticks"]:
                self.step()
        else:
            end = time.perf_counter() + self.spec["warmup_s"]
            while time.perf_counter() < end:
                self.step()
        self.sync()
        self.setup_s = time.perf_counter() - self.t0
        self.setup_ticks = self.loop.ticks

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def window(self) -> None:
        """The timed window: ticks until ``seconds`` have passed; traced,
        then a slice of about ``PROFILE_S`` seconds of ticks right after
        it under the profiler, so the profiler's cost falls outside the
        window's spans and counts."""
        if self.spans is not None:
            self.spans.total.clear()
        gc.callbacks.append(self.gc_clock)
        cpu0, pcpu0 = time.thread_time(), time.process_time()
        t0 = time.perf_counter()
        self.t_w0 = t0
        ends = self.tick_ends
        while time.perf_counter() - t0 < self.seconds:
            self.step()
            ends.append(time.perf_counter())
        self.sync()
        self.t_w1 = time.perf_counter()
        self.cpu_s = time.thread_time() - cpu0
        self.process_cpu_s = time.process_time() - pcpu0
        self.probe_ms = host_probe_ms()
        gc.callbacks.remove(self.gc_clock)
        self.window_ticks = self.loop.ticks - self.setup_ticks
        gc.unfreeze()
        if self.trace:
            per_tick = (self.t_w1 - t0) / max(self.window_ticks, 1)
            self._profile(max(PROFILE_MIN_TICKS, int(PROFILE_S / per_tick)))

    def _profile(self, ticks: int) -> None:
        """``ticks`` ticks under the profiler (host ranges and device
        activity); a slice in which the profiler saw fewer launches of a
        kernel than the program counted is taken again after it."""
        from torch.profiler import ProfilerActivity, profile
        ops = self.P.ops
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        with profile(activities=acts):      # the profiler's first-use cost
            self.step()
            self.sync()
        for attempt in range(PROFILE_TRIES):
            before = dict(ops.LAUNCHES)
            self.sync()
            first = self.loop.ticks
            self.spans.profiling = True
            t0 = time.perf_counter()
            with profile(activities=acts) as prof:
                for _ in range(ticks):
                    with torch.profiler.record_function("xlbench::tick"):
                        self.step()
                self.sync()
            wall = time.perf_counter() - t0
            self.spans.profiling = False
            counted = {k: ops.LAUNCHES[k] - before[k] for k in KERNELS}
            dev, host = events(prof)
            seen = {k: sum(1 for n, *_ in dev if any(s in n for s in keys))
                    for k, keys in KERNELS.items()}
            if all(seen[k] >= counted[k] for k in KERNELS):
                break
            print(f"xlbench: note: the profiler saw {seen} of the launches "
                  f"{counted} in slice {attempt + 1}", file=_stderr())
        self.profile = types.SimpleNamespace(
            ticks=(first, first + ticks), wall_s=wall, device=dev, host=host,
            counted=counted, seen=seen)

    # ------------------------------------------------------------------ #
    def collect(self) -> dict:
        """What the program showed, read after the window: its state on
        the host, each request's record, the tuned admission tile; then
        the program's device state is let go."""
        st = self.loop.state
        got = {}
        for part in ("pool", "routing", "metrics"):
            tup = getattr(st, part)
            for f in tup._fields:
                got[f"{part}.{f}"] = getattr(tup, f).cpu().numpy()
        R = self.cfg["serve_loop"]["admit_batch"]
        self.tile = self.P.tune.plan_admit(R, (self.I, self.C), commit=True,
                                           device=self.device)[0]
        self.graphs = len(self.tick_obj.graphs)
        self.graphs_setup_s = self.tick_obj.graphs.setup_s
        self.n_ticks = self.loop.ticks
        self.dropped = {r.req_id for r in self.loop.dropped}
        self.loop = self.eng = self.tick_obj = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return got


class GcClock:
    """The collector's passes in the window (a ``gc.callbacks`` entry):
    count, total and longest pause by generation."""

    def __init__(self):
        self.count = [0, 0, 0]
        self.total = [0.0, 0.0, 0.0]
        self.longest = [0.0, 0.0, 0.0]
        self.t = 0.0

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            self.t = time.perf_counter()
            return
        g, s = info["generation"], time.perf_counter() - self.t
        self.count[g] += 1
        self.total[g] += s
        self.longest[g] = max(self.longest[g], s)


def host_probe_ms(rounds: int = 3) -> float:
    """The host's speed at pure Python: the least ms of ``rounds`` runs of
    a fixed loop of dict and list work (read after the window, to set a
    run's tick times beside the speed of the host it ran on)."""
    best = float("inf")
    for _ in range(rounds):
        t = time.perf_counter()
        d, xs = {}, []
        for i in range(100_000):
            k = i & 1023
            d[k] = d.get(k, 0) + i
            xs.append(k)
        best = min(best, time.perf_counter() - t)
    return 1e3 * best


def release() -> None:
    """Let a finished run's device memory go before the next one in the
    same process (the sweep, the control)."""
    gc.unfreeze()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def events(prof) -> tuple[list, list]:
    """(device operations, benchmark host ranges) of a profile, each as
    (name, start s, end s) on the profiler's clock."""
    from torch.autograd import DeviceType
    dev, host = [], []
    for e in prof.events():
        rng = (e.time_range.start / 1e6, e.time_range.end / 1e6)
        if e.device_type == DeviceType.CUDA:
            if not e.name.startswith("xlbench::"):  # not a range's shadow
                dev.append((e.name, *rng))
        elif e.name.startswith("xlbench::"):
            host.append((e.name[len("xlbench::"):], *rng))
    return dev, host


def _nospan(name):
    return contextlib.nullcontext()


def _stderr():
    import sys
    return sys.stderr

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port of the XLB serving datapath on one
NVIDIA GPU: ``python3 chip_smoke.py`` from the root of a checkout.

Phases (each prints one line; any failure exits non-zero):

1. the card's name and power limit (nvidia-smi) and the kernel build;
2. each kernel, called through its public wrapper in ``kernels/ops.py``,
   against its plain PyTorch version on the same card tensors, bit-exact
   on every integer output and both f32 EWMAs: ``admit_commit`` and ``admit``
   over all six policies, drains, held rows and a ragged batch, at the
   serving shape and a small pool; ``complete`` with warm EWMAs;
   ``route_match`` at R = 256 and 4096; ``relay_slots`` at the staged
   chain's shapes, at N = 4096, at a ragged N and with 4096 rows on one
   destination; plus the decode model on
   the card against the CPU within rtol = atol = 1e-4;
3. the main path: ``ServeLoop`` over the port's ``Engine`` at the full
   width of ``xlb-service-model`` with 64 instance lanes x 16 slots (1024
   concurrent connections), admit batches of 256, ``max_len`` 32, one
   cluster per policy plus a 50-endpoint cluster, several thousand
   requests drained to completion and timed with CUDA events; then a
   separate pass under torch.profiler for the device's busy share;
4. the staged admission chain (match_cluster → select → allocate_slots →
   scatter_to_pool, through the route and relay kernels) on the card at
   the main path's shape, against the same chain on the CPU with the same
   draws, timed beside the fused admission kernel;
5. the same traffic through ``ServeLoop`` over the XLB engine and the
   Istio and Cilium sidecar baselines: requests/s, median tick and the
   device's busy share of each, in this one run; then the control plane:
   the serving routing built by the port's ``ControlPlane``, ``ServeLoop``
   attached to it on the card, and one transaction mid-drain (drain a
   loaded endpoint of productpage, remove one by swap-with-last, add one),
   with the version, the drained endpoint's admissions and reap, the
   loads and the splice on the card against the CPU checked, and the
   commit, the splice and the tick that carried it timed; then the
   fault-tolerant serving loop, each scenario run on the card and again
   on the CPU, where it must give the same result:
   - degraded: productpage over all 64 lanes, one lane 10x slow for 180
     ticks, the health daemon (``core/health.py``) epochs on the EWMAs the
     completion kernel keeps; the lane is ejected inside the fault, re-
     admitted after it, ends closed at weight 1 with no operator
     transaction, every request completes; the same eject and re-admit
     ticks, commit logs and bit-exact EWMAs on the CPU;
   - chaos: ``ServeLoop`` attached through a ``RemoteConsumer`` on a lossy
     channel with a partition, a crashed and restarted replica, the
     operator's canary / drain / set_weight / canary / undrain and a slow
     lane; the consumers converge, the replica resyncs once, every request
     completes; the same channel stats, histories and chaos row on the CPU;
   - sanitizer: the main path's traffic with ``XLB_SANITIZE=1`` (every
     admit and complete guard and the loop law on the card), no law fires
     and the state equals the plain run's; a planted off-by-one release
     must raise naming its law;
   then sharded admission and completion (``kernels/shard_admit.py``) at
   M = 1, 2 and 4 shards of one card: ``ops.admit_commit_sharded`` at the
   serving shape, a ragged batch and with an idle ingress host (a shard
   of padding rows, which launches nothing), ``ops.complete_sharded`` at
   the serving shape, each bit-exact against the unsharded wrapper on the
   same card tensors and against the CPU, with its call ms and the device
   ms of B3 (in its all-free mode) at width R/M, B4 and B1, and the F4
   shape (I_LANES lanes, R = 4096 over 4 shards: B3 at W = 1024, where a
   staged mask would not fit a block) bit-exact against the unsharded
   wrapper; then ENGINE_REQUESTS requests through ``ServeLoop`` over
   ``Engine(shards=4)``, equal to shards=1 on the card and to shards=4 on
   the CPU in every count, tick and routing bit, timed beside the
   unsharded drain, with the B1, B3 and B4 launches per tick; then the
   chained-service path (``workload/hops.py``, ``workload/chain.py``): a
   depth-3 chain of the full-width serving model (64 x 16 a hop, one
   least-request cluster, admit batch 256, 512 Poisson requests at the
   main path's rate) on istio, cilium and xlb, xlb with shards=2 and an
   xlb live-ops leg (the reference chain bench's canary and scale ops,
   weighted), each equal to its CPU run in every count and tick, every
   request complete and ``ep_load`` zero on every hop, xlb's p99 at most
   each sidecar's and shards=2 equal to the unsharded row;
6. the model stack at full width and depth in bf16, with weights from a
   CUDA generator: minitron-4b (prefill through ``flash_attention``,
   decode through ``decode_attention``) and mamba2-2.7b (prefill through
   ``ssd_scan``, recurrent decode), each prefilling 2 x 4096 tokens and
   decoding 32 greedy steps (prefill ms, ms per decode step, tokens/s,
   peak memory), with finite logits, and decode after a shorter prefill
   against the last logits of the full prefill: relative error < 1e-3 in
   f32 (the weights cast up), and in bf16 under a fixed limit per
   architecture that a planted decode fault must exceed;
7. the reduced (smoke) configs of minitron-4b and mamba2-2.7b (head dim
   16; mamba's state 16) through the launcher's ``main`` on the card, as a
   user runs ``prefill_decode --smoke``, with finite logits and every
   attention or SSD call through its kernel; then prefill and one decode
   step of each on the card against the CPU (f32, rtol = atol = 1e-4);
   then ``launch/serve.py --arch`` at full width for xlb-service-model,
   minitron-4b and mamba2-2.7b (every request served), and an arch not
   ported yet refused with ``NotImplementedError``;
8. the kernel launch counts: ``admit_commit``, ``complete`` and
   ``decode_attention`` on the main path (and in each serving phase after
   it), ``route_match``, ``relay_slots`` and ``admit`` in the staged
   phase, ``admit``, ``complete`` and ``route_match`` in the sharded
   drain (added to those), ``flash_attention``, ``decode_attention`` and
   ``ssd_scan`` in the model phases;
9. ``python -m repro_torch.analysis`` with its kernels section in a
   subprocess: under compute-sanitizer's memcheck and racecheck where
   the sanitizer can attach to the card, else against the kernels'
   bounds-checking build; it must exit 0.

Phase 2 also holds the float kernels against their plain versions at the
paths' shapes (decode attention at minitron-4b's and the serving model's,
flash attention at minitron-4b's prefill, the SSD scan at mamba2-2.7b's),
in the path's dtype (bf16: rtol 2e-2, atol 2e-2 x the output's RMS) and
in f32 at the same shapes (2e-5), and times each beside one PyTorch call
of the same function (``scaled_dot_product_attention``) where there is
one: with events (``library_ms``) and as the profiler's sum over the
kernels one call launches (``library_device_ms``, the clock of the
kernels' own ``ms``).  In bf16 flash attention runs on the tensor cores;
the model phase checks that minitron-4b's prefill ran that kernel.  The
SSD's bf16 build is four passes (``ssd_chunk_state``, ``ssd_scores``,
``ssd_state_pass``, ``ssd_chunk_scan``): its ``ms`` is their sum, each
pass's time is printed, and both mamba's shape and mamba2-2.7b's bf16
prefill must run exactly those four.  Decode attention is also held at
G = 48 query heads over one KV head (granite-20b's MQA), and the three
float kernels at the smoke configs' head dim 16 (and the SSD's N 16), in
f32 and bf16.  The admission and completion kernels' device times at
the serving shape, and the relay kernel's at each of its shapes, are
printed beside their times before their redesigns, with the bound and
the launch floor; the route kernel's ("route redesign:") at R = 256
and 4096 likewise.

Then one JSON line of per-kernel numbers, and as the last line
``{"ok": true, "device": {...}}``.  Needs one CUDA device; exits non-zero
without one, or without the port's sources beside this file.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out"
# H100 SXM data-sheet peaks: HBM3 bytes/s, non-tensor f32 operations/s,
# dense bf16 tensor-core operations/s
MEM_BPS = 3.35e12
OPS_PS = 67e12
BF16_OPS_PS = 989e12

I_LANES, SLOTS, ADMIT_R, MAX_LEN = 64, 16, 256, 32
N_REQUESTS, N_UNROUTABLE, ARRIVALS_PER_TICK = 4096, 64, 34
PROFILE_FROM, PROFILE_TICKS = 60, 20    # the separate profiled pass
# the engines phase: fewer requests, so that Istio's per-instance decode
# launches fit the time limit, and a short profiled pass of each engine
ENGINE_REQUESTS, ENGINE_WARM, ENGINE_PROFILE = 1024, 8, 4
TIE_GAP = 1e-5      # weighted picks may flip between devices below this
# the model phases: cuts of SHAPES prefill_32k (32 x 32768) and decode_32k
# (128 x 32768) to one card
LLM_BATCH, LLM_PROMPT, LLM_STEPS = 2, 4096, 32
# decode after a shorter prefill vs the full prefill, max |diff| / max |logit|:
# in f32 sound runs read 5.1e-6 (minitron-4b) and 1.4e-5 (mamba2-2.7b); in
# bf16 minitron-4b reads 1.7e-2 against tests/test_smoke_archs.py's 5e-2,
# and mamba2-2.7b 6.4e-2, as bf16 rounding grows over its 64 layers (its
# bf16 prefill alone is 5.5e-2 from the f32 one)
LLM_REL_TOL_F32 = 1e-3
LLM_REL_TOL_BF16 = {"minitron-4b": 5e-2, "mamba2-2.7b": 1e-1}
PLANT_KEYS = 256    # two key splits of csrc/decode_attention.cu
# the SSD's kernels (csrc/ssd_scan.cu) and the passes of its bf16 build
# with B and C shared by the heads, as mamba2-2.7b calls it
SSD_PREFIX = "ssd_"
SSD_BF16_PASSES = ("ssd_chunk_state", "ssd_scores", "ssd_state_pass",
                   "ssd_chunk_scan")
# the admission kernel before its redesign: device ms per call at the
# serving shape, commit and not (PERF.md §6, on an NVIDIA H100 80GB HBM3
# at 700 W)
ADMIT_BEFORE_MS = {"admit_commit": 0.0350, "admit": 0.0349}
# the completion and relay kernels before their redesign: device ms per
# call at the serving shape and at each relay shape (PERF.md §6, on an
# NVIDIA H100 80GB HBM3 at 700 W)
COMPLETE_BEFORE_MS = 0.00274
RELAY_BEFORE_MS = {(256, 65): 0.00337, (256, 513): 0.00345,
                   (4096, 65): 0.0383, (1000, 65): 0.0101, (4096, 1): 0.0382}
# the route kernel before its redesign: device ms per call at R = 256
# and 4096 (the R = 4096 time by tools/admit_timing.py; PERF.md §6), on
# an NVIDIA H100 80GB HBM3 at 700 W
ROUTE_BEFORE_MS = {256: 0.00415, 4096: 0.00436}
# the control phase: routable requests, the tick whose commit drains,
# removes and adds an endpoint of productpage, the instance lane added,
# and the calls over which the splice alone is timed
CONTROL_REQUESTS, CONTROL_COMMIT_TICK, CONTROL_ADD_LANE = 1024, 12, 5
SPLICE_REPS = 50
# relay_slots at the staged chain's shapes (select: CL + 1 = 65
# destinations, allocate_slots: I + 1 = 65, the affinity update: A + 1 =
# 513), a large batch, a ragged one, and every row of a large batch on one
# destination
RELAY_SHAPES = ((256, 65), (256, 513), (4096, 65), (1000, 65), (4096, 1))
# the launcher's reduced configs on the card: batch, prompt, decode steps
SMOKE_BATCH, SMOKE_PROMPT, SMOKE_STEPS = 2, 64, 4
# the degraded phase: arrivals a tick (about half of what the main path's
# ARRIVALS_PER_TICK saturate), ticks of arrivals, the fault window of the
# slow lane and its slowdown, ticks between health epochs.  An epoch is
# longer than one request (about MAX_LEN ticks): the half-open probe of a
# least-request cluster takes a burst of new connections, and an epoch
# that ends before they can complete reads the probe as sick (with 6-tick
# epochs it is ejected again one epoch after it opens, and never closes;
# the phase runs that schedule too and prints it)
DEG_ARRIVALS, DEG_TICKS, DEG_FAULT = 16, 396, (60, 240)
DEG_FACTOR, DEG_EPOCH, DEG_SHORT_EPOCH = 10, 36, 6
# the chaos phase: the reference chaos leg's seed and its 170 ticks of
# schedule, with its two tokens a request (max_len 3), so that its
# windows (healthy before tick 20, recovered from 110) hold completions
CHAOS_SEED, CHAOS_TICKS, CHAOS_MAX_LEN = 23, 170, 3
# the sanitizer phase: ticks of the main path's traffic, plain and sanitized
SAN_TICKS = 40
# the sharded phase: the mesh widths, the seed of its drains' draws
SHARDS, SHARD_SEED = (1, 2, 4), 11
# B3 in the sharded admission with the staged all-free mask, before its
# all-free mode: device ms per launch at width R/M = 256 / 128 / 64
# (PERF.md §5, on an NVIDIA H100 80GB HBM3 at 700 W); and F4's
# shape, where the staged mask passes the 227 KB a block may have: I_LANES
# lanes, R = 4096 over 4 shards (W = 1024)
B3_STAGED_MS = {1: 0.04199, 2: 0.02455, 4: 0.01464}
F4_R, F4_M = 4096, 4
# the chain phase: hops, requests, arrivals a tick (the main path's rate),
# decode steps a request holds a slot at each hop, the seed of the
# arrivals and of the engines' draws
CHAIN_DEPTH, CHAIN_REQUESTS, CHAIN_RATE, CHAIN_TOKENS = 3, 512, 34.0, 8
CHAIN_SEED = 11
# the archs serve --arch runs at full width
SERVE_ARCHS = ("xlb-service-model", "minitron-4b", "mamba2-2.7b")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


# --------------------------------------------------------------------------- #
# helpers
# --------------------------------------------------------------------------- #


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int = 50, warm: int = 5) -> float:
    """Mean device-timeline ms per call over ``reps`` back-to-back calls."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / reps


def device_events(torch, fn, counts: dict | None = None):
    """Run ``fn`` under torch.profiler (CUDA activity only) and return
    (wall us, {device event name: total us}); ``counts``, where given, is
    filled with the number of events of each name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e6
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) \
                + e.time_range.elapsed_us()
            if counts is not None:
                counts[e.name] = counts.get(e.name, 0) + 1
    return wall, by_name


def profile_calls(torch, fn, reps: int = 20) -> dict:
    """{device event name: ms per call} over ``reps`` calls of ``fn``
    (profiler), after one call outside the window.  A window in which a
    name shows no whole number of events per call (the profiler once lost
    about half of a library call's events on an H100) is taken again, up
    to 3 times; the last one is kept with a note on stderr."""
    fn()

    def run():
        for _ in range(reps):
            fn()

    for _ in range(3):
        counts: dict = {}
        _, by_name = device_events(torch, run, counts)
        if all(c % reps == 0 for c in counts.values()):
            break
    else:
        print(f"chip_smoke: note: events per call not whole in 3 profiler "
              f"windows of {reps} calls: {counts}", file=sys.stderr)
    return {n: us / 1e3 / reps for n, us in by_name.items()}


def kernel_time(prof: dict, key) -> tuple:
    """(ms per call of the kernels in ``prof`` whose name contains ``key``
    (a string or a tuple of them), or None where there is none; their
    short names, joined by " + ")."""
    keys = (key,) if isinstance(key, str) else key
    hit = {n: t for n, t in prof.items() if any(k in n for k in keys)}
    return (sum(hit.values()) or None,
            " + ".join(sorted(kernel_name(n) for n in hit)))


def kernel_ms(torch, fn, key, reps: int = 20):
    """Device ms per call of the kernels whose name contains ``key``
    (profiler), or None where the profiler sees none."""
    return kernel_time(profile_calls(torch, fn, reps), key)[0]


def library_device_ms(torch, fn, reps: int = 20) -> float:
    """Device ms per call of a library call: the sum over every kernel (and
    memset) one call launches (profiler), the clock of a kernel's ``ms``;
    ``library_ms`` times the same call with events, host gaps included."""
    return sum(profile_calls(torch, fn, reps).values())


def kernel_name(event: str) -> str:
    """A profiler kernel name without return type, namespaces and
    parameter list: ``flash_kernel_wgmma<128>``."""
    name = event.replace("(anonymous namespace)::", "").split("(", 1)[0]
    return name.removeprefix("void ").split("::")[-1]


def bound_ms(t: dict) -> tuple:
    """(the least ms the card could take for a kernel's work, the bytes'
    ms, the operations' ms) from its ``bytes``, ``ops`` and ``peak``."""
    t_bytes = t["bytes"] / MEM_BPS * 1e3
    t_ops = t["ops"] / t.get("peak", OPS_PS) * 1e3
    return max(t_bytes, t_ops), t_bytes, t_ops


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def max_abs_err(torch, pairs) -> float:
    """Fail unless every (name, got, want) pair is equal in dtype, shape
    and value; the largest absolute difference (0.0 when they agree)."""
    err = 0.0
    for n, a, b in pairs:
        if a.dtype != b.dtype or a.shape != b.shape:
            fail(f"field {n}: {a.dtype}{tuple(a.shape)} vs "
                 f"{b.dtype}{tuple(b.shape)}")
        if not torch.equal(a, b):
            fail(f"field {n} differs from the plain version")
        err = max(err, float((a.double() - b.double()).abs().max())
                  if a.numel() else 0.0)
    return err


def launch_floor(torch, lib, n: int = 2000):
    """The least device time of one launch on this card: (ms of one empty
    kernel as the profiler times it, the same clock as each kernel's
    ``ms``; ms between n back-to-back empty launches from one C loop,
    events-timed: the rate at which the host can issue them)."""
    st = torch.cuda.current_stream().cuda_stream

    def launch(k):
        check(lib.xlb_empty_launches(k, st) == 0,
              "empty kernel did not launch")

    prof = profile_calls(torch, lambda: launch(1), reps=200)
    device = kernel_time(prof, "empty_kernel")[0]
    check(device is not None, f"the profiler saw no empty kernel (it saw "
          f"{ {kernel_name(n): ms for n, ms in prof.items()} })")
    launch(10)
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    launch(n)
    e.record()
    e.synchronize()
    return device, s.elapsed_time(e) / n


def admit_work(torch, RT, PD, routing, rid, svc, feats, free, res, commit):
    """(bytes, operations) the admission kernel needs for this batch and
    its result: each input element it reads once, each output element
    written once.  Of the tables it reads only what the batch indexes
    (csrc/admit.cu): the drain bits of the windows of the clusters the
    rows resolve to, one Maglev entry per distinct (cluster, key) of the
    maglev and affinity rows, the eligible Gumbel lanes and weights of
    the weighted rows, and at most the whole rule chain of each service
    asked for (the walk stops at the first match)."""
    R, F = feats.shape
    S, E = routing.svc_rule_start.shape[0], routing.ep_load.shape[0]
    CL, A = routing.cluster_ep_count.shape[0], routing.aff_key.shape[0]
    T = routing.maglev_table.shape[1]
    I, C = free.shape
    WE = RT.MAX_EPS_PER_CLUSTER
    cc = routing.cluster_ep_count.long()
    cs = routing.cluster_ep_start.long()
    cl = res.cluster.long().clamp(0, CL - 1)     # every row reads a cluster
    pol = routing.cluster_policy.long()[cl]
    routable = res.endpoint != -1
    ok = res.ok > 0
    win = torch.arange(WE, device=cl.device)
    eidx = (cs[cl][:, None] + win).clamp(0, E - 1)
    eok = (win < cc[cl][:, None]) & (routing.ep_drained[eidx] == 0)
    wt = routable & (pol == RT.POLICY_WEIGHTED)
    ucl = cl.unique()
    sv = svc[rid >= 0].long().clamp(0, S - 1).unique()
    fkey = PD.flow_hash(feats).long()
    mrow = routable & ((pol == RT.POLICY_MAGLEV)
                       | (pol == RT.POLICY_AFFINITY))
    ints = (R * (2 + F)                                  # rid, svc, features
            + int((ok & (svc < S)).sum())                # msg_bytes
            + (int(ok.sum()) if commit else 0)           # prompt token
            + int((routable & (pol == RT.POLICY_RANDOM)).sum())   # rnd
            + 2 * len(sv)
            + 3 * int(routing.svc_rule_count.long()[sv]
                      .clamp(max=RT.MAX_RULES_PER_SVC).sum())
            + 2 * CL + 2 * len(ucl)                      # cc, cursors; cs, cp
            + int(cc[ucl].clamp(max=WE).sum())           # drain bits
            + int(res.endpoint[routable].clamp_min(0).unique().numel())
            + E + 2 * A                                  # ep_load, aff cache
            + int((cl[mrow] * T + fkey[mrow] % T).unique().numel()))
    floats = int(eok[wt].sum()) + int(eidx[eok & wt[:, None]].unique()
                                      .numel())
    bytes_in = 4 * (ints + floats) + I * C + (5 * 4 * I * C if commit else 0)
    # integer operations: the hash, the rule walk, the in-tile ranks (a
    # warp match and up to 8 warp counts, twice), the k-th set bit (6
    # popcount steps), the Gumbel argmax of weighted rows, and per tile a
    # (load, lane) ranking of the 64 lanes of each least-request cluster
    # with rows in it
    lr = routable & (pol == RT.POLICY_LEAST_REQUEST)
    tiles = torch.arange(R, device=cl.device) // 256
    lr_tables = int((tiles[lr] * CL + cl[lr]).unique().numel())
    ops = (R * (2 * F + RT.MAX_RULES_PER_SVC + 2 * 9 + 6)
           + 2 * WE * int(wt.sum()) + 4 * WE * WE * lr_tables)
    return bytes_in + nbytes(*res), ops


def route_work(RT, routing, svc, feats, cluster):
    """(bytes, operations) the route kernel needs for this batch: svc and
    features of every row, the rule chain of each distinct service asked
    for (rs, rc and three ints per rule), the window of each distinct
    cluster matched (cs, cc and its loads), two outputs per row."""
    R, F = feats.shape
    S = routing.svc_rule_start.shape[0]
    CL = routing.cluster_ep_count.shape[0]
    sv = svc.long().clamp(0, S - 1).unique()
    chain = int(routing.svc_rule_count.long()[sv]
                .clamp(0, RT.MAX_RULES_PER_SVC).sum())
    ucl = cluster.long().clamp(0, CL - 1).unique()
    lanes = int(routing.cluster_ep_count.long()[ucl]
                .clamp(0, RT.MAX_EPS_PER_CLUSTER).sum())
    ints = R * (1 + F) + 2 * len(sv) + 3 * chain + 2 * len(ucl) + lanes
    return 4 * ints + 2 * 4 * R, \
        R * (RT.MAX_RULES_PER_SVC + 2 * RT.MAX_EPS_PER_CLUSTER)


def routing_config(RT, device):
    """``serving_config`` built into routing tables on ``device``:
    (RoutingState, name → id maps)."""
    return RT.build_state(*serving_config(RT), device)


def serving_config(RT):
    """One service per policy (8 endpoints each over lanes 8i..8i+7), a
    50-endpoint least-request cluster over lanes 14..63 (bookinfo's
    productpage), and a service whose only rule no request matches:
    (services, clusters)."""
    services, clusters = [], []
    for p in range(6):
        services.append(RT.ServiceConfig(
            f"svc{p}", [RT.Rule(0, f"/api/{p}", f"pol{p}"),
                        RT.Rule(1, None, f"pol{p}")]))
        clusters.append(RT.Cluster(
            f"pol{p}", [8 * p + k for k in range(8)], policy=p,
            weights=[1.0 + k for k in range(8)]))
    services.append(RT.ServiceConfig("productpage",
                                     [RT.Rule(0, None, "productpage")]))
    clusters.append(RT.Cluster("productpage", list(range(14, 64)),
                               policy=RT.POLICY_LEAST_REQUEST))
    services.append(RT.ServiceConfig("closed",
                                     [RT.Rule(0, "/never", "pol0")]))
    return services, clusters


# --------------------------------------------------------------------------- #
# phase 2: kernels against their plain versions on the card
# --------------------------------------------------------------------------- #


def admit_inputs(torch, RT, routing, R, I, C, seed, dev):
    g = torch.Generator().manual_seed(seed)
    S = 8
    svc = torch.randint(0, S, (R,), generator=g, dtype=torch.int32)
    feats = torch.randint(0, 1 << 20, (R, RT.N_FEATURES), generator=g,
                          dtype=torch.int32)
    hit = torch.rand(R, generator=g) < 0.5
    feats[:, 0] = torch.where(
        hit, torch.tensor([RT.fnv1a(f"/api/{p}") for p in range(8)],
                          dtype=torch.int32)[svc % 8], feats[:, 0])
    dup = torch.rand(R, generator=g) < 0.25         # repeated flows
    src = (torch.rand(R, generator=g) * torch.arange(R)).long()
    feats[dup] = feats[src[dup]]
    svc[dup] = svc[src[dup]]
    svc[torch.rand(R, generator=g) < 0.03] = 70     # rogue ids
    rid = torch.where(torch.rand(R, generator=g) < 0.9,
                      torch.arange(R, dtype=torch.int32), -1)
    act = torch.rand((I, C), generator=g) < 0.5
    pool = [torch.where(act, torch.randint(1000, 9000, (I, C), generator=g),
                        -1).int(),
            torch.where(act, torch.randint(0, 100, (I, C), generator=g),
                        -1).int(),
            torch.randint(0, S, (I, C), generator=g, dtype=torch.int32),
            torch.randint(0, MAX_LEN - 2, (I, C), generator=g,
                          dtype=torch.int32),
            torch.randint(0, 500, (I, C), generator=g, dtype=torch.int32),
            act]
    reqs = [rid, svc, feats,
            torch.randint(0, 500, (R,), generator=g, dtype=torch.int32),
            torch.randint(1, 900, (R,), generator=g, dtype=torch.int32)]
    rnd = torch.randint(0, 1 << 30, (R,), generator=g, dtype=torch.int32)
    gum = -torch.log(-torch.log(torch.rand((R, 64), generator=g)
                                .clamp_min(1e-30)))
    loads = torch.randint(0, 6, routing.ep_load.shape, generator=g,
                          dtype=torch.int32)
    drained = torch.zeros_like(routing.ep_drained)
    drained[[1, 17, 33]] = 1                        # rr, lr, maglev lanes
    routing = routing._replace(ep_load=loads, ep_drained=drained).to(dev)
    to = lambda xs: [x.to(dev) for x in xs]
    return (routing, to(reqs), to(pool), rnd.to(dev), gum.to(dev))


def complete_inputs(torch, RT, dev):
    """Completion at the serving shape (I_LANES x SLOTS cells, the routing
    config's E and S), from a seed: ~80 % active cells, ~25 % of them at
    EOS, some endpoints and services out of range, warm EWMAs.  The
    eleven arguments of ``completion.complete`` on ``dev``."""
    g = torch.Generator().manual_seed(7)
    I, C, E, S = I_LANES, SLOTS, RT.MAX_ENDPOINTS, RT.MAX_SERVICES
    act = torch.rand((I, C), generator=g) < 0.8
    pool = [torch.where(act, torch.randint(0, 9999, (I, C), generator=g),
                        -1).int(),
            torch.randint(-2, E + 3, (I, C), generator=g, dtype=torch.int32),
            torch.randint(-1, S + 2, (I, C), generator=g, dtype=torch.int32),
            torch.randint(0, MAX_LEN - 1, (I, C), generator=g,
                          dtype=torch.int32),
            torch.randint(0, 500, (I, C), generator=g, dtype=torch.int32),
            act]
    nxt = torch.where(torch.rand((I, C), generator=g) < 0.25, 1,
                      torch.randint(2, 500, (I, C), generator=g)).int()
    load = torch.randint(3, 9, (E,), generator=g, dtype=torch.int32)
    rx = torch.randint(0, 100, (S,), generator=g, dtype=torch.int32)
    ewl = torch.rand(E, generator=g) * 6
    ewt = torch.rand(E, generator=g) * 2
    return [t.to(dev) for t in (*pool, nxt, load, rx, ewl, ewt)]


def relay_inputs(torch, N, nd, dev):
    """N relay rows from a seed: destinations uniform over [0, nd] with nd
    the sentinel (about one row in nd + 1), except that with one
    destination every row goes to it."""
    if nd == 1:
        return torch.zeros((N,), dtype=torch.int32, device=dev)
    g = torch.Generator().manual_seed(N + nd)
    return torch.randint(0, nd + 1, (N,), generator=g,
                         dtype=torch.int32).to(dev)


def phase_kernels(torch, RT, PD, ops, rm, rs, cp, B, lib, dev="cuda"):
    """Each kernel through its public wrapper in ``kernels/ops.py`` against
    its plain PyTorch version on the same card tensors, bit-exact."""
    dev = torch.device(dev)
    routing0, _ = routing_config(RT, "cpu")
    rows, timing = [], {}
    cases = [("serving", ADMIT_R, I_LANES, SLOTS), ("ragged", 300, 8, 4)]
    for label, R, I, C in cases:
        routing, reqs, pool, rnd, gum = admit_inputs(
            torch, RT, routing0, R, I, C, seed=R, dev=dev)
        rid, svc, feats, tok, msgb = reqs
        fields, act = pool[:5], pool[5]
        batch = B.RequestBatch(rid, svc, feats, tok, msgb)
        pstate = B.PoolState(*fields, act)
        commit = lambda: ops.admit_commit(batch, routing, pstate, rnd, gum)
        plain_c = lambda: rm.admit_commit(rid, svc, feats, msgb, tok,
                                          routing, *fields, act, rnd, gum)
        k, p = commit(), plain_c()
        torch.cuda.synchronize()
        err_c = max_abs_err(torch, [
            *zip(rm.AdmitResult._fields, k[:13], p[:13]),
            *zip(B.PoolState._fields, k.pool, p[13:])])
        pol = routing.cluster_policy[k.cluster[k.cluster >= 0].long()]
        check(int(k.held) > 0 or label == "serving", f"{label}: no held rows")
        check(int(k.no_route) > 0, f"{label}: no NO_ROUTE rows")
        check(len(set(pol.tolist())) == 6, f"{label}: not every policy ran")
        free = (torch.rand((I, C), device=dev) < 0.6).int() * 2
        admit = lambda: ops.admit(batch, routing, free, rnd, gum)
        plain_a = lambda: rm.admit(rid, svc, feats, msgb, routing, free,
                                   rnd, gum)
        k2, p2 = admit(), plain_a()
        torch.cuda.synchronize()
        err_a = max_abs_err(torch, zip(rm.AdmitResult._fields, k2, p2))
        rows.append(f"admit_commit[{label} R={R} I={I} C={C}] "
                    f"max_abs_err={err_c} ok={int(k.ok.sum())} "
                    f"held={int(k.held)} no_route={int(k.no_route)}; "
                    f"admit max_abs_err={err_a}")
        if label == "serving":
            for name, call, plain, res, mask, c, err in (
                    ("admit_commit", commit, plain_c, p, act == 0, True,
                     err_c),
                    ("admit", admit, plain_a, p2, free, False, err_a)):
                nb, nops = admit_work(torch, RT, PD, routing, rid, svc,
                                      feats, mask, res, c)
                timing[name] = dict(
                    ms=kernel_ms(torch, call, "admit_kernel"),
                    call_ms=cuda_ms(torch, call),
                    plain_ms=cuda_ms(torch, plain, reps=5, warm=1),
                    bytes=nb, ops=nops, err=err)

    args = complete_inputs(torch, RT, dev)
    I, C = args[0].shape
    pstate = B.PoolState(*args[:6])
    call = lambda: ops.complete(pstate, *args[6:], eos=1, max_len=MAX_LEN)
    plain = lambda: cp.complete(*args, eos=1, max_len=MAX_LEN)
    k, p = call(), plain()
    torch.cuda.synchronize()
    err = max_abs_err(torch, [
        *zip(B.PoolState._fields, k.pool, p[:6]),
        *zip(("done", "ep_load", "rx_bytes", "done_cnt", "ep_inflight_ewma",
              "ep_tput_ewma"), k[1:], p[6:])])
    check(int(k.done.sum()) > 0, "complete: nothing finished")
    rows.append(f"complete[I={I} C={C}] max_abs_err={err} "
                f"done={int(k.done.sum())}")
    E = args[7].shape[0]
    timing["complete"] = dict(
        ms=kernel_ms(torch, call, "complete_kernel"),
        call_ms=cuda_ms(torch, call),
        plain_ms=cuda_ms(torch, plain),
        bytes=nbytes(*args) + nbytes(*p), ops=I * C * 12 + E * 8, err=err)
    # route_match at the serving batch and a large one, over routing
    # config's capacities with random loads
    for R in (ADMIT_R, 4096):
        routing, reqs, _, _, _ = admit_inputs(torch, RT, routing0, R, I_LANES,
                                              SLOTS, seed=R + 1, dev=dev)
        svc, feats = reqs[1], reqs[2]
        call = lambda: ops.route_match(svc, feats, routing)
        plain = lambda: rm.route_match(svc, feats, routing)
        k, p = call(), plain()
        torch.cuda.synchronize()
        err = max_abs_err(torch, zip(("cluster", "endpoint"), k, p))
        check(bool((k[0] < 0).any() and (k[1] >= 0).any()),
              f"route_match[R={R}]: no NO_ROUTE or no routed rows")
        rows.append(f"route_match[R={R}] max_abs_err={err} "
                    f"matched={int((k[0] >= 0).sum())}")
        nb, nops = route_work(RT, routing, svc, feats, k[0])
        timing["route_match" if R == ADMIT_R else f"route_match[R={R}]"] = \
            dict(ms=kernel_ms(torch, call, "route_kernel"),
                 call_ms=cuda_ms(torch, call),
                 plain_ms=cuda_ms(torch, plain, reps=10, warm=1),
                 bytes=nb, ops=nops, err=err)

    for N, nd in RELAY_SHAPES:
        idx = relay_inputs(torch, N, nd, dev)
        call = lambda: ops.relay_slots(idx, nd)
        plain = lambda: rs.relay_slots(idx, nd)
        k, p = call(), plain()
        torch.cuda.synchronize()
        err = max_abs_err(torch, zip(("slot", "load"), k, p))
        check(int(k[1].sum()) == int((idx < nd).sum()),
              f"relay_slots[N={N}]: loads do not add up")
        rows.append(f"relay_slots[N={N} n_dest={nd}] max_abs_err={err} "
                    f"sentinel rows={int((idx == nd).sum())}")
        key = ("relay_slots" if (N, nd) == (ADMIT_R, 65)
               else f"relay_slots[N={N},n_dest={nd}]")
        timing[key] = dict(ms=kernel_ms(torch, call, "relay_kernel"),
                           call_ms=cuda_ms(torch, call),
                           plain_ms=cuda_ms(torch, plain, reps=10, warm=1),
                           bytes=4 * (2 * N + nd), ops=2 * N + nd, err=err,
                           shape=(N, nd))

    floor, issue = launch_floor(torch, lib)
    for t in timing.values():
        t["floor_ms"], t["issue_ms"] = floor, issue
    return rows, timing


def phase_model(torch, cfg, TM):
    """The decode model on the card against the CPU (f32, no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    params = TM.init_params(cfg, torch.Generator().manual_seed(1),
                            torch.float32, "cpu")
    B, L = 16, 8
    g = torch.Generator().manual_seed(2)
    tok = torch.randint(0, cfg.vocab, (B, 1), generator=g, dtype=torch.int32)
    lengths = torch.randint(0, L - 1, (B,), generator=g, dtype=torch.int32)
    out = {}
    for dev in ("cpu", "cuda"):
        p = _to(torch, params, dev)
        cache = TM.init_cache(cfg, B, L, torch.float32, dev)
        logits, _ = TM.decode_step(cfg, p, tok.to(dev), lengths.to(dev),
                                   cache)
        out[dev] = logits.cpu()
    check(bool(torch.isfinite(out["cuda"]).all()), "decode: non-finite")
    torch.testing.assert_close(out["cuda"], out["cpu"], rtol=1e-4,
                               atol=1e-4)
    return float((out["cuda"] - out["cpu"]).abs().max())


def _to(torch, tree, dev):
    if isinstance(tree, dict):
        return {k: _to(torch, v, dev) for k, v in tree.items()}
    return tree.to(dev)


# --------------------------------------------------------------------------- #
# phase 2b: the float kernels against their plain versions on the card
# --------------------------------------------------------------------------- #


def float_err(torch, name, got, want) -> float:
    """Fail unless ``got`` is finite and within the dtype's tolerance of
    ``want``: f32 rtol = atol = 2e-5, bf16 rtol = 2e-2 (tests/test_kernels.py)
    with atol = 2e-2 x the RMS of ``want``, so that the bound follows
    outputs far below 1 (attention over n unit-variance values averages to
    an RMS of about sqrt(e / n), 0.026 at 4096 keys).  The largest absolute
    difference."""
    if got.dtype != want.dtype or got.shape != want.shape:
        fail(f"{name}: {got.dtype}{tuple(got.shape)} vs "
             f"{want.dtype}{tuple(want.shape)}")
    a, b = got.float(), want.float()
    check(bool(torch.isfinite(a).all()), f"{name}: non-finite output")
    rtol = atol = 2e-5
    if want.dtype == torch.bfloat16:
        rtol, atol = 2e-2, 2e-2 * float(b.square().mean().sqrt())
    if not torch.allclose(a, b, rtol=rtol, atol=atol):
        fail(f"{name}: differs from the plain version beyond rtol {rtol}, "
             f"atol {atol:.3g}: max abs err {float((a - b).abs().max())}")
    return float((a - b).abs().max())


def decode_inputs(torch, B, S, H, K, hd, dtype, lengths, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    rn = lambda *shape: torch.randn(shape, generator=g, device=dev,
                                    dtype=torch.float32).to(dtype)
    return (rn(B, H, hd), rn(B, S, K, hd), rn(B, S, K, hd),
            torch.as_tensor(lengths, dtype=torch.int32, device=dev))


def decode_work(q, kc, lengths):
    """(bytes, operations): q and the output, the lengths, and
    the keys and values at kpos <= lengths[b] each read once; 4 operations
    per (query head, valid key, dim)."""
    B, H, hd = q.shape
    S, K = kc.shape[1], kc.shape[2]
    valid = int(lengths.long().add(1).clamp(1, S).sum())
    e = q.element_size()
    return (2 * B * H * hd * e + 4 * B + 2 * valid * K * hd * e,
            4 * valid * H * hd)


def phase_float_kernels(torch, ops, da, fa, ssd, dev="cuda"):
    """Decode attention, flash attention and the SSD scan through
    ``kernels/ops.py`` against their plain versions on the same card
    tensors at the paths' shapes; device, call, plain and library times."""
    import torch.nn.functional as F
    dev = torch.device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False     # the f32 plain runs
    bf16, f32 = torch.bfloat16, torch.float32
    rows, timing = [], {}
    sdpa = F.scaled_dot_product_attention

    # B6 at minitron-4b's decode (the last of 32 steps after a 4096-token
    # prompt) and at the serving model's (1024 slots x max_len 32)
    g = torch.Generator().manual_seed(5)
    xlb_len = torch.randint(0, MAX_LEN - 1, (I_LANES * SLOTS,), generator=g)
    last = LLM_PROMPT + LLM_STEPS - 1
    for key, shape, dtype, lengths, peak in (
            ("decode_attention", (LLM_BATCH, LLM_PROMPT + LLM_STEPS, 24, 8,
                                  128), bf16, [last - 20, last],
             BF16_OPS_PS),
            ("decode_attention[xlb]", (I_LANES * SLOTS, MAX_LEN, 4, 2, 32),
             f32, xlb_len, OPS_PS)):
        B, S, H, K, hd = shape
        q, kc, vc, lens = decode_inputs(torch, *shape, dtype, lengths, dev,
                                        seed=S)
        call = lambda: ops.decode_attention(q, kc, vc, lens)
        plain = lambda: da.decode_attention(q, kc, vc, lens)
        err = float_err(torch, key, call(), plain())
        err32 = err if dtype == f32 else f32_err(
            torch, ops.decode_attention, da.decode_attention, key,
            q.float(), kc.float(), vc.float(), lens)
        mask = (torch.arange(S, device=dev)[None, :]
                <= lens[:, None].long())[:, None, None, :]
        q4, k4, v4 = q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2)
        lib = lambda: sdpa(q4, k4, v4, attn_mask=mask, enable_gqa=True)
        lib_err = float((lib()[:, :, 0].float() - plain().float())
                        .abs().max())
        rows.append(f"{key}[B={B} S={S} H={H} K={K} hd={hd} {dtype}] "
                    f"max_abs_err={err}, in f32 {err32} (sdpa vs plain "
                    f"{lib_err:.3g})")
        nb, nops = decode_work(q, kc, lens)
        ms, names = kernel_time(profile_calls(torch, call), "decode_")
        timing[key] = dict(
            ms=ms, kernel=names,
            call_ms=cuda_ms(torch, call),
            plain_ms=cuda_ms(torch, plain, reps=10, warm=2),
            library_ms=cuda_ms(torch, lib, reps=20, warm=3),
            library_device_ms=library_device_ms(torch, lib),
            bytes=nb, ops=nops, peak=peak, err=err, err_f32=err32)

    # B6 at G = 48: 48 query heads over one KV head at hd 128 (granite-20b's
    # MQA), walked in passes of 4 heads (bf16) or 8 (f32)
    for dtype in (bf16, f32):
        shape = (LLM_BATCH, 2048, 48, 1, 128)
        q, kc, vc, lens = decode_inputs(torch, *shape, dtype, [1000, 2047],
                                        dev, seed=48)
        call = lambda: ops.decode_attention(q, kc, vc, lens)
        plain = lambda: da.decode_attention(q, kc, vc, lens)
        key = "decode_attention[G48]" + ("" if dtype == bf16 else "[f32]")
        err = float_err(torch, key, call(), plain())
        nb, nops = decode_work(q, kc, lens)
        ms, names = kernel_time(profile_calls(torch, call), "decode_")
        rows.append(f"{key}[B={shape[0]} S={shape[1]} H=48 K=1 hd=128 "
                    f"{dtype}] max_abs_err={err} ({names})")
        timing[key] = dict(
            ms=ms, kernel=names, call_ms=cuda_ms(torch, call),
            plain_ms=cuda_ms(torch, plain, reps=5, warm=1), bytes=nb,
            ops=nops, peak=BF16_OPS_PS if dtype == bf16 else OPS_PS,
            err=err)

    # head dim 16 (the smoke configs; the SSD at N 16 too), f32 and bf16:
    # B6, B7 and B8 at the smoke shapes, all three on their FMA kernels
    gs = torch.Generator(device=dev).manual_seed(16)
    rs = lambda *shape, dt, scale=1.0: (torch.randn(
        shape, generator=gs, device=dev) * scale).to(dt)
    for dtype in (f32, bf16):
        q, kc, vc, lens = decode_inputs(
            torch, SMOKE_BATCH, SMOKE_PROMPT + SMOKE_STEPS, 4, 2, 16, dtype,
            [20, SMOKE_PROMPT + SMOKE_STEPS - 1], dev, seed=16)
        e6 = float_err(torch, f"decode_attention[hd16 {dtype}]",
                       ops.decode_attention(q, kc, vc, lens),
                       da.decode_attention(q, kc, vc, lens))
        q = rs(SMOKE_BATCH, SMOKE_PROMPT, 4, 16, dt=dtype)
        k, v = (rs(SMOKE_BATCH, SMOKE_PROMPT, 2, 16, dt=dtype)
                for _ in range(2))
        e7 = float_err(torch, f"flash_attention[hd16 {dtype}]",
                       ops.flash_attention(q, k, v, causal=True),
                       fa.flash_attention(q, k, v, causal=True))
        x = rs(SMOKE_BATCH, SMOKE_PROMPT, 8, 16, dt=dtype, scale=0.5)
        a = -F.softplus(rs(SMOKE_BATCH, SMOKE_PROMPT, 8, dt=f32)) * 0.5
        Bm, Cm = (rs(SMOKE_BATCH, SMOKE_PROMPT, 1, 16, dt=dtype, scale=0.3)
                  .expand(-1, -1, 8, -1) for _ in range(2))
        (ky, kh), (py, ph) = ops.ssd_scan(x, a, Bm, Cm, chunk=32,
                                          return_state=True), \
            ssd.ssd_scan(x, a, Bm, Cm, 32)
        e8 = max(float_err(torch, f"ssd_scan[hd16 N16 {dtype}] y", ky, py),
                 float_err(torch, f"ssd_scan[hd16 N16 {dtype}] h_last", kh,
                           ph))
        rows.append(f"hd 16 [{dtype}]: decode_attention[B=2 S=68 H=4 K=2] "
                    f"max_abs_err={e6}, flash_attention[B=2 S=64 H=4 K=2] "
                    f"{e7}, ssd_scan[B=2 S=64 nh=8 N=16] {e8}")

    # B7 at minitron-4b's prefill
    B, S, H, K, hd = LLM_BATCH, LLM_PROMPT, 24, 8, 128
    gd = torch.Generator(device=dev).manual_seed(7)
    rn = lambda *shape: torch.randn(shape, generator=gd, device=dev).to(bf16)
    q, k, v = rn(B, S, H, hd), rn(B, S, K, hd), rn(B, S, K, hd)
    call = lambda: ops.flash_attention(q, k, v, causal=True)
    plain = lambda: fa.flash_attention(q, k, v, causal=True)
    err = float_err(torch, "flash_attention", call(), plain())
    err32 = f32_err(torch, lambda *t: ops.flash_attention(*t, causal=True),
                    lambda *t: fa.flash_attention(*t, causal=True),
                    "flash_attention", q.float(), k.float(), v.float())
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib = lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)
    lib_err = float((lib().transpose(1, 2).float() - plain().float())
                    .abs().max())
    rows.append(f"flash_attention[B={B} S={S} H={H} K={K} hd={hd} causal "
                f"bf16] max_abs_err={err}, in f32 {err32} (sdpa vs plain "
                f"{lib_err:.3g})")
    ms, names = kernel_time(profile_calls(torch, call, reps=5),
                            "flash_kernel")
    timing["flash_attention"] = dict(
        ms=ms, kernel=names,
        call_ms=cuda_ms(torch, call, reps=5, warm=1),
        plain_ms=cuda_ms(torch, plain, reps=3, warm=1),
        library_ms=cuda_ms(torch, lib, reps=10, warm=2),
        library_device_ms=library_device_ms(torch, lib, reps=5),
        bytes=nbytes(q, k, v, q),                 # q, k, v in; out
        ops=4 * B * H * hd * S * (S + 1) // 2, peak=BF16_OPS_PS, err=err,
        err_f32=err32)

    # B8 at mamba2-2.7b's prefill: 80 heads of hd 64, N 128, one group
    # broadcast over the heads (stride 0), chunk 256
    B, S, nh, hd, N = LLM_BATCH, LLM_PROMPT, 80, 64, 128
    Q = min(256, S)
    x = (torch.randn((B, S, nh, hd), generator=gd, device=dev) * 0.5).to(bf16)
    a = -F.softplus(torch.randn((B, S, nh), generator=gd, device=dev)) * 0.5
    Bg = (torch.randn((B, S, 1, N), generator=gd, device=dev) * 0.3).to(bf16)
    Cg = (torch.randn((B, S, 1, N), generator=gd, device=dev) * 0.3).to(bf16)
    Bm, Cm = Bg.expand(-1, -1, nh, -1), Cg.expand(-1, -1, nh, -1)
    call = lambda: ops.ssd_scan(x, a, Bm, Cm, chunk=Q, return_state=True)
    plain = lambda: ssd.ssd_scan(x, a, Bm, Cm, Q)
    (ky, kh), (py, ph) = call(), plain()
    err = max(float_err(torch, "ssd_scan y", ky, py),
              float_err(torch, "ssd_scan h_last", kh, ph))
    err32 = f32_err(
        torch, lambda *t: ops.ssd_scan(*t, chunk=Q, return_state=True),
        lambda *t: ssd.ssd_scan(*t, Q), "ssd_scan", x.float(), a,
        Bg.float().expand(-1, -1, nh, -1), Cg.float().expand(-1, -1, nh, -1))
    rows.append(f"ssd_scan[B={B} S={S} nh={nh} hd={hd} N={N} chunk={Q} "
                f"bf16] max_abs_err={err}, in f32 {err32} (y and h_last)")
    # every kernel one call launches (the passes share the prefix "ssd_")
    prof = profile_calls(torch, call, reps=5)
    ms, names = kernel_time(prof, SSD_PREFIX)
    passes = ssd_passes(prof)
    rows.append("ssd_scan passes (device ms per call): " + ", ".join(
        f"{n} {t}" for n, t in passes.items()))
    # the function's work in the 64-row chunked form, whatever chunk the
    # kernels use: per (sequence, head) and 64 rows, the masked scores and
    # G x over the causal half, C h^T and the state update
    T = 64
    tiles = -(-S // T)
    timing["ssd_scan"] = dict(
        ms=ms, kernel=names, passes=passes,
        call_ms=cuda_ms(torch, call, reps=5, warm=1),
        plain_ms=cuda_ms(torch, plain, reps=3, warm=1), library_ms=None,
        bytes=nbytes(x, a, Bg, Cg, ky, kh),
        ops=B * nh * tiles * 2 * (T * (T + 1) // 2 * (N + hd)
                                   + 2 * T * N * hd),
        peak=BF16_OPS_PS, err=err, err_f32=err32)
    return rows, timing


def ssd_passes(prof: dict) -> dict:
    """{kernel name: ms} of the SSD's kernels in ``prof``, in pass order;
    fails unless they are the four passes of the bf16 build."""
    passes = {kernel_name(n): t for n, t in prof.items() if SSD_PREFIX in n}
    base = lambda n: n.split("<", 1)[0]
    check(sorted(map(base, passes)) == sorted(SSD_BF16_PASSES),
          f"ssd_scan ran {sorted(passes)}, not the passes {SSD_BF16_PASSES}")
    return dict(sorted(passes.items(),
                       key=lambda kv: SSD_BF16_PASSES.index(base(kv[0]))))


def f32_err(torch, call, plain, name, *inputs) -> float:
    """The f32 build of a kernel against its plain version on f32
    ``inputs`` within 2e-5: the path's shape gated without bf16's
    rounding."""
    got, want = call(*inputs), plain(*inputs)
    pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
    err = max(float_err(torch, f"{name} f32", a, b) for a, b in pairs)
    del got, want
    torch.cuda.empty_cache()
    return err


# --------------------------------------------------------------------------- #
# phase 6: the model stack at full width on the card
# --------------------------------------------------------------------------- #


def phase_llm(torch, ops, TM, launcher, cfg, dev="cuda"):
    """Build ``cfg`` at full width and depth in bf16 (weights from a CUDA
    generator), prefill LLM_BATCH x LLM_PROMPT tokens and decode LLM_STEPS
    greedy steps through the launcher's ``run``; check the path's kernel
    launches, finite logits, and decode after a shorter prefill against
    the last logits of the full prefill."""
    dev = torch.device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False     # the f32 check
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = TM.init_params(cfg, gen, None, dev)
    tokens = torch.randint(0, cfg.vocab, (LLM_BATCH, LLM_PROMPT),
                           generator=gen, device=dev, dtype=torch.int32)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    launcher.run(cfg, params, tokens[:, :256], 2)   # warm-up (cuBLAS)
    for k in ops.LAUNCHES:
        ops.LAUNCHES[k] = 0
    res = launcher.run(cfg, params, tokens, LLM_STEPS)
    launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    L = cfg.n_layers
    want = ({"ssd_scan": L} if cfg.family == "ssm" else
            {"flash_attention": L, "decode_attention": L * LLM_STEPS})
    check(launches == want, f"{cfg.name}: kernel launches {launches}, "
          f"expected {want}")
    # which kernels a bf16 prefill runs, and their share of its device
    # time: one more prefill under the profiler (apart from the timed run)
    _, by_name = device_events(torch, lambda: TM.prefill(
        cfg, params, tokens, TM.init_cache(cfg, LLM_BATCH, LLM_PROMPT,
                                           params["embed"].dtype, dev)))
    if cfg.attn_free:
        kernels = " + ".join(ssd_passes(by_name))
        kernel_us = kernel_time(by_name, SSD_PREFIX)[0]
    else:
        kernel_us, kernels = kernel_time(by_name, "flash_kernel")
        check(kernels == "flash_kernel_wgmma<128>", f"{cfg.name}: the bf16 "
              f"prefill ran {kernels!r}, not the tensor-core kernel")
    busy_ms = sum(by_name.values()) / 1e3
    check(bool(torch.isfinite(res["logits"]).all()),
          f"{cfg.name}: non-finite decode logits")
    peak = torch.cuda.max_memory_allocated(dev)    # init, prefill, decode

    # consistency, as tests/test_smoke_archs.py checks it (in f32): the
    # full prefill's last logits against a shorter prefill plus
    # teacher-forced decode of the rest (mamba: a prefill that is a
    # multiple of the 256-row chunk, as ssd_chunked asserts)
    split = LLM_PROMPT - (cfg.ssm.chunk if cfg.family == "ssm" else 1)
    f16_full, f16_dec = consistency(torch, TM, ops, cfg, params, tokens,
                                    split)
    _, bad_dec = consistency(torch, TM, ops, cfg, params, tokens, split,
                             plant=True)
    p32 = _tree(params, lambda t: t.float())
    f32_full, f32_dec = consistency(torch, TM, ops, cfg, p32, tokens, split)
    del p32
    for name, t in (("bf16 prefill", f16_full), ("bf16 decode", f16_dec),
                    ("f32 prefill", f32_full), ("f32 decode", f32_dec)):
        check(bool(torch.isfinite(t).all()), f"{cfg.name}: non-finite "
              f"{name} logits")
    rel32 = rel_err(f32_dec, f32_full)
    check(rel32 < LLM_REL_TOL_F32, f"{cfg.name}: f32 decode after a "
          f"{split}-token prefill vs the full prefill: rel {rel32:.3e} >= "
          f"{LLM_REL_TOL_F32}")
    tol16 = LLM_REL_TOL_BF16[cfg.name]
    rel16 = rel_err(f16_dec, f16_full)
    check(rel16 < tol16, f"{cfg.name}: bf16 decode after a {split}-token "
          f"prefill vs the full prefill: rel {rel16:.3e} >= {tol16}")
    planted = rel_err(bad_dec, f16_full)
    fault = (f"layer {cfg.n_layers // 2} skips its state update"
             if cfg.attn_free else
             f"decode attention drops the newest {PLANT_KEYS} keys")
    check(planted >= tol16, f"{cfg.name}: the bf16 gate does not see a "
          f"planted fault ({fault}): rel {planted:.3e} < {tol16}")
    floor16, dist16 = rel_err(f16_full, f32_full), rel_err(f16_dec, f32_full)
    per_step = res["decode_s"] / LLM_STEPS
    line = (f"model {cfg.name}: {n_params / 1e9:.3f} B parameters "
            f"({cfg.n_layers} layers, bf16), init {init_s:.2f} s; prefill "
            f"{LLM_BATCH} x {LLM_PROMPT} tokens {1e3 * res['prefill_s']:.3f}"
            f" ms ({LLM_BATCH * LLM_PROMPT / res['prefill_s']:.1f} tokens/s)"
            f"; {LLM_STEPS} decode steps {1e3 * per_step:.3f} ms per step "
            f"= {LLM_BATCH / per_step:.1f} tokens/s (host clock, "
            f"synchronised); peak memory {peak / 2**30:.2f} GiB; decode "
            f"after a {split}-token prefill vs the full prefill: rel "
            f"{rel32:.3e} in f32 (< {LLM_REL_TOL_F32}), {rel16:.3e} in "
            f"bf16 (< {tol16}), with a planted fault ({fault}) {planted:.3e}"
            f" (>= {tol16}); bf16 vs f32 logits: prefill {floor16:.3e}, "
            f"decode {dist16:.3e}; launches "
            + " ".join(f"{k}={v}" for k, v in launches.items())
            + f"; profiled prefill: device busy {busy_ms:.3f} ms, of which "
            f"{kernels} {kernel_us / 1e3:.3f} ms")
    del params, res
    torch.cuda.empty_cache()
    return line, launches, kernels


def consistency(torch, TM, ops, cfg, params, tokens, split, plant=False):
    """(the last logits of a prefill over all of ``tokens``, the logits
    after a prefill of ``tokens[:, :split]`` and decode of the rest, each
    token fed as the reference's test feeds it).  With ``plant`` the
    decode carries a fault that the bf16 gate must see, and the first is
    None: attention drops the newest PLANT_KEYS keys (a lost key split of
    the decode kernel), or mamba's middle layer keeps its state from
    before each step (its state update skipped)."""
    dev, dt = tokens.device, params["embed"].dtype
    B, S = tokens.shape
    full = None if plant else TM.prefill(
        cfg, params, tokens, TM.init_cache(cfg, B, S, dt, dev))[0]
    logits, cache = TM.prefill(cfg, params, tokens[:, :split],
                               TM.init_cache(cfg, B, S, dt, dev))
    decode_attention, mid = ops.decode_attention, cfg.n_layers // 2
    if plant and not cfg.attn_free:
        ops.decode_attention = lambda q, k, v, lengths: decode_attention(
            q, k, v, lengths - PLANT_KEYS)
    try:
        for pos in range(split, S):
            lengths = torch.full((B,), pos, dtype=torch.int32, device=dev)
            held = [t[mid].clone() for t in cache] \
                if plant and cfg.attn_free else []
            logits, cache = TM.decode_step(cfg, params,
                                           tokens[:, pos:pos + 1], lengths,
                                           cache)
            for t, h in zip(cache, held):
                t[mid].copy_(h)
    finally:
        ops.decode_attention = decode_attention
    return full, logits


def rel_err(got, want) -> float:
    """max |got - want| / max |want| (tests/test_smoke_archs.py)."""
    return float((got - want).abs().max() / (want.abs().max() + 1e-6))


def _tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree(v, fn) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


# --------------------------------------------------------------------------- #
# phase 7: the reduced configs through the launcher on the card
# --------------------------------------------------------------------------- #


def phase_smoke_configs(torch, ops, TM, launcher, configs, dev="cuda"):
    """``prefill_decode --smoke`` of minitron-4b and mamba2-2.7b on the
    card through the launcher's ``main`` (weights from a CUDA generator):
    finite logits, and the kernel launches of that run counted from zero;
    then prefill and one decode step of each smoke config on the card
    against the CPU with the same weights (f32, rtol = atol = 1e-4)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lines = []
    for arch in ("minitron-4b", "mamba2-2.7b"):
        cfg = configs.smoke_config(configs.get_config(arch))
        for k in ops.LAUNCHES:
            ops.LAUNCHES[k] = 0
        res = launcher.main(["--smoke", "--arch", arch, "--batch",
                             str(SMOKE_BATCH), "--prompt", str(SMOKE_PROMPT),
                             "--steps", str(SMOKE_STEPS)])
        got = {k: v for k, v in ops.LAUNCHES.items() if v}
        L = cfg.n_layers
        want = ({"ssd_scan": L} if cfg.attn_free else
                {"flash_attention": L, "decode_attention": L * SMOKE_STEPS})
        check(got == want, f"{cfg.name}: launcher kernel launches {got}, "
              f"expected {want}")
        check(res["logits"].shape == (SMOKE_BATCH, cfg.vocab_padded)
              and bool(torch.isfinite(res["logits"]).all()),
              f"{cfg.name}: launcher logits not finite of the right shape")
        params = TM.init_params(cfg, torch.Generator().manual_seed(3),
                                torch.float32, "cpu")
        tokens = torch.randint(0, cfg.vocab, (SMOKE_BATCH, SMOKE_PROMPT),
                               generator=torch.Generator().manual_seed(4),
                               dtype=torch.int32)
        out = {}
        for d in ("cpu", dev):
            p = _to(torch, params, d)
            cache = TM.init_cache(cfg, SMOKE_BATCH, SMOKE_PROMPT + 1,
                                  torch.float32, d)
            first, cache = TM.prefill(cfg, p, tokens.to(d), cache)
            lengths = torch.full((SMOKE_BATCH,), SMOKE_PROMPT,
                                 dtype=torch.int32, device=d)
            nxt, _ = TM.decode_step(cfg, p, tokens[:, :1].to(d), lengths,
                                    cache)
            out[d] = (first.cpu(), nxt.cpu())
        for a, b in zip(out[dev], out["cpu"]):
            check(bool(torch.isfinite(a).all()), f"{cfg.name}: non-finite")
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
        err = max(float((a - b).abs().max())
                  for a, b in zip(out[dev], out["cpu"]))
        per_step = res["decode_s"] / SMOKE_STEPS
        lines.append(
            f"smoke {cfg.name} (hd {cfg.head_dim}"
            + (f", N {cfg.ssm.d_state}" if cfg.ssm else "")
            + f", f32): prefill_decode --smoke on the card, prefill "
            f"{SMOKE_BATCH} x {SMOKE_PROMPT} tokens "
            f"{1e3 * res['prefill_s']:.3f} ms, {SMOKE_STEPS} decode steps "
            f"{1e3 * per_step:.3f} ms per step, logits finite; launches "
            + " ".join(f"{k}={v}" for k, v in got.items())
            + f"; prefill + decode on the card vs the CPU max_abs_err={err}"
            " (rtol=atol=1e-4)")
    return lines


# --------------------------------------------------------------------------- #
# phase 3: the main path
# --------------------------------------------------------------------------- #


def make_request(SL, cfg, ids, i):
    """Request i of the traffic: the first N_UNROUTABLE go to the service
    whose only rule nothing matches; the rest cycle over the six policy
    services and productpage, a third of them on the wildcard rule."""
    if i < N_UNROUTABLE:
        return SL.Request(req_id=i, service=ids["services"]["closed"],
                          headers={"path": f"/x/{i}"}, prompt_token=3)
    svc_ids = [ids["services"][f"svc{p}"] for p in range(6)] \
        + [ids["services"]["productpage"]]
    s = svc_ids[i % len(svc_ids)]
    hdr = {"path": f"/api/{s}" if i % 3 else f"/other/{i}",
           "user": f"user{i % 997}", "tenant": f"t{i % 13}"}
    return SL.Request(req_id=i, service=s, headers=hdr,
                      prompt_token=3 + i % (cfg.vocab - 3))


def phase_serve(torch, RT, ops, TM, interpose, SL, cfg, dev="cuda"):
    """The timed drain of the main path (no profiler), then a separate
    profiled pass for the device's busy share in steady state."""
    dev = torch.device(dev)
    routing, ids = routing_config(RT, dev)
    params = TM.init_params(cfg, torch.Generator().manual_seed(0),
                            torch.float32, dev)
    eng = interpose.Engine(cfg, I_LANES, SLOTS, MAX_LEN, device=dev)
    # unroutable requests drop after max_retries (64) attempts; the short
    # backoff cap keeps their retry tail near the routable drain
    loop = SL.ServeLoop(eng, params, routing, admit_batch=ADMIT_R,
                        dtype=torch.float32, backoff_cap=4)

    events = {"admit": [], "decode": [], "complete": [], "tick": []}

    def timed(name, fn):
        def wrapper(*a, **k):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = fn(*a, **k)
            e.record()
            events[name].append((s, e))
            return out
        return wrapper

    reqs = [make_request(SL, cfg, ids, i) for i in range(N_REQUESTS)]
    n_routable = N_REQUESTS - N_UNROUTABLE
    nxt = 0

    def step(tick):
        nonlocal nxt
        for r in reqs[nxt:nxt + ARRIVALS_PER_TICK]:
            loop.submit(r)
        nxt += ARRIVALS_PER_TICK
        tick()

    originals = (ops.admit_commit, ops.complete, TM.decode_step)
    ops.admit_commit = timed("admit", ops.admit_commit)
    ops.complete = timed("complete", ops.complete)
    TM.decode_step = timed("decode", TM.decode_step)
    timed_tick = timed("tick", loop.tick)
    for k in ops.LAUNCHES:
        ops.LAUNCHES[k] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wall = None
    try:
        while (nxt < len(reqs) or loop.n_queued or loop.inflight) \
                and loop.ticks < 3000:
            step(timed_tick)
            if wall is None and len(loop.done) == n_routable:
                wall = time.perf_counter() - t0   # the tick synced already
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        ops.admit_commit, ops.complete, TM.decode_step = originals
    launches = dict(ops.LAUNCHES)

    done, dropped = list(loop.done), list(loop.dropped)
    check(len(done) == n_routable,
          f"{len(done)} of {n_routable} routable requests completed")
    check(sorted(r.req_id for r in dropped) == list(range(N_UNROUTABLE)),
          "the dropped requests are not exactly the unroutable ones")
    m = loop.state.metrics
    # no_route counts per admission attempt (FlowMetrics contract)
    attempts = sum(r.retries for r in dropped)
    check(int(m.no_route_match) == attempts,
          f"no_route {int(m.no_route_match)} != {attempts} attempts of the "
          f"{N_UNROUTABLE} unroutable requests")
    check(not bool(loop.routing.ep_load.any()), "ep_load not back to zero")
    check(not bool(loop.state.pool.active.any()), "pool not drained")
    check(all(1 <= len(r.tokens) <= MAX_LEN - 1 for r in done),
          "token counts out of range")
    check(all(0 <= t < cfg.vocab_padded for r in done for t in r.tokens),
          "emitted token out of range")
    check(launches["admit_commit"] > 0 and launches["complete"] > 0
          and launches["decode_attention"] > 0,
          f"kernels not launched on the main path: {launches}")
    med = {k: statistics.median(s.elapsed_time(e) for s, e in v)
           for k, v in events.items() if v}
    lat = loop.latency_samples()
    line = (f"serve: {len(done)} requests completed, {len(dropped)} "
            f"unroutable dropped after {attempts} attempts, "
            f"{loop.ticks} ticks in {total:.3f} s; the last routable one "
            f"after {wall:.3f} s = {len(done) / wall:.1f} req/s; "
            f"median ms per tick: "
            + ", ".join(f"{k} {v:.4f}" for k, v in med.items())
            + f"; admit_to_done median {statistics.median(lat['admit_to_done'])}"
            f" ticks, submit_to_done p99 "
            f"{sorted(lat['submit_to_done'])[int(0.99 * len(done))]} ticks;"
            f" overflow {int(m.overflow)}, held_first {loop.held_first}, "
            f"max retries of a completed request "
            f"{max(r.retries for r in done)}")

    # profiled pass: fresh routable requests at the same arrival rate; the
    # pool is full again after PROFILE_FROM ticks, then PROFILE_TICKS
    # ticks run under the profiler, then the loop drains
    reqs = [make_request(SL, cfg, ids, N_REQUESTS + i)
            for i in range((PROFILE_FROM + PROFILE_TICKS)
                           * ARRIVALS_PER_TICK)]
    nxt, t_start = 0, loop.ticks
    while loop.ticks - t_start < PROFILE_FROM:
        step(loop.tick)
    wall_us, by_name = device_events(
        torch, lambda: [step(loop.tick) for _ in range(PROFILE_TICKS)])
    loop.drain(max_ticks=3000)
    check(len(loop.done) == n_routable + len(reqs),
          "the profiled pass did not complete every request")
    busy_ms = sum(by_name.values()) / 1e3
    window_ms = PROFILE_TICKS * med["tick"]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    prof = (f"serve profile (separate pass, steady state): device busy "
            f"{busy_ms:.3f} ms over {PROFILE_TICKS} ticks = "
            f"{100 * busy_ms / window_ms:.1f}% of {PROFILE_TICKS} x the "
            f"unprofiled median tick {med['tick']:.4f} ms (idle "
            f"{100 - 100 * busy_ms / window_ms:.1f}%); wall under the "
            f"profiler {wall_us / 1e3:.3f} ms; {len(by_name)} kernel names; "
            "top: " + "; ".join(f"{n[:48]} {t / 1e3:.3f} ms"
                                for n, t in top))
    return line, prof, launches


# --------------------------------------------------------------------------- #
# phase 4: the staged admission chain, card against CPU
# --------------------------------------------------------------------------- #


def staged_chain(torch, M, routing, batch, pool, rnd, gum):
    """match_cluster → select → allocate_slots → scatter_to_pool: the
    pre-fusion admission chain, one batch, the pool committed field by
    field.  Returns (cluster, selection, routing, assignment, pool)."""
    router, policies, request_map = M
    rid, svc, feats, tok = batch.req_id, batch.svc, batch.features, \
        batch.token
    cl = torch.where(rid >= 0, router.match_cluster(routing, svc, feats), -1)
    sel, st = policies.select(routing, cl, rnd, gum, feats)
    a = request_map.allocate_slots(sel.instance, pool.active == 0)
    vals = (rid, sel.endpoint, svc, torch.zeros_like(rid), tok)
    fields = [request_map.scatter_to_pool(p, a, v)
              for p, v in zip(pool[:5], vals)]
    return cl, sel, st, a, fields


def weighted_ties(torch, RT, routing, cl, feats_gum):
    """Per row: a weighted row whose two best scores lie within TIE_GAP
    (the rows whose pick may flip between devices by an ulp of log)."""
    cs = routing.cluster_ep_start.long()
    cc = routing.cluster_ep_count.long()
    E = routing.ep_weight.shape[0]
    clc = cl.long().clamp(0, cs.shape[0] - 1)
    win = torch.arange(RT.MAX_EPS_PER_CLUSTER)
    idx = (cs[clc][:, None] + win).clamp(0, E - 1)
    ok = (win < cc[clc][:, None]) & (routing.ep_drained.long()[idx] == 0)
    score = torch.where(ok, torch.log(routing.ep_weight[idx] + 1e-9)
                        + feats_gum, -torch.inf)
    top2 = score.topk(2, dim=1).values
    wt = (cl >= 0) & (routing.cluster_policy.long()[clc]
                      == RT.POLICY_WEIGHTED) & (ok.sum(1) > 1)
    return wt & ((top2[:, 0] - top2[:, 1]) < TIE_GAP)


def phase_staged(torch, RT, ops, B, M, dev="cuda"):
    """The staged chain on the card against the same chain on the CPU with
    the same draws; then its time beside the fused admission kernel's."""
    routing0, _ = routing_config(RT, "cpu")
    runs = {}
    for name, d in (("cpu", "cpu"), ("card", torch.device(dev))):
        routing, reqs, pool, rnd, gum = admit_inputs(
            torch, RT, routing0, ADMIT_R, I_LANES, SLOTS, seed=11, dev=d)
        args = (routing, B.RequestBatch(*reqs), B.PoolState(*pool), rnd, gum)
        if name == "card":
            for k in ops.LAUNCHES:
                ops.LAUNCHES[k] = 0
            out = staged_chain(torch, M, *args)
            fused = ops.admit(args[1], routing, pool[5] == 0, rnd, gum)
            torch.cuda.synchronize()
            launches = {k: ops.LAUNCHES[k]
                        for k in ("route_match", "relay_slots", "admit")}
        else:
            out = staged_chain(torch, M, *args)
        runs[name] = (out, args)
    check(launches["route_match"] >= 1 and launches["relay_slots"] >= 3
          and launches["admit"] >= 1,
          f"kernels not launched in the staged phase: {launches}")

    (c_cl, c_sel, c_st, c_a, c_pool), c_args = runs["cpu"]
    (k_cl, k_sel, k_st, k_a, k_pool), k_args = runs["card"]
    ties = weighted_ties(torch, RT, c_args[0], c_cl, c_args[4])
    flipped = k_sel.endpoint.cpu() != c_sel.endpoint
    check(not bool((flipped & ~ties).any()),
          "staged chain: endpoints differ between the card and the CPU on "
          "rows that are not weighted near-ties")
    pairs = [("cluster", k_cl.cpu(), c_cl)]
    if not bool(flipped.any()):   # a flipped tie changes everything after
        pairs += [("endpoint", k_sel.endpoint.cpu(), c_sel.endpoint),
                  ("instance", k_sel.instance.cpu(), c_sel.instance),
                  ("slot", k_a.slot.cpu(), c_a.slot),
                  ("ok", k_a.ok.cpu(), c_a.ok)]
        pairs += [(f, getattr(k_st, f).cpu(), getattr(c_st, f))
                  for f in ("ep_load", "rr_cursor", "aff_key", "aff_ep")]
        pairs += [(f"pool.{f}", x.cpu(), y) for f, x, y in
                  zip(B.PoolState._fields, k_pool, c_pool)]
    err = max_abs_err(torch, pairs)
    n_ok = int(k_a.ok.sum())
    check(n_ok > 0, "staged chain admitted nothing")

    routing, batch, pstate, rnd, gum = k_args
    chain = lambda: staged_chain(torch, M, *k_args)
    admit = lambda: ops.admit(batch, routing, pstate.active == 0, rnd, gum)
    commit = lambda: ops.admit_commit(batch, routing, pstate, rnd, gum)
    staged_ms = cuda_ms(torch, chain, reps=20, warm=3)
    admit_ms = cuda_ms(torch, admit, reps=20, warm=3)
    commit_ms = cuda_ms(torch, commit, reps=20, warm=3)
    t0 = time.perf_counter()
    for _ in range(5):
        staged_chain(torch, M, *c_args)
    cpu_ms = (time.perf_counter() - t0) / 5 * 1e3
    line = (f"staged: chain on the card vs the CPU max_abs_err={err}, "
            f"{n_ok} of {ADMIT_R} rows admitted (fused admit: "
            f"{int(fused.ok.sum())}); weighted rows with top-two scores "
            f"within {TIE_GAP}: {int(ties.sum())}, flipped: "
            f"{int(flipped.sum())}; ms per batch (events): staged chain "
            f"{staged_ms:.4f}, fused admit {admit_ms:.4f}, fused "
            f"admit_commit {commit_ms:.4f}; the staged chain on the CPU "
            f"{cpu_ms:.4f} ms (host clock); launches per chain: "
            f"route_match {launches['route_match']}, relay_slots "
            f"{launches['relay_slots']}")
    return line, launches


# --------------------------------------------------------------------------- #
# phase 5: the same traffic through the XLB engine and the sidecars
# --------------------------------------------------------------------------- #


def phase_engines(torch, RT, TM, B, SL, cfg, dev="cuda"):
    """ServeLoop over make_balancer("xlb" | "istio" | "cilium"): a timed
    drain of ENGINE_REQUESTS routable requests (host clock per tick),
    then a separate short pass with ENGINE_PROFILE ticks under the
    profiler for the device's busy share."""
    dev = torch.device(dev)
    routing, ids = routing_config(RT, dev)
    params = TM.init_params(cfg, torch.Generator().manual_seed(0),
                            torch.float32, dev)
    lines = []
    for kind in B.ENGINE_KINDS:
        eng = B.make_balancer(kind, cfg, I_LANES, SLOTS, MAX_LEN, device=dev)
        loop = SL.ServeLoop(eng, params, routing, admit_batch=ADMIT_R,
                            dtype=torch.float32, backoff_cap=4)
        reqs = [make_request(SL, cfg, ids, N_UNROUTABLE + i)
                for i in range(ENGINE_REQUESTS)]
        nxt, tick_ms = 0, []

        def step():
            nonlocal nxt
            for r in reqs[nxt:nxt + ARRIVALS_PER_TICK]:
                loop.submit(r)
            nxt += ARRIVALS_PER_TICK
            t = time.perf_counter()
            loop.tick()                 # ends in the tick's download
            tick_ms.append((time.perf_counter() - t) * 1e3)

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        while (nxt < len(reqs) or loop.n_queued or loop.inflight) \
                and loop.ticks < 2000:
            step()
        wall = time.perf_counter() - t0
        check(len(loop.done) == len(reqs),
              f"{kind}: {len(loop.done)} of {len(reqs)} requests completed")
        check(not bool(torch.as_tensor(loop.routing.ep_load).any()),
              f"{kind}: ep_load not back to zero")
        check(not bool(torch.as_tensor(loop.state.pool.active).any()),
              f"{kind}: pool not drained")
        med = statistics.median(tick_ms)
        ticks = loop.ticks

        # profiled pass: fresh requests at the same rate, ENGINE_WARM
        # ticks, then ENGINE_PROFILE ticks under the profiler
        reqs, nxt = [make_request(SL, cfg, ids, 10 * N_REQUESTS + i)
                     for i in range((ENGINE_WARM + ENGINE_PROFILE)
                                    * ARRIVALS_PER_TICK)], 0
        for _ in range(ENGINE_WARM):
            step()
        _, by_name = device_events(
            torch, lambda: [step() for _ in range(ENGINE_PROFILE)])
        busy = sum(by_name.values()) / 1e3 / ENGINE_PROFILE
        lines.append(
            f"engine {kind}: {ENGINE_REQUESTS} requests in {ticks} ticks, "
            f"{wall:.3f} s = {ENGINE_REQUESTS / wall:.1f} req/s; median "
            f"tick {med:.4f} ms (host clock); device busy {busy:.4f} ms "
            f"per tick (profiler, {ENGINE_PROFILE} ticks) = "
            f"{100 * busy / med:.1f}% of the median tick (idle "
            f"{100 - 100 * busy / med:.1f}%)")
    return lines


# --------------------------------------------------------------------------- #
# phase 5, continued: the control plane, a commit mid-drain
# --------------------------------------------------------------------------- #


def phase_control(torch, RT, CT, TM, interpose, SL, ops, cfg, dev="cuda"):
    """The serving routing built by the port's ControlPlane and served by
    ServeLoop over the XLB engine on the card.  At CONTROL_COMMIT_TICK one
    transaction drains the most loaded endpoint of productpage (the
    50-endpoint least-request cluster), removes one from the middle of its
    window (swap-with-last) and adds one; after it, each tick runs the
    reaper.  Checks one version bump, no admission onto the drained
    endpoint, every request completed, loads back to zero, the endpoint
    reaped on a later commit, and apply_plan on the card equal to
    apply_plan on the CPU.  Times the commit (host clock, synchronised),
    the splice inside it (host clock and CUDA events), the splice alone
    over SPLICE_REPS calls (host clock, events, profiler), and the tick
    that carried the commit against the median tick."""
    dev = torch.device(dev)
    cp = CT.ControlPlane(*serving_config(RT))
    params = TM.init_params(cfg, torch.Generator().manual_seed(0),
                            torch.float32, dev)
    eng = interpose.Engine(cfg, I_LANES, SLOTS, MAX_LEN, device=dev)
    loop = SL.ServeLoop(eng, params, cp, admit_batch=ADMIT_R,
                        dtype=torch.float32, backoff_cap=4)
    check(loop.cp is cp and int(loop.routing.version) == 0,
          "control: the loop did not attach at version 0")
    refresh, inside = eng.apply_refresh, {}

    def timed_refresh(state, plan):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        t = time.perf_counter()
        s.record()
        out = refresh(state, plan)
        e.record()
        inside["host_ms"] = (time.perf_counter() - t) * 1e3
        inside["events"] = (s, e)
        return out

    eng.apply_refresh = timed_refresh
    reqs = [make_request(SL, cfg, cp.ids, N_UNROUTABLE + i)
            for i in range(CONTROL_REQUESTS)]
    pp = "productpage"
    nxt, tick_ms, slot, reaped_at, onto_drained = 0, [], None, None, 0
    for k in ops.LAUNCHES:
        ops.LAUNCHES[k] = 0
    torch.cuda.synchronize()
    while (nxt < len(reqs) or loop.n_queued or loop.inflight) \
            and loop.ticks < 2000:
        for r in reqs[nxt:nxt + ARRIVALS_PER_TICK]:
            loop.submit(r)
        nxt += ARRIVALS_PER_TICK
        t0 = time.perf_counter()
        if loop.ticks == CONTROL_COMMIT_TICK:
            members = cp.cluster_members(pp)
            load = loop.routing.ep_load.cpu()
            _, drained = max(members, key=lambda m: int(load[m[0]]))
            _, removed = next(m for m in members[len(members) // 2:]
                              if m[1] != drained)
            state0 = loop.state
            tc = time.perf_counter()
            with cp.transaction():
                cp.drain_endpoint(pp, drained)
                cp.remove_endpoint(pp, removed)
                cp.add_endpoint(pp, CONTROL_ADD_LANE)
            torch.cuda.synchronize()
            commit_ms = (time.perf_counter() - tc) * 1e3
            plan, commit_log = cp.last_plan, list(cp.last_commit_log)
            slot = cp.endpoint_slot(pp, drained)
            check(cp.version == 1 and int(loop.routing.version) == 1,
                  f"control: version {cp.version} / "
                  f"{int(loop.routing.version)} after one commit")
            load_at_commit = int(loop.routing.ep_load[slot])
            check(load_at_commit > 0,
                  "control: the drained endpoint carried no load")
        watch = slot is not None and reaped_at is None
        before = loop.state.pool.active.clone() if watch else None
        loop.tick()
        if watch:
            new = loop.state.pool.active & ~before
            onto_drained += int((new & (loop.state.pool.endpoint == slot))
                                .sum())
            cp.reap()
            if cp.endpoint_slot(pp, drained) < 0:
                reaped_at = loop.ticks - 1
        tick_ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    launches = {k: ops.LAUNCHES[k] for k in ("admit_commit", "complete",
                                             "decode_attention")}
    eng.apply_refresh = refresh

    check(len(loop.done) == CONTROL_REQUESTS and not loop.dropped,
          f"control: {len(loop.done)} of {CONTROL_REQUESTS} requests "
          f"completed, {len(loop.dropped)} dropped")
    check(onto_drained == 0, f"control: {onto_drained} admissions onto "
          "the drained endpoint after the commit")
    check(not bool(loop.routing.ep_load.any()), "control: ep_load not "
          "back to zero")
    check(not bool(loop.state.pool.active.any()), "control: pool not "
          "drained")
    check(reaped_at is not None and reaped_at > CONTROL_COMMIT_TICK
          and ("reap", pp, drained) in cp.last_commit_log,
          "control: the drained endpoint was not reaped on a later commit")
    check(min(launches.values()) > 0,
          f"control: kernels not launched: {launches}")
    # the splice on the card against the same splice on the CPU
    got = CT.apply_plan(state0.routing, plan)
    want = CT.apply_plan(state0.routing.to("cpu"), plan)
    err = max_abs_err(torch, [(f, getattr(got, f).cpu(), getattr(want, f))
                              for f in RT.RoutingState._fields])
    err = max(err, max_abs_err(torch, [(
        "pool.endpoint",
        CT.remap_endpoints(plan, state0.pool.endpoint).cpu(),
        CT.remap_endpoints(plan, state0.pool.endpoint.cpu()))]))
    # the splice alone, as the commit ran it
    splice = lambda: refresh(state0, plan)
    splice()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(SPLICE_REPS):
        splice()
    host_ms = (time.perf_counter() - t) * 1e3 / SPLICE_REPS
    torch.cuda.synchronize()
    events_ms = cuda_ms(torch, splice, reps=SPLICE_REPS)
    device_ms = library_device_ms(torch, splice, reps=SPLICE_REPS)
    s, e = inside["events"]
    c = CONTROL_COMMIT_TICK
    med = statistics.median(tick_ms[:c] + tick_ms[c + 1:])
    return (f"control: {CONTROL_REQUESTS} requests through ServeLoop "
            f"attached to the port's ControlPlane, {loop.ticks} ticks; at "
            f"tick {c} one commit ({len(commit_log)} primitive writes) "
            f"drained instance {drained} of {pp} with {load_at_commit} "
            f"in flight, removed instance {removed} (swap-with-last) and "
            f"added lane {CONTROL_ADD_LANE}: version 0 -> 1, "
            f"{onto_drained} admissions onto the drained endpoint, reaped "
            f"at tick {reaped_at} (version {cp.version}); every request "
            f"completed, ep_load back to 0; apply_plan and "
            f"remap_endpoints card vs CPU max_abs_err={err}; kernels: "
            + " ".join(f"{k}={v}" for k, v in launches.items()),
            f"control timing: commit host ms {commit_ms:.4f} (the "
            f"transaction, the splice's issue and a synchronize); splice "
            f"inside the commit: host ms {inside['host_ms']:.4f}, events "
            f"ms {s.elapsed_time(e):.4f}; splice alone ({SPLICE_REPS} "
            f"calls): host ms {host_ms:.4f} per call, events ms "
            f"{events_ms:.4f}, device ms {device_ms:.5f} (profiler, every "
            f"kernel and copy of one splice); the tick with the commit "
            f"{tick_ms[c]:.4f} ms (host clock) vs the median tick "
            f"{med:.4f} ms", launches, med)


# --------------------------------------------------------------------------- #
# phase 9: the fault-tolerant serving loop (degraded, chaos, sanitizer)
# --------------------------------------------------------------------------- #


def sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def host_draws(torch, policies, dev, seed: int):
    """An engine's policy draws made by a seeded CPU generator and moved to
    ``dev``: the card run and the CPU run of a phase draw the same bits."""
    gen = torch.Generator().manual_seed(seed)

    def draws(R):
        rnd, gum = policies.draws(gen, R)
        return rnd.to(dev, non_blocking=True), gum.to(dev, non_blocking=True)
    return draws


def p99_window(W, done, lo, hi, since="admit_tick") -> float:
    """p99 of done_tick - ``since`` (ticks) over the requests done in
    [lo, hi): admit_to_done by default, submit_to_done with
    ``since="submit_tick"``."""
    return W.percentiles([r.done_tick - getattr(r, since) for r in done
                          if lo <= r.done_tick < hi])["p99"]


def degraded_run(torch, RT, CT, TM, interpose, SL, H, W, policies, ops, cfg,
                 dev, epoch=DEG_EPOCH):
    """One run of the degraded scenario on ``dev``: productpage scaled to
    the lane count (one least-request cluster of all I_LANES lanes),
    DEG_ARRIVALS requests a tick, lane I_LANES - 1 DEG_FACTOR x slower
    over DEG_FAULT, a HealthPolicy epoch every ``epoch`` ticks with the
    cooldown sized so that the half-open probe lands after the fault
    clears; then a drain."""
    dev = torch.device(dev)
    pp, sick = "productpage", I_LANES - 1
    cp = CT.ControlPlane([RT.ServiceConfig(pp, [RT.Rule(0, None, pp)])],
                         [RT.Cluster(pp, list(range(I_LANES)),
                                     policy=RT.POLICY_LEAST_REQUEST)])
    params = TM.init_params(cfg, torch.Generator().manual_seed(0),
                            torch.float32, dev)
    eng = interpose.Engine(cfg, I_LANES, SLOTS, MAX_LEN, eos=-1, device=dev)
    eng.draws = host_draws(torch, policies, dev, 1)
    f0, f1 = DEG_FAULT
    loop = SL.ServeLoop(eng, params, cp, admit_batch=ADMIT_R,
                        dtype=torch.float32, backoff_cap=4,
                        fault=SL.FaultInjector([SL.Fault(
                            sick, "slow", factor=DEG_FACTOR, start=f0,
                            end=f1)]))
    pol = H.HealthPolicy(cp, H.HealthConfig(
        trip_after=2, cooldown=(f1 - f0) // epoch, recover_after=2,
        probe_patience=10), clusters=[pp])
    rid, eject, uneject = 0, None, None
    ewmas, logs, tick_ms, epoch_ms, commit_ms = [], [], [], [], []
    for k in ops.LAUNCHES:
        ops.LAUNCHES[k] = 0
    sync(torch, dev)
    for t in range(DEG_TICKS):
        for _ in range(DEG_ARRIVALS):
            loop.submit(SL.Request(req_id=rid, service=0,
                                   headers={"user": f"user{rid % 997}"},
                                   prompt_token=3 + rid % (cfg.vocab - 3)))
            rid += 1
        t0 = time.perf_counter()
        loop.tick()
        t1 = time.perf_counter()
        tick_ms.append((t1 - t0) * 1e3)
        if (t + 1) % epoch:
            continue
        acts = pol.epoch(loop.routing)
        sync(torch, dev)
        ms = (time.perf_counter() - t1) * 1e3
        if acts:                            # (epoch ms, the tick before)
            commit_ms.append((ms, tick_ms[-1]))
            logs.append((t, list(cp.last_commit_log)))
        else:
            epoch_ms.append(ms)
        ewmas.append(torch.stack([loop.routing.ep_inflight_ewma,
                                  loop.routing.ep_tput_ewma]).cpu()
                     .view(torch.int32).numpy())
        st = pol.state_of(pp, sick)
        if st == H.OPEN and eject is None:
            eject = t
        if eject is not None and uneject is None and st == H.CLOSED:
            uneject = t
    rep = loop.drain(max_ticks=2000)
    sync(torch, dev)
    launches = {k: ops.LAUNCHES[k] for k in ("admit_commit", "complete",
                                             "decode_attention")}
    slot = cp.endpoint_slot(pp, sick)
    lat = loop.latency_samples()
    return {"eject": eject, "uneject": uneject, "commits": pol.commits,
            "version": cp.version, "events": pol.events, "logs": logs,
            "ewmas": ewmas, "state": pol.state_of(pp, sick),
            "weight": cp.endpoint_weight(pp, sick),
            "drained": int(cp.snapshot().ep_drained[slot]),
            "submitted": rid, "done": len(rep.done),
            "dropped": len(rep.dropped), "stranded": rep.queued
            + rep.inflight, "load": int(loop.routing.ep_load.abs().sum()),
            "samples": {k: v.tolist() for k, v in lat.items()},
            "p99": [p99_window(W, rep.done, MAX_LEN, f0),
                    p99_window(W, rep.done, f0, f1),
                    p99_window(W, rep.done, uneject or f1, loop.ticks)],
            "ticks": loop.ticks, "launches": launches, "tick_ms": tick_ms,
            "epoch_ms": epoch_ms, "commit_ms": commit_ms}


def phase_degraded(torch, RT, CT, TM, interpose, SL, H, W, policies, ops,
                   cfg, dev="cuda"):
    """The degraded scenario on the card, checked, then the same on the
    CPU: the same eject and re-admit ticks, commits and commit logs, and
    the EWMAs bit-exact at every epoch."""
    args = (torch, RT, CT, TM, interpose, SL, H, W, policies, ops, cfg)
    card = degraded_run(*args, dev)
    f0, f1 = DEG_FAULT
    check(card["eject"] is not None and f0 < card["eject"] < f1,
          f"degraded: ejected at {card['eject']}, not inside {DEG_FAULT}")
    check(card["uneject"] is not None and card["uneject"] > f1,
          f"degraded: re-admitted at {card['uneject']}, not after {f1}")
    check((card["state"], card["weight"], card["drained"])
          == (H.CLOSED, 1.0, 0),
          f"degraded: the sick lane ends {card['state']}, weight "
          f"{card['weight']}, drained bit {card['drained']}")
    check(card["version"] == card["commits"] > 0,
          f"degraded: version {card['version']} != daemon commits "
          f"{card['commits']}")
    check(card["done"] == card["submitted"] and not card["dropped"]
          and not card["stranded"] and card["load"] == 0,
          f"degraded: {card['done']} of {card['submitted']} completed, "
          f"{card['dropped']} dropped, {card['stranded']} stranded, "
          f"load {card['load']}")
    check(min(card["launches"].values()) > 0,
          f"degraded: kernels not launched: {card['launches']}")
    short = degraded_run(*args, dev, epoch=DEG_SHORT_EPOCH)
    cpu = degraded_run(*args, "cpu")
    for k in ("eject", "uneject", "commits", "version", "events", "logs",
              "samples", "done"):
        check(card[k] == cpu[k], f"degraded: {k} differs between the card "
              "and the CPU")
    check(len(card["ewmas"]) == len(cpu["ewmas"]) and all(
        (a == b).all() for a, b in zip(card["ewmas"], cpu["ewmas"])),
        "degraded: the EWMAs differ between the card and the CPU")
    med = statistics.median(card["tick_ms"])
    commit = ", ".join(f"{e:.4f} + tick {t:.4f}"
                       for e, t in card["commit_ms"])
    acts = lambda run, epoch: ", ".join(
        f"{e[1]} at tick {e[0] * epoch - 1}" for e in run["events"])
    return (f"degraded: productpage over {I_LANES} lanes x {SLOTS} slots, "
            f"{DEG_ARRIVALS} arrivals/tick, lane {I_LANES - 1} "
            f"{DEG_FACTOR}x slow over ticks {f0}-{f1}, an epoch every "
            f"{DEG_EPOCH} ticks (cooldown {(f1 - f0) // DEG_EPOCH}): ejected at tick {card['eject']}, "
            f"re-admitted at {card['uneject']}; {card['commits']} daemon "
            f"commits = version {card['version']} (0 operator); "
            f"{card['done']} of {card['submitted']} completed in "
            f"{card['ticks']} ticks, ep_load back to 0; p99 admit_to_done "
            f"healthy / degraded / recovered "
            + " / ".join(str(p) for p in card["p99"]) + " ticks (daemon: "
            + acts(card, DEG_EPOCH) + f"; with {DEG_SHORT_EPOCH}-tick "
            f"epochs on the card: " + acts(short, DEG_SHORT_EPOCH)
            + f", ending {short['state']}); card = "
            f"CPU on eject, re-admit, commits, commit logs, latency samples "
            f"and the EWMAs bit-exact at all {len(card['ewmas'])} epochs; "
            "kernels: " + " ".join(f"{k}={v}" for k, v in
                                   card["launches"].items()),
            f"degraded timing: an epoch without a commit host ms "
            f"{statistics.median(card['epoch_ms']):.4f} (median of "
            f"{len(card['epoch_ms'])}: one EWMA read, the breakers); with "
            f"its commit (host ms, epoch + the tick before): {commit}; "
            f"median tick {med:.4f} ms", card["launches"])


def chaos_run(torch, RT, CT, TM, interpose, SL, TR, W, policies, ops, cfg,
              dev, times=None):
    """One run of the chaos scenario on ``dev``: ServeLoop attached through
    a RemoteConsumer on a lossy channel (the reference chaos leg's
    settings, its arrival rate and request count scaled from 4 lanes to
    I_LANES), a WEIGHTED cluster of all lanes, the operator schedule, a
    slow lane, a replica crashed and restarted; then a flush."""
    dev = torch.device(dev)
    sick, scale = I_LANES - 1, I_LANES // 4
    cp = CT.ControlPlane([RT.ServiceConfig("svc", [RT.Rule(0, None, "pool")])],
                         [RT.Cluster("pool", list(range(I_LANES)),
                                     policy=RT.POLICY_WEIGHTED)],
                         lease_epochs=3)
    seed = CHAOS_SEED
    chan = TR.LossyChannel(seed=seed, p_drop=0.15, p_dup=0.10, delay_min=1,
                           delay_max=4,
                           faults=[TR.ChannelFault(22, 58, dst="ingress-0")])
    hub = TR.Transport(cp, chan, retry_base=1, retry_cap=8, seed=seed + 1)
    rc = hub.consumer("ingress-0")
    params = TM.init_params(cfg, torch.Generator().manual_seed(0),
                            torch.float32, dev)
    eng = interpose.Engine(cfg, I_LANES, SLOTS, CHAOS_MAX_LEN, eos=-1,
                           device=dev)
    eng.draws = host_draws(torch, policies, dev, 2)
    loop = SL.ServeLoop(eng, params, rc, admit_batch=ADMIT_R,
                        dtype=torch.float32, fault=SL.FaultInjector([
                            SL.Fault(sick, "slow", factor=8, start=20,
                                     end=78)]))
    if times is not None:                  # the heartbeat's host cost
        pump = rc.pump

        def timed_pump(tick):
            t0 = time.perf_counter()
            pump(tick)
            times["pump"].append((time.perf_counter() - t0) * 1e3)
        rc.pump = timed_pump
    replica = hub.consumer("replica-1")
    wl = W.Workload(W.PoissonArrivals(rate=1.0 * scale, seed=seed),
                    n_requests=130 * scale, vocab=cfg.vocab)
    schedule = [W.Op(6, "canary", args={"instance": 1, "pct": 40.0}),
                W.Op(24, "drain", args={"instance": sick}),
                W.Op(40, "set_weight", args={"instance": 0, "weight": 1.4}),
                W.Op(72, "canary", args={"instance": 2, "pct": 50.0}),
                W.Op(88, "undrain", args={"instance": sick, "weight": 1.0})]
    driver = W.ScenarioDriver([cp], schedule, max_instances=I_LANES)
    rid = 0
    for k in ops.LAUNCHES:
        ops.LAUNCHES[k] = 0
    sync(torch, dev)
    for t in range(CHAOS_TICKS):
        driver.apply(t)
        if (t + 1) % 6 == 0:
            cp.advance_epoch()
        if t == 44:
            replica.crash()
        if t == 76:
            replica.restart()
        hub.pump(t)
        for r in wl.wave(t, rid):
            loop.submit(SL.Request(req_id=r, service=0,
                                   headers={"user": f"user{r % 997}"},
                                   prompt_token=3 + r % (cfg.vocab - 3)))
            rid += 1
        t0 = time.perf_counter()
        loop.tick()
        if times is not None:
            times["tick"].append((time.perf_counter() - t0) * 1e3)
        replica.pump(t)
    flush = 0
    while flush < 120:
        t = CHAOS_TICKS + flush
        hub.pump(t)
        loop.tick()
        replica.pump(t)
        flush += 1
        if not (loop.n_queued or loop.inflight) \
                and hub.report()["converged"]:
            break
    sync(torch, dev)
    launches = {k: ops.LAUNCHES[k] for k in ("admit_commit", "complete",
                                             "decode_attention")}
    rep = TR.assert_converged(cp, hub.consumers)
    done, since = loop.done, "submit_tick"   # the chaos row's latency
    healthy = p99_window(W, done, 4, 20, since)
    recovered = p99_window(W, done, 110, CHAOS_TICKS + flush, since)
    cs, pub = chan.stats(), hub.publisher.stats()
    row = W.chaos_row(
        "chaos", "xlb", seed=seed, n_requests=rid, completed=len(done),
        dropped=len(loop.dropped), ticks=CHAOS_TICKS, flush_ticks=flush,
        versions=cp.version, consumers=len(hub.consumers),
        resyncs=sum(c.resyncs for c in hub.consumers),
        crashes=sum(c.crashes for c in hub.consumers),
        converged=bool(rep["converged"]), healthy_p99_ticks=healthy,
        chaos_p99_ticks=p99_window(W, done, 20, 110, since),
        recovered_p99_ticks=recovered,
        recovery_ratio=recovered / healthy if healthy else float("nan"),
        msgs_sent=cs["sent"], msgs_dropped=cs["dropped"],
        msgs_duped=cs["duped"], msgs_delivered=cs["delivered"],
        msgs_partitioned=cs["partitioned"],
        stale=sum(c.stale for c in hub.consumers),
        held=sum(c.held for c in hub.consumers),
        rejected=sum(c.rejected for c in hub.consumers),
        plan_sends=sum(s["plan_sends"] for s in pub.values()),
        snap_sends=sum(s["snap_sends"] for s in pub.values()),
        ops=len(schedule), txns=driver.txns, rate=float(scale))
    return {"row": json.dumps(row), "channel": cs, "publisher": pub,
            "histories": [list(c.history) for c in hub.consumers],
            "log": driver.log, "replica_resyncs": replica.resyncs,
            "samples": {k: v.tolist()
                        for k, v in loop.latency_samples().items()},
            "launches": launches, "loop": loop}


def phase_chaos(torch, RT, CT, TM, interpose, SL, TR, W, policies, ops, cfg,
                control_tick_ms, dev="cuda"):
    """The chaos scenario on the card, checked, then the same on the CPU:
    the same channel stats, consumer histories, scenario log and row."""
    args = (torch, RT, CT, TM, interpose, SL, TR, W, policies, ops, cfg)
    times = {"pump": [], "tick": []}
    card = chaos_run(*args, dev, times)
    row = json.loads(card["row"])
    check(row["converged"], "chaos: the transport did not converge")
    check(card["replica_resyncs"] == 1,
          f"chaos: the replica took {card['replica_resyncs']} resyncs")
    check(row["completed"] == row["n_requests"] and not row["dropped"],
          f"chaos: {row['completed']} of {row['n_requests']} completed, "
          f"{row['dropped']} dropped")
    check(min(card["launches"].values()) > 0,
          f"chaos: kernels not launched: {card['launches']}")
    loop = card.pop("loop")
    load = loop.routing.ep_load
    reads = []
    for _ in range(50):                     # the heartbeat's ep_load read
        t0 = time.perf_counter()
        load.cpu()
        reads.append((time.perf_counter() - t0) * 1e3)
    cpu = chaos_run(*args, "cpu")
    cpu.pop("loop")
    for k in ("row", "channel", "publisher", "histories", "log",
              "samples"):
        check(card[k] == cpu[k], f"chaos: {k} differs between the card "
              "and the CPU")
    return (f"chaos: ServeLoop on {I_LANES} x {SLOTS} slots (max_len "
            f"{CHAOS_MAX_LEN}) attached through a RemoteConsumer on a lossy "
            f"channel (seed {CHAOS_SEED}, drop 0.15, dup 0.10, delay 1-4, "
            f"ingress-0 partitioned over ticks 22-58), replica-1 crashed at "
            f"44 and restarted at 76, canary / drain / set_weight / canary "
            f"/ undrain, lane {I_LANES - 1} 8x slow over 20-78: converged, "
            f"one replica resync; card = CPU on the row, channel stats, "
            f"publisher stats, histories, scenario log and latency "
            f"samples; row " + card["row"] + "; kernels: "
            + " ".join(f"{k}={v}" for k, v in card["launches"].items()),
            f"chaos timing: median tick {statistics.median(times['tick']):.4f}"
            f" ms (the control phase's: {control_tick_ms:.4f}); the "
            f"consumer's pump per tick (plans in, the heartbeat with its "
            f"ep_load read out) median host ms "
            f"{statistics.median(times['pump']):.4f}; one ep_load read "
            f"alone (.cpu() of 512 int32) median host ms "
            f"{statistics.median(reads):.4f}", card["launches"])


def phase_sanitize(torch, RT, TM, interpose, SL, INV, policies, ops, cfg,
                   dev="cuda"):
    """The main path's traffic for SAN_TICKS ticks, plain and then with
    XLB_SANITIZE=1 (every admit and complete guard and the loop law on the
    card): no law fires, both runs end in the same state; then a planted
    violation (a completion ctx whose load_after is off by one) must
    raise naming release-conservation."""
    import os
    dev = torch.device(dev)
    params = TM.init_params(cfg, torch.Generator().manual_seed(0),
                            torch.float32, dev)
    calls, last = {"admit": 0, "complete": 0, "loop": 0}, {}
    guard, assert_host = ops.guard, SL.assert_host

    def counted_guard(scope, ctx):
        calls[scope] += 1
        last[scope] = ctx
        guard(scope, ctx)

    def counted_host(scope, ctx):
        calls[scope] += 1
        assert_host(scope, ctx)

    def run(sanitized):
        routing, ids = routing_config(RT, dev)
        eng = interpose.Engine(cfg, I_LANES, SLOTS, MAX_LEN, device=dev)
        eng.draws = host_draws(torch, policies, dev, 3)
        loop = SL.ServeLoop(eng, params, routing, admit_batch=ADMIT_R,
                            dtype=torch.float32, backoff_cap=4)
        reqs = [make_request(SL, cfg, ids, i)
                for i in range(SAN_TICKS * ARRIVALS_PER_TICK)]
        ms = []
        old = os.environ.get("XLB_SANITIZE")
        os.environ["XLB_SANITIZE"] = "1" if sanitized else "0"
        try:
            sync(torch, dev)
            for t in range(SAN_TICKS):
                for r in reqs[t * ARRIVALS_PER_TICK:
                              (t + 1) * ARRIVALS_PER_TICK]:
                    loop.submit(r)
                t0 = time.perf_counter()
                loop.tick()
                ms.append((time.perf_counter() - t0) * 1e3)
        finally:
            if old is None:
                del os.environ["XLB_SANITIZE"]
            else:
                os.environ["XLB_SANITIZE"] = old
        sync(torch, dev)
        return loop, ms

    for k in ops.LAUNCHES:
        ops.LAUNCHES[k] = 0
    plain, plain_ms = run(False)
    ops.guard, SL.assert_host = counted_guard, counted_host
    try:
        check(calls == {"admit": 0, "complete": 0, "loop": 0},
              "sanitize: a guard ran with XLB_SANITIZE=0")
        san, san_ms = run(True)
    finally:
        ops.guard, SL.assert_host = guard, assert_host
    launches = {k: ops.LAUNCHES[k] for k in ("admit_commit", "complete",
                                             "decode_attention")}
    check(calls["complete"] == calls["loop"] == SAN_TICKS
          and calls["admit"] > 0,
          f"sanitize: guards ran {calls} in {SAN_TICKS} ticks")
    for f in ("ep_load", "ep_inflight_ewma", "ep_tput_ewma"):
        check(torch.equal(getattr(san.routing, f), getattr(plain.routing, f)),
              f"sanitize: {f} differs from the plain run")
    check(len(san.done) == len(plain.done)
          and san.latency_samples()["req_id"].tolist()
          == plain.latency_samples()["req_id"].tolist(),
          "sanitize: the sanitized run completed other requests")
    check(min(launches.values()) > 0,
          f"sanitize: kernels not launched: {launches}")
    ctx = dict(last["complete"])
    bad = ctx["load_after"].clone()
    bad[0] += 1
    try:
        INV.guard("complete", dict(ctx, load_after=bad))
    except AssertionError as e:
        planted = str(e)
    else:
        planted = None
    check(planted is not None and "release-conservation" in planted,
          f"sanitize: the planted violation did not raise: {planted!r}")
    return (f"sanitize: the main path's traffic for {SAN_TICKS} ticks with "
            f"XLB_SANITIZE=1: {calls['admit']} admit guards, "
            f"{calls['complete']} complete guards and {calls['loop']} loop "
            f"laws on the card, none fired; the same loads, EWMAs and "
            f"completions as the plain run ({len(san.done)} done); the "
            f"planted off-by-one release raised: {planted}; median tick "
            f"sanitized {statistics.median(san_ms):.4f} ms vs plain "
            f"{statistics.median(plain_ms):.4f} ms (one host sync per "
            f"guard); kernels: "
            + " ".join(f"{k}={v}" for k, v in launches.items()), launches)


# --------------------------------------------------------------------------- #
# phase 5, continued: sharded admission and completion
# --------------------------------------------------------------------------- #


def out_pairs(a, b):
    """(field, a's, b's) over an AdmitCommitOut / CompleteOut pair, the
    pool's fields included, for ``max_abs_err``."""
    pairs = []
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if f == "pool":
            pairs += [(f"pool.{g}", getattr(x, g), getattr(y, g))
                      for g in x._fields]
        else:
            pairs.append((f, x, y))
    return pairs


def to_cpu(out):
    """An AdmitCommitOut / CompleteOut with every tensor on the CPU."""
    return out._replace(pool=type(out.pool)(*[t.cpu() for t in out.pool]),
                        **{f: getattr(out, f).cpu()
                           for f in out._fields if f != "pool"})


def sharded_drain(torch, RT, TM, interpose, SL, MS, policies, ops, cfg, dev,
                  shards, timed=False):
    """ENGINE_REQUESTS routable main-path requests through ServeLoop over
    Engine(shards=``shards``) on ``dev`` (eos -1: completion depends only
    on the length, so the card and the CPU finish the same requests on the
    same ticks), draws from one seeded CPU generator.  Returns (the drain's
    record, its timing, its kernel launches)."""
    routing, ids = routing_config(RT, dev)
    params = TM.init_params(cfg, torch.Generator().manual_seed(0),
                            torch.float32, dev)
    kw = {} if shards == 1 else dict(
        shards=shards, shard_mesh=MS.make_shard_mesh(shards, device=dev))
    eng = interpose.Engine(cfg, I_LANES, SLOTS, MAX_LEN, eos=-1, device=dev,
                           **kw)
    eng.draws = host_draws(torch, policies, dev, SHARD_SEED)
    loop = SL.ServeLoop(eng, params, routing, admit_batch=ADMIT_R,
                        dtype=torch.float32, backoff_cap=4)
    reqs = [make_request(SL, cfg, ids, N_UNROUTABLE + i)
            for i in range(ENGINE_REQUESTS)]
    events = {"admit": [], "complete": [], "tick": []}

    def timed_call(name, fn):
        def wrapper(*a, **k):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = fn(*a, **k)
            e.record()
            events[name].append((s, e))
            return out
        return wrapper

    names = ("admit_commit", "complete") if shards == 1 else \
        ("admit_commit_sharded", "complete_sharded")
    originals = [getattr(ops, n) for n in names]
    tick = loop.tick
    if timed:
        for n, part, fn in zip(names, ("admit", "complete"), originals):
            setattr(ops, n, timed_call(part, fn))
        tick = timed_call("tick", loop.tick)
    for k in ops.LAUNCHES:
        ops.LAUNCHES[k] = 0
    nxt = 0
    sync(torch, dev)
    t0 = time.perf_counter()
    try:
        while (nxt < len(reqs) or loop.n_queued or loop.inflight) \
                and loop.ticks < 2000:
            for r in reqs[nxt:nxt + ARRIVALS_PER_TICK]:
                loop.submit(r)
            nxt += ARRIVALS_PER_TICK
            tick()
        sync(torch, dev)
        wall = time.perf_counter() - t0
    finally:
        for n, fn in zip(names, originals):
            setattr(ops, n, fn)
    launches = {k: ops.LAUNCHES[k] for k in ("admit", "admit_commit",
                                             "complete", "route_match",
                                             "decode_attention")}
    check(len(loop.done) == len(reqs),
          f"sharded drain (M={shards}, {dev}): {len(loop.done)} of "
          f"{len(reqs)} requests completed")
    check(not bool(loop.routing.ep_load.any())
          and not bool(loop.state.pool.active.any()),
          f"sharded drain (M={shards}, {dev}): not drained")
    lists = lambda t: {f: getattr(t, f).tolist() for f in t._fields}  # noqa
    record = {
        "done": [(r.req_id, r.retries, r.submit_tick, r.admit_tick,
                  r.done_tick) for r in loop.done],
        "tokens": [r.tokens for r in loop.done],
        "dropped": [r.req_id for r in loop.dropped],
        "ticks": loop.ticks, "held_first": loop.held_first,
        "routing": lists(loop.routing), "metrics": lists(loop.state.metrics),
        "pool": {f: v for f, v in lists(loop.state.pool).items()
                 if f != "token"}}
    med = {k: statistics.median(s.elapsed_time(e) for s, e in v)
           for k, v in events.items() if v}
    return record, dict(wall=wall, med=med, arrival_ticks=len(
        events["admit"])), launches


def phase_sharded(torch, RT, B, ops, interpose, SL, TM, MS, SA, policies,
                  cfg, b3_ms, dev="cuda"):
    """Sharded admission and completion (``kernels/shard_admit.py``) on the
    card at each M of SHARDS: ``ops.admit_commit_sharded`` at the serving
    shape, a ragged batch and with an idle ingress host (a quarter of
    padding rows), and ``ops.complete_sharded`` at the serving shape, each
    bit-exact against the unsharded wrapper on the same card tensors and
    against the sharded plain versions on the CPU, timed; then a drain of
    ENGINE_REQUESTS requests through ServeLoop over Engine(shards=4) on
    the card against shards=1 on the card and shards=4 on the CPU (every
    count, tick and routing bit; the tokens too between the card runs)."""
    dev = torch.device(dev)
    routing0, _ = routing_config(RT, "cpu")
    lines, timing = [], {}
    cases = [("serving", ADMIT_R, I_LANES, SLOTS), ("ragged", 300, 8, 4),
             ("idle", ADMIT_R, I_LANES, SLOTS)]
    for label, R, I, C in cases:
        routing, reqs, pool, rnd, gum = admit_inputs(
            torch, RT, routing0, R, I, C, seed=R, dev=dev)
        if label == "idle":                 # shard 1 of 4 holds padding only
            reqs[0] = reqs[0].clone()
            reqs[0][R // 4:R // 2] = -1
        batch, pstate = B.RequestBatch(*reqs), B.PoolState(*pool)
        unsharded = lambda: ops.admit_commit(  # noqa: E731
            batch, routing, pstate, rnd, gum)
        want = unsharded()
        unsharded_ms = cuda_ms(torch, unsharded)
        cargs = (B.RequestBatch(*[t.cpu() for t in reqs]), routing.to("cpu"),
                 B.PoolState(*[t.cpu() for t in pool]), rnd.cpu(), gum.cpu())
        for M in SHARDS:
            mesh = MS.make_shard_mesh(M, device=dev)
            live = SA.live_shards(reqs[0], M)
            call = lambda: ops.admit_commit_sharded(  # noqa: E731
                batch, routing, pstate, rnd, gum, mesh=mesh, live=live)
            n0 = dict(ops.LAUNCHES)
            got = call()
            sync(torch, dev)
            n = {k: ops.LAUNCHES[k] - n0[k] for k in n0}
            check(n["admit"] == sum(live) and n["route_match"] == 1
                  and n["admit_commit"] == 0,
                  f"sharded admit[{label} M={M}]: launches {n}, "
                  f"live shards {live}")
            check(label != "idle" or M != 4 or live == [True, False, True,
                                                        True],
                  f"sharded admit[idle M=4]: live shards {live}")
            err = max_abs_err(torch, out_pairs(got, want))
            cpu = ops.admit_commit_sharded(
                *cargs, mesh=MS.make_shard_mesh(M, device="cpu"))
            err_cpu = max_abs_err(torch, out_pairs(to_cpu(got), cpu))
            line = (f"sharded admit_commit[{label} R={R} I={I} C={C} M={M}] "
                    f"max_abs_err={err} vs admit_commit on the card, "
                    f"{err_cpu} vs the CPU; launches admit={n['admit']} "
                    f"route_match={n['route_match']}; ok={int(got.ok.sum())}"
                    f" held={int(got.held)} no_route={int(got.no_route)}")
            if label != "idle":
                prof = profile_calls(torch, call)
                b3 = kernel_time(prof, "admit_kernel")[0]
                b4 = kernel_time(prof, "route_kernel")[0]
                check(b3 is not None and b4 is not None,
                      f"sharded admit[{label} M={M}]: the profiler saw no "
                      "admission or route kernel")
                t = dict(call_ms=cuda_ms(torch, call),
                         b3_ms=b3 / sum(live), b4_ms=b4)
                timing[f"admit[{label},M={M}]"] = t
                line += (f"; call ms {t['call_ms']:.4f} (unsharded "
                         f"{unsharded_ms:.4f}), B3 device ms per "
                         f"launch at width R/M = {-(-R // M)}: "
                         f"{t['b3_ms']:.5f}, B4 {b4:.5f}")
            lines.append(line)
    lines.append(
        "sharded B3 in its all-free mode (no mask staged), device ms per "
        "launch at width R/M = " + " / ".join(
            f"{-(-ADMIT_R // M)}: {timing[f'admit[serving,M={M}]']['b3_ms']:.5f}"
            for M in SHARDS) + " (with the staged mask, PERF.md §5: "
        + " / ".join(str(B3_STAGED_MS[M]) for M in SHARDS) + ")")

    # F4: at I_LANES lanes and R/M = 1024 the staged all-free mask passed
    # the shared memory a block may have, and the sharded admission raised
    routing, reqs, pool, rnd, gum = admit_inputs(
        torch, RT, routing0, F4_R, I_LANES, SLOTS, seed=F4_R, dev=dev)
    batch, pstate = B.RequestBatch(*reqs), B.PoolState(*pool)
    mesh = MS.make_shard_mesh(F4_M, device=dev)
    call = lambda: ops.admit_commit_sharded(  # noqa: E731
        batch, routing, pstate, rnd, gum, mesh=mesh)
    n0 = dict(ops.LAUNCHES)
    got = call()
    sync(torch, dev)
    n = {k: ops.LAUNCHES[k] - n0[k] for k in n0}
    check(n["admit"] == F4_M, f"sharded F4: launches {n}")
    err = max_abs_err(torch, out_pairs(
        got, ops.admit_commit(batch, routing, pstate, rnd, gum)))
    b3 = kernel_time(profile_calls(torch, call), "admit_kernel")[0]
    check(b3 is not None, "sharded F4: the profiler saw no admission kernel")
    timing["admit[F4]"] = dict(call_ms=cuda_ms(torch, call), b3_ms=b3 / F4_M)
    lines.append(
        f"sharded F4: admit_commit_sharded[I={I_LANES} R={F4_R} M={F4_M}, "
        f"B3 all-free at W={F4_R // F4_M}] max_abs_err={err} vs "
        f"admit_commit on the card; ok={int(got.ok.sum())} "
        f"held={int(got.held)}; call ms {timing['admit[F4]']['call_ms']:.4f}"
        f", B3 device ms per launch {timing['admit[F4]']['b3_ms']:.5f}")

    args = complete_inputs(torch, RT, dev)
    pstate = B.PoolState(*args[:6])
    want = ops.complete(pstate, *args[6:], eos=1, max_len=MAX_LEN)
    cpu_args = [t.cpu() for t in args]
    for M in SHARDS:
        mesh = MS.make_shard_mesh(M, device=dev)
        call = lambda: ops.complete_sharded(  # noqa: E731
            pstate, *args[6:], mesh=mesh, eos=1, max_len=MAX_LEN)
        n0 = ops.LAUNCHES["complete"]
        got = call()
        sync(torch, dev)
        check(ops.LAUNCHES["complete"] - n0 == M,
              f"sharded complete M={M}: {ops.LAUNCHES['complete'] - n0} "
              "launches")
        err = max_abs_err(torch, out_pairs(got, want))
        cpu = ops.complete_sharded(
            B.PoolState(*cpu_args[:6]), *cpu_args[6:],
            mesh=MS.make_shard_mesh(M, device="cpu"), eos=1, max_len=MAX_LEN)
        err_cpu = max_abs_err(torch, out_pairs(to_cpu(got), cpu))
        b1 = kernel_time(profile_calls(torch, call), "complete_kernel")[0]
        check(b1 is not None, f"sharded complete M={M}: no kernel seen")
        t = dict(call_ms=cuda_ms(torch, call), b1_ms=b1 / M)
        timing[f"complete[M={M}]"] = t
        lines.append(
            f"sharded complete[I={I_LANES} C={SLOTS} M={M}] max_abs_err="
            f"{err} vs complete on the card (EWMAs included), {err_cpu} vs "
            f"the CPU; done={int(got.done.sum())}; call ms "
            f"{t['call_ms']:.4f}, B1 device ms per launch at "
            f"({I_LANES // M}, {SLOTS}): {t['b1_ms']:.5f}")

    run = lambda d, m, timed=False: sharded_drain(  # noqa: E731
        torch, RT, TM, interpose, SL, MS, policies, ops, cfg, d, m, timed)
    one, t1, _ = run(dev, 1, True)
    four, t4, launches = run(dev, 4, True)
    four_cpu, _, _ = run(torch.device("cpu"), 4)
    check(four == one, "sharded drain: shards=4 on the card differs from "
          "shards=1 on the card")
    untok = lambda r: {k: v for k, v in r.items() if k != "tokens"}  # noqa
    check(untok(four) == untok(four_cpu), "sharded drain: shards=4 on the "
          "card differs from shards=4 on the CPU")
    check(min(launches[k] for k in ("admit", "complete", "route_match")) > 0
          and launches["admit_commit"] == 0,
          f"sharded drain: kernels not launched as the sharded path does: "
          f"{launches}")
    arr = t4["arrival_ticks"]
    n_req = ENGINE_REQUESTS
    for M, rec, t in ((1, one, t1), (4, four, t4)):
        med = t["med"]
        lines.append(
            f"sharded drain M={M}: {n_req} requests in {rec['ticks']} ticks, "
            f"{t['wall']:.3f} s = {n_req / t['wall']:.1f} req/s; median ms "
            f"per tick {med['tick']:.4f}, admit {med['admit']:.4f}, complete "
            f"{med['complete']:.4f} (events); held_first "
            f"{rec['held_first']}")
    lines.append(
        f"sharded drain: shards=4 equals shards=1 on the card (every count, "
        f"tick, token and routing bit) and shards=4 on the CPU; launches "
        f"per arrival tick ({arr} of {four['ticks']}): B3 "
        f"{launches['admit'] / arr:.3f}, B4 {launches['route_match'] / arr:.3f};"
        f" B1 per tick {launches['complete'] / four['ticks']:.3f}; B3 at the "
        f"serving shape unsharded (width C = {SLOTS}): {b3_ms}")
    return lines, timing, {k: launches[k] for k in ("admit", "complete",
                                                    "route_match")}


# --------------------------------------------------------------------------- #
# phase 5, continued: the chain of services
# --------------------------------------------------------------------------- #


def chain_ops(W):
    """The live-ops leg's operations: the reference chain bench's (a canary
    at hop 1 on instance 1 at 75 % at tick 6; hop 2 scaled to half its
    fleet at tick 10 and back at 16), its 2 lanes scaled to I_LANES."""
    return [W.Op(6, "canary", hop=1, args={"instance": 1, "pct": 75.0}),
            W.Op(10, "scale", hop=2, args={"target": I_LANES // 2}),
            W.Op(16, "scale", hop=2, args={"target": I_LANES})]


def chain_run(torch, W, HP, RT, interpose, policies, cfg, params, dev, mode,
              shards=1, live=False):
    """One depth-CHAIN_DEPTH chain through ``HP.run_chain_scenario`` on
    ``dev``: every hop the full-width serving model over I_LANES lanes x
    SLOTS slots behind ``HP.build_cp(I_LANES)`` (one least-request
    cluster; weighted in the live-ops leg), admit batch ADMIT_R, Poisson
    arrivals at the main path's rate, eos -1.  Each xlb engine draws from
    its own seeded CPU generator, so the card and the CPU runs draw the
    same bits.  Returns (row, tick records, timing)."""
    seeds = iter(range(1000))
    post = interpose.Engine.__post_init__

    def seeded(self):
        post(self)
        self.draws = host_draws(torch, policies, self.device,
                                CHAIN_SEED + next(seeds))

    stamps, busy = [], [0, 0.0]
    plain_busy = HP.Service.busy

    def timed_busy(self):
        t = time.perf_counter()
        v = plain_busy.fget(self)
        busy[0] += 1
        busy[1] += time.perf_counter() - t
        return v

    interpose.Engine.__post_init__ = seeded
    HP.Service.busy = property(timed_busy)
    try:
        out = HP.run_chain_scenario(
            mode, depth=CHAIN_DEPTH, workload=W.Workload(
                W.PoissonArrivals(rate=CHAIN_RATE, seed=CHAIN_SEED),
                n_requests=CHAIN_REQUESTS, vocab=cfg.vocab),
            ops=chain_ops(W) if live else None,
            label="chain_liveops" if live else "chain",
            n_instances=I_LANES, slots=SLOTS, tokens_per_req=CHAIN_TOKENS,
            admit_batch=ADMIT_R, policy=(RT.POLICY_WEIGHTED if live else
                                         RT.POLICY_LEAST_REQUEST),
            shards=shards, cfg=cfg, params=params, device=dev,
            on_tick=lambda t: stamps.append(time.perf_counter()))
    finally:
        interpose.Engine.__post_init__ = post
        HP.Service.busy = plain_busy
    res, row = out["result"], out["row"]
    check(row["completed"] == row["n_requests"] == CHAIN_REQUESTS
          and row["dropped"] == 0,
          f"chain {mode} (shards {shards}, live {live}, {dev}): "
          f"{row['completed']} of {row['n_requests']} completed, "
          f"{row['dropped']} dropped")
    for k, h in enumerate(out["hops"]):
        check(not bool(torch.as_tensor(h.routing.ep_load).any()),
              f"chain {mode} ({dev}): ep_load of hop {k} not back to zero")
    record = {f: getattr(res, f) for f in (
        "completed", "dropped", "ticks", "submit_tick", "done_tick",
        "hop_submit", "hop_done", "n_submitted")}
    gaps = [1e3 * (b - a) for a, b in zip(stamps, stamps[1:])]
    return row, record, dict(wall=res.wall_s,
                             tick_ms=statistics.median(gaps),
                             busy_calls=busy[0], busy_s=busy[1])


def phase_chain(torch, W, HP, RT, interpose, policies, cfg, dev="cuda"):
    """The chained-service path (``workload/hops.py`` + ``workload/
    chain.py``): the depth-CHAIN_DEPTH chain on istio, cilium and xlb,
    xlb with shards=2, and the xlb live-ops leg, each on the card and again
    on the CPU, where every count and tick must be equal; the reference's
    chain gate (xlb's p99 at most each sidecar's)."""
    dev = torch.device(dev)
    params = model_params(torch, cfg, dev)
    cpu_params = _to(torch, params, torch.device("cpu"))
    run = lambda d, p, mode, **kw: chain_run(  # noqa: E731
        torch, W, HP, RT, interpose, policies, cfg, p, d, mode, **kw)
    lines, rows = [], {}
    for mode, kw in (("istio", {}), ("cilium", {}), ("xlb", {}),
                     ("xlb shards=2", dict(shards=2)),
                     ("xlb live-ops", dict(live=True))):
        kind = mode.split()[0]
        row, rec, t = run(dev, params, kind, **kw)
        cpu_row, cpu_rec, _ = run(torch.device("cpu"), cpu_params, kind,
                                  **kw)
        check(json.dumps(row) == json.dumps(cpu_row) and rec == cpu_rec,
              f"chain {mode}: the card's row or tick records differ from "
              f"the CPU's: {row} vs {cpu_row}")
        rows[mode] = (row, rec)
        busy = (f"; busy {1e3 * t['busy_s'] / t['busy_calls']:.4f} ms a "
                f"read ({t['busy_calls']} reads)" if kind == "xlb" else "")
        lines.append(
            f"chain {mode}: {row['completed']} requests through "
            f"{CHAIN_DEPTH} hops ({I_LANES} x {SLOTS} each) in "
            f"{row['ticks']} ticks, {t['wall']:.3f} s = "
            f"{row['completed'] / t['wall']:.1f} req/s; median global tick "
            f"{t['tick_ms']:.4f} ms (host clock); p50 / p99 "
            f"{row['p50_ticks']} / {row['p99_ticks']} ticks, per hop p99 "
            f"{row['per_hop_p99_ticks']}; txns {row['txns']}{busy}; equal "
            "to the CPU run in every count and tick")
    flat, sharded = rows["xlb"], rows["xlb shards=2"]
    srow = dict(sharded[0])
    check(srow.pop("shards", None) == 2
          and json.dumps(srow) == json.dumps(flat[0])
          and sharded[1] == flat[1],
          "chain: xlb shards=2 differs from the unsharded xlb chain")
    check(rows["xlb live-ops"][0]["txns"] == 3,
          f"chain live-ops: {rows['xlb live-ops'][0]['txns']} transactions")
    p99 = {m: rows[m][0]["p99_ticks"] for m in ("istio", "cilium", "xlb")}
    check(p99["xlb"] <= p99["istio"] and p99["xlb"] <= p99["cilium"],
          f"chain gate: xlb p99 {p99['xlb']} above a sidecar's {p99}")
    lines.append(f"chain gate: depth {CHAIN_DEPTH} p99 ticks " + " ".join(
        f"{m}={v}" for m, v in p99.items()) + "; xlb shards=2 equals "
        "unsharded xlb in every count and tick")
    return lines


def model_params(torch, cfg, dev):
    """``cfg``'s weights from a generator on ``dev`` seeded with 0, in
    f32."""
    from repro_torch.models import model as TM
    return TM.init_params(cfg, torch.Generator(dev).manual_seed(0),
                          torch.float32, dev)


# --------------------------------------------------------------------------- #
# phase 6b: serve --arch at full width
# --------------------------------------------------------------------------- #


def phase_serve_arch(torch, serve):
    """``serve.main(["--arch", a, "--device", "cuda"])`` for each arch the
    port serves, at full width (free the earlier phases' models first:
    minitron-4b in f32 is about 16 GB); an arch whose family is not ported
    must raise NotImplementedError."""
    import contextlib
    import gc
    import io
    lines = []
    for arch in SERVE_ARCHS:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            n = serve.main(["--arch", arch, "--device", "cuda"])
        wall = time.perf_counter() - t0
        check(n == 32, f"serve --arch {arch}: {n} of 32 requests")
        first = buf.getvalue().splitlines()[0]
        lines.append(f"serve --arch {arch}: {first}; main() {wall:.2f} s "
                     "with the weights' init; peak memory "
                     f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    try:
        serve.main(["--arch", "granite-20b", "--device", "cuda"])
        fail("serve --arch granite-20b did not raise")
    except NotImplementedError as e:
        lines.append(f"serve --arch granite-20b: NotImplementedError ({e})")
    gc.collect()
    torch.cuda.empty_cache()
    return lines


# --------------------------------------------------------------------------- #
# phase 9: the analysis gate with the kernels' bounds check
# --------------------------------------------------------------------------- #


def sanitizer_attaches(path: str) -> tuple[bool, str]:
    """Whether compute-sanitizer can instrument a CUDA program here: a
    one-line torch program under memcheck must run clean."""
    probe = [path, "--tool", "memcheck", sys.executable, "-c",
             "import torch; print(torch.ones(4, device='cuda').sum().item())"]
    try:
        p = subprocess.run(probe, capture_output=True, text=True, timeout=240)
    except subprocess.TimeoutExpired:
        return False, "the probe timed out"
    out = p.stdout + p.stderr
    ok = p.returncode == 0 and "ERROR SUMMARY: 0 errors" in out
    return ok, (out.strip().splitlines() or [""])[-1]


def phase_analysis(torch):
    """``python -m repro_torch.analysis`` with its kernels section, in a
    subprocess: under compute-sanitizer's memcheck and racecheck where the
    sanitizer can attach to the card, else against the kernels'
    bounds-checking build.  It must exit 0."""
    import os
    import shutil
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    gate = [sys.executable, "-m", "repro_torch.analysis", "--report"]
    path = shutil.which("compute-sanitizer")
    runs = []
    if path:
        ok, why = sanitizer_attaches(path)
        if ok:
            runs = [("compute-sanitizer memcheck", [
                path, "--tool", "memcheck", *gate, "--kernel-build",
                "plain"]), ("compute-sanitizer racecheck", [
                    path, "--tool", "racecheck", *gate, "--kernel-build",
                    "plain"])]
        tool = (f"compute-sanitizer is on PATH ({path}) but "
                + ("attaches" if ok else f"cannot attach here ({why})"))
    else:
        tool = "compute-sanitizer is not on PATH"
    if not runs:
        runs = [("the bounds-checking build (-DXLB_BOUNDS_CHECK)", gate)]
    lines = [f"analysis: {tool}; the kernels section runs under {runs[0][0]}"
             + (" and racecheck" if len(runs) > 1 else "")]
    for name, cmd in runs:
        t0 = time.perf_counter()
        p = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                           text=True, timeout=900)
        wall = time.perf_counter() - t0
        out = p.stdout + p.stderr
        OUT.mkdir(exist_ok=True)
        (OUT / f"analysis_{len(lines)}.txt").write_text(out)
        summary = [ln for ln in out.splitlines()
                   if "ERROR SUMMARY" in ln or ln.startswith(("[", "verif",
                                                              "FAIL"))]
        check(p.returncode == 0, f"analysis under {name}: exit "
              f"{p.returncode}: " + " | ".join(summary[-12:]))
        if name.startswith("compute-sanitizer"):
            check("ERROR SUMMARY: 0 errors" in out,
                  f"analysis under {name}: " + " | ".join(summary[-3:]))
        lines.append(f"analysis under {name}: exit 0 in {wall:.1f} s "
                     "(build included); " + " | ".join(summary))
    return lines


# --------------------------------------------------------------------------- #


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        fail("torch finds no CUDA device")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail("src/repro_torch not found beside chip_smoke.py")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import configs
    from repro_torch.configs import XLB_SERVICE_MODEL as cfg
    from repro_torch.core import balancer as B
    from repro_torch.core import control as CT
    from repro_torch.core import interpose, policies, request_map, router
    from repro_torch.core import policy_defs as PD
    from repro_torch.core import routing_table as RT
    from repro_torch.kernels import _build, ops
    from repro_torch.configs import get_config
    from repro_torch.kernels import completion as cp
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import relay_dispatch as rs
    from repro_torch.kernels import route_match as rm
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.launch import prefill_decode as PDL
    from repro_torch.models import model as TM
    from repro_torch.runtime import serve_loop as SL
    from repro_torch.runtime import transport as TR
    from repro_torch import workload as W
    from repro_torch.analysis import invariants as INV
    from repro_torch.core import health as H
    from repro_torch.kernels import shard_admit as SA
    from repro_torch.launch import mesh as MS
    from repro_torch.launch import serve
    from repro_torch.workload import hops as HP

    gpu = gpu_line()
    print(gpu)
    t0 = time.perf_counter()
    lib = _build.library(torch.device("cuda"))
    OUT.mkdir(exist_ok=True)
    (OUT / "build_log.txt").write_text(_build.build_log)
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc "
          f"{_build.build_seconds:.1f} s), log in chiprun_out/build_log.txt")

    rows, timing = phase_kernels(torch, RT, PD, ops, rm, rs, cp, B, lib)
    frows, ftiming = phase_float_kernels(torch, ops, da, fa, ssd)
    for t in ftiming.values():
        t["floor_ms"], t["issue_ms"] = timing["complete"]["floor_ms"], \
            timing["complete"]["issue_ms"]
    timing.update(ftiming)
    for row in rows + frows:
        print("kernel " + row)
    err = phase_model(torch, cfg, TM)
    print(f"model: decode on the card vs the CPU max_abs_err={err:.3g} "
          "(rtol=atol=1e-4)")

    line, prof, launches = phase_serve(torch, RT, ops, TM, interpose, SL,
                                       cfg)
    print(line)
    print(prof)
    main_launches = {k: launches[k] for k in ("admit_commit", "complete",
                                              "decode_attention")}
    line, staged_launches = phase_staged(torch, RT, ops, B,
                                         (router, policies, request_map))
    print(line)
    for line in phase_engines(torch, RT, TM, B, SL, cfg):
        print(line)
    line, ctiming, control_launches, control_tick_ms = phase_control(
        torch, RT, CT, TM, interpose, SL, ops, cfg)
    print(line)
    print(ctiming)
    line, dtiming, degraded_launches = phase_degraded(
        torch, RT, CT, TM, interpose, SL, H, W, policies, ops, cfg)
    print(line)
    print(dtiming)
    line, xtiming, chaos_launches = phase_chaos(
        torch, RT, CT, TM, interpose, SL, TR, W, policies, ops, cfg,
        control_tick_ms)
    print(line)
    print(xtiming)
    line, sanitize_launches = phase_sanitize(torch, RT, TM, interpose, SL,
                                             INV, policies, ops, cfg)
    print(line)
    slines, stiming, sharded_launches = phase_sharded(
        torch, RT, B, ops, interpose, SL, TM, MS, SA, policies, cfg,
        timing["admit"]["ms"])
    for line in slines:
        print(line)
    for line in phase_chain(torch, W, HP, RT, interpose, policies, cfg):
        print(line)
    llm_launches, prefill_kernels = {}, {}
    for arch in ("minitron-4b", "mamba2-2.7b"):
        line, got, names = phase_llm(torch, ops, TM, PDL, get_config(arch))
        print(line)
        llm_launches.update(got)
        prefill_kernels[arch] = names
    for line in phase_smoke_configs(torch, ops, TM, PDL, configs):
        print(line)
    for line in phase_serve_arch(torch, serve):
        print(line)
    launches = {**main_launches, **staged_launches, **llm_launches}
    for k, v in sharded_launches.items():       # the sharded drain's
        launches[k] += v
    print("kernels: " + " ".join(
        f"{k}={v}" for k, v in {**launches, "decode_attention[xlb]":
                                main_launches["decode_attention"]}.items())
          + " (admit_commit, complete and decode_attention[xlb] on the main "
          "path; route_match, relay_slots and admit in the staged phase, "
          "and admit, complete and route_match in the sharded drain too; "
          "flash_attention and decode_attention in minitron-4b's, ssd_scan "
          "in mamba2-2.7b's); " + "; ".join(
              f"in the {name} phase: " + " ".join(
                  f"{k}={v}" for k, v in got.items())
              for name, got in (("control", control_launches),
                                ("degraded", degraded_launches),
                                ("chaos", chaos_launches),
                                ("sanitizer", sanitize_launches),
                                ("sharded drain", sharded_launches))))

    src = "src/repro_torch/kernels/csrc/"
    meta = {"admit_commit": (src + "admit.cu",
                             "src/repro/kernels/route_match.py:245"),
            "admit": (src + "admit.cu",
                      "src/repro/kernels/route_match.py:245"),
            "complete": (src + "complete.cu",
                         "src/repro/kernels/completion.py:100"),
            "route_match": (src + "route.cu",
                            "src/repro/kernels/route_match.py:170"),
            "relay_slots": (src + "relay.cu",
                            "src/repro/kernels/relay_dispatch.py:28"),
            "decode_attention": (src + "decode_attention.cu",
                                 "src/repro/kernels/decode_attention.py:32"),
            "flash_attention": (src + "flash_attention.cu",
                                "src/repro/kernels/flash_attention.py:34"),
            "ssd_scan": (src + "ssd_scan.cu",
                         "src/repro/kernels/ssd_scan.py:28")}
    kernels = []
    for name, t in timing.items():
        bound, t_bytes, t_ops = bound_ms(t)
        # device time from the profiler; the event-timed call where the
        # profiler saw no kernel
        ms = t["ms"] if t["ms"] is not None else t["call_ms"]
        print(f"timing {name}: device ms {t['ms']}"
              + (f" ({t['kernel']})" if t.get("kernel") else "")
              + f", call ms {t['call_ms']}, plain ms {t['plain_ms']}, "
              f"library ms {t.get('library_ms')} (device "
              f"{t.get('library_device_ms')}), "
              f"bound ms {bound} ({t['bytes']} B, {t['ops']} operations), "
              f"launch floor ms {t['floor_ms']} (device) / {t['issue_ms']} "
              f"(issue interval), on {gpu}")
        if name in meta:            # each kernel at its path's shape
            source, replaces = meta[name]
            kernels.append({
                "name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": t["err"], "ms": ms,
                "plain_ms": t["plain_ms"], "bound_ms": bound,
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": t.get("library_ms"),
                "library_device_ms": t.get("library_device_ms"),
                "launch_floor_ms": t["floor_ms"]})
            if name == "decode_attention":
                kernels[-1]["kernel"] = t["kernel"]
                kernels[-1]["launches_xlb_main_path"] = \
                    main_launches["decode_attention"]
                xlb = timing["decode_attention[xlb]"]
                kernels[-1]["xlb_shape"] = {
                    k: xlb[k] for k in ("ms", "kernel", "library_ms",
                                        "library_device_ms")}
            if name in sharded_launches:       # and in the sharded drain
                key, part = {"admit": ("admit[serving,M={}]", "b3_ms"),
                             "route_match": ("admit[serving,M={}]", "b4_ms"),
                             "complete": ("complete[M={}]", "b1_ms")}[name]
                kernels[-1]["launches_sharded_drain"] = \
                    sharded_launches[name]
                kernels[-1]["sharded_ms"] = {
                    str(M): stiming[key.format(M)][part] for M in SHARDS}
            if name == "flash_attention":      # as minitron's prefill ran it
                kernels[-1]["kernel"] = prefill_kernels["minitron-4b"]
            if name == "ssd_scan":             # as mamba's prefill ran it
                kernels[-1]["kernel"] = prefill_kernels["mamba2-2.7b"]
                kernels[-1]["passes_ms"] = t["passes"]
    for name, label in (("admit_commit", "B2"), ("admit", "B3")):
        t = timing[name]
        print(f"admit redesign: {label} {name} device ms {t['ms']} at the "
              f"serving shape (R {ADMIT_R}, {I_LANES} x {SLOTS} pool, six "
              f"policies; before the redesign: {ADMIT_BEFORE_MS[name]}), "
              f"bound ms {bound_ms(t)[0]}, launch floor ms {t['floor_ms']}, "
              f"call ms {t['call_ms']}, on {gpu}")
    for R in (ADMIT_R, 4096):
        t = timing["route_match" if R == ADMIT_R else f"route_match[R={R}]"]
        print(f"route redesign: B4 route_match[R={R}] device ms {t['ms']} "
              f"(before the redesign: {ROUTE_BEFORE_MS[R]}), bound ms "
              f"{bound_ms(t)[0]}, launch floor ms {t['floor_ms']}, call ms "
              f"{t['call_ms']}, on {gpu}")
    t = timing["complete"]
    print(f"complete redesign: B1 complete device ms {t['ms']} at the "
          f"serving shape ({I_LANES} x {SLOTS} cells; before the redesign: "
          f"{COMPLETE_BEFORE_MS}), bound ms {bound_ms(t)[0]}, launch floor "
          f"ms {t['floor_ms']}, call ms {t['call_ms']}, on {gpu}")
    for t in timing.values():
        if "shape" in t:
            N, nd = t["shape"]
            print(f"relay redesign: B5 relay_slots[N={N},n_dest={nd}] device "
                  f"ms {t['ms']} (before the redesign: "
                  f"{RELAY_BEFORE_MS[N, nd]}), bound "
                  f"ms {bound_ms(t)[0]}, launch floor ms {t['floor_ms']}, "
                  f"call ms {t['call_ms']}, on {gpu}")
    for line in phase_analysis(torch):
        print(line)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port of the XLB serving datapath on one
NVIDIA GPU: ``python3 chip_smoke.py`` from the root of a checkout.

Phases (each prints one line; any failure exits non-zero):

1. the card's name and power limit (nvidia-smi) and the kernel build;
   then the autotuner (``kernels/tune.py``): ``plan_admit`` swept on the
   card at the serving shape (R 256 over 64 x 16: tiles 64 and 256), at R
   4096 (64, 256, 1024) and at R 128, each candidate's device ms, the plan
   and the candidates dropped; B2 and B3 in each mode (commit, masked,
   all-free) at each tile against the plain version at the same block_r,
   on a batch whose affinity cache differs between tiles (two flows, each
   in two AFFINITY clusters); each tile's device ms at R 256 and 4096; the
   pins (XLB_BLOCK_R, XLB_AUTOTUNE=0) obeyed.  Every later timed window
   starts after its shape's sweep, and every CPU leg of a card-against-CPU
   comparison plans as the card did (``cpu_plans``);
2. each kernel, called through its public wrapper in ``kernels/ops.py``,
   against its plain PyTorch version on the same card tensors, bit-exact
   on every integer output and both f32 EWMAs: ``admit_commit`` and ``admit``
   over all six policies, drains, held rows and a ragged batch, at the
   serving shape and a small pool; ``complete`` with warm EWMAs;
   ``route_match`` at R = 256 and 4096; ``relay_slots`` at the staged
   chain's shapes, at N = 4096, at a ragged N, with 4096 rows on one
   destination and at the MoE prefills' shapes (2 x 4096 tokens, top-k
   of the experts: arctic-480b N 16384 over 128, deepseek-v2-236b 49152
   over 160, jamba-v0.1-52b 16384 over 16); plus the decode model on
   the card against the CPU within rtol = atol = 1e-4;
3. the main path: ``ServeLoop`` over the port's ``Engine`` at the full
   width of ``xlb-service-model`` with 64 instance lanes x 16 slots (1024
   concurrent connections), admit batches of 256, ``max_len`` 32, one
   cluster per policy plus a 50-endpoint cluster, several thousand
   requests drained to completion through ``make_jitted``'s captured tick
   (two CUDA graphs: the arrival tick and the decode-only tick), each
   tick timed with CUDA events; then a separate pass under torch.profiler
   for the device's busy share, where the launches ``ops.LAUNCHES``
   counts from the graph replays must equal the profiler's count of the
   B2, B1 and B6 kernels; the same through the eager tick
   (``Engine.eager_step``), whose parts (admit, decode, complete) are
   timed by patching their wrappers; then AB_PAIRS alternating pairs of
   AB_REQUESTS-request drains, captured against eager, each pair
   bit-equal (every completion, tick, token, routing counter, EWMA,
   metric and pool cell), with req/s, the median tick and the device's
   idle share of each side, and one pair with a commit and a slow lane
   midway, bit-equal too;
4. the staged admission chain (match_cluster → select → allocate_slots →
   scatter_to_pool, through the route and relay kernels) on the card at
   the main path's shape, against the same chain on the CPU with the same
   draws, timed beside the fused admission kernel;
5. the same traffic through ``ServeLoop`` over the XLB engine and the
   Istio and Cilium sidecar baselines, each captured (the XLB tick's two
   graphs; a decode graph a KV cache for the sidecars: one per instance
   for Istio, one for Cilium), as the reference jits all three:
   requests/s, median tick and the device's busy share of each, in this
   one run; then the control plane:
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
   - sanitizer: the main path's traffic with ``XLB_SANITIZE=1`` through
     the sanitizing captured tick (the admit and complete laws inside the
     graphs, one read of their verdicts a tick, the loop law on the
     host), unsharded and at 4 shards of a one-process mesh: no law
     fires and each run equals its plain captured run; a planted
     off-by-one release through the eager guard and a leak planted in
     the admission's output that fires only from a replay must each
     raise naming its law, the leak leaving the loop's state as it was;
     3 alternating pairs of 1024-request drains, the captured sanitized
     tick against the eager one, bit-equal to each other and to the
     plain captured tick's drain, with one profiled pass a side;
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
   ``Engine(shards=4)`` through the captured sharded tick (one CUDA graph
   a set of live shards), equal to its eager tick, to shards=1 on the
   card and to shards=4 on the CPU in every count, tick and routing bit,
   and at shards=2 equal to shards=1, timed beside the unsharded drain,
   with the B1, B3, B4 and B5 launches per tick; at M = 2 and 4,
   SHARD_AB_PAIRS alternating pairs of AB_REQUESTS-request drains,
   captured against eager, each pair bit-equal, with each side's device
   idle share and replayed launches against the profiler; then
   the same datapath across processes, one rank a shard: two NCCL ranks
   on this card first (a probe: NCCL refuses two ranks on one device), then
   four spawned ``gloo`` processes on this card (``rank_worker``; a
   FileStore under build/, the group's 120-s timeout), at M = 2 (the
   first two, a subgroup) and then M = 4 (RANK_WIDTHS), each rank on its
   ``RankShardMesh``: ``ops.admit_commit_sharded`` on its rows
   of the serving batch, a ragged batch and one whose rank 1 holds only
   padding (an idle ingress host), ``ops.complete_sharded`` on its pool
   slice, and ENGINE_REQUESTS requests through ``ServeLoop`` over
   ``Engine(shards=M)`` (its lanes' decode through B6); rank 0 gathers
   the results, and each is held bit-exact against the one-process mesh at
   M and the unsharded run on the card (the drain: every count, tick,
   routing bit, metric and pool cell; its tokens compared and counted);
   per rank its B3, B4, B5, B1 and B6 launches (and the profiler's count of
   them), ms a call and ms a tick; the run fails unless gloo takes CUDA
   tensors for the three collectives the mesh calls, and where a rank
   raises, fails a check or outlives RANK_TIMEOUT; then
   the chained-service path (``workload/hops.py``, ``workload/chain.py``): a
   depth-3 chain of the full-width serving model (64 x 16 a hop, one
   least-request cluster, admit batch 256, 512 Poisson requests at the
   main path's rate) on istio, cilium and xlb, xlb with shards=2 and an
   xlb live-ops leg (the reference chain bench's canary and scale ops,
   weighted), each equal to its CPU run in every count and tick, every
   request complete and ``ep_load`` zero on every hop, xlb's p99 at most
   each sidecar's and shards=2 equal to the unsharded row;
6. the model stack at full width in bf16, with weights from a CUDA
   generator: minitron-4b, granite-20b (MQA, G = 48), internlm2-20b,
   yi-34b and chameleon-34b (vlm: a dense decoder) (prefill through
   ``flash_attention``, decode through ``decode_attention``) and
   mamba2-2.7b (prefill through ``ssd_scan``, recurrent decode) at full
   depth; then arctic-480b (2 of 35 layers), deepseek-v2-236b (8 of 60:
   MLA in plain torch, a dense first layer) and jamba-v0.1-52b (16 of 32:
   two periods, B8 at N 16), the depth cut to what one card holds
   (MOE_CUTS), their MoE dispatch taking its slots from ``relay_slots``
   once a MoE layer a prefill and a decode step; each prefilling 2 x 4096
   tokens and decoding 32 greedy steps (prefill ms, ms per decode step,
   tokens/s, peak memory under 80 GiB; B5, B7 and B8's device ms a launch
   inside the profiled prefill, B5 and B6's inside one profiled decode
   step beside the step's device time and its weight-read bound; the MoE
   prefill's ``overflow_frac`` and expert loads at capacity factor 1.25),
   with finite logits; the launcher's decode is captured
   (``StaticModelDecode``: one CUDA graph replayed a step), and each arch
   runs the decode A/B (``decode_ab``): from one prefill, the captured
   decode against ``decode_eager`` on a copy of the cache, tokens
   identical, ms a step, tokens/s and peaks of each side, and one
   profiled captured step's busy share with its B6 and B5 launches
   equal to the profiler's count; and decode after a shorter prefill
   against the last logits of the full prefill: relative error < 1e-3 in
   f32 (the
   weights cast up, where they fit beside the bf16 ones: minitron-4b and
   mamba2-2.7b), and in bf16 under a fixed limit per architecture that a
   planted decode fault must exceed (the MoE archs: drop-free, on 8
   prompts of 256 tokens, holding those whose router top-k set flips in
   no layer; the faults: every routed row dropped, and where there is GQA
   attention half the keys); the largest kernels of each profiled
   prefill; each model is freed before the next is built; then
   whisper-large-v3 at full width and depth (32 encoder + 32 decoder
   layers, bf16): 8 x (1500 encoder frames + a 224-token prompt)
   prefilled and 32 greedy decode steps (the encoder through B7 not
   causal, the decoder's self-attention through B7 and B6, its cross
   decode through B6 against the stored encoder K/V; the encoder's and
   the prefill's ms, ms per step, tokens/s, peak memory, B7's device ms
   a launch in the profiled encoder, B6's in a profiled step), with the
   decode check in f32 (< 1e-3) and bf16 (under WHISPER_REL_TOL_BF16,
   which cross_v zeroed in the cache must exceed); then whisper trained
   at full width and depth (bf16 params, f32 moments, 8 x (448 tokens +
   1500 frames)) through ``train_loop.run``, whose step is captured
   (``StaticTrainStep``: one CUDA graph replayed a step): 8 steps, a
   checkpoint every 4, a failure injected at step 6 (restored into the
   static state and replayed bit-equal), B7 in every forward, finite
   losses falling, ms a step, tokens/s, peak memory allocated and
   reserved, the share of the FLOP bound, one replayed step under the
   profiler (B7's launches equal to the profiler's count), one eager
   step's B7 backward recompute as a share of its device time; then the
   training A/B: the eager step from the same init over the same batches
   (ms a step, peaks), eager against eager over two steps, the captured
   losses bit-equal to eager's where eager against eager is, else within
   TRAIN_AB_RTOL; then the ``RunCtx`` phase: the same training step (the
   same init and batches) under ``RunCtx(remat="none")`` and
   ``RunCtx(remat="block")``, captured and eager, CTX_STEPS steps each
   in this one run (ms a step, peak memory, the losses, the first
   bit-equal between the two remats and captured against eager as in the
   A/B; B7 launched once a layer a step, twice under block remat), and a
   world-size-1 NCCL process group: a (1, 1)
   ``DeviceMesh`` over it, CTX_ARCHS' smoke configs (f32) placed by
   ``MeshSpec`` as DTensors, ``loss_fn`` under ``RunCtx(shard=
   ms.constrain, tp_size=1, ep=(mesh, ("data", "model")))`` against the
   plain tensors' ``loss_fn`` without a ctx (rtol 1e-4), B5 launched in
   the expert-parallel relay's body and B7 through ``local_map``;
7. the reduced (smoke) configs of minitron-4b, mamba2-2.7b, the four
   dense and vlm archs and the three moe and hybrid ones (head dim 16;
   mamba's state 16) through the launcher's ``main`` on the card, as a
   user runs ``prefill_decode --smoke``, with finite logits and every
   attention, SSD and MoE dispatch through its kernel; then prefill and
   one decode step of each on the card against the CPU (f32, rtol = atol
   = 1e-4), whisper-large-v3's with its encoder frames; every arch's
   smoke config trained two steps through ``launch.train`` on the card
   (the forward's B7, B8 and B5 launches counted), and one smoke training
   step of whisper-large-v3 and jamba-v0.1-52b on the card against the
   CPU (f32: the loss and every gradient leaf within rtol = atol =
   1e-4); then ``launch/serve.py --arch`` at full width for
   xlb-service-model, minitron-4b and mamba2-2.7b and with ``--smoke`` for
   the four dense and vlm archs and the three moe and hybrid ones (every
   request served); ``serve --arch whisper-large-v3`` exits as the
   reference's does (an encoder-decoder has no prompt audio there);
   then the port's three examples (``examples/torch/``) through their
   ``main`` on the card: quickstart (8 requests, a transaction, a 9th;
   no_route 0, routing version 1, commit #1), serve_cluster (bookinfo on
   istio, cilium and xlb, every request completed) and train_moe
   (deepseek-mini-100m, EXAMPLE_TRAIN_STEPS captured steps through
   ``train_loop.run``: finite losses, falling over the first 100 steps
   (EXAMPLE_FALL_WINDOW), its checkpoints under build/), each one's
   launches of B1, B2, B5, B6 and B7 counted; then the dry run
   (``launch/dryrun.trace_cell_for`` on a one-chip ``LogicalMesh((1,
   1))``: meta tensors on the host, the H100's
   data-sheet peaks) for whisper-large-v3's training cell (without and
   with block remat) and minitron-4b's prefill, its predicted bytes
   beside the peaks this run measured (the ``RunCtx`` phase's two
   runs too) and its traced FLOPs beside ``train_flops`` (the ratio
   held to DRYRUN_FLOP_RATIO[remat]);
8. the kernel launch counts: ``admit_commit``, ``complete`` and
   ``decode_attention`` on the main path (and in each serving phase after
   it), ``route_match``, ``relay_slots`` and ``admit`` in the staged
   phase, ``admit``, ``complete`` and ``route_match`` in the sharded
   drain (added to those), ``flash_attention``, ``decode_attention``,
   ``ssd_scan`` and ``relay_slots`` (the MoE layers x (1 + steps) of each
   run) in the model phases (summed over the archs), and the same three
   in the training forwards (whisper's cell and the smoke configs); then
   of each kernel the launches of the whole run that ran inside CUDA
   graph replays ("kernels replayed");
9. ``python -m repro_torch.analysis`` with its kernels section in a
   subprocess: under compute-sanitizer's memcheck and racecheck where
   the sanitizer can attach to the card, else against the kernels'
   bounds-checking build; it must exit 0.

Phase 2 also holds the float kernels against their plain versions at the
paths' shapes (decode attention at minitron-4b's and the serving model's,
flash attention at minitron-4b's prefill, the SSD scan at mamba2-2.7b's
and at jamba-v0.1-52b's, where N 16 runs the FMA ``ssd_kernel``),
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
G = 48 query heads over one KV head (granite-20b's MQA), decode and
flash attention at the MoE archs' heads (arctic-480b's 56 / 8, G 7, and
jamba-v0.1-52b's 32 / 8, G 4, hd 128: the run's decode and prefill
shapes, each in bf16 and f32, timed beside their bounds), flash attention
not causal at whisper-large-v3's encoder (8 x 1500, 20 / 20, hd 64, bf16
and f32, beside SDPA) and at a ragged S of 130, decode attention at its
cross decode (8 x 1500 frames, lengths F - 1), and the three
float kernels at the smoke configs' head dim 16 (and the SSD's N 16), in
f32 and bf16.  The admission and completion kernels' device times at
the serving shape, and the relay kernel's at each of its shapes, are
printed beside their times before their redesigns, with the bound and
the launch floor; the route kernel's ("route redesign:") at R = 256
and 4096 likewise.

Then one JSON line of per-kernel numbers, and as the last line
``{"ok": true, "device": {...}}``.  Needs one CUDA device; exits non-zero
without one, or without the port's sources beside this file.

Phase 2 ends with the nine-product f32 product (``ops.dense`` through
``csrc/dense_x9.cu``) at the gateway decode's shapes, 128 rows against
Minitron-4B's wq, wk, wv, wo, w_in, w_out and the head (``X9_SITES``):
its largest absolute error against float64 at most twice that of
``torch.matmul`` in f32 (TF32 off), two launches and a captured replay
bitwise equal to the eager call, its device and call ms beside its bound,
the plain version's ms and ``torch.matmul``'s (``library_ms``), and a
tick's products (32 layers and the head) summed.  Phase 8's full-width
``serve --arch`` runs count the kernel's launches inside their captured
serving ticks (minitron-4b: 32 x 7 + 1 a tick), beside phase 2's.

``python3 chip_smoke.py --timing SRC`` times only the main path's drain
and the one-process sharded admission of the port in SRC
(``timing_for``): run it for two checkouts in one call, in turns, to
compare them.
"""

from __future__ import annotations

import contextlib
import gc
import io
import json
import math
import os
import statistics
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out"
# H100 SXM data-sheet peaks (HBM3 bytes/s, non-tensor f32 operations/s,
# dense bf16 tensor-core operations/s): set in main() from
# repro_torch.roofline.constants
MEM_BPS = OPS_PS = BF16_OPS_PS = None

I_LANES, SLOTS, ADMIT_R, MAX_LEN = 64, 16, 256, 32
N_REQUESTS, N_UNROUTABLE, ARRIVALS_PER_TICK = 4096, 64, 34
PROFILE_FROM, PROFILE_TICKS = 60, 20    # the separate profiled pass
PROFILE_WINDOWS = 5                     # profiler windows a measure may take
PASS_WINDOWS = 3                        # and a profiled pass (its ids fit
                                        # in N_REQUESTS)
# the engines phase: fewer requests, so that Istio's per-instance decode
# launches fit the time limit, and a short profiled pass of each engine
ENGINE_REQUESTS, ENGINE_WARM, ENGINE_PROFILE = 1024, 8, 4
# the main path's captured-against-eager A/B: pairs of drains of this many
# routable requests, and the ticks (from a drain's start) over which a
# lane is slow in the pair that also commits midway
AB_PAIRS, AB_REQUESTS, MIDWAY_FAULT = 5, 1024, (8, 40)
TIE_GAP = 1e-5      # weighted picks may flip between devices below this
# the model phases: cuts of SHAPES prefill_32k (32 x 32768) and decode_32k
# (128 x 32768) to one card
LLM_BATCH, LLM_PROMPT, LLM_STEPS = 2, 4096, 32
# decode after a shorter prefill vs the full prefill, max |diff| / max |logit|:
# in f32 sound runs read 5.1e-6 (minitron-4b) and 1.4e-5 (mamba2-2.7b); in
# bf16 minitron-4b reads 1.7e-2 against tests/test_smoke_archs.py's 5e-2,
# and mamba2-2.7b 6.4e-2, as bf16 rounding grows over its 64 layers (its
# bf16 prefill alone is 5.5e-2 from the f32 one); granite-20b,
# internlm2-20b, yi-34b and chameleon-34b read 1.95e-2 to 2.03e-2 in bf16,
# and with the planted fault 0.199 to 0.255 (an H100 80GB HBM3 at 700 W)
LLM_REL_TOL_F32 = 1e-3
LLM_REL_TOL_BF16 = {"minitron-4b": 5e-2, "mamba2-2.7b": 1e-1,
                    "granite-20b": 5e-2, "internlm2-20b": 5e-2,
                    "yi-34b": 5e-2, "chameleon-34b": 5e-2,
                    "arctic-480b": 5e-2, "deepseek-v2-236b": 5e-2,
                    "jamba-v0.1-52b": 5e-2}
# the MoE archs, drop-free: bf16 noise flips some sequences' router top-k
# set between prefill and decode, and a flipped sequence takes other
# experts in decode than in prefill, so the check holds the sequences that
# flip in no layer, at the dense archs' limit.  On 8 x 256 tokens (an H100
# 80GB HBM3 at 700 W) arctic-480b flips none, deepseek-v2-236b 4 and
# jamba-v0.1-52b 3; all 8 read 1.2e-2, 9.5e-2 and 0.255, the sequences
# held 1.2e-2, 2.1e-2 and 2.5e-2 (the f32 legs 4e-6 to 5e-6, no flip);
# every routed row dropped reads 0.46-0.69, half the keys dropped 1.03
# (arctic) and 0.120 (jamba, 2 attention layers of 16)
# the f32 leg of that check casts the weights up beside the bf16 ones: run
# it where they fit (minitron-4b's 5.1 B parameters are 20 GB in f32;
# granite-20b's 28.2 B would be 113 GB)
F32_LEG_MAX_PARAMS = 8e9
# the MoE archs' f32 leg runs at a shallower cut than their bf16 one, its
# f32 weights alone on the card (52-62 GB; jamba's 16 layers would be
# 104 GB, so one period of 8), on the first LLM_BATCH check sequences
MOE_F32_CUTS = {"arctic-480b": 1, "deepseek-v2-236b": 4, "jamba-v0.1-52b": 8}
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
# the sanitizer phase: ticks of the main path's traffic, plain and
# sanitized, also at SAN_SHARDS shards; the admission launch from which
# the planted leak fires (the second replay of the arrival graph); the
# sanitized tick's captured-against-eager A/B pairs
SAN_TICKS, SAN_SHARDS, SAN_LEAK_AT, SAN_AB_PAIRS = 40, 4, 3, 3
# the sharded phase: the mesh widths, the seed of its drains' draws; the
# widths of its captured-against-eager A/B and its alternating pairs; the
# kernels a sharded drain must launch, here and on each rank of the ranks
# phase (ops.LAUNCHES key: the profiler's kernel name)
SHARDS, SHARD_SEED = (1, 2, 4), 11
SHARD_AB_WIDTHS, SHARD_AB_PAIRS = (2, 4), 3
SHARD_KERNELS = {"admit": "admit_kernel", "route_match": "route_kernel",
                 "relay_slots": "relay_kernel", "complete": "complete_kernel",
                 "decode_attention": "decode_kernel"}
# the ranks phase: the widths (one spawned process a shard, all on this
# card; the processes of the widest, the smaller ones over its first
# ranks), the seconds the processes may take, and the NCCL probe's; its
# admission cases (label, R, I, C; "idle": shard 1's rows all padding)
RANK_WIDTHS, RANK_TIMEOUT, NCCL_PROBE_TIMEOUT = (2, 4), 240, 60
RANK_CASES = (("serving", ADMIT_R, I_LANES, SLOTS), ("ragged", 300, 8, 4),
              ("idle", ADMIT_R, I_LANES, SLOTS))
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
# the tune phase: the affinity batch's rows and its two flows' rows (each
# pair in one 256-row tile but two 64-row ones, or in one 1024-row tile
# but two 256-row ones)
TUNE_R, TUNE_PAIRS = 1040, ((20, 100), (30, 700))
# the dense and vlm archs of the model phase (full width, bf16)
DENSE_ARCHS = ("granite-20b", "internlm2-20b", "yi-34b", "chameleon-34b")
# the moe and hybrid archs of the model phase: full width, the depth cut to
# what one card holds beside the activations (bf16 weights: arctic's 3
# layers would be 76.9 GiB, jamba's 3 periods about 72; deepseek keeps room
# for its MLA score chunks and dispatch buffers)
MOE_CUTS = {"arctic-480b": 2, "deepseek-v2-236b": 8, "jamba-v0.1-52b": 16}
MOE_ARCHS = tuple(MOE_CUTS)
# the query heads of those with GQA attention (8 KV heads of hd 128 each;
# deepseek-v2-236b's MLA runs neither B6 nor B7)
MOE_ATTN_HEADS = {"arctic": 56, "jamba": 32}
# their decode check runs drop-free (capacity factor n_experts / top_k: a
# capacity drop depends on the batch, so decode and prefill would differ)
# on MOE_CHECK_BATCH prompts of MOE_CHECK_PROMPT tokens cut from the run's
MOE_CHECK_PROMPT, MOE_CHECK_BATCH = 256, 8
# a slot past every capacity: the planted fault of the MoE decode check
PLANT_SLOT = 1 << 30
# the whisper serving cell: batch, encoder frames (30 s of audio), the
# decoder prompt and the decode steps (224 + 32 tokens within the
# 448-token text context of the published dimensions); its bf16 decode
# check's limit, which cross_v zeroed in the cache must exceed
WHISPER_BATCH, WHISPER_PROMPT, WHISPER_STEPS = 8, 224, 32
WHISPER_REL_TOL_BF16 = 5e-2
# the whisper training cell: batch x (decoder tokens + encoder frames), the
# steps through train_loop.run, the checkpoint interval and the step whose
# first run fails (restored from the step-4 checkpoint and replayed)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 448, 8
TRAIN_CKPT_EVERY, TRAIN_FAIL_AT = 4, 6
# the smoke configs through launch.train: steps, batch, sequence; and the
# archs whose one smoke training step runs on the card against the CPU
SMOKE_TRAIN_STEPS, SMOKE_TRAIN_BATCH, SMOKE_TRAIN_SEQ = 2, 2, 64
TRAIN_PARITY_ARCHS = ("whisper-large-v3", "jamba-v0.1-52b")
# the archs serve --arch runs at full width, and those it serves at the
# reduced config (their f32 serving weights pass one card)
SERVE_ARCHS = ("xlb-service-model", "minitron-4b", "mamba2-2.7b")
SERVE_SMOKE_ARCHS = DENSE_ARCHS + MOE_ARCHS
# the examples phase: train_moe's steps (its default) and where its
# checkpoints go; the kernels each example must launch (ops.LAUNCHES keys)
# and the profiler's kernel names they count under
EXAMPLE_TRAIN_STEPS = 300
# train_moe's loss must fall over its first 100 steps: the mean of these
# steps below the mean of steps 0-19.  Later it climbs back, in the
# reference too (ROADMAP.md §3: the synthetic stream slides 32 tokens a
# step and the memorised window outruns the decaying learning rate)
EXAMPLE_FALL_WINDOW = (80, 100)
EXAMPLE_KERNELS = {"quickstart": ("admit_commit", "complete",
                                  "decode_attention"),
                   "serve_cluster": ("admit_commit", "complete",
                                     "decode_attention"),
                   "train_moe": ("relay_slots", "flash_attention")}
PROFILER_NAMES = {"admit_commit": "admit_kernel",
                  "complete": "complete_kernel",
                  "decode_attention": "decode_kernel",
                  "relay_slots": "relay_kernel",
                  "flash_attention": "flash_kernel"}
# the dryrun phase: traced FLOPs of whisper's training step over the
# hand count train_flops must fall in this range, by remat (PERF.md §6:
# the B7 backward recompute and the checkpointed cross prefill add their
# forward matmuls again, 1.0494; block remat every block's forward
# again, 1.2987 on the CPU's trace)
DRYRUN_FLOP_RATIO = {"none": (1.02, 1.10), "block": (1.27, 1.33)}
# the RunCtx phase: whisper's training steps under each remat, and the
# smoke configs whose loss runs on DTensors over a world-size-1 NCCL
# group (deepseek: B5 and MLA; arctic: B5 and B7), within this rtol
CTX_STEPS = 4
CTX_ARCHS = ("deepseek-v2-236b", "arctic-480b")
CTX_RTOL = 1e-4
# captured against eager training losses where eager against eager is not
# bit-equal: the card-against-CPU tolerance
TRAIN_AB_RTOL = 1e-4


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


def profile_calls(torch, fn, reps: int = 20, expect: tuple = ()) -> dict:
    """{device event name: ms per call} over ``reps`` calls of ``fn``
    (profiler), after one call outside the window.  A window in which a
    name shows no whole number of events per call (the profiler once lost
    about half of a library call's events on an H100) is taken again, up
    to 3 times, and one in which no event name contains one of the keys
    in ``expect`` (the profiler on an H100 once saw none of the 20
    launches of a kernel that ``ops.LAUNCHES`` counted in its window) up
    to PROFILE_WINDOWS times; the last one is kept, with a note on stderr
    where it is not whole or lacks a key."""
    fn()

    def run():
        for _ in range(reps):
            fn()

    for i in range(PROFILE_WINDOWS):
        counts: dict = {}
        _, by_name = device_events(torch, run, counts)
        whole = all(c % reps == 0 for c in counts.values())
        missing = [k for k in expect if not any(k in n for n in counts)]
        if not missing and (whole or i >= 2):
            break
    if missing or not whole:
        print(f"chip_smoke: note: profiler window {i + 1} of {reps} calls: "
              f"events per call {'' if whole else 'not '}whole, none of "
              f"{missing}: {counts}", file=sys.stderr)
    return {n: us / 1e3 / reps for n, us in by_name.items()}


def kernel_time(prof: dict, key) -> tuple:
    """(ms per call of the kernels in ``prof`` whose name contains ``key``
    (a string or a tuple of them), or None where there is none; their
    short names, joined by " + ")."""
    keys = (key,) if isinstance(key, str) else key
    hit = {n: t for n, t in prof.items() if any(k in n for k in keys)}
    return (sum(hit.values()) or None,
            " + ".join(sorted(kernel_name(n) for n in hit)))


def profile_kernel(torch, fn, key: str, reps: int = 20) -> tuple:
    """``kernel_time`` of ``key`` over a profiler window of ``reps`` calls
    of ``fn`` in which the profiler saw the kernel (``profile_calls``)."""
    return kernel_time(profile_calls(torch, fn, reps, expect=(key,)), key)


def kernel_ms(torch, fn, key: str, reps: int = 20):
    """Device ms per call of the kernels whose name contains ``key``
    (profiler), or None where the profiler sees none."""
    return profile_kernel(torch, fn, key, reps)[0]


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


def admit_work(torch, RT, PD, routing, rid, svc, feats, free, res, commit,
               tile=256):
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
    # with rows in it, of ``tile`` rows
    lr = routable & (pol == RT.POLICY_LEAST_REQUEST)
    tiles = torch.arange(R, device=cl.device) // tile
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
# phase 1b: the autotuner and the admission kernel's tiles
# --------------------------------------------------------------------------- #


def tune_config(RT):
    """``serving_config`` plus a second AFFINITY cluster (lanes 56..63)
    behind service "svc5b" (id 8), whose rules match what svc5's do: a
    flow sent to both services lands in two affinity clusters, so the
    cache keeps the first writer of a tile and the last tile's writer
    (the reference's kernel does the same; ROADMAP.md §3)."""
    services, clusters = serving_config(RT)
    services.append(RT.ServiceConfig("svc5b", [RT.Rule(0, "/api/5", "pol5b"),
                                               RT.Rule(1, None, "pol5b")]))
    clusters.append(RT.Cluster("pol5b", list(range(56, 64)),
                               policy=RT.POLICY_AFFINITY))
    return services, clusters


def affinity_batch(torch, RT, PD, dev):
    """TUNE_R rows of ``admit_inputs`` over ``tune_config``, with the two
    flows of TUNE_PAIRS planted: each pair's rows carry one flow, the
    first to svc5 (pol5), the second to svc5b (pol5b); no other row's flow
    shares a pair's cache slot.  (routing, reqs, pool, rnd, gum, slots)."""
    routing0, _ = RT.build_state(*tune_config(RT), "cpu")
    routing, reqs, pool, rnd, gum = admit_inputs(
        torch, RT, routing0, TUNE_R, I_LANES, SLOTS, seed=5, dev="cpu")
    rid, svc, feats = reqs[0], reqs[1], reqs[2]
    A = routing.aff_key.shape[0]
    for k, (a, b) in enumerate(TUNE_PAIRS):
        flow = torch.tensor([RT.fnv1a("/api/5")]
                            + [7_000_000 + 10 * k + j for j in range(7)],
                            dtype=torch.int32)
        feats[a], feats[b] = flow, flow
        svc[a], svc[b] = 5, 8
        rid[a], rid[b] = a, b
    pair_rows = [r for pr in TUNE_PAIRS for r in pr]
    slots = [int(PD.flow_hash(feats[a:a + 1])[0]) % A for a, _ in TUNE_PAIRS]
    others = torch.ones(TUNE_R, dtype=torch.bool)
    others[pair_rows] = False
    while True:                  # move other flows off the pairs' slots
        hit = others & torch.isin(PD.flow_hash(feats).long() % A,
                                  torch.tensor(slots))
        if not bool(hit.any()):
            break
        feats[hit, 7] += 1
    to = lambda xs: [x.to(dev) for x in xs]            # noqa: E731
    return (routing.to(dev), to(reqs), to(pool), rnd.to(dev), gum.to(dev),
            slots)


def sweep_line(tune, entry) -> str:
    key, best, timings, dropped = entry
    kind, _, _, R, I, C = key
    return (f"tune: plan_admit[{kind} R={R} pool={I}x{C}] swept on the "
            "card (B2 commit / B3 masked, CUDA events, min of 3 trials of "
            "3 calls): "
            + ", ".join(f"block_r={b} {1e3 * t:.5f} ms"
                        for b, t in sorted(timings.items()))
            + f"; chosen block_r={best}; dropped: "
            + ("; ".join(f"{b}: {why}" for b, why in dropped.items())
               or "none"))


def phase_tune(torch, RT, PD, B, ops, rm, tune, dev="cuda"):
    """``kernels/tune.py`` on the card: ``plan_admit`` swept at the serving
    shape (R 256 over 64 x 16: candidates 64 and 256) and at R 4096 (64,
    256 and 1024), both kernels, and at R/2 (the sharded and chained
    shards=2 width), so that no timed window of a later phase holds a
    sweep; B2 and B3 in each mode (commit, masked, all-free) at each tile
    against the plain version at the same block_r, on a batch whose
    affinity cache depends on the tile; each tile's device ms at R 256
    and 4096; the pins (XLB_BLOCK_R, XLB_AUTOTUNE=0) obeyed."""
    dev = torch.device(dev)
    tune.clear_cache()
    lines, timing = [], {}
    for R, commit in ((ADMIT_R, True), (ADMIT_R, False), (4096, True),
                      (4096, False), (ADMIT_R // 2, True)):
        n = len(tune._log)
        tune.plan_admit(R, (I_LANES, SLOTS), commit=commit, device=dev)
        check(len(tune._log) == n + 1, f"tune: no sweep at R={R}")
        key, best, timings, dropped = tune._log[-1]
        want = set(tune._admit_candidates(R))
        check(set(timings) == want and not dropped,
              f"tune: R={R} timed {sorted(timings)} (want {sorted(want)}),"
              f" dropped {dropped}")
        check(all(0 < t < 1e-2 for t in timings.values()),
              f"tune: R={R} timings {timings}")
        lines.append(sweep_line(tune, tune._log[-1]))
    # the sweep's own work, per candidate: 10 launches of the kernel
    routing, reqs, pool, rnd, gum, slots = affinity_batch(torch, RT, PD, dev)
    batch, pstate = B.RequestBatch(*reqs), B.PoolState(*pool)
    fields, act = pool[:5], pool[5]
    free = act == 0
    args = (reqs[0], reqs[1], reqs[2], reqs[4])
    A = routing.aff_key.shape[0]
    by_tile, errs = {}, []
    for b in rm.TILES:
        k = ops.admit_commit(batch, routing, pstate, rnd, gum, block_r=b)
        p = rm.admit_commit(*args[:3], args[3], reqs[3], routing, *fields,
                            act, rnd, gum, block_r=b)
        k2 = ops.admit(batch, routing, free, rnd, gum, block_r=b)
        p2 = rm.admit(*args, routing, free, rnd, gum, block_r=b)
        k3 = rm.admit_cuda(*args, None, routing, None, None, rnd, gum,
                           block_r=b, pool_shape=(I_LANES, SLOTS))
        p3 = rm.admit(*args, routing, None, rnd, gum, block_r=b,
                      pool_shape=(I_LANES, SLOTS))
        torch.cuda.synchronize()
        errs.append(max(
            max_abs_err(torch, [*zip(rm.AdmitResult._fields, k[:13], p[:13]),
                                *zip(B.PoolState._fields, k.pool, p[13:])]),
            max_abs_err(torch, zip(rm.AdmitResult._fields, k2, p2)),
            max_abs_err(torch, zip(rm.AdmitResult._fields, k3, p3))))
        ak, ae = k.aff_key.cpu(), k.aff_ep.cpu()
        lanes = [int(routing.ep_instance[int(ae[s])]) for s in slots]
        check(all(int(ak[s]) >= 0 for s in slots),
              f"tune: block_r={b}: a pair's flow is not in the cache")
        by_tile[b] = ["pol5" if ln < 56 else "pol5b" for ln in lanes]
        check(int(k.held) > 0 and int(k.no_route) > 0,
              f"tune: block_r={b}: no held or NO_ROUTE rows")
    want = {64: ["pol5b", "pol5b"], 256: ["pol5", "pol5b"],
            1024: ["pol5", "pol5"]}
    check(by_tile == want, f"tune: the affinity cache by tile {by_tile}, "
          f"want {want}")
    lines.append(
        f"tune: B2 commit, B3 masked and B3 all-free at block_r "
        f"{'/'.join(map(str, rm.TILES))} on R={TUNE_R} rows over "
        f"{I_LANES}x{SLOTS} (flows {TUNE_PAIRS} each in pol5 then pol5b), "
        f"each against the plain version at the same block_r: max_abs_err "
        f"{'/'.join(str(e) for e in errs)}; the cache keeps, for the two "
        f"flows: {by_tile} (first writer of a tile, later tile wins)")

    # the pins on the card: XLB_BLOCK_R, then XLB_AUTOTUNE=0
    n = len(tune._log)
    os.environ[tune.ENV_BLOCK_R] = "64"
    try:
        pin = tune.plan_admit(TUNE_R, (I_LANES, SLOTS), commit=True,
                              device=dev)
        k = ops.admit_commit(batch, routing, pstate, rnd, gum)
    finally:
        del os.environ[tune.ENV_BLOCK_R]
    os.environ[tune.ENV_AUTOTUNE] = "0"
    try:
        off = tune.plan_admit(2048, (I_LANES, SLOTS), device=dev)
        k0 = ops.admit_commit(batch, routing, pstate, rnd, gum)
    finally:
        del os.environ[tune.ENV_AUTOTUNE]
    p64 = rm.admit_commit(*args[:3], args[3], reqs[3], routing, *fields,
                          act, rnd, gum, block_r=64)
    p256 = rm.admit_commit(*args[:3], args[3], reqs[3], routing, *fields,
                           act, rnd, gum, block_r=256)
    max_abs_err(torch, [*zip(rm.AdmitResult._fields, k[:13], p64[:13])])
    max_abs_err(torch, [*zip(rm.AdmitResult._fields, k0[:13], p256[:13])])
    check(pin[0] == 64 and off[0] == 256 and len(tune._log) == n,
          f"tune: pins not obeyed: XLB_BLOCK_R=64 gave {pin}, "
          f"XLB_AUTOTUNE=0 gave {off}, sweeps {len(tune._log) - n}")
    lines.append("tune: pins on the card: XLB_BLOCK_R=64 plans 64 and "
                 "admit_commit equals the plain version at 64; "
                 "XLB_AUTOTUNE=0 plans min(256, R) and equals it at 256; "
                 "neither swept")

    # each tile's device ms (profiler) at R 256 and 4096 over the serving
    # routing
    routing0, _ = routing_config(RT, "cpu")
    for R in (ADMIT_R, 4096):
        routing, reqs, pool, rnd, gum = admit_inputs(
            torch, RT, routing0, R, I_LANES, SLOTS, seed=R, dev=dev)
        batch, pstate = B.RequestBatch(*reqs), B.PoolState(*pool)
        free = pool[5] == 0
        for b in rm.TILES:
            for name, call in (
                    ("admit_commit", lambda: ops.admit_commit(
                        batch, routing, pstate, rnd, gum, block_r=b)),
                    ("admit", lambda: ops.admit(batch, routing, free, rnd,
                                                gum, block_r=b))):
                timing[(name, R, b)] = kernel_ms(torch, call, "admit_kernel")
        lines.append(
            f"tune: device ms per launch at R={R} over {I_LANES}x{SLOTS} "
            "(profiler): " + "; ".join(
                f"block_r={b}: B2 {timing[('admit_commit', R, b)]:.5f}, B3 "
                f"{timing[('admit', R, b)]:.5f}" for b in rm.TILES))
    return lines, timing


def cpu_plans():
    """A context for the CPU leg of a card-against-CPU comparison: it plans
    as the card did.  Every admission plan the card has made is copied to
    the CPU's key of the same shape, and XLB_AUTOTUNE=0 keeps the CPU from
    sweeping a shape of its own (one the card never planned takes the
    static default, as on the card), so no equality rests on two sweeps
    agreeing."""
    import contextlib
    from repro_torch.kernels import tune

    @contextlib.contextmanager
    def ctx():
        for key, b in list(tune._cache.items()):
            if key[1] == "cuda":
                tune._cache[(key[0], "cpu", *key[2:])] = b
        old = os.environ.get(tune.ENV_AUTOTUNE)
        os.environ[tune.ENV_AUTOTUNE] = "0"
        try:
            yield
        finally:
            if old is None:
                del os.environ[tune.ENV_AUTOTUNE]
            else:
                os.environ[tune.ENV_AUTOTUNE] = old
    return ctx()


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


def moe_route_ids(torch, T, E, k, dev):
    """The flat (T * k,) expert ids of T tokens, each routed to k distinct
    experts drawn uniformly from a seed, token-major as the MoE dispatch
    hands them to ``relay_slots``."""
    g = torch.Generator().manual_seed(T + E + k)
    ids = torch.rand((T, E), generator=g).argsort(dim=-1)[:, :k]
    return ids.reshape(-1).to(torch.int32).to(dev)


def phase_kernels(torch, RT, PD, ops, rm, rs, cp, B, lib, dev="cuda",
                  moe_shapes=None):
    """Each kernel through its public wrapper in ``kernels/ops.py`` against
    its plain PyTorch version on the same card tensors, bit-exact (the
    admission at the tile the wrapper planned, ``kernels/tune.py``);
    ``relay_slots`` also at each MoE prefill's shape of ``moe_shapes``
    ({arch: (tokens, experts, top_k)})."""
    from repro_torch.kernels import tune
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
        br_c = tune.plan_admit(R, (I, C), commit=True, device=dev)[0]
        br_a = tune.plan_admit(R, (I, C), device=dev)[0]
        plain_c = lambda: rm.admit_commit(rid, svc, feats, msgb, tok,
                                          routing, *fields, act, rnd, gum,
                                          block_r=br_c)
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
                                   rnd, gum, block_r=br_a)
        k2, p2 = admit(), plain_a()
        torch.cuda.synchronize()
        err_a = max_abs_err(torch, zip(rm.AdmitResult._fields, k2, p2))
        rows.append(f"admit_commit[{label} R={R} I={I} C={C}] (planned "
                    f"block_r={br_c}) max_abs_err={err_c} "
                    f"ok={int(k.ok.sum())} held={int(k.held)} "
                    f"no_route={int(k.no_route)}; admit (block_r={br_a}) "
                    f"max_abs_err={err_a}")
        if label == "serving":
            for name, call, plain, res, mask, c, err, br in (
                    ("admit_commit", commit, plain_c, p, act == 0, True,
                     err_c, br_c),
                    ("admit", admit, plain_a, p2, free, False, err_a,
                     br_a)):
                nb, nops = admit_work(torch, RT, PD, routing, rid, svc,
                                      feats, mask, res, c, br)
                timing[name] = dict(block_r=br,
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

    for arch, (T, E, k) in (moe_shapes or {}).items():
        idx = moe_route_ids(torch, T, E, k, dev)
        N = idx.shape[0]
        call = lambda: ops.relay_slots(idx, E)
        plain = lambda: rs.relay_slots(idx, E)
        got, p = call(), plain()
        torch.cuda.synchronize()
        err = max_abs_err(torch, zip(("slot", "load"), got, p))
        check(int(got[1].sum()) == N, f"relay_slots[{arch}]: loads do not "
              "add up")
        rows.append(f"relay_slots[{arch} MoE prefill: N={N} ({T} tokens x "
                    f"top-{k}) n_dest={E}] max_abs_err={err} largest "
                    f"load={int(got[1].max())}")
        timing[f"relay_slots[{arch}]"] = dict(
            ms=kernel_ms(torch, call, "relay_kernel"),
            call_ms=cuda_ms(torch, call),
            plain_ms=cuda_ms(torch, plain, reps=10, warm=1),
            bytes=4 * (2 * N + E), ops=2 * N + E, err=err, moe=(N, E))

    floor, issue = launch_floor(torch, lib)
    for t in timing.values():
        t["floor_ms"], t["issue_ms"] = floor, issue
    return rows, timing


#: the gateway decode's products: x (X9_ROWS, K), its 128 lanes, against
#: Minitron-4B's (K, N) of each site; X9_LAYERS layers of all but the head
X9_ROWS, X9_LAYERS = 128, 32
X9_SITES = {"wq": (3072, 3072), "wk": (3072, 1024), "wv": (3072, 1024),
            "wo": (3072, 3072), "w_in": (3072, 9216), "w_out": (9216, 3072),
            "head": (3072, 256000)}


def phase_dense_x9(torch, ops, x9, gpu, dev="cuda"):
    """``ops.dense`` through ``csrc/dense_x9.cu`` at each of ``X9_SITES``
    (shapes shared by two sites measured once): the error against float64
    beside ``torch.matmul``'s in f32, two launches and a captured replay
    bitwise equal to the eager call, device ms (both kernels, profiler),
    call ms, the bound (9 x 2 M K N operations at the bf16 peak, or the
    planes, x and y at 3.35 TB/s), the plain version's ms and
    ``torch.matmul``'s.  Returns (lines, {site: timing})."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(36)
    lines, timing, done = [], {}, {}
    for site, (K, N) in X9_SITES.items():
        if (K, N) in done:
            timing[site] = timing[done[K, N]]
            continue
        done[K, N] = site
        x = torch.randn((X9_ROWS, K), generator=gen, device=dev)
        w = torch.randn((K, N), generator=gen, device=dev) / K ** 0.5
        h = x9.X9Weight(w, x9.split_planes(w))
        n0 = ops.LAUNCHES["dense_x9"]
        got = ops.dense(x, h)
        again = ops.dense(x, h)
        check(ops.LAUNCHES["dense_x9"] == n0 + 2,
              f"dense_x9[{site}]: {ops.LAUNCHES['dense_x9'] - n0} launches "
              "counted for 2 calls")
        check(torch.equal(got, again), f"dense_x9[{site}]: two launches "
              "differ")
        graph, xs = torch.cuda.CUDAGraph(), x.clone()
        with ops.capture_launches() as delta, torch.cuda.graph(graph):
            ys = ops.dense(xs, h)
        graph.replay()
        ops.count_replay(delta)
        torch.cuda.synchronize()
        check(torch.equal(ys, got), f"dense_x9[{site}]: the captured "
              "replay differs from the eager call")
        check(delta == {"dense_x9": 1}
              and ops.LAUNCHES["dense_x9"] == n0 + 3,
              f"dense_x9[{site}]: the capture counted {delta}, the table "
              f"{ops.LAUNCHES['dense_x9'] - n0} for 2 calls and a replay")
        del graph, ys
        want = x.double() @ w.double()
        lib = torch.matmul(x, w)
        err = float((got.double() - want).abs().max())
        lib_err = float((lib.double() - want).abs().max())
        plain_err = float((x9.dense_x9(x, h.planes).double() - want)
                          .abs().max())
        del want, lib
        check(err <= 2 * lib_err, f"dense_x9[{site}]: max abs err {err:.3e}"
              f" against float64 above twice torch.matmul's {lib_err:.3e}")
        prof = profile_calls(torch, lambda: ops.dense(x, h),
                             expect=("dense_x9_kernel",))
        ms, kernel = kernel_time(prof, "dense_x9")
        t = {"ms": ms, "kernel": kernel,
             "reduce_ms": kernel_time(prof, "dense_x9_reduce")[0] or 0.0,
             "call_ms": cuda_ms(torch, lambda: ops.dense(x, h)),
             "plain_ms": cuda_ms(torch, lambda: x9.dense_x9(x, h.planes),
                                 reps=3, warm=1),
             "library_ms": cuda_ms(torch, lambda: torch.matmul(x, w)),
             "library_device_ms": library_device_ms(
                 torch, lambda: torch.matmul(x, w)),
             "ops": 9 * 2 * X9_ROWS * K * N, "peak": BF16_OPS_PS,
             "bytes": nbytes(h.planes, x) + 4 * X9_ROWS * N,
             "err": err, "library_err": lib_err, "plain_err": plain_err}
        timing[site] = t
        lines.append(
            f"dense_x9[{site}] (M {X9_ROWS}, K {K}, N {N}): device ms "
            f"{t['ms']:.5f} ({kernel}; the reduce {t['reduce_ms']:.5f}), "
            f"call ms {t['call_ms']:.5f}, bound ms "
            f"{bound_ms(t)[0]:.5f}, plain ms {t['plain_ms']:.5f}, library ms "
            f"{t['library_ms']:.5f} (device {t['library_device_ms']:.5f}); "
            f"max abs err against float64 {err:.3e}, torch.matmul f32's "
            f"{lib_err:.3e} (ratio {err / lib_err:.3f}), the plain "
            f"version's {plain_err:.3e}; launches bitwise equal, the "
            f"captured replay equal to the eager call; on {gpu}")
        del x, w, h, got, again
        torch.cuda.empty_cache()
    tick = {k: sum(timing[s][k] * (1 if s == "head" else X9_LAYERS)
                   for s in X9_SITES)
            for k in ("ms", "reduce_ms", "library_device_ms", "ops")}
    bound = sum(bound_ms(timing[s])[0] * (1 if s == "head" else X9_LAYERS)
                for s in X9_SITES)
    lines.append(
        f"dense_x9 tick: {X9_LAYERS} x (wq, wk, wv, wo, w_in, w_out) + head "
        f"= {len(X9_SITES) * X9_LAYERS - X9_LAYERS + 1} launches, device ms "
        f"{tick['ms']:.3f} (the reduces {tick['reduce_ms']:.3f}) against "
        f"torch.matmul f32's "
        f"{tick['library_device_ms']:.3f}, bound ms {bound:.3f}; "
        f"{tick['ops'] / tick['ms'] / 1e9:.1f} TFLOP/s of bf16 products = "
        f"{100 * tick['ops'] / tick['ms'] * 1e3 / BF16_OPS_PS:.1f}% of the "
        f"dense peak; on {gpu}")
    return lines, timing


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
    return _tree(tree, lambda t: t.to(dev))


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
        ms, names = profile_kernel(torch, call, "decode_")
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
        ms, names = profile_kernel(torch, call, "decode_")
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
    ms, names = profile_kernel(torch, call, "flash_kernel", reps=5)
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

    # B8 at jamba-v0.1-52b's prefill: 128 heads of hd 64, N 16, one group
    # broadcast over the heads; at N 16 bf16 runs the FMA ssd_kernel
    # (ssd_scan.runs_passes), first at a full width here
    nh, N = 128, 16
    x = (torch.randn((B, S, nh, hd), generator=gd, device=dev) * 0.5).to(bf16)
    a = -F.softplus(torch.randn((B, S, nh), generator=gd, device=dev)) * 0.5
    Bg = (torch.randn((B, S, 1, N), generator=gd, device=dev) * 0.3).to(bf16)
    Cg = (torch.randn((B, S, 1, N), generator=gd, device=dev) * 0.3).to(bf16)
    Bm, Cm = Bg.expand(-1, -1, nh, -1), Cg.expand(-1, -1, nh, -1)
    call = lambda: ops.ssd_scan(x, a, Bm, Cm, chunk=Q, return_state=True)
    plain = lambda: ssd.ssd_scan(x, a, Bm, Cm, Q)
    (ky, kh), (py, ph) = call(), plain()
    err = max(float_err(torch, "ssd_scan[jamba] y", ky, py),
              float_err(torch, "ssd_scan[jamba] h_last", kh, ph))
    del py, ph
    err32 = f32_err(
        torch, lambda *t: ops.ssd_scan(*t, chunk=Q, return_state=True),
        lambda *t: ssd.ssd_scan(*t, Q), "ssd_scan[jamba]", x.float(), a,
        Bg.float().expand(-1, -1, nh, -1), Cg.float().expand(-1, -1, nh, -1))
    ms, names = profile_kernel(torch, call, SSD_PREFIX, reps=3)
    check(names.split("<", 1)[0] == "ssd_kernel", f"ssd_scan at jamba's "
          f"shape ran {names!r}, not the FMA ssd_kernel")
    rows.append(f"ssd_scan[jamba: B={B} S={S} nh={nh} hd={hd} N={N} bf16] "
                f"max_abs_err={err}, in f32 {err32} (y and h_last; {names})")
    timing["ssd_scan[jamba]"] = dict(
        ms=ms, kernel=names,
        call_ms=cuda_ms(torch, call, reps=3, warm=1),
        plain_ms=cuda_ms(torch, plain, reps=3, warm=1), library_ms=None,
        bytes=nbytes(x, a, Bg, Cg, ky, kh),
        ops=B * nh * tiles * 2 * (T * (T + 1) // 2 * (N + hd)
                                   + 2 * T * N * hd),
        peak=BF16_OPS_PS, err=err, err_f32=err32)
    del x, a, Bg, Cg, Bm, Cm, ky, kh
    moe_attention(torch, ops, da, fa, rows, timing, dev)
    whisper_attention(torch, ops, da, fa, rows, timing, dev)
    return rows, timing


def whisper_attention(torch, ops, da, fa, rows, timing, dev):
    """B7 in its non-causal mode at whisper-large-v3's encoder (8 x 1500
    frames, 20 / 20 heads, hd 64: the bf16 tensor-core kernel, a ragged
    last 128-row tile) in bf16 and f32, and at a ragged S of 130, each
    against its plain version, the encoder shape timed beside one SDPA
    call; B6 at its cross decode (one query against every frame of the
    stored encoder K/V, lengths F - 1)."""
    import torch.nn.functional as F
    sdpa = F.scaled_dot_product_attention
    B, S, H, hd = WHISPER_BATCH, 1500, 20, 64
    g = torch.Generator(device=dev).manual_seed(1500)
    rn = lambda *shape, dt=torch.bfloat16: torch.randn(
        shape, generator=g, device=dev).to(dt)
    q, k, v = rn(B, S, H, hd), rn(B, S, H, hd), rn(B, S, H, hd)
    call = lambda: ops.flash_attention(q, k, v, causal=False)
    plain = lambda: fa.flash_attention(q, k, v, causal=False)
    err = float_err(torch, "flash_attention[enc]", call(), plain())
    err32 = f32_err(torch, lambda *t: ops.flash_attention(*t, causal=False),
                    lambda *t: fa.flash_attention(*t, causal=False),
                    "flash_attention[enc]", q.float(), k.float(), v.float())
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib = lambda: sdpa(qt, kt, vt)
    lib_err = float((lib().transpose(1, 2).float() - plain().float())
                    .abs().max())
    ms, names = profile_kernel(torch, call, "flash_kernel", reps=5)
    check(names == "flash_kernel_wgmma<64>", f"B7 at the encoder's shape "
          f"ran {names!r}, not the tensor-core kernel")
    rows.append(f"flash_attention[enc: B={B} S={S} H={H} K={H} hd={hd} "
                f"not causal bf16] max_abs_err={err}, in f32 {err32} (sdpa "
                f"vs plain {lib_err:.3g}; {names})")
    timing["flash_attention[enc]"] = dict(
        ms=ms, kernel=names, call_ms=cuda_ms(torch, call, reps=5, warm=1),
        plain_ms=cuda_ms(torch, plain, reps=3, warm=1),
        library_ms=cuda_ms(torch, lib, reps=10, warm=2),
        library_device_ms=library_device_ms(torch, lib, reps=5),
        bytes=nbytes(q, k, v, q), ops=4 * B * H * hd * S * S,
        peak=BF16_OPS_PS, err=err, err_f32=err32)
    errs = []
    for dt in (torch.bfloat16, torch.float32):
        q, k, v = (rn(2, 130, H, hd, dt=dt) for _ in range(3))
        errs.append(float_err(torch, f"flash_attention[S=130 {dt}]",
                              ops.flash_attention(q, k, v, causal=False),
                              fa.flash_attention(q, k, v, causal=False)))
    rows.append(f"flash_attention[B=2 S=130 H={H} hd={hd} not causal] "
                f"max_abs_err={errs[0]} bf16, {errs[1]} f32")
    del q, k, v, qt, kt, vt
    # B6 against the stored encoder K/V: every frame valid
    q, kc, vc, lens = decode_inputs(torch, B, S, H, H, hd, torch.bfloat16,
                                    [S - 1] * B, dev, seed=1499)
    call = lambda: ops.decode_attention(q, kc, vc, lens)
    plain = lambda: da.decode_attention(q, kc, vc, lens)
    err = float_err(torch, "decode_attention[cross]", call(), plain())
    err32 = f32_err(torch, ops.decode_attention, da.decode_attention,
                    "decode_attention[cross]", q.float(), kc.float(),
                    vc.float(), lens)
    q4, k4, v4 = q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2)
    lib = lambda: sdpa(q4, k4, v4)
    ms, names = profile_kernel(torch, call, "decode_")
    nb, nops = decode_work(q, kc, lens)
    rows.append(f"decode_attention[cross: B={B} F={S} H={H} K={H} hd={hd} "
                f"bf16, lengths F - 1] max_abs_err={err}, in f32 {err32} "
                f"({names})")
    timing["decode_attention[cross]"] = dict(
        ms=ms, kernel=names, call_ms=cuda_ms(torch, call),
        plain_ms=cuda_ms(torch, plain, reps=10, warm=2),
        library_ms=cuda_ms(torch, lib, reps=20, warm=3),
        library_device_ms=library_device_ms(torch, lib), bytes=nb,
        ops=nops, peak=BF16_OPS_PS, err=err, err_f32=err32)
    del q, kc, vc
    torch.cuda.empty_cache()


def moe_attention(torch, ops, da, fa, rows, timing, dev):
    """B6 and B7 at the MoE archs' attention, each dtype against its plain
    version: arctic-480b's 56 / 8 heads (G 7: bf16 walks the heads in a
    pass of 4 and a ragged one of 3, f32 in one of 7) and jamba-v0.1-52b's
    32 / 8 (G 4), hd 128; decode as the last of the run's steps, prefill
    over the whole prompt."""
    B, S, K, hd = LLM_BATCH, LLM_PROMPT, 8, 128
    last = S + LLM_STEPS - 1
    for arch, H in MOE_ATTN_HEADS.items():
        for dtype in (torch.bfloat16, torch.float32):
            tag = f"[{arch}]" + ("" if dtype == torch.bfloat16 else "[f32]")
            peak = BF16_OPS_PS if dtype == torch.bfloat16 else OPS_PS
            q, kc, vc, lens = decode_inputs(torch, B, last + 1, H, K, hd,
                                            dtype, [last - 20, last], dev,
                                            seed=H)
            call = lambda: ops.decode_attention(q, kc, vc, lens)
            plain = lambda: da.decode_attention(q, kc, vc, lens)
            err = float_err(torch, "decode_attention" + tag, call(), plain())
            nb, nops = decode_work(q, kc, lens)
            ms, names = profile_kernel(torch, call, "decode_")
            rows.append(f"decode_attention{tag}[B={B} S={last + 1} H={H} "
                        f"K={K} hd={hd} {dtype}] max_abs_err={err} ({names})")
            timing["decode_attention" + tag] = dict(
                ms=ms, kernel=names, call_ms=cuda_ms(torch, call),
                plain_ms=cuda_ms(torch, plain, reps=5, warm=1), bytes=nb,
                ops=nops, peak=peak, err=err)
            g = torch.Generator(device=dev).manual_seed(H)
            rn = lambda *shape: torch.randn(shape, generator=g, device=dev,
                                            dtype=torch.float32).to(dtype)
            q, k, v = rn(B, S, H, hd), rn(B, S, K, hd), rn(B, S, K, hd)
            call = lambda: ops.flash_attention(q, k, v, causal=True)
            plain = lambda: fa.flash_attention(q, k, v, causal=True)
            err = float_err(torch, "flash_attention" + tag, call(), plain())
            ms, names = profile_kernel(torch, call, "flash_kernel", reps=5)
            rows.append(f"flash_attention{tag}[B={B} S={S} H={H} K={K} "
                        f"hd={hd} causal {dtype}] max_abs_err={err} "
                        f"({names})")
            timing["flash_attention" + tag] = dict(
                ms=ms, kernel=names,
                call_ms=cuda_ms(torch, call, reps=5, warm=1),
                plain_ms=cuda_ms(torch, plain, reps=3, warm=1),
                bytes=nbytes(q, k, v, q),
                ops=4 * B * H * hd * S * (S + 1) // 2, peak=peak, err=err)
            del q, k, v, kc, vc
            torch.cuda.empty_cache()


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


def phase_llm(torch, ops, TM, launcher, cfg, dev="cuda", full_layers=None):
    """Build ``cfg`` at full width in bf16 (weights from a CUDA generator),
    at full depth or, with ``full_layers``, at the depth ``cfg`` was cut
    to; prefill LLM_BATCH x LLM_PROMPT tokens and decode LLM_STEPS greedy
    steps through the launcher's ``run``; check the path's kernel
    launches, finite logits, and decode after a shorter prefill against
    the last logits of the full prefill (drop-free on MOE_CHECK_PROMPT
    tokens where the arch has MoE layers).  Returns (line, launches,
    the prefill's kernels, peak bytes over init, prefill and decode)."""
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
    want = expected_launches(cfg, LLM_STEPS)
    check(launches == want, f"{cfg.name}: kernel launches {launches}, "
          f"expected {want}")
    n = layer_counts(cfg)
    # which kernels a bf16 prefill runs, and their share of its device
    # time: one more prefill under the profiler (apart from the timed run)
    _, by_name = device_events(torch, lambda: TM.prefill(
        cfg, params, tokens, TM.init_cache(cfg, LLM_BATCH, LLM_PROMPT,
                                           params["embed"].dtype, dev)))
    parts = []
    if n["gqa"]:
        b7_us, names = kernel_time(by_name, "flash_kernel")
        check(names == "flash_kernel_wgmma<128>", f"{cfg.name}: the bf16 "
              f"prefill ran {names!r}, not the tensor-core kernel")
        parts.append((names, b7_us, n["gqa"], "B7"))
    if n["mamba"]:
        b8_us, names = kernel_time(by_name, SSD_PREFIX)
        if cfg.ssm.d_state == 16:      # the FMA build (runs_passes)
            check(names.split("<", 1)[0] == "ssd_kernel", f"{cfg.name}: "
                  f"the bf16 prefill ran {names!r}, not the FMA ssd_kernel")
        else:
            names = " + ".join(ssd_passes(by_name))
        parts.append((names, b8_us, n["mamba"], "B8"))
    if n["moe"]:
        b5_us, names = kernel_time(by_name, "relay_kernel")
        parts.append((names, b5_us, n["moe"], "B5"))
    kernels = " + ".join(p[0] for p in parts)
    busy_ms = sum(by_name.values()) / 1e3
    top = "; ".join(f"{kernel_name(k)[:70]} {us / 1e3:.3f}" for k, us in
                    sorted(by_name.items(), key=lambda kv: -kv[1])[:8])
    check(bool(torch.isfinite(res["logits"]).all()),
          f"{cfg.name}: non-finite decode logits")
    peak = torch.cuda.max_memory_allocated(dev)    # init, prefill, decode
    check(peak < 80 * 2**30, f"{cfg.name}: peak memory {peak / 2**30:.2f} "
          "GiB")

    # B6 and B5 inside the model: one decode step at the last position of
    # the run, under the profiler (the cache's contents do not change its
    # work); beside it the step's least time, every weight read once
    step = ""
    if not cfg.attn_free:
        cache = TM.init_cache(cfg, LLM_BATCH, LLM_PROMPT + LLM_STEPS,
                              params["embed"].dtype, dev)
        pos = LLM_PROMPT + LLM_STEPS - 1
        lengths = torch.full((LLM_BATCH,), pos, dtype=torch.int32,
                             device=dev)
        tok = tokens[:, :1]
        TM.decode_step(cfg, params, tok, lengths, cache)
        _, step_ev = device_events(torch, lambda: TM.decode_step(
            cfg, params, tok, lengths, cache))
        step_busy = sum(step_ev.values()) / 1e3
        w_bytes = nbytes(*(t for t in _leaves(params)
                           if t is not params["embed"]))
        step = (f"; one decode step at position {pos} (profiler): device "
                f"busy {step_busy:.4f} ms, bound {w_bytes / MEM_BPS * 1e3:.4f}"
                f" ms (every weight but the embedding read once, {w_bytes} B)")
        if n["gqa"]:
            b6_us, b6_names = kernel_time(step_ev, "decode_")
            kc = (cache["attn"] if cfg.is_hybrid
                  else cache["blocks"]["self"])["k"][0]
            q = torch.empty((LLM_BATCH, cfg.n_heads, cfg.head_dim),
                            dtype=kc.dtype, device=dev)
            nb, nops = decode_work(q, kc, lengths)
            b6_bound = max(nb / MEM_BPS, nops / BF16_OPS_PS) * 1e3
            step += (f"; B6 inside the model (G = "
                     f"{cfg.n_heads // cfg.n_kv_heads}): "
                     f"{b6_us / 1e3 / n['gqa']:.5f} ms a launch "
                     f"({b6_names}; {n['gqa']} launches a "
                     f"step, {b6_us / 1e3:.4f} ms of the step), bound "
                     f"{b6_bound:.5f} ms ({nb} B)")
        if n["moe"]:
            b5_us, b5_names = kernel_time(step_ev, "relay_kernel")
            step += (f"; B5 in the step: {b5_us / 1e3 / n['moe']:.5f} ms a "
                     f"launch ({b5_names}; {n['moe']} launches at N = "
                     f"{LLM_BATCH * cfg.moe.top_k})")
        del cache

    ab_line, ab = decode_ab(torch, ops, launcher, cfg, params, tokens,
                            LLM_STEPS)

    # consistency, as tests/test_smoke_archs.py checks it (in f32): the
    # full prefill's last logits against a shorter prefill plus
    # teacher-forced decode of the rest (mamba: a prefill that is a
    # multiple of the 256-row chunk, as ssd_chunked asserts; MoE:
    # drop-free on shorter prompts, the first LLM_BATCH of them the heads
    # of the run's prompts)
    ccfg, ctok = cfg, tokens
    if cfg.moe.enabled:
        m, P = cfg.moe, MOE_CHECK_PROMPT
        ccfg = replace(cfg, moe=replace(
            m, capacity_factor=m.n_experts / m.top_k))
        per = MOE_CHECK_BATCH // LLM_BATCH
        ctok = (tokens[:, :per * P].reshape(LLM_BATCH, per, P)
                .transpose(0, 1).reshape(MOE_CHECK_BATCH, P))
    S = ctok.shape[1]
    split = S - (cfg.ssm.chunk if cfg.family == "ssm" else 1)
    flipped, (f16_full, f16_dec) = topk_flips(
        torch, n["moe"], lambda: consistency(torch, TM, ops, ccfg, params,
                                             ctok, split))
    # a sequence whose router top-k set at the last position differs
    # between the full prefill and the decode in some layer takes other
    # experts there: its logits differ by design, and the check holds the
    # others
    keep = ~flipped.any(0) if n["moe"] else torch.ones(
        ctok.shape[0], dtype=torch.bool, device=dev)
    check(bool(keep.any()), f"{cfg.name}: every sequence's router top-k "
          "set flipped between prefill and decode; the decode check holds "
          "none")
    faults = {}
    for fault in plant_faults(cfg, n):
        _, bad = consistency(torch, TM, ops, ccfg, params, ctok, split,
                             plant=fault)
        faults[fault] = rel_err(bad[keep], f16_full[keep])
    for name, t in (("bf16 prefill", f16_full), ("bf16 decode", f16_dec)):
        check(bool(torch.isfinite(t).all()), f"{cfg.name}: non-finite "
              f"{name} logits")
    f32_leg = n_params <= F32_LEG_MAX_PARAMS or cfg.name in MOE_F32_CUTS
    if f32_leg:
        if n_params <= F32_LEG_MAX_PARAMS:
            p32 = _tree(params, lambda t: t.float())
        else:           # the MoE archs: f32 weights alone, shallower
            del params
            gc.collect()
            torch.cuda.empty_cache()
            ccfg = replace(ccfg, n_layers=MOE_F32_CUTS[cfg.name])
            p32 = TM.init_params(ccfg, torch.Generator(device=dev)
                                 .manual_seed(0), torch.float32, dev)
            params = None
        f32_full, f32_dec = consistency(torch, TM, ops, ccfg, p32,
                                        ctok[:LLM_BATCH], split)
        del p32
        for name, t in (("f32 prefill", f32_full), ("f32 decode", f32_dec)):
            check(bool(torch.isfinite(t).all()), f"{cfg.name}: non-finite "
                  f"{name} logits")
        rel32 = rel_err(f32_dec, f32_full)
        check(rel32 < LLM_REL_TOL_F32, f"{cfg.name}: f32 decode after a "
              f"{split}-token prefill vs the full prefill: rel {rel32:.3e} "
              f">= {LLM_REL_TOL_F32}")
    tol16 = LLM_REL_TOL_BF16[cfg.name]
    rel16 = rel_err(f16_dec[keep], f16_full[keep])
    check(rel16 < tol16, f"{cfg.name}: bf16 decode after a {split}-token "
          f"prefill vs the full prefill: rel {rel16:.3e} >= {tol16}")
    what = {"dispatch": "every routed row of the MoE dispatch placed past "
                        "its expert's capacity",
            "state": f"layer {cfg.n_layers // 2} skips its state update",
            "attention": f"decode attention drops the newest "
                         f"{min(PLANT_KEYS, S // 2)} keys"}
    for fault, planted in faults.items():
        check(planted >= tol16, f"{cfg.name}: the bf16 gate does not see a "
              f"planted fault ({what[fault]}): rel {planted:.3e} < {tol16}")
    fault = "; ".join(f"{what[f]}: {r:.3e}" for f, r in faults.items())
    rel16_all = rel_err(f16_dec, f16_full)
    if f32_leg and params is None:
        f32_part = (f"{rel32:.3e} in f32 at {ccfg.n_layers} layers "
                    f"(< {LLM_REL_TOL_F32}), ")
        vs32 = ""
    elif f32_leg:
        f32_part = (f"{rel32:.3e} in f32 (< {LLM_REL_TOL_F32}), ")
        vs32 = (f"; bf16 vs f32 logits: prefill "
                f"{rel_err(f16_full[:LLM_BATCH], f32_full):.3e}, decode "
                f"{rel_err(f16_dec[:LLM_BATCH], f32_full):.3e}")
    else:
        f32_part = (f"f32 not run ({4 * n_params / 1e9:.1f} GB of f32 "
                    "weights beside the bf16 ones pass the card), ")
        vs32 = ""
    moe = ""
    if cfg.moe.enabled:
        met = res["metrics"]
        from repro_torch.models.moe import capacity_for
        moe = (f"; MoE (capacity factor {cfg.moe.capacity_factor}, "
               f"{capacity_for(LLM_BATCH * LLM_PROMPT, cfg)} slots an "
               f"expert): prefill overflow_frac "
               f"{float(met.overflow_frac):.6f}, expert load summed over "
               f"{n['moe']} MoE layers largest {int(met.load.max())}, mean "
               f"{float(met.load.float().mean()):.1f}; decode check "
               f"drop-free (factor {ccfg.moe.capacity_factor:.4g}) on "
               f"{ctok.shape[0]} x {S}, router top-k sets that differ "
               f"between the full prefill and the decode in bf16, per MoE "
               f"layer: {flipped.sum(1).tolist()} of {ctok.shape[0]} "
               f"sequences; the check holds {int(keep.sum())} sequences "
               f"(all {ctok.shape[0]}: rel {rel16_all:.3e}); f32 leg on "
               f"the first {LLM_BATCH}")
    depth = (f"{cfg.n_layers} of {full_layers} layers, depth cut"
             if full_layers else f"{cfg.n_layers} layers, full depth")
    per_step = res["decode_s"] / LLM_STEPS
    line = (f"model {cfg.name}: {n_params / 1e9:.3f} B parameters "
            f"({depth}; bf16), init "
            f"{init_s:.2f} s; prefill "
            f"{LLM_BATCH} x {LLM_PROMPT} tokens {1e3 * res['prefill_s']:.3f}"
            f" ms ({LLM_BATCH * LLM_PROMPT / res['prefill_s']:.1f} tokens/s)"
            f"; {LLM_STEPS} decode steps (captured) {1e3 * per_step:.3f} ms"
            f" per step = {LLM_BATCH / per_step:.1f} tokens/s (host clock, "
            f"synchronised); peak memory {peak / 2**30:.2f} GiB; decode "
            f"after a {split}-token prefill vs the full prefill: rel "
            f"{f32_part}{rel16:.3e} in bf16 (< {tol16}), with planted "
            f"faults ({fault}; each >= {tol16}){vs32}; launches "
            + " ".join(f"{k}={v}" for k, v in launches.items())
            + f"; profiled prefill: device busy {busy_ms:.3f} ms, of which "
            + ", ".join(f"{label} {name} {us / 1e3:.3f} ms ("
                        f"{us / 1e3 / cnt:.5f} a launch, {cnt} launches)"
                        for name, us, cnt, label in parts)
            + f"; its largest kernels (ms): {top}" + moe + step
            + f" (of the captured decode: {1e3 * res['setup_s']:.3f} ms "
            "warm-up and capture)\n" + ab_line)
    del params, res
    gc.collect()
    torch.cuda.empty_cache()
    return line, launches, kernels, peak


def decode_ab(torch, ops, launcher, cfg, params, tokens, steps: int,
              frames=None) -> tuple:
    """The launcher's decode captured against eager from one prefill
    (``launcher.prefill``): ``steps`` greedy steps through ``decode`` (a
    ``StaticModelDecode``: the first step a warm-up, then its capture,
    then replays) and through ``decode_eager`` on a copy of the cache,
    each on the host clock to a synchronise, with its peak memory; the
    tokens must be identical.  Then the captured step once more, rewound
    to the last position, under the profiler: the device's busy share of
    its host-clock window, and the B6 and B5 launches ``ops.LAUNCHES``
    counts against the profiler's count of their kernels, which must be
    equal.  Returns (line, {side: measurements})."""
    from repro_torch.runtime.graphs import StaticModelDecode
    from repro_torch.tree import map_tree
    dev = tokens.device
    B, P = tokens.shape
    logits, cache, _ = launcher.prefill(cfg, params, tokens, steps, frames)
    twin = map_tree(torch.clone, cache)
    dec = StaticModelDecode(cfg, dev)
    got = {}
    for side in ("captured", "eager"):
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        if side == "captured":
            toks, last = launcher.decode(cfg, params, logits, cache, P,
                                         steps, dec)
        else:
            toks, last = launcher.decode_eager(cfg, params, logits, twin, P,
                                               steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got[side] = {"ms": 1e3 * wall / steps, "tokens": toks, "last": last,
                     "peak": torch.cuda.max_memory_allocated(dev),
                     "reserved": torch.cuda.max_memory_reserved(dev)}
    cap, eag = got["captured"], got["eager"]
    setup_ms = 1e3 * dec.graphs.setup_s
    cap["steady_ms"] = (cap["ms"] * steps - setup_ms) / (steps - 1)
    same = torch.equal(cap["tokens"], eag["tokens"])
    check(same, f"{cfg.name}: captured decode tokens differ from eager's "
          f"in {int((cap['tokens'] != eag['tokens']).sum())} of "
          f"{cap['tokens'].numel()}")
    logit_err = float((cap["last"] - eag["last"]).abs().max())
    del twin
    # one profiled replay at the last position (the cache's contents do
    # not change its work)
    dec.load(cache, cap["last"], torch.full((B,), P + steps - 1,
                                            dtype=torch.int32, device=dev))
    names = {"decode_attention": "decode_kernel",
             "relay_slots": "relay_kernel"}
    before, counts, box = dict(ops.LAUNCHES), {}, []

    def one():
        t0 = time.perf_counter()
        dec.step(params, cache)
        torch.cuda.synchronize()
        box.append(time.perf_counter() - t0)

    _, by_name = device_events(torch, one, counts)
    launched = {k: ops.LAUNCHES[k] - before[k] for k in names}
    seen = {k: sum(c for n, c in counts.items() if v in n)
            for k, v in names.items()}
    check(launched == seen, f"{cfg.name}: a captured decode step's "
          f"launches {launched}, the profiler's {seen}")
    busy = sum(by_name.values()) / 1e3
    window = 1e3 * box[0]
    cap.update(busy_ms=busy, window_ms=window)
    del dec, cache
    gc.collect()
    torch.cuda.empty_cache()
    tps = lambda ms: B / ms * 1e3  # noqa: E731
    line = (f"decode A/B {cfg.name}: one {B} x {P} prefill, {steps} greedy "
            f"steps each side; captured {cap['ms']:.3f} ms a step "
            f"({tps(cap['ms']):.1f} tokens/s; {setup_ms:.3f} ms of warm-up "
            f"and capture in the first; the {steps - 1} replays "
            f"{cap['steady_ms']:.3f} ms a step = "
            f"{tps(cap['steady_ms']):.1f} tokens/s), eager "
            f"{eag['ms']:.3f} ms a step ({tps(eag['ms']):.1f} tokens/s): "
            f"{eag['ms'] / cap['ms']:.2f}x (host clock, synchronised); "
            f"tokens identical ({cap['tokens'].numel()}), last logits "
            f"max_abs_err {logit_err:.3g}; peak allocated / reserved "
            f"captured {cap['peak'] / 2**30:.2f} / "
            f"{cap['reserved'] / 2**30:.2f} GiB, eager "
            f"{eag['peak'] / 2**30:.2f} / {eag['reserved'] / 2**30:.2f} GiB; "
            f"one profiled captured step: device busy {busy:.4f} ms of its "
            f"{window:.4f}-ms window ({100 * busy / window:.1f} %; the "
            f"profiler stretches a replay: {100 * busy / cap['steady_ms']:.1f}"
            f" % of the unprofiled replays' ms a step), "
            "launches " + " ".join(f"{k}={v}" for k, v in launched.items()
                                   if v)
            + " = the profiler's " + " ".join(
                f"{names[k]}={v}" for k, v in seen.items() if v))
    return line, got


def topk_flips(torch, n_moe: int, run):
    """((MoE layers, sequences) bool: whether the sequence's router top-k
    set at the last position differs between the full prefill and the
    decode step; ``run()``'s result) for a ``consistency`` run with one
    decode step: the routes of its full prefill, its shorter prefill and
    its decode step are recorded in that order.  Without MoE layers the
    first is None."""
    if not n_moe:
        return None, run()
    from repro_torch.models import moe as moe_mod
    route, rec = moe_mod.route, []

    def recording(*a, **k):
        out = route(*a, **k)
        rec.append(out[1])
        return out

    moe_mod.route = recording
    try:
        res = run()
    finally:
        moe_mod.route = route
    check(len(rec) == 3 * n_moe, f"recorded {len(rec)} routes, expected "
          f"3 x {n_moe} (one decode step)")
    key = lambda ids: torch.sort(ids, dim=-1).values
    B = res[1].shape[0]
    flipped = torch.stack([
        (key(rec[l].reshape(B, -1, rec[l].shape[-1])[:, -1])
         != key(rec[2 * n_moe + l].reshape(B, -1))).any(-1)
        for l in range(n_moe)])
    return flipped, res


def plant_faults(cfg, n: dict) -> tuple:
    """The faults ``consistency`` plants in an arch's decode: the MoE
    dispatch's where it has MoE layers, attention's where it has GQA
    layers, the state update's where it is attention-free."""
    return tuple(f for f, on in (("dispatch", n["moe"]),
                                 ("attention", n["gqa"]),
                                 ("state", cfg.attn_free)) if on)


def consistency(torch, TM, ops, cfg, params, tokens, split, plant=None):
    """(the last logits of a prefill over all of ``tokens``, the logits
    after a prefill of ``tokens[:, :split]`` and decode of the rest, each
    token fed as the reference's test feeds it).  With ``plant`` (one of
    ``plant_faults``) the decode carries a fault that the bf16 gate must
    see, and the first is None: ``dispatch``, the MoE dispatch places
    every routed row past its expert's capacity (all dropped);
    ``attention``, attention drops the newest PLANT_KEYS keys, or half
    the prompt where that is shorter (lost key splits of the decode
    kernel); ``state``, mamba's middle layer keeps its state from before
    each step (its state update skipped)."""
    dev, dt = tokens.device, params["embed"].dtype
    B, S = tokens.shape
    full = None if plant else TM.prefill(
        cfg, params, tokens, TM.init_cache(cfg, B, S, dt, dev))[0]
    logits, cache = TM.prefill(cfg, params, tokens[:, :split],
                               TM.init_cache(cfg, B, S, dt, dev))
    decode_attention, mid = ops.decode_attention, cfg.n_layers // 2
    relay_slots = ops.relay_slots
    if plant == "dispatch":
        def past_capacity(idx, n_dest):
            slot, load = relay_slots(idx, n_dest)
            return torch.full_like(slot, PLANT_SLOT), load
        ops.relay_slots = past_capacity
    elif plant == "attention":
        drop = min(PLANT_KEYS, S // 2)
        ops.decode_attention = lambda q, k, v, lengths: decode_attention(
            q, k, v, lengths - drop)
    try:
        for pos in range(split, S):
            lengths = torch.full((B,), pos, dtype=torch.int32, device=dev)
            held = [t[mid].clone() for t in cache] \
                if plant == "state" else []
            logits, cache = TM.decode_step(cfg, params,
                                           tokens[:, pos:pos + 1], lengths,
                                           cache)
            for t, h in zip(cache, held):
                t[mid].copy_(h)
    finally:
        ops.decode_attention, ops.relay_slots = decode_attention, relay_slots
    return full, logits


def rel_err(got, want) -> float:
    """max |got - want| / max |want| (tests/test_smoke_archs.py)."""
    return float((got - want).abs().max() / (want.abs().max() + 1e-6))


def _tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree(v, fn) for v in tree]
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def layer_counts(cfg) -> dict:
    """A config's layers by the kernels they launch: GQA attention (B7 a
    prefill, B6 a decode step, twice with whisper's cross-attention; MLA
    runs neither), whisper's encoder layers (B7 not causal), mamba (B8 a
    prefill) and MoE FFNs (B5 a prefill and a decode step)."""
    L, m = cfg.n_layers, cfg.moe
    attn = 0 if cfg.attn_free else (L // cfg.attn_period if cfg.is_hybrid
                                    else L)
    moe = sum(m.enabled and i >= m.first_dense
              and i % m.moe_every == m.moe_offset for i in range(L))
    return {"gqa": 0 if cfg.mla else attn, "mamba": L - attn, "moe": moe,
            "enc": cfg.n_enc_layers if cfg.is_encdec else 0}


def expected_launches(cfg, steps: int) -> dict:
    """The kernel launches of a prefill and ``steps`` decode steps."""
    n = layer_counts(cfg)
    per_step = n["gqa"] * (2 if cfg.is_encdec else 1)
    want = {"flash_attention": n["gqa"] + n["enc"],
            "decode_attention": per_step * steps,
            "ssd_scan": n["mamba"], "relay_slots": n["moe"] * (1 + steps)}
    return {k: v for k, v in want.items() if v}


def train_launches(cfg, steps: int) -> dict:
    """The kernel launches of ``steps`` training steps: each forward runs
    B7 in every attention layer (whisper's encoder too), B8 in every
    mamba layer and B5 in every MoE layer; the backward recomputes the
    plain functions and launches none."""
    n = layer_counts(cfg)
    want = {"flash_attention": (n["gqa"] + n["enc"]) * steps,
            "ssd_scan": n["mamba"] * steps, "relay_slots": n["moe"] * steps}
    return {k: v for k, v in want.items() if v}


# --------------------------------------------------------------------------- #
# phase 7: the reduced configs through the launcher on the card
# --------------------------------------------------------------------------- #


def phase_smoke_configs(torch, ops, TM, launcher, configs, dev="cuda"):
    """``prefill_decode --smoke`` of minitron-4b, mamba2-2.7b, the dense
    and vlm archs (DENSE_ARCHS), the moe and hybrid ones (MOE_ARCHS) and
    whisper-large-v3 (its encoder frames drawn from the seed) on the card
    through the launcher's ``main`` (weights from a CUDA generator):
    finite logits, and the kernel launches of that run counted from zero;
    then prefill and one decode step of each smoke config on the card
    against the CPU with the same weights (f32, rtol = atol = 1e-4)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lines = []
    for arch in ("minitron-4b", "mamba2-2.7b") + DENSE_ARCHS + MOE_ARCHS \
            + ("whisper-large-v3",):
        cfg = configs.smoke_config(configs.get_config(arch))
        for k in ops.LAUNCHES:
            ops.LAUNCHES[k] = 0
        res = launcher.main(["--smoke", "--arch", arch, "--batch",
                             str(SMOKE_BATCH), "--prompt", str(SMOKE_PROMPT),
                             "--steps", str(SMOKE_STEPS)])
        got = {k: v for k, v in ops.LAUNCHES.items() if v}
        want = expected_launches(cfg, SMOKE_STEPS)
        check(got == want, f"{cfg.name}: launcher kernel launches {got}, "
              f"expected {want}")
        check(res["logits"].shape == (SMOKE_BATCH, cfg.vocab_padded)
              and bool(torch.isfinite(res["logits"]).all()),
              f"{cfg.name}: launcher logits not finite of the right shape")
        params = TM.init_params(cfg, torch.Generator().manual_seed(3),
                                torch.float32, "cpu")
        g = torch.Generator().manual_seed(4)
        tokens = torch.randint(0, cfg.vocab, (SMOKE_BATCH, SMOKE_PROMPT),
                               generator=g, dtype=torch.int32)
        frames = torch.randn((SMOKE_BATCH, cfg.enc_frames, cfg.d_model),
                             generator=g) if cfg.is_encdec else None
        out = {}
        for d in ("cpu", dev):
            p = _to(torch, params, d)
            cache = TM.init_cache(cfg, SMOKE_BATCH, SMOKE_PROMPT + 1,
                                  torch.float32, d)
            first, cache = TM.prefill(
                cfg, p, tokens.to(d), cache,
                enc_frames=None if frames is None else frames.to(d))
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


def timed_call(torch, events: list, fn):
    """``fn`` with a pair of CUDA events around each call, kept in
    ``events``."""
    def wrapper(*a, **k):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        out = fn(*a, **k)
        e.record()
        events.append((s, e))
        return out
    return wrapper


def main_drain(torch, RT, ops, TM, interpose, SL, cfg, params, dev,
               captured):
    """The main path's timed drain (no profiler) through ``make_jitted``'s
    captured tick or through ``eager_step``, then a separate profiled pass
    for the device's busy share in steady state.  The eager drain also
    times its parts (admit, decode, complete) by patching their wrappers,
    which a replay does not call.  Returns (line, profile line, launches,
    stats)."""
    routing, ids = routing_config(RT, dev)
    eng = interpose.Engine(cfg, I_LANES, SLOTS, MAX_LEN, device=dev)
    # unroutable requests drop after max_retries (64) attempts; the short
    # backoff cap keeps their retry tail near the routable drain
    loop = SL.ServeLoop(eng, params, routing, admit_batch=ADMIT_R,
                        dtype=torch.float32, backoff_cap=4)
    tick_obj = loop.serve_step
    check(type(tick_obj).__name__ == "StaticTick",
          f"the main path's tick is {tick_obj!r}, not the captured one")
    if not captured:
        loop.serve_step = eng.eager_step
    events = {"admit": [], "decode": [], "complete": [], "tick": []}
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
    if not captured:
        ops.admit_commit = timed_call(torch, events["admit"],
                                      ops.admit_commit)
        ops.complete = timed_call(torch, events["complete"], ops.complete)
        TM.decode_step = timed_call(torch, events["decode"], TM.decode_step)
    timed_tick = timed_call(torch, events["tick"], loop.tick)
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
    side = "captured" if captured else "eager"

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
    if captured:
        check(len(tick_obj.graphs) == 2,
              f"{len(tick_obj.graphs)} graphs captured, not the arrival "
              "and the decode-only tick")
    med = {k: statistics.median(s.elapsed_time(e) for s, e in v)
           for k, v in events.items() if v}
    lat = loop.latency_samples()
    from repro_torch.kernels import tune
    plan = tune.plan_admit(ADMIT_R, (I_LANES, SLOTS), commit=True,
                           device=dev)[0]
    parts = ("median ms per tick (events; the parts from the eager tick, "
             "whose wrappers a replay does not call): " if not captured
             else "median ms per tick (events around the tick): ")
    line = (f"serve ({side}): admission at the tuned block_r={plan}; "
            f"{len(done)} requests completed, {len(dropped)} "
            f"unroutable dropped after {attempts} attempts, "
            f"{loop.ticks} ticks in {total:.3f} s"
            + (f" (of which {tick_obj.graphs.setup_s:.3f} s the two "
               "warm-up ticks and captures)" if captured else "")
            + f"; the last routable one "
            f"after {wall:.3f} s = {len(done) / wall:.1f} req/s"
            + (f" ({len(done) / (wall - tick_obj.graphs.setup_s):.1f} "
               "without the set-up)" if captured else "") + "; "
            + parts + ", ".join(f"{k} {v:.4f}" for k, v in med.items())
            + f"; admit_to_done median {statistics.median(lat['admit_to_done'])}"
            f" ticks, submit_to_done p99 "
            f"{sorted(lat['submit_to_done'])[int(0.99 * len(done))]} ticks;"
            f" overflow {int(m.overflow)}, held_first {loop.held_first}, "
            f"max retries of a completed request "
            f"{max(r.retries for r in done)}")

    busy, wall_us, by_name, window = profiled_pass(
        torch, SL, ops, cfg, loop, ids, N_REQUESTS,
        {k: PROFILER_NAMES[k] for k in ("admit_commit", "complete",
                                        "decode_attention")},
        f"serve ({side})")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    prof = (f"serve profile ({side}; separate pass, steady state): device "
            f"busy {busy * PROFILE_TICKS:.3f} ms over {PROFILE_TICKS} ticks "
            f"= {100 * busy / med['tick']:.1f}% of {PROFILE_TICKS} x the "
            f"unprofiled median tick {med['tick']:.4f} ms (idle "
            f"{100 - 100 * busy / med['tick']:.1f}%); wall under the "
            f"profiler {wall_us / 1e3:.3f} ms; {len(by_name)} kernel names; "
            f"launches in the window "
            + " ".join(f"{k}={v}" for k, v in window.items())
            + ", equal to the profiler's count of their kernels"
            + (" (every one from a graph replay)" if captured else "")
            + "; top: " + "; ".join(f"{n[:48]} {t / 1e3:.3f} ms"
                                    for n, t in top))
    stats = {"req_s": len(done) / wall, "tick_ms": med["tick"],
             "busy_ms": busy}
    return line, prof, launches, stats


def profiled_pass(torch, SL, ops, cfg, loop, ids, first, names: dict,
                  what: str):
    """The device's busy share in steady state: fresh routable requests
    of the main path's traffic (ids from ``first``) at its arrival rate
    through ``loop``; the pool is full again after PROFILE_FROM ticks,
    then PROFILE_TICKS ticks run under the profiler, then the loop
    drains.  ``names``: {``ops.LAUNCHES`` key: the profiler's name of its
    kernel}; the launches counted in the window must equal the profiler's
    count of those kernels, each at least one.  A window in which the
    profiler saw fewer is taken again after it, up to PASS_WINDOWS
    windows (the profiler on an H100 once lost every event of one kernel
    in a window), with a note on stderr.  Returns (busy device ms a tick,
    wall us under the profiler, {kernel: us}, the window's launches)."""
    reqs, nxt, t_start, n_done = [], 0, loop.ticks, len(loop.done)

    def more(ticks):
        n = len(reqs)
        reqs.extend(make_request(SL, cfg, ids, first + i)
                    for i in range(n, n + ticks * ARRIVALS_PER_TICK))

    def step():
        nonlocal nxt
        for r in reqs[nxt:nxt + ARRIVALS_PER_TICK]:
            loop.submit(r)
        nxt += ARRIVALS_PER_TICK
        loop.tick()

    more(PROFILE_FROM)
    while loop.ticks - t_start < PROFILE_FROM:
        step()
    for _ in range(PASS_WINDOWS):
        more(PROFILE_TICKS)
        n0 = dict(ops.LAUNCHES)
        counts: dict = {}
        wall_us, by_name = device_events(
            torch, lambda: [step() for _ in range(PROFILE_TICKS)], counts)
        window = {k: ops.LAUNCHES[k] - n0[k] for k in names}
        seen = {k: sum(c for n, c in counts.items() if key in n)
                for k, key in names.items()}
        if all(seen[k] >= window[k] for k in names):
            break
        print(f"chip_smoke: note: {what}: the profiler saw {seen} of the "
              f"launches {window} in a window",
              file=sys.stderr)
    check(window == seen and min(window.values()) > 0,
          f"{what}: launches counted {window} in the profiled window, the "
          f"profiler saw {seen}")
    loop.drain(max_ticks=3000)
    check(len(loop.done) == n_done + len(reqs),
          f"{what}: the profiled pass did not complete every request")
    return (sum(by_name.values()) / 1e3 / PROFILE_TICKS, wall_us, by_name,
            window)


def ab_drain(torch, SL, cfg, loop, ids, first, midway=None):
    """AB_REQUESTS routable requests of the main path's traffic (ids from
    ``first``) through ``loop`` until it is idle, each tick timed with
    events.  ``midway``: the loop's ControlPlane, which commits at
    CONTROL_COMMIT_TICK of the drain (drain, remove and add an endpoint
    of productpage).  Returns (record, req/s, median tick ms)."""
    reqs = [make_request(SL, cfg, ids, first + i) for i in range(AB_REQUESTS)]
    events, nxt, t_start = [], 0, loop.ticks
    tick = timed_call(torch, events, loop.tick)
    n_done = len(loop.done)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while nxt < len(reqs) or loop.n_queued or loop.inflight:
        if midway is not None and loop.ticks - t_start == CONTROL_COMMIT_TICK:
            pp = "productpage"
            members = [i for _, i in midway.cluster_members(pp)]
            with midway.transaction():
                midway.drain_endpoint(pp, members[0])
                midway.remove_endpoint(pp, members[len(members) // 2])
                midway.add_endpoint(pp, CONTROL_ADD_LANE)
        for r in reqs[nxt:nxt + ARRIVALS_PER_TICK]:
            loop.submit(r)
        nxt += ARRIVALS_PER_TICK
        tick()
        check(loop.ticks - t_start < 2000, "A/B drain: not idle")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    done = loop.done[n_done:]
    check(len(done) == AB_REQUESTS and not loop.dropped,
          f"A/B drain: {len(done)} of {AB_REQUESTS} completed")
    check(not bool(loop.routing.ep_load.any())
          and not bool(loop.state.pool.active.any()),
          "A/B drain: loads or pool not back to zero")
    lists = lambda t: {f: getattr(t, f).tolist() for f in t._fields}  # noqa
    record = {
        "done": [(r.req_id, r.retries, r.submit_tick, r.admit_tick,
                  r.done_tick) for r in done],
        "tokens": [r.tokens for r in done], "ticks": loop.ticks,
        "held_first": loop.held_first, "routing": lists(loop.routing),
        "metrics": lists(loop.state.metrics),
        "pool": lists(loop.state.pool)}
    return (record, AB_REQUESTS / wall,
            statistics.median(s.elapsed_time(e) for s, e in events))


def ab_summary(runs: list, busy_ms: float) -> str:
    """One side of an A/B: its drains' (req/s, median tick ms) and the
    device idle share, each median tick against ``busy_ms``, the busy
    device ms a tick of the side's profiled pass."""
    rps = [r for r, _ in runs]
    ticks = [t for _, t in runs]
    idle = [100 * (1 - busy_ms / t) for t in ticks]
    return (f"req/s " + " / ".join(f"{r:.1f}" for r in rps)
            + f" (median {statistics.median(rps):.1f}); median tick ms "
            + " / ".join(f"{t:.4f}" for t in ticks)
            + f" (median {statistics.median(ticks):.4f}); device idle "
            f"{statistics.median(idle):.1f}% (busy {busy_ms:.4f} ms a tick "
            "from its profiled pass)")


def phase_serve(torch, RT, CT, ops, TM, interpose, SL, cfg, dev="cuda"):
    """The main path through the captured tick (its drain and profiled
    pass), the same through the eager tick (with the parts timed); then
    AB_PAIRS alternating pairs of AB_REQUESTS-request drains, captured
    against eager, each bit-equal to its counterpart (after one untimed
    drain a side that captures its graphs), and one pair with a commit
    and a slow lane midway.  Returns (lines, launches of the captured
    main path)."""
    dev = torch.device(dev)
    params = TM.init_params(cfg, torch.Generator().manual_seed(0),
                            torch.float32, dev)
    lines, stats = [], {}
    for captured in (True, False):
        line, prof, got, stats[captured] = main_drain(
            torch, RT, ops, TM, interpose, SL, cfg, params, dev, captured)
        lines += [line, prof]
        if captured:
            launches = got

    def side(captured, midway=False):
        cp = CT.ControlPlane(*serving_config(RT)) if midway else None
        routing, ids = (cp, cp.ids) if midway else routing_config(RT, dev)
        eng = interpose.Engine(cfg, I_LANES, SLOTS, MAX_LEN, device=dev)
        fault = SL.FaultInjector([SL.Fault(
            I_LANES - 1, "slow", factor=4, start=MIDWAY_FAULT[0],
            end=MIDWAY_FAULT[1])]) if midway else None
        loop = SL.ServeLoop(eng, params, routing, admit_batch=ADMIT_R,
                            dtype=torch.float32, backoff_cap=4, fault=fault)
        if not captured:
            loop.serve_step = eng.eager_step
        return loop, ids, cp

    loops = {c: side(c) for c in (True, False)}
    first = {c: ab_drain(torch, SL, cfg, loops[c][0], loops[c][1],
                         10 * N_REQUESTS)[0] for c in (True, False)}
    check(first[True] == first[False], "A/B: the captured warm-up drain "
          "differs from the eager one")
    runs = {True: [], False: []}
    for p in range(AB_PAIRS):
        order = (True, False) if p % 2 == 0 else (False, True)
        recs = {}
        for c in order:
            recs[c], rps, tick_ms = ab_drain(
                torch, SL, cfg, loops[c][0], loops[c][1],
                (11 + p) * N_REQUESTS)
            runs[c].append((rps, tick_ms))
        check(recs[True] == recs[False], f"A/B pair {p}: the captured "
              "drain differs from the eager one")
    mid = {}
    for c in (True, False):
        loop, ids, cp = side(c, midway=True)
        mid[c] = ab_drain(torch, SL, cfg, loop, ids, N_UNROUTABLE,
                          midway=cp)[0]
        check(mid[c]["routing"]["version"] >= 1, "A/B midway: no commit")
    check(mid[True] == mid[False], "A/B midway: the captured drain with a "
          "commit and a slow lane differs from the eager one")

    lines.append(
        f"serve A/B: {AB_PAIRS} alternating pairs of {AB_REQUESTS}-request "
        f"drains through one captured and one eager loop (after one untimed "
        f"drain each), each pair bit-equal (every completion, tick, token, "
        f"routing counter, EWMA, metric and pool cell; loads and pool back "
        f"to zero); captured: "
        f"{ab_summary(runs[True], stats[True]['busy_ms'])}; eager: "
        f"{ab_summary(runs[False], stats[False]['busy_ms'])}; a "
        f"drain with a commit at tick {CONTROL_COMMIT_TICK} and lane "
        f"{I_LANES - 1} 4x slow over ticks {MIDWAY_FAULT[0]}-"
        f"{MIDWAY_FAULT[1]}: captured equals eager "
        f"({len(mid[True]['done'])} requests, version "
        f"{mid[True]['routing']['version']})")
    return lines, launches


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
        graphs = (loop.serve_step.graphs if kind == "xlb"
                  else eng.decode.graphs)
        check(len(graphs) == (2 if kind == "xlb" else
                              I_LANES if kind == "istio" else 1),
              f"{kind}: {len(graphs)} captured graphs")

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
            f"engine {kind} (captured: {len(graphs)} CUDA graph"
            f"{'s' if len(graphs) > 1 else ''}, "
            + ("the arrival and the decode-only tick" if kind == "xlb"
               else "one decode a KV cache")
            + f", set-up {graphs.setup_s:.3f} s): "
            f"{ENGINE_REQUESTS} requests in {ticks} ticks, "
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
            # the live state is the captured tick's static buffers, which
            # the next tick overwrites: the splice's inputs, as they were
            state0 = loop.state._replace(
                routing=RT.RoutingState(*[t.clone()
                                          for t in loop.state.routing]),
                pool=loop.state.pool._replace(
                    endpoint=loop.state.pool.endpoint.clone()))
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
    with cpu_plans():
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
    with cpu_plans():
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


@contextlib.contextmanager
def sanitizer(on: bool):
    """``XLB_SANITIZE`` set to 1 or 0 inside, put back after: a loop's
    ``make_jitted`` reads it when the loop is built, the eager guards and
    the loop law at every tick."""
    old = os.environ.get("XLB_SANITIZE")
    os.environ["XLB_SANITIZE"] = "1" if on else "0"
    try:
        yield
    finally:
        if old is None:
            del os.environ["XLB_SANITIZE"]
        else:
            os.environ["XLB_SANITIZE"] = old


def loop_record(loop) -> dict:
    """Everything a drain leaves: completions, tokens, ticks, routing,
    metrics and pool."""
    lists = lambda t: {f: getattr(t, f).tolist() for f in t._fields}  # noqa
    return {"done": [(r.req_id, r.retries, r.submit_tick, r.admit_tick,
                      r.done_tick) for r in loop.done],
            "tokens": [r.tokens for r in loop.done], "ticks": loop.ticks,
            "held_first": loop.held_first, "routing": lists(loop.routing),
            "metrics": lists(loop.state.metrics),
            "pool": lists(loop.state.pool)}


def state_fields(loop) -> dict:
    """A copy of the loop state's routing, pool and metrics tensors."""
    return {f"{n}.{g}": getattr(getattr(loop.state, n), g).clone()
            for n in ("routing", "pool", "metrics")
            for g in getattr(loop.state, n)._fields}


def san_loop(torch, RT, interpose, SL, MS, cfg, params, dev, sanitized,
             shards=1, draws=None):
    """A ServeLoop over the main path's engine (``shards``-way on a
    one-process mesh) built with XLB_SANITIZE set or not; (loop, ids,
    its make_jitted tick, a StaticTick)."""
    routing, ids = routing_config(RT, dev)
    kw = {} if shards == 1 else dict(
        shards=shards, shard_mesh=MS.make_shard_mesh(shards, device=dev))
    with sanitizer(sanitized):
        eng = interpose.Engine(cfg, I_LANES, SLOTS, MAX_LEN, device=dev,
                               **kw)
        if draws is not None:
            eng.draws = draws
        loop = SL.ServeLoop(eng, params, routing, admit_batch=ADMIT_R,
                            dtype=torch.float32, backoff_cap=4)
    tick = loop.serve_step
    check(type(tick).__name__ == "StaticTick" and tick.sanitize == sanitized,
          f"sanitize: make_jitted (XLB_SANITIZE={int(sanitized)}, M "
          f"{shards}) gave {tick!r}, not the {'sanitizing ' * sanitized}"
          "captured tick")
    return loop, ids, tick


def phase_sanitize(torch, RT, TM, interpose, SL, MS, INV, policies, ops,
                   cfg, dev="cuda", gpu=""):
    """The sanitized tick (XLB_SANITIZE=1), ``make_jitted``'s sanitizing
    ``StaticTick`` (the reference's ``jit(checkify(serve_step))``):

    * the main path's traffic for SAN_TICKS ticks, plain and sanitized,
      both captured: every sanitized tick reads its verdicts once (the
      admit and complete laws checked inside the graphs) and runs the
      loop law on the host, none fires, and the two runs end bit-equal;
      the same at M SAN_SHARDS on a one-process mesh (whose body calls no
      guard); a planted off-by-one release through the eager
      ``INV.guard`` must raise naming its law;
    * a leak planted in the admission's output from its SAN_LEAK_AT-th
      launch (a device counter the wrapper increments, recorded in the
      arrival graph at its capture) must raise from a replay naming
      load-delta-conservation, and leave the loop's state as it was;
    * SAN_AB_PAIRS alternating pairs of AB_REQUESTS-request drains, the
      captured sanitized tick against ``eager_step`` under the sanitizer,
      each pair bit-equal and bit-equal to the plain captured drain (after
      one untimed drain each); one profiled pass a side, whose launches
      must equal the profiler's count of their kernels.

    Returns (lines, the 40-tick runs' launches)."""
    dev = torch.device(dev)
    params = TM.init_params(cfg, torch.Generator().manual_seed(0),
                            torch.float32, dev)
    calls, last = {"admit": 0, "complete": 0, "loop": 0}, {}
    guard, assert_host = ops.guard, SL.assert_host
    capturing = lambda: dev.type == "cuda" and \
        torch.cuda.is_current_stream_capturing()  # noqa: E731

    def counted_guard(scope, ctx):
        calls[scope] += 1
        if not capturing():         # the warm-up's values, kept
            last[scope] = {k: torch.as_tensor(v).clone()
                           for k, v in ctx.items()}
        guard(scope, ctx)

    def counted_host(scope, ctx):
        calls[scope] += 1
        assert_host(scope, ctx)

    def run(sanitized, shards=1):
        loop, ids, tick = san_loop(torch, RT, interpose, SL, MS, cfg,
                                   params, dev, sanitized, shards,
                                   host_draws(torch, policies, dev, 3))
        reqs = [make_request(SL, cfg, ids, i)
                for i in range(SAN_TICKS * ARRIVALS_PER_TICK)]
        ms = []
        sync(torch, dev)
        with sanitizer(sanitized):
            for t in range(SAN_TICKS):
                for r in reqs[t * ARRIVALS_PER_TICK:
                              (t + 1) * ARRIVALS_PER_TICK]:
                    loop.submit(r)
                t0 = time.perf_counter()
                loop.tick()
                ms.append((time.perf_counter() - t0) * 1e3)
        sync(torch, dev)
        return loop, tick, ms

    for k in ops.LAUNCHES:
        ops.LAUNCHES[k] = 0
    plain, _, plain_ms = run(False)
    ops.guard, SL.assert_host = counted_guard, counted_host
    try:
        check(calls == {"admit": 0, "complete": 0, "loop": 0},
              "sanitize: a guard ran with XLB_SANITIZE=0")
        san, san_tick, san_ms = run(True)
    finally:
        ops.guard, SL.assert_host = guard, assert_host
    launches = {k: ops.LAUNCHES[k] for k in ("admit_commit", "complete",
                                             "decode_attention")}
    per_tick = len(INV.laws("admit")) + len(INV.laws("complete"))
    check(san_tick.verdict_reads == calls["loop"] == SAN_TICKS
          and san_tick.laws_checked == SAN_TICKS * per_tick,
          f"sanitize: {san_tick.verdict_reads} verdict reads and "
          f"{san_tick.laws_checked} device laws checked, {calls['loop']} "
          f"loop laws, in {SAN_TICKS} arrival ticks")
    check(loop_record(san) == loop_record(plain),
          "sanitize: the sanitized run differs from the plain one")
    check(min(launches.values()) > 0,
          f"sanitize: kernels not launched: {launches}")
    plain4, _, plain4_ms = run(False, SAN_SHARDS)
    san4, san4_tick, san4_ms = run(True, SAN_SHARDS)
    check(loop_record(san4) == loop_record(plain4),
          f"sanitize: the sanitized run at M {SAN_SHARDS} differs from the "
          "plain one")
    check(san4_tick.verdict_reads == 0,
          f"sanitize: the sharded tick read verdicts "
          f"{san4_tick.verdict_reads} times, though its body has no guard")
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
    lines = [
        f"sanitize: the main path's traffic for {SAN_TICKS} ticks through "
        f"the sanitizing captured tick (XLB_SANITIZE=1, "
        f"{len(san_tick.graphs)} programs; the guards traced "
        f"{calls['admit']} admit / {calls['complete']} complete times, in "
        f"warm-ups and captures): {san_tick.verdict_reads} verdict reads, "
        f"one a tick, {san_tick.laws_checked} device laws checked inside "
        f"the graphs and {calls['loop']} loop laws on the host, none fired;"
        f" bit-equal to the plain captured run ({len(san.done)} done, every "
        f"tick, token, routing counter, EWMA, metric and pool cell); at M "
        f"{SAN_SHARDS} on a one-process mesh the same, bit-equal to the "
        f"plain M {SAN_SHARDS} run, {san4_tick.verdict_reads} verdict reads "
        f"(its body calls no guard); the planted off-by-one release raised:"
        f" {planted}; median tick (host clock) sanitized "
        f"{statistics.median(san_ms):.4f} ms vs plain "
        f"{statistics.median(plain_ms):.4f} ms, at M {SAN_SHARDS} "
        f"{statistics.median(san4_ms):.4f} vs "
        f"{statistics.median(plain4_ms):.4f} ms, on {gpu}; kernels: "
        + " ".join(f"{k}={v}" for k, v in launches.items())]

    # a leak that only a replay sets off: the wrapper's counter reaches
    # SAN_LEAK_AT at the second replay of the arrival graph
    trigger = torch.zeros((), dtype=torch.int32, device=dev)
    name = "admit_cuda" if dev.type == "cuda" else "admit_commit"
    real = getattr(ops._rm, name)

    def leaky(*a, **k):
        res = real(*a, **k)
        trigger.add_(1)
        return res._replace(ep_load=res.ep_load + (
            trigger >= SAN_LEAK_AT).to(torch.int32))

    loop, ids, tick = san_loop(torch, RT, interpose, SL, MS, cfg, params,
                               dev, True)
    raised = None
    setattr(ops._rm, name, leaky)
    try:
        with sanitizer(True):
            for t in range(2 * SAN_LEAK_AT):
                for i in range(ARRIVALS_PER_TICK):
                    loop.submit(make_request(
                        SL, cfg, ids, N_UNROUTABLE + t * ARRIVALS_PER_TICK
                        + i))
                before, n_graphs = state_fields(loop), \
                    len(tick.graphs)
                try:
                    loop.tick()
                except AssertionError as e:
                    raised = (t, str(e))
                    break
    finally:
        setattr(ops._rm, name, real)
    check(raised is not None and raised[0] == SAN_LEAK_AT - 1
          and "XLB_SANITIZE[admit/load-delta-conservation]" in raised[1],
          f"sanitize: the leak planted in a replay raised {raised}")
    kept = state_fields(loop)
    check(loop.ticks == raised[0] and int(trigger) == SAN_LEAK_AT
          and len(tick.graphs) == n_graphs
          and all(torch.equal(kept[k], v) for k, v in before.items()),
          f"sanitize: after the leak's tick: {loop.ticks} ticks, counter "
          f"{int(trigger)}, {len(tick.graphs)} programs (before "
          f"{n_graphs}), the state "
          + ("kept" if all(torch.equal(kept[k], v) for k, v in
                           before.items()) else "changed"))
    lines.append(
        f"sanitize leak: a load leak planted in the admission kernel's "
        f"output from its launch {SAN_LEAK_AT} on (a device counter the "
        f"wrapper increments, recorded in the arrival graph at its capture)"
        f" raised on tick {raised[0]}, a replay of a graph captured before "
        f"it ({n_graphs} programs, none new): {raised[1]}; the loop's tick "
        f"count, routing (ep_load {int(before['routing.ep_load'].sum())} "
        f"outstanding), pool and metrics as before that tick")

    # the A/B: the captured sanitized tick against the eager one, each
    # pair against the plain captured tick too
    kinds = ("captured", "eager", "plain")
    loops = {k: san_loop(torch, RT, interpose, SL, MS, cfg, params, dev,
                         k != "plain") for k in kinds}
    loops["eager"][0].serve_step = loops["eager"][0].balancer.eager_step
    first = {}
    for k in kinds:
        with sanitizer(k != "plain"):
            first[k] = ab_drain(torch, SL, cfg, loops[k][0], loops[k][1],
                                10 * N_REQUESTS)[0]
    check(first["captured"] == first["eager"] == first["plain"],
          "sanitize A/B: the untimed drains differ")
    runs = {k: [] for k in kinds}
    for p in range(SAN_AB_PAIRS):
        recs = {}
        order = ("captured", "eager") if p % 2 == 0 else ("eager",
                                                          "captured")
        for k in order + ("plain",):
            with sanitizer(k != "plain"):
                recs[k], rps, tick_ms = ab_drain(
                    torch, SL, cfg, loops[k][0], loops[k][1],
                    (11 + p) * N_REQUESTS)
            runs[k].append((rps, tick_ms))
        check(recs["captured"] == recs["eager"] == recs["plain"],
              f"sanitize A/B pair {p}: the captured sanitized, eager "
              "sanitized and plain captured drains differ")
    static = loops["captured"][2]
    check(static.verdict_reads == loops["captured"][0].ticks,
          f"sanitize A/B: {static.verdict_reads} verdict reads in "
          f"{loops['captured'][0].ticks} ticks")
    n_graphs = len(static.graphs)
    busy, window = {}, {}
    for k in ("captured", "eager"):
        with sanitizer(True):
            busy[k], _, _, window[k] = profiled_pass(
                torch, SL, ops, cfg, loops[k][0], loops[k][1],
                (11 + SAN_AB_PAIRS) * N_REQUESTS,
                {n: PROFILER_NAMES[n] for n in ("admit_commit", "complete",
                                                "decode_attention")},
                f"sanitize A/B ({k})")
    check(len(static.graphs) == n_graphs,
          "sanitize A/B: the profiled pass captured a program anew")
    lines.append(
        f"sanitize A/B on {gpu}: {SAN_AB_PAIRS} alternating pairs of "
        f"{AB_REQUESTS}-request drains, the sanitizing captured tick "
        f"against eager_step under XLB_SANITIZE=1 (after one untimed drain "
        f"each), each pair bit-equal and bit-equal to the plain captured "
        f"tick's drain (every completion, tick, token, routing counter, "
        f"EWMA, metric and pool cell); captured: "
        f"{ab_summary(runs['captured'], busy['captured'])}; eager: "
        f"{ab_summary(runs['eager'], busy['eager'])}; plain captured "
        f"(after each pair, not alternated): median tick ms "
        + " / ".join(f"{t:.4f}" for _, t in runs["plain"])
        + ", req/s " + " / ".join(f"{r:.1f}" for r, _ in runs["plain"])
        + f"; {static.verdict_reads} verdict reads in "
        f"{loops['captured'][0].ticks} ticks; launches in the captured "
        f"profiled window (every one from a replay of the "
        f"{n_graphs} programs) "
        + " ".join(f"{k}={v}" for k, v in window["captured"].items())
        + ", the eager window's "
        + " ".join(f"{k}={v}" for k, v in window["eager"].items())
        + ", each equal to the profiler's count of its kernels")
    return lines, launches


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
                  shards, timed=False, mesh=None, block_r=None,
                  captured=True):
    """ENGINE_REQUESTS routable main-path requests through ServeLoop over
    Engine(shards=``shards``) on ``dev`` (eos -1: completion depends only
    on the length, so the card and the CPU finish the same requests on the
    same ticks), draws from one seeded CPU generator, through
    ``make_jitted``'s tick (captured, but on a rank mesh) or, with
    ``captured`` False, ``eager_step``.  ``timed``: each tick timed with
    events, and on an eager tick its admission and completion too (by
    patching their wrappers, which a replay does not call).  ``mesh``: the
    shard mesh (None: ``make_shard_mesh``); ``block_r``: the admission
    plan (None: the tuner's).  Returns (the drain's record, its timing and
    the captured programs' count and set-up seconds, its kernel
    launches); on a rank mesh the record's pool is the rank's slice."""
    routing, ids = routing_config(RT, dev)
    params = TM.init_params(cfg, torch.Generator().manual_seed(0),
                            torch.float32, dev)
    kw = {} if shards == 1 else dict(
        shards=shards, shard_mesh=mesh if mesh is not None
        else MS.make_shard_mesh(shards, device=dev))
    eng = interpose.Engine(cfg, I_LANES, SLOTS, MAX_LEN, eos=-1, device=dev,
                           block_r=block_r, **kw)
    eng.draws = host_draws(torch, policies, dev, SHARD_SEED)
    loop = SL.ServeLoop(eng, params, routing, admit_batch=ADMIT_R,
                        dtype=torch.float32, backoff_cap=4)
    if not captured:
        loop.serve_step = eng.eager_step
    static = loop.serve_step if type(loop.serve_step).__name__ \
        == "StaticTick" else None
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
    if timed and static is None:
        for n, part, fn in zip(names, ("admit", "complete"), originals):
            setattr(ops, n, timed_call(part, fn))
    if timed:
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
                                             "relay_slots",
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
    return record, dict(
        wall=wall, med=med, arrival_ticks=len(events["admit"]),
        graphs=len(static.graphs) if static is not None else 0,
        setup_s=static.graphs.setup_s if static is not None else 0.0), \
        launches


def sharded_ab(torch, RT, SL, MS, ops, interpose, cfg, params, dev, M: int,
               gpu: str) -> str:
    """The sharded tick on a one-process M-way mesh, captured against
    eager: two ServeLoops over Engine(shards=M) at the main path's shape,
    one through ``make_jitted``'s captured tick and one through
    ``eager_step``; one untimed AB_REQUESTS-request drain each (the
    captured side captures its programs there), then SHARD_AB_PAIRS
    alternating pairs, each pair bit-equal (``ab_drain``); then one
    profiled pass a side (``profiled_pass``: its launches equal to the
    profiler's count of SHARD_KERNELS, its busy device ms a tick).
    Returns the line."""
    def side(captured):
        routing, ids = routing_config(RT, dev)
        eng = interpose.Engine(cfg, I_LANES, SLOTS, MAX_LEN, device=dev,
                               shards=M,
                               shard_mesh=MS.make_shard_mesh(M, device=dev))
        loop = SL.ServeLoop(eng, params, routing, admit_batch=ADMIT_R,
                            dtype=torch.float32, backoff_cap=4)
        static = loop.serve_step
        check(type(static).__name__ == "StaticTick",
              f"sharded A/B M={M}: make_jitted gave {static!r}, not the "
              "captured tick")
        if not captured:
            loop.serve_step = eng.eager_step
        return loop, ids, static

    loops = {c: side(c) for c in (True, False)}
    first = {c: ab_drain(torch, SL, cfg, loops[c][0], loops[c][1],
                         10 * N_REQUESTS)[0] for c in (True, False)}
    check(first[True] == first[False], f"sharded A/B M={M}: the captured "
          "warm-up drain differs from the eager one")
    runs = {True: [], False: []}
    for p in range(SHARD_AB_PAIRS):
        recs = {}
        for c in ((True, False) if p % 2 == 0 else (False, True)):
            recs[c], rps, tick_ms = ab_drain(
                torch, SL, cfg, loops[c][0], loops[c][1],
                (11 + p) * N_REQUESTS)
            runs[c].append((rps, tick_ms))
        check(recs[True] == recs[False], f"sharded A/B M={M} pair {p}: the "
              "captured drain differs from the eager one")
    busy, window = {}, {}
    for c in (True, False):
        busy[c], _, _, window[c] = profiled_pass(
            torch, SL, ops, cfg, loops[c][0], loops[c][1],
            (11 + SHARD_AB_PAIRS) * N_REQUESTS, SHARD_KERNELS,
            f"sharded A/B M={M} ({'captured' if c else 'eager'})")
    static = loops[True][2]
    check(len(static.graphs) <= M + 1, f"sharded A/B M={M}: "
          f"{len(static.graphs)} programs captured, more than M + 1")
    return (
        f"sharded A/B M={M} on {gpu}: {SHARD_AB_PAIRS} alternating pairs "
        f"of {AB_REQUESTS}-request drains through ServeLoop over "
        f"Engine(shards={M}) on a one-process mesh, one captured and one "
        f"eager loop (after one untimed drain each), each pair bit-equal "
        f"(every completion, tick, token, routing counter, EWMA, metric "
        f"and pool cell); captured: {ab_summary(runs[True], busy[True])}; "
        f"eager: {ab_summary(runs[False], busy[False])}; the captured "
        f"loop holds {len(static.graphs)} programs (set-up "
        f"{static.graphs.setup_s:.3f} s); launches in the captured "
        f"profiled window "
        + " ".join(f"{k}={v}" for k, v in window[True].items())
        + ", the eager window's "
        + " ".join(f"{k}={v}" for k, v in window[False].items())
        + ", each equal to the profiler's count of its kernels")


def phase_sharded(torch, RT, B, ops, interpose, SL, TM, MS, SA, policies,
                  cfg, b3_ms, dev="cuda", gpu=""):
    """Sharded admission and completion (``kernels/shard_admit.py``) on the
    card at each M of SHARDS: ``ops.admit_commit_sharded`` at the serving
    shape, a ragged batch and with an idle ingress host (a quarter of
    padding rows), and ``ops.complete_sharded`` at the serving shape, each
    bit-exact against the unsharded wrapper on the same card tensors and
    against the sharded plain versions on the CPU, timed; then drains of
    ENGINE_REQUESTS requests through ServeLoop over Engine(shards=M) on a
    one-process mesh: at M 4 through the captured tick against its eager
    tick, shards=1 on the card and shards=4 on the CPU, at M 2 captured
    against shards=1 (every count, tick and routing bit; the tokens too
    between the card runs); then ``sharded_ab`` at each M of
    SHARD_AB_WIDTHS.  ``gpu``: the card's name and power limit."""
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
                  and n["relay_slots"] == 1 and n["admit_commit"] == 0,
                  f"sharded admit[{label} M={M}]: launches {n}, "
                  f"live shards {live}")
            check(label != "idle" or M != 4 or live == [True, False, True,
                                                        True],
                  f"sharded admit[idle M=4]: live shards {live}")
            err = max_abs_err(torch, out_pairs(got, want))
            with cpu_plans():
                cpu = ops.admit_commit_sharded(
                    *cargs, mesh=MS.make_shard_mesh(M, device="cpu"))
            err_cpu = max_abs_err(torch, out_pairs(to_cpu(got), cpu))
            line = (f"sharded admit_commit[{label} R={R} I={I} C={C} M={M}] "
                    f"max_abs_err={err} vs admit_commit on the card, "
                    f"{err_cpu} vs the CPU; launches admit={n['admit']} "
                    f"route_match={n['route_match']} relay_slots="
                    f"{n['relay_slots']}; ok={int(got.ok.sum())}"
                    f" held={int(got.held)} no_route={int(got.no_route)}")
            if label != "idle":
                prof = profile_calls(
                    torch, call, expect=("admit_kernel", "route_kernel"))
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
    b3 = profile_kernel(torch, call, "admit_kernel")[0]
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
        b1 = profile_kernel(torch, call, "complete_kernel")[0]
        check(b1 is not None, f"sharded complete M={M}: no kernel seen")
        t = dict(call_ms=cuda_ms(torch, call), b1_ms=b1 / M)
        timing[f"complete[M={M}]"] = t
        lines.append(
            f"sharded complete[I={I_LANES} C={SLOTS} M={M}] max_abs_err="
            f"{err} vs complete on the card (EWMAs included), {err_cpu} vs "
            f"the CPU; done={int(got.done.sum())}; call ms "
            f"{t['call_ms']:.4f}, B1 device ms per launch at "
            f"({I_LANES // M}, {SLOTS}): {t['b1_ms']:.5f}")

    run = lambda d, m, **kw: sharded_drain(  # noqa: E731
        torch, RT, TM, interpose, SL, MS, policies, ops, cfg, d, m, **kw)
    one, t1, _ = run(dev, 1, timed=True, captured=False)
    check(run(dev, 1)[0] == one, "sharded drain: shards=1 through the "
          "captured tick differs from the eager tick")
    four_eager, t4, eager_launches = run(dev, 4, timed=True, captured=False)
    four, t4c, launches = run(dev, 4, timed=True)
    two, t2c, _ = run(dev, 2, timed=True)
    with cpu_plans():
        four_cpu, _, _ = run(torch.device("cpu"), 4)
    check(four == four_eager, "sharded drain: shards=4 through the captured "
          "tick differs from shards=4 through the eager tick")
    check(four == one, "sharded drain: shards=4 on the card differs from "
          "shards=1 on the card")
    check(two == one, "sharded drain: shards=2 through the captured tick "
          "differs from shards=1 on the card")
    untok = lambda r: {k: v for k, v in r.items() if k != "tokens"}  # noqa
    check(untok(four) == untok(four_cpu), "sharded drain: shards=4 on the "
          "card differs from shards=4 on the CPU")
    check(launches == eager_launches,
          f"sharded drain: the captured M=4 drain launched {launches}, the "
          f"eager one {eager_launches}")
    check(min(launches[k] for k in ("admit", "complete", "route_match",
                                    "relay_slots")) > 0
          and launches["admit_commit"] == 0,
          f"sharded drain: kernels not launched as the sharded path does: "
          f"{launches}")
    for M, t in ((2, t2c), (4, t4c)):
        check(2 <= t["graphs"] <= M + 1,
              f"sharded drain M={M}: {t['graphs']} programs captured, not "
              f"the decode-only tick and at most M arrival ticks")
    arr = t4["arrival_ticks"]
    n_req = ENGINE_REQUESTS
    for M, rec, t in ((1, one, t1), (4, four_eager, t4)):
        med = t["med"]
        lines.append(
            f"sharded drain M={M} (eager): {n_req} requests in "
            f"{rec['ticks']} ticks, {t['wall']:.3f} s = "
            f"{n_req / t['wall']:.1f} req/s; median ms per tick "
            f"{med['tick']:.4f}, admit {med['admit']:.4f}, complete "
            f"{med['complete']:.4f} (events); held_first "
            f"{rec['held_first']}")
    for M, rec, t in ((2, two, t2c), (4, four, t4c)):
        lines.append(
            f"sharded drain M={M} (captured) on {gpu}: {n_req} requests in "
            f"{rec['ticks']} ticks, {t['wall']:.3f} s = "
            f"{n_req / t['wall']:.1f} req/s (of which {t['setup_s']:.3f} s "
            f"the warm-ups and captures of {t['graphs']} programs: the "
            f"decode-only tick and {t['graphs'] - 1} live-shard sets); "
            f"median ms per tick {t['med']['tick']:.4f} (events)")
    lines.append(
        f"sharded drain: shards=4 through the captured tick equals its "
        f"eager tick, shards=1 on the card (the timed M=1 drain through "
        f"the eager tick, equal to its captured drain) and shards=4 on the "
        f"CPU (every count, tick and routing bit; every token too on the "
        f"card); shards=2 through the captured tick equals shards=1; the "
        f"captured M=4 drain launched what the eager one did; launches per "
        f"arrival tick ({arr} of {four['ticks']}): B3 "
        f"{launches['admit'] / arr:.3f}, B4 {launches['route_match'] / arr:.3f},"
        f" B5 {launches['relay_slots'] / arr:.3f}; B1 per tick {launches['complete'] / four['ticks']:.3f}; B3 at the "
        f"serving shape unsharded (width C = {SLOTS}): {b3_ms}")
    params = TM.init_params(cfg, torch.Generator().manual_seed(0),
                            torch.float32, dev)
    for M in SHARD_AB_WIDTHS:
        lines.append(sharded_ab(torch, RT, SL, MS, ops, interpose, cfg,
                                params, dev, M, gpu))
    return lines, timing, {k: launches[k] for k in ("admit", "complete",
                                                    "route_match",
                                                    "relay_slots")}


# --------------------------------------------------------------------------- #
# phase 5, continued: the sharded datapath across processes
# --------------------------------------------------------------------------- #


def rank_case(torch, RT, routing0, label, R, I, C, M, dev):
    """An admission case of the ranks phase on ``dev``, from
    ``admit_inputs``; in "idle" shard 1's rows of the M-way split are all
    padding (an idle ingress host)."""
    routing, reqs, pool, rnd, gum = admit_inputs(torch, RT, routing0, R, I,
                                                 C, seed=R, dev=dev)
    if label == "idle":
        reqs[0] = reqs[0].clone()
        reqs[0][R // M:2 * R // M] = -1
    return routing, reqs, pool, rnd, gum


def cpu_fields(out) -> dict:
    """{field: CPU tensor} of an AdmitCommitOut / CompleteOut, the pool's
    fields as "pool.<field>"."""
    return {f: t.cpu() for f, _, t in out_pairs(out, out)}


def rank_run(torch, dist, MS, rank: int, world: int, dev: str,
             group) -> dict:
    """A rank's work in the ranks phase at width ``world``, on card 0 (or
    the CPU, to rehearse) over the rank mesh of ``group``: on the card,
    which collectives gloo takes CUDA tensors for;
    ``ops.admit_commit_sharded`` on its rows of each of RANK_CASES and its
    pool slice; ``ops.complete_sharded`` on its slice of
    ``complete_inputs``; ENGINE_REQUESTS requests through ``ServeLoop``
    over ``Engine(shards=world)`` (``sharded_drain``), timed, then again
    under the profiler.  Returns its results (CPU tensors and lists)."""
    from repro_torch.configs import XLB_SERVICE_MODEL as cfg
    from repro_torch.core import balancer as B
    from repro_torch.core import interpose, policies
    from repro_torch.core import routing_table as RT
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import route_match as rm
    from repro_torch.kernels import shard_admit as SA
    from repro_torch.models import model as TM
    from repro_torch.runtime import serve_loop as SL
    dev = torch.device("cuda", 0) if dev == "cuda" else torch.device(dev)
    probe = {}
    if dev.type == "cuda":
        _build.library(dev)
        x = torch.arange(4 * world, dtype=torch.int32, device=dev)
        gather = getattr(dist, "all_gather_single", None) \
            or dist.all_gather_into_tensor
        for op, fn in (
                ("all_reduce", lambda: dist.all_reduce(x[:4].clone(),
                                                       group=group)),
                ("all_gather", lambda: gather(torch.empty_like(x), x[:4],
                                              group=group)),
                ("all_to_all", lambda: dist.all_to_all_single(
                    torch.empty_like(x), x, group=group))):
            try:
                fn()
                torch.cuda.synchronize()
                probe[op] = "takes"
            except Exception as e:             # noqa: BLE001 (the finding)
                probe[op] = f"refuses ({type(e).__name__}: {str(e)[:160]})"
    mesh = MS.make_shard_mesh(world, device=dev, group=group)
    out = {"probe": probe, "mesh": type(mesh).__name__, "admit": {}}
    calls = dict.fromkeys(SHARD_KERNELS, 0)   # the first call of each case
    rows = lambda t, fill=0: SA.held_rows(t, mesh, "shard", fill)  # noqa
    routing0, _ = routing_config(RT, "cpu")
    for label, R, I, C in RANK_CASES:
        routing, reqs, pool, rnd, gum = rank_case(torch, RT, routing0, label,
                                                  R, I, C, world, dev)
        batch = B.RequestBatch(rows(reqs[0], -1), *map(rows, reqs[1:]))
        n = I // world
        pstate = B.PoolState(*(t[rank * n:(rank + 1) * n] for t in pool))
        rnd_h, gum_h = rows(rnd), rows(gum)
        live = SA.live_shards(batch.req_id, 1)
        call = lambda: ops.admit_commit_sharded(  # noqa: E731
            batch, routing, pstate, rnd_h, gum_h, mesh=mesh, live=live,
            block_r=rm.TILE)
        n0 = dict(ops.LAUNCHES)
        got = call()
        torch.cuda.synchronize()
        launched = {k: ops.LAUNCHES[k] - n0[k] for k in SHARD_KERNELS}
        for k, v in launched.items():
            calls[k] += v
        out["admit"][label] = (cpu_fields(got), launched, live,
                               cuda_ms(torch, call, reps=20, warm=2))
    args = complete_inputs(torch, RT, dev)
    n = I_LANES // world
    pstate = B.PoolState(*(t[rank * n:(rank + 1) * n] for t in args[:6]))
    nxt = args[6][rank * n:(rank + 1) * n]
    call = lambda: ops.complete_sharded(  # noqa: E731
        pstate, nxt, *args[7:], mesh=mesh, eos=1, max_len=MAX_LEN)
    n0 = ops.LAUNCHES["complete"]
    got = call()
    calls["complete"] += ops.LAUNCHES["complete"] - n0
    out["complete"] = (cpu_fields(got), cuda_ms(torch, call, reps=20,
                                                warm=2))
    drain = lambda timed: sharded_drain(  # noqa: E731
        torch, RT, TM, interpose, SL, MS, policies, ops, cfg, dev, world,
        timed, mesh=mesh, block_r=rm.TILE)
    out["drain"], out["timing"], out["launches"] = drain(True)
    counts: dict = {}
    device_events(torch, lambda: drain(False), counts)
    out["profiled"] = {k: sum(c for name, c in counts.items() if key in name)
                       for k, key in SHARD_KERNELS.items()}
    out["calls"] = calls
    return out


def rank_worker(rank: int, world: int, where: str, backend: str,
                dev: str = "cuda") -> None:
    """One process of the ranks phase, started by ``phase_ranks`` with the
    spawn method (it loads the kernel library the parent built).  It joins
    a ``backend`` group of ``world`` ranks through a FileStore in
    ``where``, on card 0 with the others (``dev`` "cpu" rehearses the
    phase on the CPU).  With ``nccl``, one all_reduce, and what happened
    goes to nccl<rank>.txt.  With ``gloo``, ``rank_run`` at each width M of
    RANK_WIDTHS over a group of the first M ranks (the others wait), with
    its seconds; rank 0 gathers every rank's results and writes them to
    out.pt."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import tune
    from repro_torch.launch import mesh as MS
    os.environ[tune.ENV_AUTOTUNE] = "0"
    if dev == "cuda":
        torch.cuda.set_device(0)
    where = Path(where)
    MS.init_shard_group(backend, rank=rank, world_size=world,
                        store=dist.FileStore(str(where / "store"), world))
    try:
        if backend == "nccl":
            try:
                x = torch.ones(1, device="cuda")
                dist.all_reduce(x)
                torch.cuda.synchronize()
                said = f"ran (sum {x.item()})"
            except Exception as e:             # noqa: BLE001 (the finding)
                said = f"refused ({type(e).__name__}: {e})"
            (where / f"nccl{rank}.txt").write_text(said)
            return
        outs = {}
        for M in RANK_WIDTHS:
            group = dist.new_group(list(range(M)), timeout=MS.GROUP_TIMEOUT) \
                if M < world else dist.group.WORLD
            if rank < M:
                t0 = time.perf_counter()
                outs[M] = rank_run(torch, dist, MS, rank, M, dev, group)
                outs[M]["seconds"] = time.perf_counter() - t0
            dist.barrier()
        got = [None] * world if rank == 0 else None
        dist.gather_object(outs, got, dst=0)
        if rank == 0:
            torch.save(got, where / "out.pt")
    finally:
        dist.destroy_process_group()


def start_ranks(where: Path, world: int, backend: str, timeout: float,
                dev: str, target=None):
    """``world`` processes of ``target`` (``rank_worker`` by default;
    spawn), joined within ``timeout`` s, every one still alive then
    killed.  Returns (exit codes, seconds)."""
    import multiprocessing
    where.mkdir(parents=True)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target or rank_worker,
                         args=(r, world, str(where), backend, dev))
             for r in range(world)]
    t0 = time.perf_counter()
    for pr in procs:
        pr.start()
    try:
        for pr in procs:
            pr.join(max(0.0, t0 + timeout - time.perf_counter()))
    finally:
        for pr in procs:
            if pr.is_alive():
                pr.kill()
                pr.join()
    return [pr.exitcode for pr in procs], time.perf_counter() - t0


def assemble(recs: list, rows: int) -> dict:
    """The ranks' {field: tensor} records put together: per-row fields
    concatenated and cut to ``rows``, per-cell (pool, done) fields
    concatenated, the rest the same on every rank."""
    import torch
    out = {}
    for f, v in recs[0].items():
        if f in ("cluster", "endpoint", "instance", "slot", "ok"):
            out[f] = torch.cat([r[f] for r in recs])[:rows]
        elif f.startswith("pool.") or f == "done":
            out[f] = torch.cat([r[f] for r in recs])
        else:
            for m, r in enumerate(recs):
                check(torch.equal(r[f], v), f"ranks: {f} differs on rank {m}")
            out[f] = v
    return out


def phase_ranks(torch, RT, B, ops, interpose, SL, TM, MS, policies, rm, cfg,
                gpu, dev="cuda", target=None):
    """The sharded datapath across processes, one ``gloo`` rank a shard
    (``RankShardMesh``), every rank on this one card: first two NCCL
    ranks on the card (a probe: NCCL refuses two ranks on one device), then
    four gloo processes, at each M of RANK_WIDTHS over the first M of them:
    the ranks' admission (RANK_CASES), completion and drain
    (``rank_run``), each held bit-exact against the one-process
    ``ShardMesh`` at M and against the unsharded run on the card (the
    drain: every count, tick, routing bit, metric and pool cell; tokens
    compared and counted, as a rank decodes its I/M lanes alone).
    ``target`` replaces ``rank_worker`` (a rehearsal's).  Returns (lines,
    {M: [each rank's launches]})."""
    import shutil
    dev = torch.device(dev)
    base = ROOT / "build" / "ranks"
    shutil.rmtree(base, ignore_errors=True)
    lines = []
    if dev.type == "cuda":
        codes, secs = start_ranks(base / "nccl2", 2, "nccl",
                                  NCCL_PROBE_TIMEOUT, dev.type, target)
        said = [(base / "nccl2" / f"nccl{r}.txt").read_text()[:300]
                if (base / "nccl2" / f"nccl{r}.txt").exists() else "nothing"
                for r in range(2)]
        lines.append(f"ranks: NCCL with 2 ranks on one card: {said} (exit "
                     f"codes {codes}, {secs:.1f} s); the ranks below join "
                     "over gloo")
    routing0, _ = routing_config(RT, "cpu")
    drain = lambda m: sharded_drain(  # noqa: E731
        torch, RT, TM, interpose, SL, MS, policies, ops, cfg, dev, m,
        block_r=rm.TILE)[0]
    unsharded = drain(1)
    untok = lambda r: {k: v for k, v in r.items() if k != "tokens"}  # noqa
    world = max(RANK_WIDTHS)
    codes, secs = start_ranks(base / "gloo", world, "gloo", RANK_TIMEOUT,
                              dev.type, target)
    check(all(c == 0 for c in codes), f"ranks: exit codes {codes} (a rank "
          "raised, failed a check or timed out)")
    outs = torch.load(base / "gloo" / "out.pt", weights_only=False)
    lines.append(f"ranks: {world} gloo processes on one card, {secs:.1f} s "
                 "from spawn to exit")
    launches = {}
    for M in RANK_WIDTHS:
        mesh = MS.make_shard_mesh(M, device=dev)
        check(isinstance(mesh, MS.ShardMesh), "ranks: the parent's mesh is "
              "not the one-process mesh")
        got = [outs[r][M] for r in range(M)]
        check(all(g["mesh"] == "RankShardMesh" for g in got),
              f"ranks M={M}: meshes {[g['mesh'] for g in got]}")
        for op, said in got[0]["probe"].items():
            check(said == "takes", f"ranks M={M}: gloo {said} CUDA tensors "
                  f"for {op}, which the rank mesh hands it")
        lines.append(f"ranks M={M}: ranks 0-{M - 1}, {got[0]['seconds']:.1f}"
                     f" s of work; gloo and CUDA tensors: {got[0]['probe']}")
        for label, R, I, C in RANK_CASES:
            routing, reqs, pool, rnd, gum = rank_case(
                torch, RT, routing0, label, R, I, C, M, dev)
            batch, pstate = B.RequestBatch(*reqs), B.PoolState(*pool)
            want = ops.admit_commit(batch, routing, pstate, rnd, gum,
                                    block_r=rm.TILE)
            one_call = lambda: ops.admit_commit_sharded(  # noqa: E731
                batch, routing, pstate, rnd, gum, mesh=mesh, block_r=rm.TILE)
            one = one_call()
            whole = assemble([g["admit"][label][0] for g in got], R)
            pairs = lambda ref: [(f, whole[f], t) for f, t in  # noqa: E731
                                 cpu_fields(ref).items()]
            err = max_abs_err(torch, pairs(want))
            err1 = max_abs_err(torch, pairs(one))
            live = [g["admit"][label][2][0] for g in got]
            check(label != "idle" or not live[1],
                  f"ranks M={M} idle: rank 1 read {live[1]} from its rows")
            for r, g in enumerate(got):
                n = g["admit"][label][1]
                check(n["admit"] == int(live[r]) and n["route_match"] == 1
                      and n["relay_slots"] == 1,
                      f"ranks M={M} {label}: rank {r} launched {n}")
            lines.append(
                f"ranks M={M} admit_commit_sharded[{label} R={R} I={I} "
                f"C={C}] max_abs_err={err} vs admit_commit on the card, "
                f"{err1} vs the one-process mesh; live ranks {live}; ms a "
                f"call per rank " + " / ".join(
                    f"{g['admit'][label][3]:.4f}" for g in got)
                + f" (the one-process mesh {cuda_ms(torch, one_call):.4f})")
        args = complete_inputs(torch, RT, dev)
        pstate = B.PoolState(*args[:6])
        want = ops.complete(pstate, *args[6:], eos=1, max_len=MAX_LEN)
        one = ops.complete_sharded(pstate, *args[6:], mesh=mesh, eos=1,
                                   max_len=MAX_LEN)
        whole = assemble([g["complete"][0] for g in got], I_LANES * SLOTS)
        err = max_abs_err(torch, [(f, whole[f], t) for f, t in
                                  cpu_fields(want).items()])
        err1 = max_abs_err(torch, [(f, whole[f], t) for f, t in
                                   cpu_fields(one).items()])
        lines.append(
            f"ranks M={M} complete_sharded[I={I_LANES} C={SLOTS}] "
            f"max_abs_err={err} vs complete on the card (EWMAs included), "
            f"{err1} vs the one-process mesh; ms a call per rank "
            + " / ".join(f"{g['complete'][1]:.4f}" for g in got))
        recs = [g["drain"] for g in got]
        for r, rec in enumerate(recs[1:], 1):
            check(untok({k: v for k, v in rec.items() if k != "pool"})
                  == untok({k: v for k, v in recs[0].items() if k != "pool"}),
                  f"ranks M={M}: rank {r}'s host state differs from rank 0's")
        whole = dict(recs[0], pool={f: sum((rec["pool"][f] for rec in recs),
                                           [])
                                    for f in recs[0]["pool"]})
        one = drain(M)
        check(untok(whole) == untok(one), f"ranks M={M}: the drain differs "
              "from the one-process mesh's")
        check(untok(whole) == untok(unsharded), f"ranks M={M}: the drain "
              "differs from the unsharded drain")
        same = sum(a == b for a, b in zip(whole["tokens"], one["tokens"]))
        lines.append(
            f"ranks M={M} drain: {ENGINE_REQUESTS} requests in "
            f"{whole['ticks']} ticks, equal to the one-process mesh and the "
            f"unsharded drain on the card in every count, tick, routing bit, "
            f"metric and pool cell; token streams equal in {same} of "
            f"{len(one['tokens'])} requests")
        launches[M] = []
        for r, g in enumerate(got):
            n, prof, t = g["launches"], g["profiled"], g["timing"]
            total = {k: n[k] + g["calls"][k] for k in SHARD_KERNELS}
            launches[M].append(total)
            check(all(total[k] > 0 for k in SHARD_KERNELS)
                  and all(prof[k] > 0 for k in SHARD_KERNELS if n[k]),
                  f"ranks M={M} rank {r}: launches {total} (drain {n}), "
                  f"profiler {prof}")
            lines.append(
                f"ranks M={M} rank {r}: launches B3 {total['admit']} B4 "
                f"{total['route_match']} B5 {total['relay_slots']} B1 "
                f"{total['complete']} B6 {total['decode_attention']} (the "
                f"drain's B3 {n['admit']} B4 {n['route_match']} B5 "
                f"{n['relay_slots']} B1 {n['complete']} B6 "
                f"{n['decode_attention']}; the profiler's over a second "
                f"drain, this process's kernels: B3 {prof['admit']} B4 "
                f"{prof['route_match']} B5 {prof['relay_slots']} B1 "
                f"{prof['complete']} B6 {prof['decode_attention']}); "
                f"median ms a tick {t['med']['tick']:.4f}, admit "
                f"{t['med']['admit']:.4f}, complete "
                f"{t['med']['complete']:.4f}, {t['wall']:.3f} s in all")
    lines.append(f"ranks: every rank on one card ({gpu}): these times are "
                 "gloo's collectives through host memory and the card "
                 "time-sliced between processes, not a measurement of "
                 "several cards")
    return lines, launches


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
        with cpu_plans():
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
# phase 6c: whisper-large-v3 serving and training at full width
# --------------------------------------------------------------------------- #


def host_ms(torch, fn, reps: int = 3) -> float:
    """Median host-clock ms of ``fn`` over ``reps`` calls, each ending in a
    synchronise."""
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def whisper_decode_check(torch, TM, cfg, params, tokens, frames,
                         plant=False):
    """(the last logits of a prefill over all of ``tokens``, those of a
    prefill of all but the last token and one decode step): the decode
    step reads the cross K/V the shorter prefill stored.  With ``plant``
    the stored ``cross_v`` is zeroed before the step (every layer's cross
    attention reads zeros), and the first is None."""
    dev, dt = tokens.device, params["embed"].dtype
    B, S = tokens.shape
    frames = frames.to(dt)
    full = None if plant else TM.prefill(
        cfg, params, tokens, TM.init_cache(cfg, B, S, dt, dev),
        enc_frames=frames)[0]
    _, cache = TM.prefill(cfg, params, tokens[:, :-1],
                          TM.init_cache(cfg, B, S, dt, dev),
                          enc_frames=frames)
    if plant:
        cache["blocks"]["cross_v"].zero_()
    lengths = torch.full((B,), S - 1, dtype=torch.int32, device=dev)
    logits, _ = TM.decode_step(cfg, params, tokens[:, -1:], lengths, cache)
    return full, logits


def phase_whisper(torch, ops, TM, launcher, cfg, dev="cuda"):
    """whisper-large-v3 at full width and depth in bf16 (weights from a
    CUDA generator): WHISPER_BATCH x 1500 encoder frames and a
    WHISPER_PROMPT-token prompt prefilled, WHISPER_STEPS greedy decode
    steps through the launcher's ``run``; the launches (B7 in each encoder
    layer, not causal, and each decoder layer; B6 twice a decoder layer a
    step, the second against the stored encoder K/V), the encoder's and
    the prefill's time, the profiled encoder's B7 and one profiled decode
    step's B6; the decode check in f32 and bf16 with cross_v zeroed as
    the planted fault.  Returns (line, launches)."""
    dev = torch.device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    B, P, T = WHISPER_BATCH, WHISPER_PROMPT, WHISPER_STEPS
    params = TM.init_params(cfg, gen, None, dev)
    dt = params["embed"].dtype
    tokens = torch.randint(0, cfg.vocab, (B, P), generator=gen, device=dev,
                           dtype=torch.int32)
    frames = torch.randn((B, cfg.enc_frames, cfg.d_model), generator=gen,
                         device=dev).to(dt)
    n_params = sum(t.numel() for t in _leaves(params))
    launcher.run(cfg, params, tokens[:, :16], 2, frames)   # warm-up
    for k in ops.LAUNCHES:
        ops.LAUNCHES[k] = 0
    res = launcher.run(cfg, params, tokens, T, frames)
    launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    want = expected_launches(cfg, T)
    check(launches == want, f"{cfg.name}: kernel launches {launches}, "
          f"expected {want}")
    check(res["tokens"].shape == (B, T)
          and bool(torch.isfinite(res["logits"]).all()),
          f"{cfg.name}: decode logits not finite")
    enc_ms = host_ms(torch, lambda: TM.encode(cfg, params, frames))
    _, enc_ev = device_events(torch, lambda: TM.encode(cfg, params, frames))
    b7_us, b7_names = kernel_time(enc_ev, "flash_kernel")
    check(b7_names == "flash_kernel_wgmma<64>", f"{cfg.name}: the encoder "
          f"ran {b7_names!r}, not the tensor-core kernel")
    enc_busy = sum(enc_ev.values()) / 1e3
    top = "; ".join(f"{kernel_name(k)[:60]} {us / 1e3:.3f}" for k, us in
                    sorted(enc_ev.items(), key=lambda kv: -kv[1])[:5])
    # one decode step at the last position of the run under the profiler
    cache = TM.init_cache(cfg, B, P + T, dt, dev)
    TM.prefill(cfg, params, tokens, cache, enc_frames=frames)
    lengths = torch.full((B,), P + T - 1, dtype=torch.int32, device=dev)
    TM.decode_step(cfg, params, tokens[:, :1], lengths, cache)
    _, step_ev = device_events(torch, lambda: TM.decode_step(
        cfg, params, tokens[:, :1], lengths, cache))
    b6_us, b6_names = kernel_time(step_ev, "decode_")
    step_busy = sum(step_ev.values()) / 1e3
    del cache
    peak = torch.cuda.max_memory_allocated(dev)
    ab_line, _ = decode_ab(torch, ops, launcher, cfg, params, tokens, T,
                           frames)
    # the decode check: f32 (the weights cast up beside the bf16 ones),
    # then bf16 with and without the planted fault
    f16_full, f16_dec = whisper_decode_check(torch, TM, cfg, params, tokens,
                                             frames)
    _, bad = whisper_decode_check(torch, TM, cfg, params, tokens, frames,
                                  plant=True)
    rel16, planted = rel_err(f16_dec, f16_full), rel_err(bad, f16_full)
    p32 = _tree(params, lambda t: t.float())
    f32_full, f32_dec = whisper_decode_check(torch, TM, cfg, p32, tokens,
                                             frames.float())
    del p32
    peak_check = torch.cuda.max_memory_allocated(dev)
    for name, t in (("bf16 prefill", f16_full), ("bf16 decode", f16_dec),
                    ("f32 prefill", f32_full), ("f32 decode", f32_dec)):
        check(bool(torch.isfinite(t).all()), f"{cfg.name}: non-finite "
              f"{name} logits")
    rel32 = rel_err(f32_dec, f32_full)
    check(rel32 < LLM_REL_TOL_F32, f"{cfg.name}: f32 decode vs prefill rel "
          f"{rel32:.3e} >= {LLM_REL_TOL_F32}")
    check(rel16 < WHISPER_REL_TOL_BF16, f"{cfg.name}: bf16 decode vs "
          f"prefill rel {rel16:.3e} >= {WHISPER_REL_TOL_BF16}")
    check(planted >= WHISPER_REL_TOL_BF16, f"{cfg.name}: the bf16 gate does "
          f"not see cross_v zeroed: rel {planted:.3e} < "
          f"{WHISPER_REL_TOL_BF16}")
    per_step = res["decode_s"] / T
    n_dec = layer_counts(cfg)["gqa"]
    line = (f"model {cfg.name}: {n_params / 1e9:.3f} B parameters "
            f"({cfg.n_enc_layers} encoder + {cfg.n_layers} decoder layers, "
            f"full depth; bf16); prefill {B} x ({cfg.enc_frames} frames + "
            f"{P} tokens) {1e3 * res['prefill_s']:.3f} ms, of which the "
            f"encoder alone {enc_ms:.3f} ms (host clock, median of 3); "
            f"{T} decode steps (captured; {1e3 * res['setup_s']:.3f} ms of "
            f"warm-up and capture) {1e3 * per_step:.3f} ms per step = "
            f"{B / per_step:.1f} tokens/s; peak memory {peak / 2**30:.2f} "
            f"GiB (init, prefill, decode; {peak_check / 2**30:.2f} GiB "
            f"with the decode check's f32 weights); launches " + " ".join(f"{k}={v}" for k, v in
                                         launches.items())
            + f"; profiled encoder: device busy {enc_busy:.3f} ms, B7 "
            f"{b7_names} (not causal) {b7_us / 1e3:.3f} ms = "
            f"{b7_us / 1e3 / cfg.n_enc_layers:.5f} a launch "
            f"({cfg.n_enc_layers} launches); largest kernels (ms): {top}; "
            f"one decode step at position {P + T - 1} (profiler): device "
            f"busy {step_busy:.4f} ms, B6 ({b6_names}) {b6_us / 1e3:.4f} ms "
            f"over {2 * n_dec} launches (self and cross), "
            f"{b6_us / 1e3 / (2 * n_dec):.5f} a launch; decode after a "
            f"{P - 1}-token prefill vs the full prefill: rel {rel32:.3e} in "
            f"f32 (< {LLM_REL_TOL_F32}), {rel16:.3e} in bf16 (< "
            f"{WHISPER_REL_TOL_BF16}), with cross_v zeroed in the cache "
            f"{planted:.3e} (>= {WHISPER_REL_TOL_BF16}); bf16 vs f32 "
            f"prefill logits {rel_err(f16_full, f32_full):.3e}\n"
            + ab_line)
    del params, res
    gc.collect()
    torch.cuda.empty_cache()
    return line, launches


def train_flops(cfg, B: int, S: int) -> float:
    """The operations one training step of whisper needs (forward + the
    backward's two: 3 x the forward's GEMMs and attention scores, no
    recompute): encoder GEMMs over B x enc_frames rows, decoder GEMMs over
    B x S (the cross-attention's K/V projections over the frames), the
    head, the encoder's full and the decoder's causal self-attention and
    its cross-attention."""
    D, Ff, F_ = cfg.d_model, cfg.d_ff, cfg.enc_frames
    H, hd = cfg.n_heads, cfg.head_dim
    te, td = B * F_, B * S
    ffn, proj = 2 * D * Ff, 4 * D * H * hd        # params a token
    enc = cfg.n_enc_layers * (2 * (proj + ffn) * te
                              + 4 * B * H * hd * F_ * F_)
    dec = cfg.n_layers * (2 * (proj + 2 * D * H * hd + ffn) * td
                          + 2 * 2 * D * H * hd * te
                          + 4 * B * H * hd * S * (S + 1) // 2
                          + 4 * B * H * hd * S * F_)
    head = 2 * D * cfg.vocab_padded * td
    return 3.0 * (enc + dec + head)


def ranged_kernel_ms(events, names) -> tuple:
    """(device ms of the kernels that ran inside the device-side ranges
    of the profiler annotations ``names``, device ms of every kernel),
    from the profiler's device timeline (one stream: a range's kernels
    are the kernels between its start and end).  The first is None where
    the profiler recorded no device-side range of those names."""
    from torch.autograd import DeviceType
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    ranges = sorted((e.time_range.start, e.time_range.end) for e in dev
                    if e.name in names)
    kernels = [e for e in dev if e.name not in names]
    total = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    if not ranges:
        return None, total
    inside = sum(e.time_range.elapsed_us() for e in kernels
                 if any(a <= e.time_range.start and e.time_range.end <= b
                        for a, b in ranges))
    return inside / 1e3, total


def train_steps(torch, ops, TL, TA, TM, TT, cfg, tcfg, batches, dev,
                remat="none", captured=False, profile=False) -> dict:
    """One training step a batch of ``batches`` (host arrays) from the
    seed-0 init ``train_loop.run`` draws on ``dev``, under
    ``RunCtx(remat=remat)``: through ``StaticTrainStep`` (``captured``:
    the first step a warm-up, then its capture, then replays) or the
    eager step (the batch uploaded inside the step's time, as the static
    step stages it), each step on the host clock to a synchronise.
    With ``profile`` one more step on the first batch under the profiler
    (apart from the timed ones): its B7 launches from ``ops.LAUNCHES``
    and the profiler's count of B7 kernels (``"b7"``: the pair).
    Returns {"losses", "norms", "step_ms" (median of steps 2 on),
    "first_ms", "peak", "reserved", "launches"[, "b7"]} and frees what it
    built."""
    from repro_torch.runtime.graphs import StaticTrainStep
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    params = TM.init_params(cfg, torch.Generator(dev).manual_seed(0), None,
                            dev)
    state = (params, TA.init(params),
             torch.zeros((max(cfg.moe.n_experts, 1),), dtype=torch.float32,
                         device=dev))
    del params
    step = TL.make_train_step(cfg, TT.RunCtx(remat=remat), tcfg)
    if captured:
        step = StaticTrainStep(step, dev)
    for k in ops.LAUNCHES:
        ops.LAUNCHES[k] = 0
    walls, losses, norms = [], [], []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if not captured:
            b = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
        *state, m = step(*state, b)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    out = {"losses": losses, "norms": norms,
           "step_ms": statistics.median(walls[1:]) * 1e3,
           "first_ms": walls[0] * 1e3,
           "peak": torch.cuda.max_memory_allocated(dev),
           "reserved": torch.cuda.max_memory_reserved(dev),
           "launches": {k: v for k, v in ops.LAUNCHES.items() if v}}
    if profile:
        before, counts = ops.LAUNCHES["flash_attention"], {}
        device_events(torch, lambda: step(*state, batches[0]), counts)
        out["b7"] = (ops.LAUNCHES["flash_attention"] - before,
                     sum(c for n, c in counts.items() if "flash_kernel" in n))
    del state, step, m
    gc.collect()
    torch.cuda.empty_cache()
    return out


def loss_gap(a: list, b: list) -> float:
    """The largest relative difference of two loss sequences."""
    return max(abs(x - y) / max(abs(y), 1e-30) for x, y in zip(a, b))


def phase_train(torch, ops, fa, TL, TP, TA, cfg, dev="cuda"):
    """whisper-large-v3 trained at full width and depth (bf16 params, f32
    moments) on TRAIN_BATCH x (TRAIN_SEQ tokens + 1500 frames) through
    ``train_loop.run``: TRAIN_STEPS steps, a checkpoint every
    TRAIN_CKPT_EVERY, a failure injected before step TRAIN_FAIL_AT's first
    run (restored from the last checkpoint and replayed); B7 counted in
    every forward; finite losses and gradient norms, the last loss below
    the first; ms a step, tokens/s, peak memory, the share of the FLOP
    bound, peak allocated and reserved; one captured step replayed under
    the profiler (B7's launches from ``ops.LAUNCHES`` against the
    profiler's count, equal; the device's busy share); then, its graph
    freed, one eager step under the profiler for the backward
    recompute's device share; then the A/B: the eager step from the same
    init over the same TRAIN_STEPS batches (ms a step, peaks), twice over
    the first two (eager against eager: bit-equal or not), the captured
    losses against the eager ones (bit-equal where eager against eager
    is, else within TRAIN_AB_RTOL).  Returns (lines, launches, the
    measurements the dryrun and ctx phases read: peak bytes,
    ``train_flops``, ms a step, whether eager against eager was
    bit-equal)."""
    import shutil
    from torch.profiler import ProfilerActivity, profile
    dev = torch.device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    ckpt_dir = ROOT / "build" / "train_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    pipe = TP.Pipeline(TP.DataConfig(
        vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
        enc_frames=cfg.enc_frames, d_model=cfg.d_model))
    tcfg = TL.TrainConfig(steps=TRAIN_STEPS, ckpt_every=TRAIN_CKPT_EVERY,
                          ckpt_dir=str(ckpt_dir), warmup=2,
                          opt=TA.AdamWConfig(lr=1e-3), log_every=1)
    failed = []

    def fail_once(step):
        if step == TRAIN_FAIL_AT and not failed:
            failed.append(step)
            raise RuntimeError("injected node failure")

    for k in ops.LAUNCHES:
        ops.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    out = TL.run(cfg, pipe, tcfg, device=dev, fail_injector=fail_once)
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    reserved = torch.cuda.max_memory_reserved(dev)
    hist = out["history"]
    steps = [h["step"] for h in hist]
    want_steps = list(range(TRAIN_FAIL_AT)) + list(
        range(TRAIN_CKPT_EVERY, TRAIN_STEPS))
    check(out["restarts"] == 1 and steps == want_steps, f"{cfg.name} "
          f"training: steps {steps}, restarts {out['restarts']}")
    want = train_launches(cfg, len(hist))
    check(launches == want, f"{cfg.name} training: launches {launches}, "
          f"expected {want}")
    check(all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
              for h in hist), f"{cfg.name} training: a non-finite loss or "
          "gradient norm")
    check(hist[-1]["loss"] < hist[0]["loss"], f"{cfg.name} training: last "
          f"loss {hist[-1]['loss']} not below the first {hist[0]['loss']}")
    peak = torch.cuda.max_memory_allocated(dev)
    first = {h["step"]: h["loss"] for h in hist[:TRAIN_FAIL_AT]}
    replay = [(h["step"], h["loss"] - first[h["step"]])
              for h in hist[TRAIN_FAIL_AT:] if h["step"] in first]
    check([st for st, _ in replay] == list(range(TRAIN_CKPT_EVERY,
                                                  TRAIN_FAIL_AT))
          and all(d == 0.0 for _, d in replay), f"{cfg.name} training: "
          f"the replayed steps' loss - first run {replay}, expected 0")
    walls = [h["wall_s"] for h in hist[1:]]
    step_ms = statistics.median(walls) * 1e3
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = train_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    bound = flops / BF16_OPS_PS * 1e3
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.roofline import analysis as RA
    model_flops = RA.model_flops(cfg, ShapeConfig(
        "train_whisper", TRAIN_SEQ, TRAIN_BATCH, "train"))
    # one captured step replayed under the profiler, on the trained state
    state, static = out["state"], out.pop("train_step")
    check(len(static.graphs) == 1, f"{cfg.name} training: "
          f"{len(static.graphs)} graphs, expected 1")
    before, counts, box = ops.LAUNCHES["flash_attention"], {}, []

    def replayed_step():
        t1 = time.perf_counter()
        static(state["params"], state["opt"], state["bias"],
               pipe.batch_at(TRAIN_STEPS))
        torch.cuda.synchronize()
        box.append(time.perf_counter() - t1)

    _, rep_ev = device_events(torch, replayed_step, counts)
    b7_counted = ops.LAUNCHES["flash_attention"] - before
    b7_seen = sum(c for n, c in counts.items() if "flash_kernel" in n)
    check(b7_counted == b7_seen == train_launches(cfg, 1)["flash_attention"],
          f"{cfg.name}: a replayed training step's B7 launches "
          f"{b7_counted}, the profiler's {b7_seen}")
    rep_busy, rep_window = sum(rep_ev.values()) / 1e3, box[0] * 1e3
    del static
    gc.collect()
    torch.cuda.empty_cache()
    # one eager step under the profiler, on the trained state
    from repro_torch.models.transformer import RunCtx
    step_fn = TL.make_train_step(cfg, RunCtx(), tcfg)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in pipe.batch_at(TRAIN_STEPS + 1).items()}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step_fn(state["params"], state["opt"], state["bias"], batch)
        torch.cuda.synchronize()
    events = prof.events()
    recompute, busy = ranged_kernel_ms(
        events, (ops.VJP_RANGES["flash_attention"],))
    by_name: dict = {}
    from torch.autograd import DeviceType
    for e in events:
        if e.device_type == DeviceType.CUDA \
                and e.name not in ops.VJP_RANGES.values():
            by_name[e.name] = by_name.get(e.name, 0.0) \
                + e.time_range.elapsed_us() / 1e3
    check(busy > 0, f"{cfg.name}: the profiler saw no kernel of the "
          "training step")
    pct = lambda ms: 100 * ms / busy if busy else float("nan")
    b7 = kernel_time(by_name, "flash_kernel")[0] or 0.0
    top = "; ".join(f"{kernel_name(k)[:60]} {ms:.2f}" for k, ms in
                    sorted(by_name.items(), key=lambda kv: -kv[1])[:10])
    # the recompute timed alone: one backward of B7 at the encoder's and
    # the decoder's self-attention shapes (events), times the layers
    H, hd = cfg.n_heads, cfg.head_dim
    g = torch.Generator(device=dev).manual_seed(9)
    vjp_ms = 0.0
    for S, causal, layers in ((cfg.enc_frames, False, cfg.n_enc_layers),
                              (TRAIN_SEQ, True, cfg.n_layers)):
        q, k, v, do = (torch.randn((TRAIN_BATCH, S, H, hd), generator=g,
                                   device=dev).to(torch.bfloat16)
                       for _ in range(4))
        vjp_ms += layers * cuda_ms(torch, lambda: fa.flash_attention_vjp(
            q, k, v, do, causal=causal), reps=3, warm=1)
        del q, k, v, do
    del out, state, batch
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    # the A/B: the eager step from the same init over the same batches,
    # and eager against eager over the first two
    from repro_torch.models import model as TM
    from repro_torch.models import transformer as TT
    host = [pipe.batch_at(i) for i in range(TRAIN_STEPS)]
    eager = train_steps(torch, ops, TL, TA, TM, TT, cfg, tcfg, host, dev)
    again = train_steps(torch, ops, TL, TA, TM, TT, cfg, tcfg, host[:2], dev)
    deterministic = again["losses"] == eager["losses"][:2]
    captured = {}
    for h in hist:
        captured.setdefault(h["step"], h["loss"])
    captured = [captured[i] for i in range(TRAIN_STEPS)]
    gap = loss_gap(captured, eager["losses"])
    check(captured == eager["losses"] if deterministic
          else gap <= TRAIN_AB_RTOL, f"{cfg.name} training: captured losses "
          f"{captured} against eager {eager['losses']} (rel {gap:.3g}; eager "
          f"against eager bit-equal: {deterministic})")
    lines = [
        f"train {cfg.name}: full width and depth ({cfg.n_enc_layers} + "
        f"{cfg.n_layers} layers), bf16 params and grads, f32 moments; "
        f"batch {TRAIN_BATCH} x ({TRAIN_SEQ} tokens + {cfg.enc_frames} "
        f"frames); {len(hist)} steps run ({TRAIN_STEPS} + the replay of "
        f"{TRAIN_FAIL_AT - TRAIN_CKPT_EVERY} after the failure injected at "
        f"step {TRAIN_FAIL_AT}; one restart), checkpoints every "
        f"{TRAIN_CKPT_EVERY}, {wall:.1f} s in all; losses "
        + " ".join(f"{h['loss']:.4f}" for h in hist)
        + "; grad norms " + " ".join(f"{h['grad_norm']:.3f}" for h in hist)
        + "; replayed steps' loss - first run: "
        + ", ".join(f"step {s} {d:+.3e}" for s, d in replay)
        + f"; ms a step {step_ms:.2f} (captured: median of steps "
        f"2-{len(hist)}, host clock; step 1, the warm-up and capture, "
        f"{hist[0]['wall_s'] * 1e3:.1f}), "
        f"{tokens / step_ms * 1e3:.1f} decoder tokens/s "
        f"({TRAIN_BATCH * cfg.enc_frames / step_ms * 1e3:.1f} frames/s); "
        f"peak memory {peak / 2**30:.2f} GiB allocated, "
        f"{reserved / 2**30:.2f} reserved; FLOP bound {bound:.2f} ms "
        f"({flops / 1e12:.2f} TFLOP at {BF16_OPS_PS / 1e12:.0f} TFLOP/s): "
        f"{100 * bound / step_ms:.1f} % of the step (roofline.analysis."
        f"model_flops of the shape: {model_flops / 1e12:.2f} TFLOP); "
        "launches "
        + " ".join(f"{k}={v}" for k, v in launches.items()),
        f"train {cfg.name} profiled step: device busy {busy:.2f} ms; B7 "
        f"forward {b7:.3f} ms ({cfg.n_enc_layers + cfg.n_layers} launches); "
        f"backward recompute of B7 (the kernels inside the "
        f"xlb::flash_attention_vjp ranges) "
        + ("not measured (no device-side range recorded)"
           if recompute is None else
           f"{recompute:.2f} ms = {pct(recompute):.1f} % of the "
           f"step's device time")
        + f"; timed alone (events, one vjp at the encoder's and the "
        f"decoder's shape x the layers) {vjp_ms:.2f} ms = "
        f"{pct(vjp_ms):.1f} %; largest kernels (ms): {top}",
        f"train {cfg.name} A/B: the same init and {TRAIN_STEPS} batches; "
        f"captured (train_loop.run) {step_ms:.2f} ms a step, peak "
        f"{peak / 2**30:.2f} GiB allocated / {reserved / 2**30:.2f} "
        f"reserved; eager {eager['step_ms']:.2f} ms a step (step 1 "
        f"{eager['first_ms']:.1f}), peak {eager['peak'] / 2**30:.2f} / "
        f"{eager['reserved'] / 2**30:.2f} GiB; eager / captured "
        f"{eager['step_ms'] / step_ms:.4f}; losses captured "
        + " ".join(f"{x:.6f}" for x in captured) + ", eager "
        + " ".join(f"{x:.6f}" for x in eager["losses"])
        + f": largest relative difference {gap:.3g} ("
        + ("bit-equal, as eager against eager is over steps 1-2"
           if deterministic else f"eager against eager differs over steps "
           f"1-2 by {loss_gap(again['losses'], eager['losses']):.3g}; gate "
           f"{TRAIN_AB_RTOL}")
        + f"); one replayed step under the profiler: B7 {b7_counted} "
        f"launches from ops.LAUNCHES = {b7_seen} kernels the profiler saw, "
        f"device busy {rep_busy:.2f} ms of its {rep_window:.2f}-ms window "
        f"({100 * rep_busy / rep_window:.1f} %)"]
    return lines, launches, {"peak": peak, "train_flops": flops,
                             "step_ms": step_ms,
                             "deterministic": deterministic}


def phase_ctx(torch, ops, TL, TP, TA, TM, SP, MS, EL, TT, cfg,
              deterministic: bool, dev="cuda"):
    """The ``RunCtx`` phase.  (1) whisper-large-v3's training step at full
    width and depth (TRAIN_BATCH x (TRAIN_SEQ tokens + frames), the
    seed-0 init on the card, the pipeline's first CTX_STEPS batches) under
    ``remat="none"`` and ``remat="block"`` in turn, each captured
    (``StaticTrainStep``) and eager: ms a step (median of steps 2 on,
    host clock to a synchronise), peak memory, the losses (captured
    against eager bit-equal where ``deterministic``, eager against eager
    in ``phase_train``, else within TRAIN_AB_RTOL; the first loss
    bit-equal between the two remats: a checkpoint changes what is kept,
    not what is computed), B7's launches (one a layer a step; under block
    remat two: the recompute).  (2) A world-size-1 NCCL process group (a
    ``FileStore`` under build/), ``launch.mesh.make_host_mesh(1, 1)``, and
    CTX_ARCHS' smoke configs in f32: ``loss_fn`` on the params and batch
    placed by ``MeshSpec`` (DTensors) under ``RunCtx(shard=ms.constrain,
    tp_size=1, ep=(mesh, ("data", "model")))`` against ``loss_fn`` of the
    plain tensors without a ctx, within CTX_RTOL; the counts of that
    loss's launches (B5 in the relay's body, B7 through ``local_map``).
    Returns (lines, launches of the ctx runs, {remat: measurements})."""
    import torch.distributed as dist
    from repro_torch.configs import get_config, smoke_config
    dev = torch.device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    pipe = TP.Pipeline(TP.DataConfig(
        vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
        enc_frames=cfg.enc_frames, d_model=cfg.d_model))
    tcfg = TL.TrainConfig(steps=TRAIN_STEPS, warmup=2,
                          opt=TA.AdamWConfig(lr=1e-3))
    batches = [pipe.batch_at(i) for i in range(CTX_STEPS)]
    layers = cfg.n_enc_layers + cfg.n_layers
    runs, total, parts = {}, {}, []
    for remat in ("none", "block"):
        want = {"flash_attention": CTX_STEPS * layers
                * (2 if remat == "block" else 1)}
        got = {}
        for captured in (True, False):
            r = train_steps(torch, ops, TL, TA, TM, TT, cfg, tcfg, batches,
                            dev, remat=remat, captured=captured,
                            profile=captured)
            side = "captured" if captured else "eager"
            check(r["launches"] == want, f"ctx {cfg.name} remat={remat} "
                  f"{side}: launches {r['launches']}, expected {want}")
            check(not captured or r["b7"][0] == r["b7"][1]
                  == want["flash_attention"] // CTX_STEPS, f"ctx {cfg.name} "
                  f"remat={remat}: a replayed step's B7 launches and the "
                  f"profiler's count {r.get('b7')}")
            check(all(math.isfinite(x) for x in r["losses"]),
                  f"ctx {cfg.name} remat={remat} {side}: a non-finite loss "
                  f"{r['losses']}")
            for k, v in r["launches"].items():
                total[k] = total.get(k, 0) + v
            got[side] = r
        cap, eag = got["captured"], got["eager"]
        gap = loss_gap(cap["losses"], eag["losses"])
        check(cap["losses"] == eag["losses"] if deterministic
              else gap <= TRAIN_AB_RTOL, f"ctx {cfg.name} remat={remat}: "
              f"captured losses {cap['losses']} against eager "
              f"{eag['losses']} (rel {gap:.3g})")
        runs[remat] = eag
        parts.append(
            f"remat={remat} eager {eag['step_ms']:.2f} ms a step (first "
            f"{eag['first_ms']:.1f}), peak {eag['peak'] / 2**30:.2f} GiB "
            f"allocated / {eag['reserved'] / 2**30:.2f} reserved, losses "
            + " ".join(f"{x:.6f}" for x in eag["losses"])
            + f"; captured {cap['step_ms']:.2f} ms a step (first, the "
            f"warm-up and capture, {cap['first_ms']:.1f}), peak "
            f"{cap['peak'] / 2**30:.2f} / {cap['reserved'] / 2**30:.2f} GiB"
            f", eager / captured {eag['step_ms'] / cap['step_ms']:.4f}, "
            f"one replayed step's B7 {cap['b7'][0]} launches from "
            f"ops.LAUNCHES = {cap['b7'][1]} kernels the profiler saw, "
            f"losses largest relative difference {gap:.3g}"
            + (" (bit-equal)" if cap["losses"] == eag["losses"] else ""))
    a, b = runs["none"], runs["block"]
    check(a["losses"][0] == b["losses"][0], f"ctx {cfg.name}: the first "
          f"loss {a['losses'][0]!r} (remat none) != {b['losses'][0]!r} "
          "(block)")
    lines = [
        f"ctx {cfg.name} training step, full width and depth, batch "
        f"{TRAIN_BATCH} x ({TRAIN_SEQ} tokens + {cfg.enc_frames} frames), "
        f"{CTX_STEPS} steps each from one init, eager and captured "
        "(StaticTrainStep): " + " | ".join(parts)
        + f" | block / none (eager): step {b['step_ms'] / a['step_ms']:.4f}, "
        f"peak {b['peak'] / a['peak']:.4f}, the peak "
        f"{(a['peak'] - b['peak']) / 2**30:.2f} GiB lower; first loss "
        f"bit-equal; B7 launches {layers} a step without remat, "
        f"{2 * layers} with (the recompute), on both sides"]
    gc.collect()
    torch.cuda.empty_cache()

    # (2) the multi-device layer on a world-size-1 NCCL group
    store_path = ROOT / "build" / "ctx_store"
    store_path.parent.mkdir(parents=True, exist_ok=True)
    store_path.unlink(missing_ok=True)
    dist.init_process_group("nccl", store=dist.FileStore(str(store_path), 1),
                            rank=0, world_size=1)
    try:
        mesh = MS.make_host_mesh(1, 1)
        ms = SP.MeshSpec(mesh)
        ctx = TT.RunCtx(shard=ms.constrain, tp_size=1,
                        ep=(mesh, ("data", "model")))
        for arch in CTX_ARCHS:
            c = smoke_config(get_config(arch))
            params = TM.init_params(c, torch.Generator(dev).manual_seed(1),
                                    torch.float32, dev)
            g = torch.Generator(dev).manual_seed(2)
            tok = torch.randint(0, c.vocab, (4, 64), generator=g, device=dev,
                                dtype=torch.int32)
            batch = {"tokens": tok, "labels": torch.roll(tok, -1, 1)}
            with torch.no_grad():
                want, _ = TM.loss_fn(c, params, batch)
                pd = EL.reshard_params(params, ms)
                bd = EL.reshard_tree(batch, ms.batch_shardings(batch))
                for k in ops.LAUNCHES:
                    ops.LAUNCHES[k] = 0
                got, _ = TM.loss_fn(c, pd, bd, ctx=ctx)
                torch.cuda.synchronize()
            launches = {k: v for k, v in ops.LAUNCHES.items() if v}
            got = float(got.full_tensor())
            rel = abs(got - float(want)) / abs(float(want))
            n_moe = c.n_layers - c.moe.first_dense
            need = {"relay_slots": n_moe}
            if c.mla is None:
                need["flash_attention"] = c.n_layers
            check(launches == need, f"ctx {arch}: launches under the mesh "
                  f"{launches}, expected {need}")
            check(rel <= CTX_RTOL, f"ctx {arch}: loss on the mesh {got!r} "
                  f"vs {float(want)!r} without a ctx (rel {rel:.3g} > "
                  f"{CTX_RTOL})")
            for k, v in launches.items():
                total[k] = total.get(k, 0) + v
            lines.append(
                f"ctx {arch}-smoke (f32) on a world-size-1 NCCL group, "
                f"(1, 1) DeviceMesh, params and batch as DTensors "
                f"(MeshSpec), RunCtx(shard=ms.constrain, tp_size=1, "
                f"ep=(mesh, ('data', 'model'))): loss {got:.7f} vs "
                f"{float(want):.7f} without a ctx (rel {rel:.3g}, rtol "
                f"{CTX_RTOL}); launches " + " ".join(
                    f"{k}={v}" for k, v in launches.items())
                + " (B5 in the relay's body, B7 through local_map)")
            del params, pd, bd
    finally:
        dist.destroy_process_group()
        store_path.unlink(missing_ok=True)
    return lines, total, runs


def phase_train_smoke(torch, ops, TM, train, configs, dev="cuda"):
    """Every arch's smoke config through ``launch.train`` on the card
    (SMOKE_TRAIN_STEPS steps each, the config's dtype): finite losses and
    the forward's launches (B7 in every attention layer, B8 in every
    mamba layer, B5 in every MoE layer) counted from zero; then one
    training step of each of TRAIN_PARITY_ARCHS' smoke configs in f32 on
    the card against the CPU with the same weights and batch: the loss
    and every gradient leaf within rtol = atol = 1e-4.  Returns (lines,
    launches summed over the archs)."""
    import shutil
    from repro_torch.tree import items, leaves
    from repro_torch.data.pipeline import DataConfig, Pipeline
    torch.backends.cuda.matmul.allow_tf32 = False
    lines, total = [], {}
    root = ROOT / "build" / "train_smoke"
    shutil.rmtree(root, ignore_errors=True)
    for arch in configs.ASSIGNED_ARCHS + ["xlb-service-model"]:
        cfg = configs.smoke_config(configs.get_config(arch))
        for k in ops.LAUNCHES:
            ops.LAUNCHES[k] = 0
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            out = train.main(["--arch", arch, "--steps",
                              str(SMOKE_TRAIN_STEPS), "--global-batch",
                              str(SMOKE_TRAIN_BATCH), "--seq",
                              str(SMOKE_TRAIN_SEQ), "--ckpt-dir",
                              str(root / arch)])
        got = {k: v for k, v in ops.LAUNCHES.items() if v}
        want = train_launches(cfg, SMOKE_TRAIN_STEPS)
        check(got == want, f"{cfg.name}: launch.train launches {got}, "
              f"expected {want}")
        losses = [h["loss"] for h in out["history"]]
        check(len(losses) == SMOKE_TRAIN_STEPS
              and all(math.isfinite(x) for x in losses),
              f"{cfg.name}: launch.train losses {losses}")
        for k, v in got.items():
            total[k] = total.get(k, 0) + v
        lines.append(f"train smoke {cfg.name} ({cfg.dtype}): launch.train "
                     f"on the card, {SMOKE_TRAIN_STEPS} steps of "
                     f"{SMOKE_TRAIN_BATCH} x {SMOKE_TRAIN_SEQ}, losses "
                     + " ".join(f"{x:.4f}" for x in losses)
                     + "; launches " + " ".join(f"{k}={v}" for k, v in
                                                got.items()))
    shutil.rmtree(root, ignore_errors=True)
    for arch in TRAIN_PARITY_ARCHS:
        cfg = configs.smoke_config(configs.get_config(arch))
        params = TM.init_params(cfg, torch.Generator().manual_seed(3),
                                torch.float32, "cpu")
        batch = Pipeline(DataConfig(
            vocab=cfg.vocab, seq_len=SMOKE_TRAIN_SEQ,
            global_batch=SMOKE_TRAIN_BATCH,
            enc_frames=cfg.enc_frames if cfg.is_encdec else 0,
            d_model=cfg.d_model)).batch_at(0)
        res = {}
        for d in ("cpu", dev):
            p = _to(torch, params, d)
            for t in leaves(p):
                t.requires_grad_(True)
            loss, _ = TM.loss_fn(cfg, p, {k: torch.from_numpy(v).to(d)
                                          for k, v in batch.items()})
            grads = torch.autograd.grad(loss, leaves(p))
            res[d] = (loss.detach().cpu(), [g.cpu() for g in grads])
        check(bool(torch.isfinite(res[dev][0])), f"{cfg.name}: non-finite "
              "loss on the card")
        torch.testing.assert_close(res[dev][0], res["cpu"][0], rtol=1e-4,
                                   atol=1e-4)
        worst = 0.0
        for (name, _), a, b in zip(items(params), res[dev][1],
                                   res["cpu"][1]):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4,
                                       msg=lambda m: f"{arch} {name}: {m}")
            worst = max(worst, float((a - b).abs().max()))
        lines.append(f"train parity {cfg.name} (f32): one training step on "
                     f"the card vs the CPU, loss {float(res[dev][0]):.6f} vs "
                     f"{float(res['cpu'][0]):.6f}, {len(res[dev][1])} "
                     f"gradient leaves max_abs_err={worst:.3g} "
                     "(rtol=atol=1e-4)")
    return lines, total


# --------------------------------------------------------------------------- #
# phase 6b: serve --arch at full width
# --------------------------------------------------------------------------- #


def phase_serve_arch(torch, ops, serve, get_config):
    """``serve.main(["--arch", a, "--device", "cuda"])`` for each arch of
    SERVE_ARCHS at full width (free the earlier phases' models first:
    minitron-4b in f32 is about 20 GB, its bf16 planes 26 GB more) and of
    SERVE_SMOKE_ARCHS with ``--smoke`` (the reduced config the reference's
    serve runs: their f32 weights pass one card); ``serve`` refuses
    whisper-large-v3 (an encoder-decoder: the serving loop has no prompt
    audio to give it) as the reference does.  Each run counts the
    ``dense_x9`` launches of its captured ticks' replays: minitron-4b's
    tick holds one a projection (wq, wk, wv, wo, w_in, w_gate, w_out) of
    each layer and the head, the service model's none (under the size
    gate).  Returns (lines, {run: dense_x9 launches})."""
    import contextlib
    import io
    lines, x9 = [], {}
    inner = ops.count_replay
    for arch, extra in ([(a, []) for a in SERVE_ARCHS]
                        + [(a, ["--smoke"]) for a in SERVE_SMOKE_ARCHS]):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        buf = io.StringIO()
        n0, per_tick = ops.LAUNCHES["dense_x9"], set()

        def seen(delta):
            inner(delta)
            per_tick.add(delta.get("dense_x9", 0))

        ops.count_replay = seen
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                n = serve.main(["--arch", arch, "--device", "cuda", *extra])
        finally:
            ops.count_replay = inner
        wall = time.perf_counter() - t0
        check(n == 32, f"serve --arch {arch} {extra}: {n} of 32 requests")
        run = arch + " --smoke" * bool(extra)
        x9[run] = ops.LAUNCHES["dense_x9"] - n0
        if arch == "minitron-4b":
            c = get_config(arch)
            want = c.n_layers * (6 + (c.ffn_act == "swiglu")) + 1
            check(per_tick == {want}, f"serve --arch {arch}: dense_x9 "
                  f"launches a replayed tick {sorted(per_tick)}, not {want}")
        if arch == "xlb-service-model":
            check(x9[run] == 0, f"serve --arch {arch}: {x9[run]} dense_x9 "
                  "launches under the size gate")
        first = buf.getvalue().splitlines()[0]
        lines.append(f"serve --arch {run}: "
                     f"{first}; main() {wall:.2f} s with the weights' init; "
                     "peak memory "
                     f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
                     f"dense_x9 launches {x9[run]} "
                     f"({'/'.join(map(str, sorted(per_tick)))} a replayed "
                     "tick)")
    try:
        serve.main(["--arch", "whisper-large-v3", "--smoke", "--device",
                    "cuda"])
    except SystemExit as e:
        check("enc-dec serving" in str(e), f"serve whisper: {e}")
        lines.append(f"serve --arch whisper-large-v3: SystemExit ({e})")
    else:
        fail("serve --arch whisper-large-v3 did not exit")
    gc.collect()
    torch.cuda.empty_cache()
    return lines, x9


# --------------------------------------------------------------------------- #
# phase 9: the analysis gate with the kernels' bounds check
# --------------------------------------------------------------------------- #


def load_example(name: str):
    """``examples/torch/<name>.py`` as a module (its ``main`` is called)."""
    import importlib.util
    path = ROOT / "examples" / "torch" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_examples(torch, ops, dev="cuda"):
    """The three examples of the port through their ``main`` on the card,
    as a user runs them: quickstart (8 requests, then a transaction and a
    9th: no_route 0, routing version 1, commit #1), serve_cluster (every
    request of bookinfo completed on istio, cilium and xlb) and train_moe
    (EXAMPLE_TRAIN_STEPS steps: finite losses, steps 80-99 below steps
    0-19 on average, every checkpoint written under build/).  Each
    example's launches counted from zero (``ops.LAUNCHES``) and, for the
    two serving ones, the kernels the profiler saw.  Returns (lines,
    launches summed)."""
    import shutil
    lines, total = [], {}
    args = {"quickstart": ["--device", dev],
            "serve_cluster": ["--device", dev],
            "train_moe": ["--device", dev, "--steps",
                          str(EXAMPLE_TRAIN_STEPS), "--ckpt-dir",
                          str(ROOT / "build" / "example_train_moe")]}
    shutil.rmtree(ROOT / "build" / "example_train_moe", ignore_errors=True)
    for name, argv in args.items():
        mod = load_example(name)
        for k in ops.LAUNCHES:
            ops.LAUNCHES[k] = 0
        counts: dict = {}
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as printed:
            if name == "train_moe":
                out = mod.main(argv)
            else:               # small: under the profiler
                box = []
                device_events(torch, lambda: box.append(mod.main(argv)),
                              counts)
                out = box[0]
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in ops.LAUNCHES.items() if v}
        for k in EXAMPLE_KERNELS[name]:
            check(launches.get(k, 0) > 0, f"example {name}: no {k} launch "
                  f"({launches})")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        seen = {k: sum(c for n, c in counts.items()
                       if PROFILER_NAMES[k] in n)
                for k in EXAMPLE_KERNELS[name]} if counts else {}
        if name == "quickstart":
            check(out["completed"] == 8 and out["no_route"] == 0
                  and out["completed_after"] == 9
                  and out["routing_version"] == 1
                  and out["cp_version"] == 1,
                  f"example quickstart: {out['lines']}")
            facts = "; ".join(out["lines"][:1] + out["lines"][-2:])
        elif name == "serve_cluster":
            for mode, row in out["rows"].items():
                check(row["completed"] == 8, f"example serve_cluster: "
                      f"{mode} completed {row['completed']} of 8")
            facts = "; ".join(out["lines"])
        else:
            losses = out["losses"]
            ckpts = sorted(p.name for p in Path(out["ckpt_dir"]).iterdir())
            check(len(losses) == EXAMPLE_TRAIN_STEPS and out["restarts"] == 0
                  and all(math.isfinite(x) for x in losses),
                  f"example train_moe: {len(losses)} steps, restarts "
                  f"{out['restarts']}, losses finite "
                  f"{all(math.isfinite(x) for x in losses)}")
            lo, hi = EXAMPLE_FALL_WINDOW
            first, fallen = (statistics.mean(losses[:20]),
                             statistics.mean(losses[lo:hi]))
            check(fallen < first, f"example train_moe: the mean loss of "
                  f"steps {lo}-{hi - 1} ({fallen}) not below steps 0-19's "
                  f"({first})")
            want = [f"step-{k:09d}" for k in sorted(
                {*range(100, EXAMPLE_TRAIN_STEPS + 1, 100),
                 EXAMPLE_TRAIN_STEPS})][-3:]    # every 100, the last 3
            check(ckpts == want, f"example train_moe: checkpoints {ckpts},"
                  f" expected {want}")
            walls = [h["wall_s"] for h in out["out"]["history"][1:]]
            facts = (f"{out['lines'][0]}; {out['lines'][-1]}; mean loss of "
                     f"steps 0-19 {first:.4f}, of steps {lo}-{hi - 1} "
                     f"{fallen:.4f}, of the last 20 "
                     f"{statistics.mean(losses[-20:]):.4f}; loss every 20 "
                     "steps " + " ".join(f"{losses[i]:.4f}" for i in
                                         range(0, len(losses), 20)) + "; "
                     f"ms a step {statistics.median(walls) * 1e3:.2f} "
                     f"(captured: StaticTrainStep through train_loop.run; "
                     f"median, host clock; step 1, the warm-up and capture, "
                     f"{out['out']['history'][0]['wall_s'] * 1e3:.1f}); "
                     f"checkpoints {', '.join(ckpts)} under "
                     "build/example_train_moe")
            del out
            shutil.rmtree(ROOT / "build" / "example_train_moe",
                          ignore_errors=True)
        check(printed.getvalue().strip() != "", f"example {name} printed "
              "nothing")
        lines.append(
            f"example {name}: {wall:.1f} s; {facts}; launches "
            + " ".join(f"{k}={v}" for k, v in launches.items())
            + ("; kernels the profiler saw: " + " ".join(
                f"{PROFILER_NAMES[k]}={v}" for k, v in seen.items())
               if seen else ""))
    return lines, total


def phase_dryrun(torch, DR, SP, measured, gpu, ctx_runs):
    """The dry run's predictions (``launch/dryrun.trace_cell_for`` on a
    one-chip ``LogicalMesh((1, 1))``, meta tensors on the host, H100
    data-sheet peaks) beside this run's measurements of the same cells:
    whisper-large-v3's training step (TRAIN_BATCH x (TRAIN_SEQ tokens +
    frames)) without and with block remat, against ``train_flops``, its
    measured peak in ``train_loop.run`` and the ``RunCtx`` phase's peaks
    under each remat (``ctx_runs``), and minitron-4b's LLM_BATCH x
    LLM_PROMPT bf16 prefill against its measured peak.  Fails if a trace
    raises or the traced FLOPs over ``train_flops`` fall outside
    DRYRUN_FLOP_RATIO[remat]."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    ms = SP.MeshSpec(SP.LogicalMesh((1, 1)))
    lines = []
    train = ShapeConfig("train_whisper", TRAIN_SEQ, TRAIN_BATCH, "train")
    cells = (("whisper-large-v3", train, "train", "none"),
             ("whisper-large-v3", train, "train", "block"),
             ("minitron-4b", ShapeConfig(
                 "prefill_minitron", LLM_PROMPT, LLM_BATCH, "prefill"),
              "prefill", None))
    for arch, shape, kind, remat in cells:
        cfg = get_config(arch)
        t0 = time.perf_counter()
        rep = DR.trace_cell_for(cfg, shape, ms, remat=remat)
        wall = time.perf_counter() - t0
        m, r, tr = rep["memory_analysis"], rep["roofline"], rep["traced"]
        got = measured[arch]
        pred = m["total_GiB"] * 2**30
        line = (f"dryrun {arch} {kind} {shape.global_batch} x "
                f"{shape.seq_len}" + (f" remat={remat}" if remat else "")
                + f" on one chip (prediction: meta trace "
                f"{wall:.1f} s on the host, H100 data-sheet peaks): traced "
                f"{tr['flops'] / 1e12:.3f} TFLOP (recompute included: "
                f"{tr['recompute_included']}), model_flops "
                f"{r['model_flops'] / 1e12:.3f}; bytes argument "
                f"{m['argument_GiB']} + output {m['output_GiB']} + temp "
                f"{m['temp_GiB']} ({m['temp_rule']}) = {m['total_GiB']} GiB "
                f"(fits_hbm {m['fits_hbm']}); {r['dominant']}-bound, "
                f"{r['step_lower_bound_s'] * 1e3:.3f} ms | measured in this "
                f"run on {gpu}: ")
        if kind == "train":
            run = ctx_runs[remat]
            line += (f"peak under RunCtx(remat={remat!r}) "
                     f"{run['peak'] / 2**30:.2f} GiB (predicted / measured "
                     f"{pred / run['peak']:.3f})")
            if remat == "none":
                line += (f", in train_loop.run {got['peak'] / 2**30:.2f} "
                         f"GiB ({pred / got['peak']:.3f})")
            ratio = tr["flops"] / got["train_flops"]
            lo, hi = DRYRUN_FLOP_RATIO[remat]
            check(lo <= ratio <= hi, f"dryrun {arch} remat={remat}: traced "
                  f"FLOPs / train_flops {ratio:.4f} outside [{lo}, {hi}]")
            line += (f", train_flops {got['train_flops'] / 1e12:.3f} TFLOP "
                     f"(traced / train_flops {ratio:.4f}, in [{lo}, {hi}]); "
                     f"a step {run['step_ms']:.2f} ms against the predicted "
                     f"bound {r['step_lower_bound_s'] * 1e3:.3f} ms")
        else:
            line += (f"peak {got['peak'] / 2**30:.2f} GiB (predicted / "
                     f"measured {pred / got['peak']:.3f})")
        lines.append(line)
    return lines


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
    from repro_torch.kernels import dense_x9 as x9
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
    from repro_torch.kernels import tune
    from repro_torch.data import pipeline as TP
    from repro_torch.launch import train as TRN
    from repro_torch.optim import adamw as TA
    from repro_torch.runtime import train_loop as TL
    from repro_torch.launch import dryrun as DR
    from repro_torch.roofline import constants as RC
    from repro_torch.sharding import specs as SP
    from repro_torch.runtime import elastic as EL
    from repro_torch.models import transformer as TT
    global MEM_BPS, OPS_PS, BF16_OPS_PS
    MEM_BPS, OPS_PS, BF16_OPS_PS = RC.MEM_BPS, RC.OPS_PS, RC.BF16_OPS_PS

    # the run plans its admissions itself: no pin from the environment
    for name in (tune.ENV_AUTOTUNE, tune.ENV_BLOCK_R, tune.ENV_BLOCK_I,
                 tune.ENV_FOLD):
        os.environ.pop(name, None)

    gpu = gpu_line()
    print(gpu)
    # the launches that ran inside graph replays, over the whole run
    replayed = dict.fromkeys(ops.LAUNCHES, 0)
    count_replay = ops.count_replay

    def counted_replay(delta):
        count_replay(delta)
        for k, n in delta.items():
            replayed[k] += n

    ops.count_replay = counted_replay
    t0 = time.perf_counter()
    lib = _build.library(torch.device("cuda"))
    OUT.mkdir(exist_ok=True)
    (OUT / "build_log.txt").write_text(_build.build_log)
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc "
          f"{_build.build_seconds:.1f} s), log in chiprun_out/build_log.txt")

    tune_lines, tune_timing = phase_tune(torch, RT, PD, B, ops, rm, tune)
    for line in tune_lines:
        print(line)
    moe_shapes = {a: (LLM_BATCH * LLM_PROMPT, c.moe.n_experts, c.moe.top_k)
                  for a in MOE_ARCHS for c in [get_config(a)]}
    rows, timing = phase_kernels(torch, RT, PD, ops, rm, rs, cp, B, lib,
                                 moe_shapes=moe_shapes)
    frows, ftiming = phase_float_kernels(torch, ops, da, fa, ssd)
    n_x9 = ops.LAUNCHES["dense_x9"]
    xrows, xtiming = phase_dense_x9(torch, ops, x9, gpu)
    x9_launches = ops.LAUNCHES["dense_x9"] - n_x9
    frows += xrows
    ftiming["dense_x9"] = xtiming["w_in"]
    for t in ftiming.values():
        t["floor_ms"], t["issue_ms"] = timing["complete"]["floor_ms"], \
            timing["complete"]["issue_ms"]
    timing.update(ftiming)
    for row in rows + frows:
        print("kernel " + row)
    err = phase_model(torch, cfg, TM)
    print(f"model: decode on the card vs the CPU max_abs_err={err:.3g} "
          "(rtol=atol=1e-4)")

    lines, launches = phase_serve(torch, RT, CT, ops, TM, interpose, SL,
                                  cfg)
    for line in lines:
        print(line)
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
    lines, sanitize_launches = phase_sanitize(
        torch, RT, TM, interpose, SL, MS, INV, policies, ops, cfg, gpu=gpu)
    for line in lines:
        print(line)
    slines, stiming, sharded_launches = phase_sharded(
        torch, RT, B, ops, interpose, SL, TM, MS, SA, policies, cfg,
        timing["admit"]["ms"], gpu=gpu)
    for line in slines:
        print(line)
    rlines, rank_launches = phase_ranks(torch, RT, B, ops, interpose, SL, TM,
                                        MS, policies, rm, cfg, gpu)
    for line in rlines:
        print(line)
    for line in phase_chain(torch, W, HP, RT, interpose, policies, cfg):
        print(line)
    llm_launches, prefill_kernels, peaks = {}, {}, {}
    for arch in ("minitron-4b", "mamba2-2.7b") + DENSE_ARCHS + MOE_ARCHS:
        cfg_a = get_config(arch)
        full = None
        if arch in MOE_CUTS:
            full, cfg_a = cfg_a.n_layers, replace(cfg_a,
                                                  n_layers=MOE_CUTS[arch])
        line, got, names, peak = phase_llm(torch, ops, TM, PDL, cfg_a,
                                           full_layers=full)
        peaks[arch] = peak
        print(line)
        for k, v in got.items():
            llm_launches[k] = llm_launches.get(k, 0) + v
        prefill_kernels[arch] = names
    whisper = get_config("whisper-large-v3")
    line, whisper_launches = phase_whisper(torch, ops, TM, PDL, whisper)
    print(line)
    for k, v in whisper_launches.items():
        llm_launches[k] = llm_launches.get(k, 0) + v
    tlines, train_whisper, train_measured = phase_train(
        torch, ops, fa, TL, TP, TA, whisper)
    for line in tlines:
        print(line)
    clines, ctx_launches, ctx_runs = phase_ctx(
        torch, ops, TL, TP, TA, TM, SP, MS, EL, TT, whisper,
        train_measured["deterministic"])
    for line in clines:
        print(line)
    for line in phase_smoke_configs(torch, ops, TM, PDL, configs):
        print(line)
    tlines, train_smoke = phase_train_smoke(torch, ops, TM, TRN, configs)
    for line in tlines:
        print(line)
    train_total = dict(train_whisper)
    for k, v in train_smoke.items():
        train_total[k] = train_total.get(k, 0) + v
    slines, serve_x9 = phase_serve_arch(torch, ops, serve, get_config)
    for line in slines:
        print(line)
    elines, example_launches = phase_examples(torch, ops)
    for line in elines:
        print(line)
    for line in phase_dryrun(torch, DR, SP, {
            "whisper-large-v3": train_measured,
            "minitron-4b": {"peak": peaks["minitron-4b"]}}, gpu, ctx_runs):
        print(line)
    launches = {**main_launches, **staged_launches, **llm_launches}
    # relay_slots runs on two paths: the staged chain and the MoE dispatch
    launches["relay_slots"] = staged_launches["relay_slots"] \
        + llm_launches["relay_slots"]
    for k, v in sharded_launches.items():       # the sharded drain's
        launches[k] += v
    for k, v in train_total.items():            # the training forwards'
        launches[k] += v
    for k, v in example_launches.items():       # the examples'
        launches[k] = launches.get(k, 0) + v
    for k, v in ctx_launches.items():           # the RunCtx phase's
        launches[k] = launches.get(k, 0) + v
    # phase 2's isolated calls and the serving ticks of phase 8
    launches["dense_x9"] = x9_launches + sum(serve_x9.values())
    print("kernels: " + " ".join(
        f"{k}={v}" for k, v in {**launches, "decode_attention[xlb]":
                                main_launches["decode_attention"],
                                "dense_x9[phase2]": x9_launches,
                                "dense_x9[serve]":
                                sum(serve_x9.values())}.items())
          + " (admit_commit, complete and decode_attention[xlb] on the main "
          "path; route_match, relay_slots and admit in the staged phase, "
          "and admit, complete, route_match and relay_slots in the sharded "
          "drain (through the captured sharded tick) too; "
          "flash_attention and decode_attention in the model phase's "
          "minitron-4b, " + ", ".join(DENSE_ARCHS) + ", arctic-480b and "
          "jamba-v0.1-52b, ssd_scan in mamba2-2.7b's and jamba's, and "
          f"relay_slots in {llm_launches['relay_slots']} launches of the "
          "MoE dispatch in " + ", ".join(MOE_ARCHS) + "; whisper-large-"
          "v3's serving cell: flash_attention in its encoder, not causal, "
          "and decoder, decode_attention self and cross; dense_x9 in "
          "phase 2's calls and the full-width serve runs' ticks ("
          + " ".join(f"{k.replace(' ', '')}={v}" for k, v in serve_x9.items())
          + "); the training "
          "forwards: " + " ".join(f"{k}={v}" for k, v in train_total.items())
          + " (whisper-large-v3 at full width "
          + " ".join(f"{k}={v}" for k, v in train_whisper.items())
          + ", the smoke configs through launch.train "
          + " ".join(f"{k}={v}" for k, v in train_smoke.items())
          + ")); " + "; ".join(
              f"in the {name} phase: " + " ".join(
                  f"{k}={v}" for k, v in got.items())
              for name, got in (("examples", example_launches),
                                ("RunCtx", ctx_launches),
                                ("control", control_launches),
                                ("degraded", degraded_launches),
                                ("chaos", chaos_launches),
                                ("sanitizer", sanitize_launches),
                                ("sharded drain", sharded_launches))))
    print("kernels replayed: " + " ".join(f"{k}={v}" for k, v in
                                          replayed.items())
          + " (the launches of every phase, the main paths' and the "
          "others', that ran inside CUDA graph replays: the serving ticks, "
          "unsharded and sharded, the sidecars' and the model launcher's "
          "decode steps, the training steps)")

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
                         "src/repro/kernels/ssd_scan.py:28"),
            "dense_x9": (src + "dense_x9.cu", "none (XLA's x @ W)")}
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
                "launch_floor_ms": t["floor_ms"],
                "launches_replayed_whole_run": replayed[name]})
            if name == "decode_attention":
                kernels[-1]["kernel"] = t["kernel"]
                kernels[-1]["launches_xlb_main_path"] = \
                    main_launches["decode_attention"]
                xlb = timing["decode_attention[xlb]"]
                kernels[-1]["xlb_shape"] = {
                    k: xlb[k] for k in ("ms", "kernel", "library_ms",
                                        "library_device_ms")}
            if name == "dense_x9":
                kernels[-1]["launches_serve"] = serve_x9
            if name in sharded_launches:       # and in the sharded drain
                kernels[-1]["launches_sharded_drain"] = \
                    sharded_launches[name]
            sharded_ms = {"admit": ("admit[serving,M={}]", "b3_ms"),
                          "route_match": ("admit[serving,M={}]", "b4_ms"),
                          "complete": ("complete[M={}]", "b1_ms")}
            if name in sharded_ms:             # per shard, at each M
                key, part = sharded_ms[name]
                kernels[-1]["sharded_ms"] = {
                    str(M): stiming[key.format(M)][part] for M in SHARDS}
            if name in SHARD_KERNELS:           # each rank's, in its drain
                kernels[-1]["launches_ranks"] = {
                    str(M): [n[name] for n in per]
                    for M, per in rank_launches.items()}
            if name in ("admit_commit", "admit"):   # the tuned plan, tiles
                kernels[-1]["block_r"] = t["block_r"]
                kernels[-1]["tiles_ms"] = {
                    f"R={R},block_r={b}": tune_timing[(name, R, b)]
                    for R in (ADMIT_R, 4096) for b in rm.TILES}
            if name in train_total:            # and in the training forwards
                kernels[-1]["launches_training"] = train_total[name]
            if name in example_launches:       # and in the examples
                kernels[-1]["launches_examples"] = example_launches[name]
            if name in ctx_launches:           # and in the RunCtx phase
                kernels[-1]["launches_ctx"] = ctx_launches[name]
            if name == "flash_attention":      # as minitron's prefill ran it
                kernels[-1]["kernel"] = prefill_kernels["minitron-4b"]
                enc = timing["flash_attention[enc]"]
                kernels[-1]["whisper_encoder_shape"] = {
                    "causal": False, "kernel": enc["kernel"],
                    "ms": enc["ms"], "plain_ms": enc["plain_ms"],
                    "bound_ms": bound_ms(enc)[0],
                    "library_ms": enc["library_ms"],
                    "library_device_ms": enc["library_device_ms"],
                    "max_abs_err": enc["err"]}
            if name == "decode_attention":     # whisper's cross decode
                cross = timing["decode_attention[cross]"]
                kernels[-1]["whisper_cross_shape"] = {
                    "kernel": cross["kernel"], "ms": cross["ms"],
                    "plain_ms": cross["plain_ms"],
                    "bound_ms": bound_ms(cross)[0],
                    "library_ms": cross["library_ms"],
                    "max_abs_err": cross["err"]}
            if name in ("decode_attention", "flash_attention"):
                kernels[-1]["moe_shapes"] = {
                    key[len(name):]: {
                        "kernel": t2["kernel"], "ms": t2["ms"],
                        "plain_ms": t2["plain_ms"],
                        "bound_ms": bound_ms(t2)[0],
                        "max_abs_err": t2["err"]}
                    for key, t2 in timing.items()
                    if any(key.startswith(f"{name}[{a}]")
                           for a in MOE_ATTN_HEADS)}
            if name == "ssd_scan":             # as mamba's prefill ran it
                kernels[-1]["kernel"] = prefill_kernels["mamba2-2.7b"]
                kernels[-1]["passes_ms"] = t["passes"]
                jam = timing["ssd_scan[jamba]"]
                kernels[-1]["jamba_shape"] = {
                    "kernel": jam["kernel"], "ms": jam["ms"],
                    "plain_ms": jam["plain_ms"],
                    "bound_ms": bound_ms(jam)[0], "max_abs_err": jam["err"]}
            if name == "relay_slots":          # and in the MoE dispatch
                kernels[-1]["launches_staged"] = \
                    staged_launches["relay_slots"]
                kernels[-1]["launches_moe_path"] = \
                    llm_launches["relay_slots"]
                kernels[-1]["moe_shapes"] = {
                    a: {"N": timing[f"relay_slots[{a}]"]["moe"][0],
                        "n_dest": timing[f"relay_slots[{a}]"]["moe"][1],
                        "ms": timing[f"relay_slots[{a}]"]["ms"],
                        "bound_ms": bound_ms(timing[f"relay_slots[{a}]"])[0]}
                    for a in MOE_ARCHS}
    for name, label in (("admit_commit", "B2"), ("admit", "B3")):
        t = timing[name]
        print(f"admit redesign: {label} {name} device ms {t['ms']} at the "
              f"serving shape (R {ADMIT_R}, {I_LANES} x {SLOTS} pool, six "
              f"policies, the planned block_r={t['block_r']}; before the "
              f"redesign: {ADMIT_BEFORE_MS[name]}), "
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
    for t in timing.values():
        if "moe" in t:
            N, nd = t["moe"]
            print(f"relay moe: B5 relay_slots[N={N},n_dest={nd}] (a MoE "
                  f"prefill's dispatch) device ms {t['ms']}, bound ms "
                  f"{bound_ms(t)[0]}, launch floor ms {t['floor_ms']}, call "
                  f"ms {t['call_ms']}, plain ms {t['plain_ms']}, on {gpu}")
    for line in phase_analysis(torch):
        print(line)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def timing_for(src: str) -> int:
    """``python3 chip_smoke.py --timing SRC``: for the port in SRC (this
    checkout's ``src``, or another checkout's, to compare two trees in one
    call, in turns), the main path's drains (``phase_serve``: its
    "serve" lines, captured and eager) and the one-process sharded
    admission
    (``ops.admit_commit_sharded`` over ``make_shard_mesh``) at the serving
    shape and block_r 256 at each M of SHARDS: event-timed ms a call, the
    mean of 50 calls."""
    import torch
    if not torch.cuda.is_available():
        fail("torch finds no CUDA device")
    sys.path.insert(0, str(Path(src).resolve()))
    from repro_torch.configs import XLB_SERVICE_MODEL as cfg
    from repro_torch.core import balancer as B
    from repro_torch.core import control as CT
    from repro_torch.core import interpose
    from repro_torch.core import routing_table as RT
    from repro_torch.kernels import ops
    from repro_torch.kernels import shard_admit as SA
    from repro_torch.launch import mesh as MS
    from repro_torch.models import model as TM
    from repro_torch.runtime import serve_loop as SL
    dev = torch.device("cuda")
    gpu = gpu_line()
    for line in phase_serve(torch, RT, CT, ops, TM, interpose, SL, cfg)[0]:
        print(f"timing {src}: {line} on {gpu}")
    routing0, _ = routing_config(RT, "cpu")
    routing, reqs, pool, rnd, gum = admit_inputs(
        torch, RT, routing0, ADMIT_R, I_LANES, SLOTS, seed=ADMIT_R, dev=dev)
    batch, pstate = B.RequestBatch(*reqs), B.PoolState(*pool)
    got = []
    for M in SHARDS:
        mesh = MS.make_shard_mesh(M, device=dev)
        live = SA.live_shards(reqs[0], M)
        got.append(cuda_ms(torch, lambda: ops.admit_commit_sharded(
            batch, routing, pstate, rnd, gum, mesh=mesh, live=live,
            block_r=256)))
    print(f"timing {src}: sharded admission, ms a call at M " + " / ".join(
        map(str, SHARDS)) + ": " + " / ".join(f"{t:.4f}" for t in got)
        + f" on {gpu}")
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--timing"]:
        sys.exit(timing_for(sys.argv[2]))
    sys.exit(main())

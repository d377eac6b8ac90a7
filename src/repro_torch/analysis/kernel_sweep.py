"""The ``kernels`` section of ``python -m repro_torch.analysis``: the eight
CUDA kernels, each through ``kernels/ops.py``, at the serving and model
paths' shapes and their edges, bounds-checked.

In place of the reference's jaxpr interval analysis (which proves each
Pallas gather in bounds) the card runs each kernel once on inputs that
reach its edges: out-of-range services and endpoints, drained lanes,
stale Maglev entries, NaN Gumbel rows, held rows, ragged batches, the
sharded widths (B3's all-free mode at W = 1024, past what a staged mask
fits), B5's thread-block cluster, B6 at G = 48 and hd 16, B7 and B8 at
hd 16.  What checks the bounds is the build (``_build.use_bounds_check``:
every computed index of global and shared memory asserted on the device,
``csrc/bounds.cuh``) or, where it can attach to the card, the sanitizer's
memcheck around the normal build.  On top of that each result is held
against the kernel's plain version on the same tensors (integers exact,
floats within the kernels' tolerances) and every integer output against
its range.

On the CPU (``device="cpu"``) the same cases run, at reduced shapes,
through the plain versions: a rehearsal of the section's inputs, with
torch's own index checks as the bounds check.
"""

from __future__ import annotations

import torch

from repro_torch.analysis.lint import Finding
from repro_torch.core import routing_table as RT
from repro_torch.core.balancer import PoolState, RequestBatch
from repro_torch.kernels import (completion, decode_attention,
                                 flash_attention, ops, relay_dispatch,
                                 route_match, ssd_scan)

#: the serving shape: admit batch, instance lanes, slots
ADMIT_R, I_LANES, SLOTS = 256, 64, 16
#: B5 at the staged chain's shapes, a ragged N, N past one block (the
#: thread-block cluster) and every row on one destination
RELAY_SHAPES = ((256, 65), (256, 513), (4096, 65), (1000, 65), (4096, 1))


def _serving_config():
    """One service per policy (8 endpoints each), a 50-endpoint
    least-request cluster over lanes 14..63 and a service no request
    matches (the serving phase's routing)."""
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


def _admit_inputs(routing, R, I, C, seed, dev):
    """A batch over the serving routing: half the rows hit a policy
    service's first rule, a quarter repeat an earlier flow, 3 % name a
    service past S, 10 % are padding; NaN in some Gumbel rows; stale
    Maglev entries and drained lanes; a pool half busy."""
    g = torch.Generator().manual_seed(seed)
    S = 8
    svc = torch.randint(0, S, (R,), generator=g, dtype=torch.int32)
    feats = torch.randint(0, 1 << 20, (R, RT.N_FEATURES), generator=g,
                          dtype=torch.int32)
    hit = torch.rand(R, generator=g) < 0.5
    feats[:, 0] = torch.where(
        hit, torch.tensor([RT.fnv1a(f"/api/{p}") for p in range(8)],
                          dtype=torch.int32)[svc % 8], feats[:, 0])
    dup = torch.rand(R, generator=g) < 0.25
    src = (torch.rand(R, generator=g) * torch.arange(R)).long()
    feats[dup] = feats[src[dup]]
    svc[dup] = svc[src[dup]]
    svc[torch.rand(R, generator=g) < 0.03] = 70
    rid = torch.where(torch.rand(R, generator=g) < 0.9,
                      torch.arange(R, dtype=torch.int32), -1)
    act = torch.rand((I, C), generator=g) < 0.5
    pool = [torch.where(act, torch.randint(1000, 9000, (I, C), generator=g),
                        -1).int(),
            torch.where(act, torch.randint(0, 100, (I, C), generator=g),
                        -1).int(),
            torch.randint(0, S, (I, C), generator=g, dtype=torch.int32),
            torch.randint(0, 30, (I, C), generator=g, dtype=torch.int32),
            torch.randint(0, 500, (I, C), generator=g, dtype=torch.int32),
            act]
    reqs = RequestBatch(
        req_id=rid, svc=svc, features=feats,
        token=torch.randint(0, 500, (R,), generator=g, dtype=torch.int32),
        msg_bytes=torch.randint(1, 900, (R,), generator=g,
                                dtype=torch.int32))
    rnd = torch.randint(0, 1 << 30, (R,), generator=g, dtype=torch.int32)
    gum = -torch.log(-torch.log(torch.rand((R, 64), generator=g)
                                .clamp_min(1e-30)))
    gum[::11, 0] = float("nan")
    gum[5::11, :] = float("nan")
    mg = routing.maglev_table.clone()
    mg[8, ::3] = 9                          # Maglev entries past the window
    mg[8, 1::5] = -1                        # and empty ones
    drained = torch.zeros_like(routing.ep_drained)
    drained[[1, 17, 33]] = 1                # rr, lr, maglev lanes
    routing = routing._replace(
        ep_load=torch.randint(0, 6, routing.ep_load.shape, generator=g,
                              dtype=torch.int32),
        ep_drained=drained, maglev_table=mg)
    to = lambda t: t.to(dev)                                 # noqa: E731
    return (routing.to(dev), RequestBatch(*map(to, reqs)),
            PoolState(*map(to, pool)), to(rnd), to(gum))


class _Sweep:
    """Runs the cases, collects findings and what launched."""

    def __init__(self, dev):
        self.dev = dev
        self.findings: list[Finding] = []
        self.cases = 0
        self.launches = dict.fromkeys(ops.LAUNCHES, 0)

    def flag(self, code, where, detail):
        self.findings.append(Finding(code, f"kernels/{where}", detail))

    def run(self, where, call, plain, check=None, tol=None):
        """``call`` through ops against ``plain`` on the same tensors:
        equal (``tol`` None) or within ``tol(want) -> (rtol, atol)``;
        ``check(got)`` returns range violations."""
        self.cases += 1
        n0 = dict(ops.LAUNCHES)
        try:
            got = call()
            if self.dev.type == "cuda":
                torch.cuda.synchronize(self.dev)
        except Exception as e:   # a trapped launch or a refused shape
            self.flag("kernel-failed", where, f"{type(e).__name__}: {e}")
            return
        for k in self.launches:
            self.launches[k] += ops.LAUNCHES[k] - n0[k]
        want = plain()
        for i, (g, w) in enumerate(zip(_leaves(got), _leaves(want))):
            if tol is None:
                same = g.dtype == w.dtype and torch.equal(g, w)
            else:
                rtol, atol = tol(w)
                same = torch.allclose(g.float(), w.float(), rtol=rtol,
                                      atol=atol, equal_nan=True)
            if not same:
                self.flag("kernel-mismatch", where,
                          f"output {i} differs from the plain version")
        for msg in (check(got) if check else []):
            self.flag("kernel-out-of-range", where, msg)


def _leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for v in x for t in _leaves(v)]


def _in_range(name, t, lo, hi):
    t = t.long()
    if t.numel() and (int(t.min()) < lo or int(t.max()) >= hi):
        return [f"{name} outside [{lo}, {hi}): [{int(t.min())}, "
                f"{int(t.max())}]"]
    return []


def _admit_checks(routing, I, C):
    """Ranges of an admission's outputs: an instance is the endpoint's lane
    from the table (it may exceed the pool, whose rows it then never
    gets); a slot lies in the pool's width."""
    E, CL = routing.ep_load.shape[0], routing.cluster_ep_count.shape[0]
    lanes = int(routing.ep_instance.max()) + 1

    def check(res):
        return (_in_range("endpoint", res.endpoint, -1, E)
                + _in_range("instance", res.instance, -1, lanes)
                + _in_range("slot", res.slot, -1, C)
                + _in_range("cluster", res.cluster, -1, CL)
                + _in_range("ep_load", res.ep_load, 0, 1 << 30))
    return check


def _sweep_admission(sw, dev, small):
    from repro_torch.launch.mesh import make_shard_mesh
    routing0, _ = RT.build_state(*_serving_config(), "cpu")
    cases = [("serving", ADMIT_R, I_LANES, SLOTS), ("ragged", 300, 8, 4)]
    if not small:
        cases.append(("R4096", 4096, I_LANES, SLOTS))
    for label, R, I, C in cases:
        routing, reqs, pool, rnd, gum = _admit_inputs(routing0, R, I, C,
                                                      R, dev)
        fields = (pool.req_id, pool.endpoint, pool.svc, pool.length,
                  pool.token)
        sw.run(f"admit_commit[{label}]",
               lambda: ops.admit_commit(reqs, routing, pool, rnd, gum),
               lambda: route_match.admit_commit(
                   reqs.req_id, reqs.svc, reqs.features, reqs.msg_bytes,
                   reqs.token, routing, *fields, pool.active, rnd, gum),
               _admit_checks(routing, I, C))
        free = pool.active == 0
        sw.run(f"admit[{label}]",
               lambda: ops.admit(reqs, routing, free, rnd, gum),
               lambda: route_match.admit(
                   reqs.req_id, reqs.svc, reqs.features, reqs.msg_bytes,
                   routing, free, rnd, gum),
               _admit_checks(routing, I, C))
        if label == "ragged":
            continue
        # the sharded widths; at R = 4096 over 4 shards B3 runs its
        # all-free mode at W = 1024 (F4's shape)
        for M in ((1, 2, 4) if label == "serving" else (4,)):
            mesh = make_shard_mesh(M, device=dev)
            sw.run(f"admit_commit_sharded[{label},M={M}]",
                   lambda: ops.admit_commit_sharded(reqs, routing, pool,
                                                    rnd, gum, mesh=mesh),
                   lambda: ops.admit_commit(reqs, routing, pool, rnd, gum)
                   if dev.type == "cuda" else route_match.admit_commit(
                       reqs.req_id, reqs.svc, reqs.features, reqs.msg_bytes,
                       reqs.token, routing, *fields, pool.active, rnd, gum),
                   _admit_checks(routing, I, C))
        W = 64 if small else 1024
        sw.run(f"admit[all-free W={W}]",
               lambda: route_match.admit_cuda(
                   reqs.req_id, reqs.svc, reqs.features, reqs.msg_bytes,
                   None, routing, None, None, rnd, gum, pool_shape=(I, W))
               if dev.type == "cuda" else route_match.admit(
                   reqs.req_id, reqs.svc, reqs.features, reqs.msg_bytes,
                   routing, None, rnd, gum, pool_shape=(I, W)),
               lambda: route_match.admit(
                   reqs.req_id, reqs.svc, reqs.features, reqs.msg_bytes,
                   routing, torch.ones((I, W), dtype=torch.int32,
                                       device=dev), rnd, gum),
               _admit_checks(routing, I, W))
        if label == "serving":
            for R2 in ((ADMIT_R,) if small else (ADMIT_R, 4096)):
                svc = reqs.svc if R2 == ADMIT_R else reqs.svc.repeat(16)
                feats = reqs.features if R2 == ADMIT_R \
                    else reqs.features.repeat(16, 1)
                sw.run(f"route_match[R={R2}]",
                       lambda: ops.route_match(svc, feats, routing),
                       lambda: route_match.route_match(svc, feats, routing),
                       lambda res: _in_range("route endpoint", res[1], -1,
                                             routing.ep_load.shape[0]))


def _sweep_completion(sw, dev):
    g = torch.Generator().manual_seed(7)
    I, C, E, S = I_LANES, SLOTS, RT.MAX_ENDPOINTS, RT.MAX_SERVICES
    act = torch.rand((I, C), generator=g) < 0.8
    pool = [torch.where(act, torch.randint(0, 9999, (I, C), generator=g),
                        -1).int(),
            torch.randint(-2, E + 3, (I, C), generator=g, dtype=torch.int32),
            torch.randint(-1, S + 2, (I, C), generator=g, dtype=torch.int32),
            torch.randint(0, 31, (I, C), generator=g, dtype=torch.int32),
            torch.randint(0, 500, (I, C), generator=g, dtype=torch.int32),
            act]
    nxt = torch.where(torch.rand((I, C), generator=g) < 0.25, 1,
                      torch.randint(2, 500, (I, C), generator=g)).int()
    rest = [torch.randint(3, 9, (E,), generator=g, dtype=torch.int32),
            torch.randint(0, 100, (S,), generator=g, dtype=torch.int32),
            torch.rand(E, generator=g) * 6, torch.rand(E, generator=g) * 2]
    t = [x.to(dev) for x in (*pool, nxt, *rest)]
    p = PoolState(*t[:6])
    sw.run("complete[64x16]",
           lambda: ops.complete(p, *t[6:], eos=1, max_len=32),
           lambda: completion.complete(*t, eos=1, max_len=32),
           lambda res: _in_range("ep_load", res[2], 0, 1 << 30))


def _sweep_relay(sw, dev, small):
    for N, nd in (RELAY_SHAPES[:2] + RELAY_SHAPES[3:4] if small
                  else RELAY_SHAPES):
        g = torch.Generator().manual_seed(N + nd)
        idx = (torch.zeros((N,), dtype=torch.int32) if nd == 1
               else torch.randint(0, nd + 1, (N,), generator=g,
                                  dtype=torch.int32)).to(dev)
        live = (idx >= 0) & (idx < nd)
        sw.run(f"relay_slots[N={N},n_dest={nd}]",
               lambda: ops.relay_slots(idx, nd),
               lambda: relay_dispatch.relay_slots(idx, nd),
               lambda res: _in_range("slot", res[0][live], 0, N))


def _rms_tol(dtype):
    """The kernels' tolerances: f32 2e-5; bf16 rtol 2e-2, atol 2e-2 x the
    output's RMS."""
    if dtype == torch.float32:
        return lambda w: (2e-5, 2e-5)
    return lambda w: (2e-2, 2e-2 * float(w.float().pow(2).mean().sqrt()))


def _sweep_float(sw, dev, small):
    bf16, f32 = torch.bfloat16, torch.float32
    g = torch.Generator(device=dev).manual_seed(0)
    rn = lambda *s, dt: torch.randn(s, generator=g, device=dev,  # noqa
                                    dtype=f32).to(dt)
    # B6: minitron-4b's decode, the serving model's, G = 48, hd 16
    dec = [("minitron", (2, 4128, 24, 8, 128), bf16),
           ("G48", (2, 2048, 48, 1, 128), bf16),
           ("G48 f32", (2, 2048, 48, 1, 128), f32),
           ("serving", (1024, 32, 4, 2, 32), f32),
           ("hd16", (2, 512, 4, 2, 16), f32),
           ("hd16 bf16", (2, 512, 4, 2, 16), bf16)]
    if small:
        dec = [(n, (B, min(S, 64), H, K, hd), dt)
               for n, (B, S, H, K, hd), dt in dec if B <= 2]
    for name, (B, S, H, K, hd), dt in dec:
        q, kc, vc = rn(B, H, hd, dt=dt), rn(B, S, K, hd, dt=dt), \
            rn(B, S, K, hd, dt=dt)
        lens = torch.randint(-1, S, (B,), generator=g, device=dev,
                             dtype=torch.int32)
        lens[0] = S - 1
        sw.run(f"decode_attention[{name}]",
               lambda: ops.decode_attention(q, kc, vc, lens),
               lambda: decode_attention.decode_attention(q, kc, vc, lens),
               tol=_rms_tol(dt))
    # B7: minitron-4b's prefill (bf16: the wgmma kernel), hd 16 and the f32
    # FMA kernel at a ragged S
    fl = [("minitron", (2, 4096, 24, 8, 128), bf16, True),
          ("f32 ragged", (1, 500, 8, 2, 64), f32, True),
          ("hd16", (2, 300, 4, 2, 16), f32, False),
          ("hd16 bf16", (2, 300, 4, 2, 16), bf16, True)]
    if small:
        fl = [(n, (B, min(S, 96), H, K, hd), dt, c)
              for n, (B, S, H, K, hd), dt, c in fl]
    for name, (B, S, H, K, hd), dt, causal in fl:
        q = rn(B, S, H, hd, dt=dt)
        k, v = rn(B, S, K, hd, dt=dt), rn(B, S, K, hd, dt=dt)
        sw.run(f"flash_attention[{name}]",
               lambda: ops.flash_attention(q, k, v, causal=causal),
               lambda: flash_attention.flash_attention(q, k, v,
                                                       causal=causal),
               tol=_rms_tol(dt))
    # B8: mamba2-2.7b's prefill (bf16: four passes, B and C shared by the
    # heads), per-head B and C, and the f32 / hd 16 FMA kernel
    ss = [("mamba", (2, 4096, 80, 64, 128), bf16, True),
          ("per-head B C", (1, 1024, 4, 64, 128), bf16, False),
          ("f32", (1, 700, 4, 64, 64), f32, False),
          ("hd16 N16", (2, 300, 4, 16, 16), f32, True)]
    if small:
        ss = [(n, (B, 256, min(nh, 4), hd, N), dt, sh)
              for n, (B, S, nh, hd, N), dt, sh in ss]
    for name, (B, S, nh, hd, N), dt, shared in ss:
        x = rn(B, S, nh, hd, dt=dt)
        a_log = -torch.rand((B, S, nh), generator=g, device=dev) * 0.5
        if shared:
            Bm = rn(B, S, 1, N, dt=dt).expand(B, S, nh, N)
            Cm = rn(B, S, 1, N, dt=dt).expand(B, S, nh, N)
        else:
            Bm, Cm = rn(B, S, nh, N, dt=dt), rn(B, S, nh, N, dt=dt)
        chunk = 256 if S % 256 == 0 else S
        tol = _rms_tol(dt) if dt == bf16 else (lambda w: (2e-4, 2e-4))
        sw.run(f"ssd_scan[{name}]",
               lambda: ops.ssd_scan(x, a_log, Bm, Cm, chunk=chunk),
               lambda: ssd_scan.ssd_scan(x, a_log, Bm, Cm, chunk),
               tol=tol)


def kernel_findings(device="cuda") -> tuple[list[Finding], dict]:
    """Run the sweep on ``device``; returns (findings, info) with info
    ``{"cases", "launches", "build"}``."""
    from repro_torch.device import resolve_device
    from repro_torch.kernels import _build
    dev = resolve_device(device)
    small = dev.type == "cpu"
    sw = _Sweep(dev)
    _sweep_admission(sw, dev, small)
    _sweep_completion(sw, dev)
    _sweep_relay(sw, dev, small)
    _sweep_float(sw, dev, small)
    if dev.type == "cuda":
        missing = [k for k, v in sw.launches.items() if v == 0]
        if missing:
            sw.flag("kernel-not-launched", "sweep",
                    f"no launch of {missing}")
    build = ("plain versions (CPU)" if dev.type == "cpu" else
             "bounds-checking build (-DXLB_BOUNDS_CHECK)"
             if _build.bounds_check else "normal build")
    return sw.findings, {"cases": sw.cases, "launches": sw.launches,
                         "build": build}


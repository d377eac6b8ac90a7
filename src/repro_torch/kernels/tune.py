"""Block-size autotuner for the datapath kernels (twin of
``repro/kernels/tune.py``): admission (B2/B3) and completion (B1).

The reference sweeps the Pallas programs' tile shapes because the right
one depends on the backend and the shape.  On the card the admission
kernel's tile (``block_r``, rows per tile == threads per block of
``csrc/admit.cu``) is built for each of ``BLOCK_R_CANDIDATES``; the ops
wrappers ask this module for a plan at the first use of a shape, the sweep
times the kernel itself on synthetic shape-matched inputs at each
candidate (CUDA events, the minimum over trials; on the CPU the plain
version, host clock), picks the fastest and caches the choice per (kernel,
device type, fold, shape) for the life of the process.  A candidate the
kernel cannot launch at that shape (its shared memory past the 227 KB a
block may opt in to) is dropped, and the sweep log says why.

``block_r`` is semantic as well as a speed knob: the policy hooks read the
counters as each tile starts, and within a tile the first writer of an
affinity slot wins.  The plain versions walk any ``block_r``; the kernel
walks the tiles it is built for, and one tile of any size at least the
batch (``route_match.kernel_tile``): any other explicit ``block_r`` raises
``ValueError`` at the launch rather than run at another tile.

``block_i`` (completion) is resolved and recorded by the reference's rules
(a divisor of I: ``gcd`` with the default, the pins, explicit arguments)
but never swept: ``csrc/complete.cu`` holds the whole (I, C) pool in one
block and the plain version is one pass, so every ``block_i`` launches the
same work and there is nothing to choose between.  ``fold`` (the
reference's aggregation strategy, one-hot against segment folds) is
accepted, validated and recorded, and changes no launch: the kernels fold
with shared-memory atomics either way.

Environment overrides (a pinned run never sweeps):

  ``XLB_AUTOTUNE=0``   disable sweeping entirely: the static defaults
  ``XLB_BLOCK_R=n``    pin the admit/admit_commit tile rows
  ``XLB_BLOCK_I=n``    pin the completion tile lanes
  ``XLB_FOLD=name``    pin the aggregation strategy (``onehot``/``segment``)

Explicit keyword arguments at a call site outrank the environment; the
environment outranks the cache/sweep; the sweep outranks the static
defaults (``min(DEFAULT_BLOCK_R, R)``, ``gcd(I, DEFAULT_BLOCK_I)``).
"""

from __future__ import annotations

import math
import os
import time

import torch

ENV_AUTOTUNE = "XLB_AUTOTUNE"
ENV_BLOCK_R = "XLB_BLOCK_R"
ENV_BLOCK_I = "XLB_BLOCK_I"
ENV_FOLD = "XLB_FOLD"

DEFAULT_BLOCK_R = 256
DEFAULT_BLOCK_I = 8
BLOCK_R_CANDIDATES = (64, 256, 1024)
BLOCK_I_CANDIDATES = (1, 4, 8, 16)

#: the reference's fold strategies (``repro/kernels/backend.py``) and its
#: choice off the TPU
FOLDS = ("onehot", "segment")
DEFAULT_FOLD = "segment"

# (kernel, device type, fold, *shape) -> chosen block size
_cache: dict[tuple, int] = {}
# sweep history: (key, chosen, {candidate: seconds}, {candidate: why
# dropped})
_log: list[tuple] = []


def clear_cache() -> None:
    _cache.clear()
    _log.clear()


def autotune_enabled() -> bool:
    return os.environ.get(ENV_AUTOTUNE, "1").lower() not in ("0", "false",
                                                             "off")


def _env_int(name: str) -> int | None:
    v = os.environ.get(name, "").strip()
    return int(v) if v else None


def resolve_fold(fold: str | None) -> str:
    """Explicit arg > XLB_FOLD > the default; an unknown name raises
    ``ValueError``."""
    if fold is None:
        fold = os.environ.get(ENV_FOLD, "").strip() or DEFAULT_FOLD
    if fold not in FOLDS:
        raise ValueError(f"unknown fold strategy {fold!r}; one of {FOLDS}")
    return fold


def _time_best(fn, dev: torch.device, reps: int = 3,
               trials: int = 3) -> float:
    """Min-of-trials seconds per call (min, not median: the sweep wants the
    noise floor).  On CUDA by events around ``reps`` calls queued behind a
    device-side spin long enough for the host to issue them all, so the
    window holds the kernels back to back and not the host's issue time;
    on the CPU by the host clock."""
    fn()                                   # build and first launch untimed
    best = math.inf
    for _ in range(trials):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(1_000_000 * reps)    # ~0.5 ms a call
            s.record()
            for _ in range(reps):
                fn()
            e.record()
            e.synchronize()
            dt = s.elapsed_time(e) / 1e3
        else:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            dt = time.perf_counter() - t0
        best = min(best, dt / reps)
    return best


def _sweep(key: tuple, candidates, make_fn, dev: torch.device) -> int:
    """Time each candidate block size, cache and return the fastest.  A
    candidate whose launch raises ``ValueError`` (the kernel cannot take
    it at this shape) is dropped with the message."""
    if key in _cache:
        return _cache[key]
    timings, dropped = {}, {}
    for cand in candidates:
        try:
            timings[cand] = _time_best(make_fn(cand), dev)
        except ValueError as e:
            dropped[cand] = str(e)
    if not timings:
        raise ValueError(f"no candidate of {list(candidates)} launches for "
                         f"{key}: {dropped}")
    best = min(timings, key=timings.get)
    _cache[key] = best
    _log.append((key, best, timings, dropped))
    return best


# --------------------------------------------------------------------------- #
# admit / admit_commit
# --------------------------------------------------------------------------- #


def _admit_candidates(R: int) -> list[int]:
    return sorted({min(b, R) for b in BLOCK_R_CANDIDATES})


def _synthetic_admit(R: int, I: int, C: int, commit: bool,
                     dev: torch.device):
    """A shape-matched workload for the sweep (the reference's): traffic to
    a LEAST_REQUEST cluster with a WEIGHTED cluster in the table, so both
    heavy branches (the water-fill and the Gumbel argmax) are there; no
    drains (the steady state the serving path runs).  Returns
    ``make_fn(block_r)`` -> a call of B2 (``commit``) or B3 on ``dev``, or
    of its plain version on the CPU."""
    from repro_torch.core.routing_table import (MAX_EPS_PER_CLUSTER,
                                                N_FEATURES,
                                                POLICY_LEAST_REQUEST,
                                                POLICY_WEIGHTED, Cluster,
                                                Rule, ServiceConfig,
                                                build_state)
    from repro_torch.kernels import route_match as _rm

    eps = [i % max(I, 1) for i in range(min(8, I))]
    state, _ = build_state(
        [ServiceConfig("t", rules=[Rule(0, None, "pool")])],
        [Cluster("pool", endpoints=eps, policy=POLICY_LEAST_REQUEST),
         Cluster("alt", endpoints=eps[:1], policy=POLICY_WEIGHTED)], dev)
    i32 = dict(dtype=torch.int32, device=dev)
    rid = torch.arange(R, **i32)
    z = torch.zeros((R,), **i32)
    feats = torch.zeros((R, N_FEATURES), **i32)
    gum = torch.zeros((R, MAX_EPS_PER_CLUSTER), dtype=torch.float32,
                      device=dev)
    cuda = dev.type == "cuda"
    if commit:
        pool = [torch.full((I, C), -1, **i32), torch.full((I, C), -1, **i32),
                torch.zeros((I, C), **i32), torch.zeros((I, C), **i32),
                torch.zeros((I, C), **i32)]
        free = torch.ones((I, C), dtype=torch.bool, device=dev)

        def make_fn(block_r):
            if cuda:
                return lambda: _rm.admit_cuda(rid, z, feats, z, z, state,
                                              free, pool, z, gum,
                                              block_r=block_r)
            return lambda: _rm.admit_commit(rid, z, feats, z, z, state,
                                            *pool, ~free, z, gum,
                                            block_r=block_r)
    else:
        free = torch.ones((I, C), dtype=torch.bool, device=dev)

        def make_fn(block_r):
            if cuda:
                return lambda: _rm.admit_cuda(rid, z, feats, z, None, state,
                                              free, None, z, gum,
                                              block_r=block_r)
            return lambda: _rm.admit(rid, z, feats, z, state, free, z, gum,
                                     block_r=block_r)
    return make_fn


def plan_admit(R: int, pool_shape: tuple, *, block_r: int | None = None,
               fold: str | None = None, commit: bool = False,
               device="cuda") -> tuple[int, str]:
    """Resolve (block_r, fold) for an admit/admit_commit launch of ``R``
    requests over an (I, C) pool on ``device`` (where a sweep runs)."""
    fold = resolve_fold(fold)
    if block_r is not None:
        return block_r, fold
    env = _env_int(ENV_BLOCK_R)
    if env is not None:
        return env, fold
    if R <= 0:
        return DEFAULT_BLOCK_R, fold
    dev = torch.device(device)
    I, C = pool_shape
    key = ("admit_commit" if commit else "admit", dev.type, fold, R, I, C)
    if key in _cache:
        return _cache[key], fold
    cands = _admit_candidates(R)
    if not autotune_enabled() or len(cands) == 1:
        return min(DEFAULT_BLOCK_R, R), fold
    make_fn = _synthetic_admit(R, I, C, commit, dev)
    return _sweep(key, cands, make_fn, dev), fold


# --------------------------------------------------------------------------- #
# complete
# --------------------------------------------------------------------------- #


def _complete_candidates(I: int) -> list[int]:
    return sorted({math.gcd(I, max(1, b)) for b in BLOCK_I_CANDIDATES + (I,)})


def plan_complete(pool_shape: tuple, *, block_i: int | None = None,
                  fold: str | None = None,
                  device="cuda") -> tuple[int, str]:
    """Resolve (block_i, fold) for a completion launch over an (I, C) pool
    on ``device``: recorded, never swept (every ``block_i`` runs the same
    kernel; see the module docstring)."""
    fold = resolve_fold(fold)
    if block_i is not None:
        return block_i, fold
    env = _env_int(ENV_BLOCK_I)
    if env is not None:
        return env, fold
    I, C = pool_shape
    key = ("complete", torch.device(device).type, fold, I, C)
    if key not in _cache:
        _cache[key] = math.gcd(I, DEFAULT_BLOCK_I)
    return _cache[key], fold

"""The port's autotuner (``repro_torch/kernels/tune.py``) against the
reference's contract (``tests/test_tune.py``): explicit arguments beat the
environment pins, the pins beat the cache and the sweep, ``XLB_AUTOTUNE=0``
never times a candidate, a swept choice is cached per (kernel, device
type, fold, shape), ``block_i`` candidates divide I, fold names are
validated.  Then the admission wrappers at ``block_r`` 64, 256 and 1024
against ``repro.kernels.ops`` at the same ``block_r``, on a batch whose
affinity cache depends on the tile (two flows, each in two AFFINITY
clusters: within a tile the first writer wins, across tiles the later
one).  Tolerance: every integer output bit-exact."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import routing_table as JR
from repro.core.balancer import PoolState as JPool
from repro.core.balancer import RequestBatch as JBatch
from repro.kernels import backend
from repro.kernels import ops as jops
from repro.kernels import tune as jtune
from repro_torch import convert
from repro_torch.configs import get_config, smoke_config
from repro_torch.core.balancer import PoolState, RequestBatch
from repro_torch.core.interpose import Engine
from repro_torch.kernels import ops, route_match, tune
from repro_torch.launch.mesh import make_shard_mesh

CPU = torch.device("cpu")
ADMIT_FIELDS = route_match.AdmitResult._fields


@pytest.fixture(autouse=True)
def _fresh_cache():
    tune.clear_cache()
    yield
    tune.clear_cache()


def _forbid_timing(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("autotuner timed a candidate under a pin")
    monkeypatch.setattr(tune, "_time_best", boom)


# --------------------------------------------------------------------------- #
# the contract
# --------------------------------------------------------------------------- #


def test_public_names_match_reference():
    for name in ("ENV_AUTOTUNE", "ENV_BLOCK_R", "ENV_BLOCK_I", "ENV_FOLD",
                 "DEFAULT_BLOCK_R", "DEFAULT_BLOCK_I", "BLOCK_R_CANDIDATES",
                 "BLOCK_I_CANDIDATES"):
        assert getattr(tune, name) == getattr(jtune, name), name
    assert tune.FOLDS == backend.FOLDS
    assert set(tune.BLOCK_R_CANDIDATES) == set(route_match.TILES)
    for R in (1, 7, 64, 100, 256, 300, 1024, 4096):
        assert tune._admit_candidates(R) == jtune._admit_candidates(R)
    for I in (1, 2, 6, 8, 16, 24, 64):
        assert tune._complete_candidates(I) == jtune._complete_candidates(I)


def test_env_override_is_deterministic(monkeypatch):
    """With XLB_BLOCK_R/XLB_BLOCK_I/XLB_FOLD set, every plan is the pinned
    value, no candidate is timed, and repeated calls (even across cache
    clears) return the same plan."""
    monkeypatch.setenv(tune.ENV_AUTOTUNE, "1")
    monkeypatch.setenv(tune.ENV_BLOCK_R, "64")
    monkeypatch.setenv(tune.ENV_BLOCK_I, "2")
    monkeypatch.setenv(tune.ENV_FOLD, "onehot")
    _forbid_timing(monkeypatch)
    plans = set()
    for _ in range(3):
        tune.clear_cache()
        plans.add(tune.plan_admit(4096, (8, 64)))
        plans.add(tune.plan_admit(4096, (8, 64), commit=True))
        plans.add(tune.plan_complete((16, 256)))
    assert plans == {(64, "onehot"), (2, "onehot")}


def test_autotune_off_uses_static_defaults(monkeypatch):
    monkeypatch.setenv(tune.ENV_AUTOTUNE, "0")
    for name in (tune.ENV_BLOCK_R, tune.ENV_BLOCK_I, tune.ENV_FOLD):
        monkeypatch.delenv(name, raising=False)
    _forbid_timing(monkeypatch)
    br, fold = tune.plan_admit(4096, (8, 64))
    assert br == tune.DEFAULT_BLOCK_R
    assert fold == backend.default_fold() == tune.DEFAULT_FOLD
    bi, _ = tune.plan_complete((16, 256))
    assert bi == math.gcd(16, tune.DEFAULT_BLOCK_I)
    # small batches clamp the default tile to the batch
    assert tune.plan_admit(32, (8, 64))[0] == 32
    assert tune.plan_admit(0, (8, 64))[0] == tune.DEFAULT_BLOCK_R


@pytest.mark.parametrize("env", [
    {}, {"XLB_BLOCK_R": "64"}, {"XLB_BLOCK_I": "4", "XLB_FOLD": "onehot"},
    {"XLB_BLOCK_R": "1024", "XLB_FOLD": "segment"}])
def test_plans_match_reference_with_autotune_off(monkeypatch, env):
    monkeypatch.setenv(tune.ENV_AUTOTUNE, "0")
    for name in (tune.ENV_BLOCK_R, tune.ENV_BLOCK_I, tune.ENV_FOLD):
        monkeypatch.delenv(name, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    for R, pool in ((4096, (8, 64)), (300, (64, 16)), (34, (64, 16)),
                    (256, (4, 4))):
        for commit in (False, True):
            assert tune.plan_admit(R, pool, commit=commit) == \
                jtune.plan_admit(R, pool, commit=commit)
    for pool in ((16, 256), (6, 4), (64, 16), (1, 1)):
        assert tune.plan_complete(pool) == jtune.plan_complete(pool)


def test_explicit_args_outrank_env(monkeypatch):
    monkeypatch.setenv(tune.ENV_BLOCK_R, "64")
    monkeypatch.setenv(tune.ENV_FOLD, "onehot")
    _forbid_timing(monkeypatch)
    assert tune.plan_admit(4096, (8, 64), block_r=512,
                           fold="segment") == (512, "segment")
    assert tune.plan_complete((16, 256), block_i=4,
                              fold="segment") == (4, "segment")


def test_sweep_picks_fastest_and_caches(monkeypatch):
    """With autotune on and no pins: the sweep times each candidate once,
    picks the argmin, and the second identical call is a pure cache hit;
    the cache key holds the device type."""
    monkeypatch.setenv(tune.ENV_AUTOTUNE, "1")
    monkeypatch.delenv(tune.ENV_BLOCK_R, raising=False)
    calls = []

    def fake_time(fn, *a, **k):
        calls.append(fn)
        return float(len(calls) % 7 == 3) + 1.0 / len(calls)

    monkeypatch.setattr(tune, "_time_best", fake_time)
    br1, fold1 = tune.plan_admit(1024, (4, 16), device="cpu")
    n_after_first = len(calls)
    assert n_after_first == len(tune._admit_candidates(1024)) > 1
    assert br1 == 256                # the fake timer ranks the second first
    br2, fold2 = tune.plan_admit(1024, (4, 16), device="cpu")
    assert (br1, fold1) == (br2, fold2)
    assert len(calls) == n_after_first          # cache hit: no re-timing
    assert ("admit", "cpu", fold1, 1024, 4, 16) in tune._cache
    key, best, timings, dropped = tune._log[-1]
    assert best == br1 and set(timings) == {64, 256, 1024} and not dropped
    # a different shape, and the commit kernel, sweep separately
    tune.plan_admit(256, (4, 16), device="cpu")
    assert len(calls) > n_after_first
    n = len(calls)
    tune.plan_admit(1024, (4, 16), commit=True, device="cpu")
    assert len(calls) > n


def test_sweep_drops_a_candidate_that_cannot_launch(monkeypatch):
    """A candidate whose launch raises ValueError is dropped, and the log
    says why; the plan is the fastest of the rest."""
    monkeypatch.setenv(tune.ENV_AUTOTUNE, "1")
    monkeypatch.delenv(tune.ENV_BLOCK_R, raising=False)

    def fake_time(fn, *a, **k):
        return fn()

    def make_fn(b):
        def fn():
            if b == 1024:
                raise ValueError("admit at tile 1024 needs too much")
            return {64: 2.0, 256: 1.0}[b]
        return fn

    monkeypatch.setattr(tune, "_time_best", fake_time)
    monkeypatch.setattr(tune, "_synthetic_admit", lambda *a: make_fn)
    assert tune.plan_admit(4096, (8, 64), device="cpu")[0] == 256
    _, best, timings, dropped = tune._log[-1]
    assert timings == {64: 2.0, 256: 1.0}
    assert list(dropped) == [1024] and "too much" in dropped[1024]
    monkeypatch.setattr(tune, "_synthetic_admit",
                        lambda *a: lambda b: make_fn(1024))
    with pytest.raises(ValueError, match="no candidate"):
        tune.plan_admit(2048, (8, 64), device="cpu")


def test_real_sweep_on_the_cpu_times_the_plain_versions(monkeypatch):
    monkeypatch.setenv(tune.ENV_AUTOTUNE, "1")
    monkeypatch.delenv(tune.ENV_BLOCK_R, raising=False)
    for commit in (False, True):
        br, _ = tune.plan_admit(100, (4, 4), commit=commit, device="cpu")
        key, best, timings, dropped = tune._log[-1]
        assert key[:2] == ("admit_commit" if commit else "admit", "cpu")
        assert br == best in (64, 100) and set(timings) == {64, 100}
        assert all(t > 0 for t in timings.values()) and not dropped


def test_plan_complete_records_and_never_sweeps(monkeypatch):
    monkeypatch.setenv(tune.ENV_AUTOTUNE, "1")
    for name in (tune.ENV_BLOCK_I, tune.ENV_FOLD):
        monkeypatch.delenv(name, raising=False)
    _forbid_timing(monkeypatch)
    assert tune.plan_complete((24, 16), device="cpu") == (8, "segment")
    assert tune.plan_complete((6, 16), device="cpu") == (2, "segment")
    assert tune._cache[("complete", "cpu", "segment", 24, 16)] == 8
    assert tune._log == []


def test_complete_candidates_divide_pool():
    for I in (1, 2, 6, 8, 16, 24):
        for b in tune._complete_candidates(I):
            assert I % b == 0 and b >= 1


def test_fold_validation(monkeypatch):
    with pytest.raises(ValueError, match="unknown fold strategy"):
        tune.resolve_fold("bogus")
    with pytest.raises(ValueError):
        backend.resolve_fold("bogus")
    monkeypatch.delenv(tune.ENV_FOLD, raising=False)
    assert tune.resolve_fold(None) in tune.FOLDS
    monkeypatch.setenv(tune.ENV_FOLD, "onehot")
    assert tune.resolve_fold(None) == "onehot"
    monkeypatch.setenv(tune.ENV_FOLD, "scatter")
    with pytest.raises(ValueError):
        tune.resolve_fold(None)
    with pytest.raises(ValueError):
        tune.plan_complete((4, 4), fold="bogus")


def test_kernel_tile_takes_the_built_tiles_or_one_tile():
    assert [route_match.kernel_tile(b, 4096) for b in (64, 256, 1024)] == \
        [64, 256, 1024]
    assert route_match.kernel_tile(34, 34) == 64      # one tile either way
    assert route_match.kernel_tile(100, 100) == 256
    assert route_match.kernel_tile(300, 300) == 1024
    assert route_match.kernel_tile(2048, 700) == 1024
    for b, R in ((100, 300), (128, 4096), (2048, 2048), (0, 10)):
        with pytest.raises(ValueError, match=r"\(64, 256, 1024\)"):
            route_match.kernel_tile(b, R)


# --------------------------------------------------------------------------- #
# the admission wrappers at each block_r, against the reference
# --------------------------------------------------------------------------- #

R, I, C = 520, 8, 16
# two flows, each sent once to affA and once to affB: rows (20, 100) share
# a 256-row tile but not a 64-row one; rows (30, 300) share only the
# 1024-row tile
PAIRS = ((20, 100), (30, 300))


def _config():
    services = [JR.ServiceConfig("a", [JR.Rule(0, "v2", "affA"),
                                       JR.Rule(1, None, "lr")]),
                JR.ServiceConfig("b", [JR.Rule(0, "v2", "affB"),
                                       JR.Rule(1, None, "rr")]),
                JR.ServiceConfig("c", [JR.Rule(0, None, "w")])]
    clusters = [JR.Cluster("affA", [0, 1, 2], policy=JR.POLICY_AFFINITY),
                JR.Cluster("affB", [3, 4, 5, 6], policy=JR.POLICY_AFFINITY),
                JR.Cluster("lr", list(range(8)),
                           policy=JR.POLICY_LEAST_REQUEST),
                JR.Cluster("rr", [1, 2, 3], policy=JR.POLICY_RR),
                JR.Cluster("w", [2, 5, 7], policy=JR.POLICY_WEIGHTED,
                           weights=[1.0, 3.0, 0.5])]
    return services, clusters


def _case(seed=0):
    st, _ = JR.build_state(*_config())
    arrs = {f: np.array(getattr(st, f)) for f in st._fields}
    rng = np.random.RandomState(seed)
    arrs["ep_load"] = rng.randint(0, 4, arrs["ep_load"].shape
                                  ).astype(np.int32)
    svc = rng.randint(0, 3, R).astype(np.int32)
    feats = rng.randint(0, 40, (R, JR.N_FEATURES)).astype(np.int32)
    feats[:, 0] = np.where(rng.rand(R) < 0.6, JR.fnv1a("v2"), 7)
    for k, (a, b) in enumerate(PAIRS):
        feats[a] = feats[b] = [JR.fnv1a("v2")] + [1000 + 10 * k + j
                                                  for j in range(7)]
        svc[a], svc[b] = 0, 1
    rid = np.where(rng.rand(R) < 0.9, np.arange(R), -1).astype(np.int32)
    for a, b in PAIRS:
        rid[a], rid[b] = a, b
    cols = (rid, svc, feats, rng.randint(0, 97, R).astype(np.int32),
            rng.randint(1, 500, R).astype(np.int32))
    rnd = rng.randint(0, 1 << 30, R).astype(np.int32)
    gum = rng.gumbel(size=(R, JR.MAX_EPS_PER_CLUSTER)).astype(np.float32)
    act = rng.rand(I, C) < 0.3
    pool = (np.where(act, rng.randint(1000, 2000, (I, C)), -1),
            np.where(act, rng.randint(0, 8, (I, C)), -1),
            rng.randint(0, 3, (I, C)), rng.randint(0, 9, (I, C)),
            rng.randint(0, 97, (I, C)), act)
    pool = [p.astype(np.int32) for p in pool[:5]] + [act]
    free = (rng.rand(I, C) < 0.7).astype(np.int32)
    jst = JR.RoutingState(*[jnp.asarray(arrs[f]) for f in st._fields])
    tst = convert.routing_from_numpy(arrs, CPU)
    t = lambda a: torch.from_numpy(np.array(a, copy=True))   # noqa: E731
    return dict(
        j=(JBatch(*map(jnp.asarray, (cols[0], cols[1], cols[2], cols[4],
                                     cols[3]))),
           jst, JPool(*map(jnp.asarray, pool)), jnp.asarray(rnd),
           jnp.asarray(gum), jnp.asarray(free)),
        t=(RequestBatch(*map(t, (cols[0], cols[1], cols[2], cols[4],
                                 cols[3]))),
           tst, PoolState(*map(t, pool)), t(rnd), t(gum), t(free)))


def _equal(got, want, names):
    for name in names:
        np.testing.assert_array_equal(
            np.asarray(getattr(got, name)).astype(np.int64),
            np.asarray(getattr(want, name)).astype(np.int64), err_msg=name)


@pytest.fixture(scope="module")
def case():
    return _case()


@pytest.mark.parametrize("block_r", [64, 256, 1024])
def test_admit_commit_matches_reference_at_block_r(case, block_r):
    reqs, st, pool, rnd, gum, _ = case["t"]
    got = ops.admit_commit(reqs, st, pool, rnd, gum, block_r=block_r)
    want = jops.admit_commit(*case["j"][:5], block_r=block_r)
    _equal(got, want, ADMIT_FIELDS)
    _equal(got.pool, want.pool, JPool._fields)


@pytest.mark.parametrize("block_r", [64, 256, 1024])
def test_admit_matches_reference_at_block_r(case, block_r):
    reqs, st, _, rnd, gum, free = case["t"]
    jr, jst, _, jrnd, jgum, jfree = case["j"]
    got = ops.admit(reqs, st, free, rnd, gum, block_r=block_r)
    want = jops.admit(jr, jst, jfree, jrnd, jgum, block_r=block_r)
    _equal(got, want, ADMIT_FIELDS)


def test_affinity_cache_depends_on_block_r(case):
    """The batch's two flows land in the cache as the tiles order them:
    the first writer of a tile wins (affA), a later tile overwrites it
    (affB) - so 64, 256 and 1024 give three different caches, each the
    reference's."""
    reqs, st, pool, rnd, gum, _ = case["t"]
    A = st.aff_key.shape[0]
    keys = route_match.policy_defs.flow_hash(reqs.features)
    by_tile = {}
    for b in (64, 256, 1024):
        res = ops.admit_commit(reqs, st, pool, rnd, gum, block_r=b)
        by_tile[b] = []
        for a, _ in PAIRS:
            slot = int(keys[a]) % A
            assert int(res.aff_key[slot]) == int(keys[a])
            ep = int(res.aff_ep[slot])
            by_tile[b].append("affA" if ep < 3 else "affB")
    assert by_tile == {64: ["affB", "affB"], 256: ["affA", "affB"],
                       1024: ["affA", "affA"]}


def test_engine_passes_its_tuning_fields(case):
    """``Engine(block_r=..., fold=...)`` admits with that plan: its state
    after one admission equals ``ops.admit_commit`` at the same block_r."""
    reqs, st, _, rnd, gum, _ = case["t"]
    cfg = smoke_config(get_config("xlb-service-model"))
    for b in (64, 1024):
        eng = Engine(cfg, I, C, max_len=8, device="cpu", block_r=b,
                     block_i=4, fold="onehot")
        eng.draws = lambda n: (rnd[:n], gum[:n])
        s0 = eng.init_state(st)
        s1 = eng.admit(s0, reqs)
        want = ops.admit_commit(reqs, st, s0.pool, rnd, gum, block_r=b)
        for f in ("ep_load", "rr_cursor", "aff_key", "aff_ep"):
            assert torch.equal(getattr(s1.routing, f), getattr(want, f)), f
        for f in PoolState._fields:
            assert torch.equal(getattr(s1.pool, f),
                               getattr(want.pool, f)), f


def test_sharded_admission_plans_at_the_shard_width(monkeypatch, case):
    """``admit_commit_sharded`` asks for a plan at R/M rows (the
    reference's rule), and at M = 1 equals ``admit_commit`` at the same
    block_r."""
    reqs, st, pool, rnd, gum, _ = case["t"]
    monkeypatch.setenv(tune.ENV_AUTOTUNE, "1")
    monkeypatch.delenv(tune.ENV_BLOCK_R, raising=False)
    monkeypatch.setattr(tune, "_time_best", lambda fn, *a, **k: 1.0)
    ops.admit_commit_sharded(reqs, st, pool, rnd, gum,
                             mesh=make_shard_mesh(2, device="cpu"))
    assert ("admit_commit", "cpu", "segment", R // 2, I, C) in tune._cache
    for b in (64, 1024):
        got = ops.admit_commit_sharded(reqs, st, pool, rnd, gum,
                                       mesh=make_shard_mesh(1, device="cpu"),
                                       block_r=b)
        want = ops.admit_commit(reqs, st, pool, rnd, gum, block_r=b)
        _equal(got, want, ADMIT_FIELDS)
        _equal(got.pool, want.pool, PoolState._fields)

"""The port's sharded datapath across processes, one ``gloo`` rank a shard
(``launch/mesh.py::RankShardMesh``), at 2 and 4 ranks on the CPU: the
twin of the reference's four-device script (``tests/test_shard_admit.py``,
its ``shard_map`` over forced host devices), each result against the
reference run here with JAX and against the port's one-process
``ShardMesh`` on the same inputs:

* ``ops.admit_commit_sharded`` over the reference's sweep (an all-padding
  shard with a near-full pool, uneven queues, a ragged R = 52, the hash
  policies with a populated affinity cache, a fully drained cluster) and
  a batch whose tx bytes wrap int32: every field against the
  reference's single-shard ``ops.admit_commit`` and its shard-major
  oracle ``ref.admit_sharded_ref``, the rows and pool slices of the ranks
  put together; the idle ingress host reads only its own rows;
* ``ops.complete_sharded`` at (8, 6) and (4, 16) and with rx bytes that
  wrap int32, EWMAs bit-exact; an int32 ``psum`` near INT32_MAX;
* ``relay.sharded_apply`` at 4 ranks against the einsum oracle;
* a mid-serve ``ControlPlane`` transaction reaching every rank with one
  version bump, and the transport crash and rejoin on a sharded loop;
* ``ServeLoop`` drains over ``Engine(shards=M)``: with the reference's
  draws equal to the unsharded port and the reference; with the engine's
  own generator, the host state and the key stream equal on every rank;
* ``serve --shards 2 --device cpu`` as two ``gloo`` ranks (the
  environment ``torchrun`` gives each rank).

The ranks are processes of ``tests/torch_shard_worker.py`` (one run of
each width for the whole file, the two widths at once), joined through a
``FileStore`` with the group's 120-s timeout; they import no JAX.
Tolerance: exact, but ``sharded_apply`` (rtol = atol = 1e-5, the
reference's).
"""

import os
import pickle
import re
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_shard_admit as T          # the reference's case makers
import torch_shard_worker as W
from repro.configs.xlb_microbench import XLB_SERVICE_MODEL as JCFG
from repro.core import interpose as JI
from repro.core import relay as JRelay
from repro.core import routing_table as JR
from repro.kernels import ops as JOps
from repro.kernels import ref as JRef
from repro.models import model as JM
from repro.runtime import serve_loop as JS
from repro_torch.launch.mesh import make_shard_mesh

WORKER = Path(__file__).with_name("torch_shard_worker.py")
SRC = Path(__file__).resolve().parents[1] / "src"
WIDTHS = (2, 4)
MESH = {M: make_shard_mesh(M, device="cpu") for M in WIDTHS}
ROWS = ("cluster", "endpoint", "instance", "slot", "ok")
POOL = ("req_id", "endpoint", "svc", "length", "token", "active")

# (R, batch seed, padded rows, pool (I, C), pool seed, active share,
# drained endpoints, msg_bytes): the reference's sweep, and a batch whose
# per-service tx bytes wrap int32
ADMIT_CASES = {
    "all_padding_shard_near_full": (96, 7, slice(48, 72), (4, 5), 9, 0.4,
                                    None, None),
    "uneven_queues": (96, 3, slice(8, 40), (4, 5), 11, 0.2, None, None),
    "ragged_R52": (52, 5, None, (4, 5), 13, 0.6, None, None),
    "hash_policies_at_volume": (128, 41, None, (4, 5), 23, 0.3, None, None),
    "fully_drained_cluster": (64, 21, None, (4, 5), 17, 0.5, slice(6, 8),
                              None),
    "tx_bytes_wrap_int32": (52, 5, None, (4, 5), 13, 0.6, None,
                            2**31 - 1),
}
# (I, C, seed, rx bytes base): the reference's, and a base that wraps
COMPLETE_CASES = {"I8_C6": (8, 6, 23, None), "I4_C16": (4, 16, 29, None),
                  "rx_wraps_int32": (8, 6, 23, 2**31 - 3)}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _admit_case(name):
    """The case's inputs (numpy), the reference's single-shard result and
    its shard-major oracle on the batch padded to a multiple of 4."""
    R, seed, pad, (I, C), pseed, pact, drain, mbytes = ADMIT_CASES[name]
    st = T._rich_state()
    if drain is not None:
        st = st._replace(ep_drained=st.ep_drained.at[drain].set(1))
    reqs, rnd, gum = T._batch(R, seed, pad_slice=pad)
    if mbytes is not None:
        reqs = reqs._replace(msg_bytes=jnp.full((R,), mbytes, jnp.int32)
                             - jnp.arange(R, dtype=jnp.int32))
    pool = T._pool(I, C, pseed, p_active=pact)
    want = JOps.admit_commit(reqs, st, pool, rnd, gum)
    R4 = -(-R // 4) * 4
    padr = lambda a, v: np.concatenate(                      # noqa: E731
        [np.asarray(a), np.full((R4 - R, *a.shape[1:]), v, a.dtype)])
    sh = lambda a, v=0: padr(a, v).reshape(4, R4 // 4, *a.shape[1:])  # noqa
    oracle = JRef.admit_sharded_ref(
        sh(reqs.req_id, -1), sh(reqs.svc), sh(reqs.features),
        sh(reqs.msg_bytes), sh(reqs.token), st, pool.req_id, pool.endpoint,
        pool.svc, pool.length, pool.token, pool.active, sh(rnd), sh(gum))
    case = {"state": {f: np.asarray(getattr(st, f)) for f in st._fields},
            **{f: np.asarray(getattr(reqs, f)) for f in reqs._fields},
            "rnd": np.asarray(rnd), "gumbel": np.asarray(gum),
            "pool": {f: np.asarray(getattr(pool, f)) for f in POOL}}
    return case, want, oracle


def _complete_case(name):
    I, C, seed, rx0 = COMPLETE_CASES[name]
    pool, nxt, load, rx, ewl, ewt = T._complete_case(I, C, seed)
    if rx0 is not None:
        rx = rx.at[:2].set(rx0)
    want = JOps.complete(pool, nxt, load, rx, ewl, ewt, eos=1, max_len=8)
    case = {"pool": {f: np.asarray(getattr(pool, f)) for f in POOL},
            "nxt": np.asarray(nxt), "load": np.asarray(load),
            "rx": np.asarray(rx), "ewl": np.asarray(ewl),
            "ewt": np.asarray(ewt)}
    return case, want


def _sharded_apply_case():
    M, E, C, D, N = 4, 8, 16, 4, 64
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (N, D)))
    idx = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (N,), 0, E))
    w = np.asarray(jax.random.uniform(jax.random.PRNGKey(2), (N,)))
    scale = np.arange(1.0, E + 1.0, dtype=np.float32)[:, None]
    buf, _, d_oh = JRelay.relay_dispatch_einsum(jnp.asarray(x),
                                                jnp.asarray(idx), E, M * C)
    want = JRelay.relay_combine_einsum(buf * scale[:, None, :], d_oh,
                                       jnp.asarray(w))
    return ({"x": x, "idx": idx.astype(np.int32), "w": w,
             "scale": scale, "E": E, "C": C},
            np.asarray(want), idx)


def _drain_routing():
    """One service per policy (one affinity cluster), each to a
    3-endpoint cluster spread over the 4 lanes; random loads."""
    services = [JR.ServiceConfig(f"s{i}", [JR.Rule(0, None, f"c{i}")])
                for i in range(6)]
    clusters = [JR.Cluster(f"c{i}", [(i + k) % 4 for k in range(3)],
                           policy=i, weights=[1.0, 3.0, 0.5])
                for i in range(6)]
    st, _ = JR.build_state(services, clusters)
    arrs = {f: np.array(getattr(st, f)) for f in st._fields}
    arrs["ep_load"][:] = np.random.RandomState(1).randint(0, 3, 512)
    return arrs


def _reference_draws(n: int) -> list:
    """The reference engine's first ``n`` admissions' draws of 8 rows."""
    key, out = jax.random.PRNGKey(0), []
    for _ in range(n):
        key, sub = jax.random.split(key)
        kr, kw, _ = jax.random.split(sub, 3)
        out.append((np.asarray(jax.random.randint(
            kr, (8,), 0, 1 << 30, dtype=jnp.int32)), np.asarray(
            jax.random.gumbel(kw, (8, JR.MAX_EPS_PER_CLUSTER),
                              jnp.float32))))
    return out


@pytest.fixture(scope="module")
def inputs():
    arrs = _drain_routing()
    jroute = JR.RoutingState(*[jnp.asarray(arrs[f]) for f in arrs])
    jp = JM.init_params(JCFG, jax.random.PRNGKey(0), jnp.float32)
    loop = JS.ServeLoop(JI.Engine(JCFG, 4, 4, 6, eos=-1), jp, jroute,
                        admit_batch=8, dtype=jnp.float32)
    ref_drain = W.drain_record(loop, JS)
    admit = {k: _admit_case(k) for k in ADMIT_CASES}
    complete = {k: _complete_case(k) for k in COMPLETE_CASES}
    sa = _sharded_apply_case()
    inp = {"admit": {k: v[0] for k, v in admit.items()},
           "complete": {k: v[0] for k, v in complete.items()},
           "sharded_apply": sa[0], "drain_routing": arrs,
           "weights": _np(jp), "draws": _reference_draws(ref_drain["ticks"])}
    return {"inp": inp, "admit": admit, "complete": complete,
            "sharded_apply": sa, "ref_drain": ref_drain}


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    """Each rank's results, at 2 and at 4 ranks (both runs at once)."""
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    procs, dirs = [], {}
    for M in WIDTHS:
        where = dirs[M] = tmp_path_factory.mktemp(f"ranks{M}")
        (where / "inputs.pkl").write_bytes(pickle.dumps(inputs["inp"]))
        procs += [(M, subprocess.Popen(
            [sys.executable, str(WORKER), str(r), str(M), str(where)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)) for r in range(M)]
    logs = []
    try:
        for _, pr in procs:
            logs.append(pr.communicate(timeout=500)[0])
    finally:
        for _, pr in procs:
            pr.kill()
    assert all(pr.returncode == 0 for _, pr in procs), "\n".join(
        log[-3000:] for log in logs)
    return {M: [pickle.loads((dirs[M] / f"rank{r}.pkl").read_bytes())
                for r in range(M)] for M in WIDTHS}


@pytest.fixture(scope="module")
def one_process(inputs):
    """The same scenarios over the one-process ``ShardMesh``."""
    inp = inputs["inp"]
    return {M: W.run(MESH[M], inp) for M in WIDTHS}


def _whole(recs: list, rows: int | None = None) -> dict:
    """The ranks' records put together: per-row fields concatenated (cut
    to ``rows``), pool fields concatenated, replicated fields the same on
    every rank."""
    out = {}
    for f, v in recs[0].items():
        if f in ROWS:
            out[f] = np.concatenate([r[f] for r in recs])[:rows]
        elif f.startswith("pool.") or f in ("req_id", "endpoint", "svc",
                                            "length", "token", "active",
                                            "done"):
            out[f] = np.concatenate([r[f] for r in recs])
        elif f != "live":
            for m, r in enumerate(recs):
                np.testing.assert_array_equal(r[f], v,
                                              err_msg=f"{f} rank {m}")
            out[f] = v
    return out


def _assert_fields(want, got: dict, ctx: str):
    for name in want._fields:
        w = getattr(want, name)
        if name == "pool":
            for f in w._fields:
                np.testing.assert_array_equal(
                    got[f"pool.{f}"].astype(np.int32),
                    np.asarray(getattr(w, f)).astype(np.int32),
                    err_msg=f"{ctx} pool.{f}")
        else:
            np.testing.assert_array_equal(got[name], np.asarray(w),
                                          err_msg=f"{ctx} {name}")


# --------------------------------------------------------------------------- #
# admission and completion
# --------------------------------------------------------------------------- #


@pytest.mark.timeout(900)
@pytest.mark.parametrize("M", WIDTHS)
@pytest.mark.parametrize("name", list(ADMIT_CASES))
def test_admit_over_ranks_matches_reference(inputs, ranks, one_process,
                                            name, M):
    case, want, oracle = inputs["admit"][name]
    R = case["req_id"].shape[0]
    got = _whole([r["admit"][name] for r in ranks[M]], R)
    _assert_fields(want, got, f"{name} M={M} vs ops.admit_commit")
    flat = lambda a: np.asarray(a).reshape(-1)[:R]           # noqa: E731
    for f in ROWS:
        np.testing.assert_array_equal(got[f], flat(getattr(oracle, f)),
                                      err_msg=f"{name} M={M} oracle {f}")
    for f in ("ep_load", "rr_cursor", "svc_requests", "svc_tx_bytes",
              "no_route", "held", "aff_key", "aff_ep"):
        np.testing.assert_array_equal(got[f], np.asarray(getattr(oracle, f)),
                                      err_msg=f"{name} M={M} oracle {f}")
    for f in POOL:
        np.testing.assert_array_equal(
            got[f"pool.{f}"].astype(np.int32),
            np.asarray(getattr(oracle, f"pool_{f}")).astype(np.int32),
            err_msg=f"{name} M={M} oracle pool_{f}")
    # the process mesh equals the one-process mesh bit for bit
    mine = one_process[M]["admit"][name]
    assert set(mine) == set(ranks[M][0]["admit"][name])
    for f, v in _whole([mine], R).items():
        np.testing.assert_array_equal(got[f], v, err_msg=f"{name} M={M} {f}")
    if name == "hash_policies_at_volume":
        assert int((got["aff_ep"] >= 0).sum()) > 0     # the cache filled
    if name == "tx_bytes_wrap_int32":
        assert int(got["svc_tx_bytes"].min()) < 0      # the sum wrapped


def test_idle_rank_reads_only_its_own_rows(inputs, ranks):
    """At 4 ranks the all-padding shard's rank finds no valid row in its
    own rows (and launches nothing); the one-process mesh reads the
    same from the whole batch."""
    name = "all_padding_shard_near_full"
    assert [r["admit"][name]["live"] for r in ranks[4]] == [
        [True], [True], [False], [True]]
    case = inputs["inp"]["admit"][name]
    from repro_torch.kernels import shard_admit
    assert shard_admit.live_shards(torch.from_numpy(case["req_id"]), 4) \
        == [True, True, False, True]
    assert int(ranks[4][0]["admit"][name]["held"]) > 0


@pytest.mark.timeout(900)
@pytest.mark.parametrize("M", WIDTHS)
@pytest.mark.parametrize("name", list(COMPLETE_CASES))
def test_complete_over_ranks_matches_reference(inputs, ranks, one_process,
                                               name, M):
    case, want = inputs["complete"][name]
    got = _whole([r["complete"][name] for r in ranks[M]])
    _assert_fields(want, got, f"{name} M={M} vs ops.complete")
    assert got["ep_inflight_ewma"].dtype == np.float32
    assert int(got["done_cnt"].sum()) > 0
    for f, v in _whole([one_process[M]["complete"][name]]).items():
        np.testing.assert_array_equal(got[f], v, err_msg=f"{name} M={M} {f}")
    if name == "rx_wraps_int32":
        assert int(got["rx_bytes"][:2].min()) < 0


@pytest.mark.timeout(900)
@pytest.mark.parametrize("M", WIDTHS)
def test_int32_psum_wraps_as_the_reference(ranks, one_process, M):
    want = (np.array([2**31 - 1, -5], np.int64) * M + 2**31) % 2**32 - 2**31
    for r in ranks[M] + [one_process[M]]:
        assert r["int32_psum"] == want.tolist()


# --------------------------------------------------------------------------- #
# sharded_apply
# --------------------------------------------------------------------------- #


@pytest.mark.timeout(900)
def test_sharded_apply_over_ranks_matches_einsum_oracle(inputs, ranks,
                                                        one_process):
    case, want, idx = inputs["sharded_apply"]
    recs = [r["sharded_apply"] for r in ranks[4]]
    out = np.concatenate([r["out"] for r in recs])
    np.testing.assert_allclose(out.reshape(want.shape), want, rtol=1e-5,
                               atol=1e-5)
    mine = one_process[4]["sharded_apply"]
    np.testing.assert_array_equal(out, mine["out"])
    for r in recs:
        np.testing.assert_array_equal(r["load"],
                                      np.bincount(idx, minlength=case["E"]))
        np.testing.assert_array_equal(r["tight_load"], r["load"])
        assert r["overflow"] == 0.0 and bool(r["ok"].all())
    ok = np.concatenate([r["ok"] for r in recs])
    assert ok.shape == (4, 16)
    # a per-source quota of 1 keeps each source's first row a destination
    kept = sum(len(np.unique(r)) for r in idx.reshape(4, -1))
    tight = np.concatenate([r["tight_ok"] for r in recs])
    assert int(tight.sum()) == kept
    np.testing.assert_array_equal(tight, mine["tight_ok"])


# --------------------------------------------------------------------------- #
# serving over the ranks
# --------------------------------------------------------------------------- #


def _drain_whole(recs: list) -> dict:
    """The ranks' drain records: everything but the pool the same on every
    rank; the pool slices concatenated."""
    for m, r in enumerate(recs[1:], 1):
        for k in r:
            if k != "pool":
                assert r[k] == recs[0][k], f"rank {m} differs in {k}"
    return {**recs[0], "pool": {f: sum((r["pool"][f] for r in recs), [])
                                for f in recs[0]["pool"]}}


@pytest.mark.timeout(900)
@pytest.mark.parametrize("M", WIDTHS)
def test_drain_over_ranks_matches_unsharded_and_reference(
        inputs, ranks, one_process, M):
    got = _drain_whole([r["drain_replay"] for r in ranks[M]])
    assert got == inputs["ref_drain"]
    assert got == one_process[M]["drain_replay"]
    done, dropped, queued, inflight, held_first = got["report"]
    assert len(done) == 48 and not (dropped or queued or inflight)
    assert held_first > 0                          # the pool filled up
    assert got["metrics"]["overflow"] > 0


@pytest.mark.timeout(900)
@pytest.mark.parametrize("M", WIDTHS)
def test_engine_streams_and_host_state_agree_across_ranks(ranks, one_process,
                                                          M):
    """With the engine's own generator (every rank seeded alike, the whole
    batch drawn and sliced), every rank ends with the same host loop state
    and draws the same next batch, as the one-process mesh does."""
    got = _drain_whole([r["drain_own"] for r in ranks[M]])
    assert got == one_process[M]["drain_own"]
    assert len(got["report"][0]) == 48
    assert got["host"]["submitted"] == 48 and not got["host"]["inflight"]


@pytest.mark.timeout(900)
def test_mid_serve_transaction_reaches_every_rank(ranks, one_process):
    recs = [r["transaction"] for r in ranks[2]]
    mine = one_process[2]["transaction"]
    for r in recs:
        assert r["v1"] == r["v0"] + 1 and r["cp_version"] == 1
        assert r["drained"] == 1
        assert r["routing"] == recs[0]["routing"] == mine["routing"]
        assert r["done"] == mine["done"]
    # no admission after the drain lands on the drained endpoint, in any
    # rank's slice; traffic kept flowing
    assert not any(any(r["on_drained"]) for r in recs)
    new = [any(r["new"][t] for r in recs) for t in range(30)]
    assert new == mine["new"] and any(new)


@pytest.mark.timeout(900)
def test_transport_crash_and_rejoin_over_ranks(ranks, one_process):
    facts = [r["crash_rejoin"]["facts"] for r in ranks[2]]
    assert facts[0] == facts[1] == one_process[2]["crash_rejoin"]["facts"]
    got = {f[0]: f[1:] for f in facts[0]}
    assert got["versions"] == (1, 1) and got["drained"] == (1,)
    assert got["pinned load"][0] > 0
    assert got["held"] == (2, 1) and got["lease"] == (False,)
    assert got["reaped"] == (1, 2) and got["weight"] == (3,)
    assert got["acked"] == (1,) and got["resync"] == (1, 3, 3)
    assert got["served"] == (4,)


# --------------------------------------------------------------------------- #
# the launcher
# --------------------------------------------------------------------------- #


@pytest.mark.timeout(300)
def test_serve_launcher_over_two_gloo_ranks():
    """``python -m repro_torch.launch.serve --shards 2 --device cpu`` as
    two ranks, with the environment ``torchrun --nproc-per-node 2`` gives
    them: every request completes and rank 0 alone prints the reference's
    report lines."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for r in range(2):
        env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1",
                   RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE="2",
                   LOCAL_WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.serve", "--shards",
             "2", "--device", "cpu", "--requests", "12", "--max-len", "6"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    outs = []
    try:
        for pr in procs:
            outs.append(pr.communicate(timeout=240))
    finally:
        for pr in procs:
            pr.kill()
    assert all(pr.returncode == 0 for pr in procs), outs
    lines = outs[0][0].splitlines()
    assert re.fullmatch(
        r"xlb-service-model \[xlb, cpu, 2 shards on 2 ranks\]: 12 requests "
        r"in [0-9.]+s \([0-9.]+ req/s\), avg latency [0-9.]+ ms, p99 "
        r"[0-9.]+ ms", lines[0]), lines
    assert re.fullmatch(r"metrics: tx=\d+B rx=\d+B no_route=0 overflow=\d+",
                        lines[1]), lines
    assert len(lines) == 2 and outs[1][0] == ""

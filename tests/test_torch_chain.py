"""The port's chained-service path (``workload/hops.py``,
``workload/chain.py``) and ``serve --arch`` against the JAX reference, on
the CPU.

* ``run_chain_scenario`` on both packages, the reference's weights
  carried across (``convert.params_from_jax``): the depth-3 chain on the
  three engines, the live-ops leg (``chain_liveops``), the graded
  heterogeneous-fleet leg (``chain_graded``), the reference's workload
  chain tests (flap fault + elastic scale; end-to-end = sum of hops) and
  its three replay cases.  Rows equal under ``json.dumps``; the chain's
  tick records equal too.  A weighted cluster on the xlb engine needs the
  reference's draws: each port engine replays them (``ReplayDraws``).
* The recorded ``BENCH_chain.json`` rows against the live runs.
* The port's ``Service(shards=2)`` chain row against its unsharded row;
  the chain under ``XLB_SANITIZE=1``; ``run_chain``'s counts against the
  reference's; the service's refusals.
* ``serve --arch {xlb-service-model, minitron-4b, mamba2-2.7b} --smoke
  --device cpu``: the reference's count of completed requests; the
  encoder-decoder and not-yet-ported archs refused.

Tolerance: exact.
"""

import functools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import common as JC
from repro import workload as JW
from repro.core import routing_table as JR
from repro.core.health import HealthConfig as JHealthConfig
from repro.launch import serve as jserve
from repro.runtime import serve_loop as JS
from repro_torch import convert
from repro_torch import workload as TW
from repro_torch.core import interpose as TI
from repro_torch.core.health import HealthConfig as THealthConfig
from repro_torch.launch import serve as tserve
from repro_torch.runtime import serve_loop as TS
from repro_torch.workload import hops as H

CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parents[1]


@functools.lru_cache(maxsize=None)
def _params():
    return convert.params_from_jax(jax.tree.map(np.asarray, JC.PARAMS), CPU)


class ReplayDraws:
    """The reference engine's draws, replayed and handed to the port."""

    def __init__(self):
        self.key = jax.random.PRNGKey(0)

    def __call__(self, n):
        self.key, sub = jax.random.split(self.key)
        kr, kw, _ = jax.random.split(sub, 3)
        rnd = jax.random.randint(kr, (n,), 0, 1 << 30, dtype=jnp.int32)
        gum = jax.random.gumbel(kw, (n, JR.MAX_EPS_PER_CLUSTER), jnp.float32)
        return torch.from_numpy(np.array(rnd)), torch.from_numpy(np.array(gum))


@pytest.fixture
def replay(monkeypatch):
    """Every port engine built in the test draws the reference's stream."""
    post = TI.Engine.__post_init__

    def replaying(self):
        post(self)
        self.draws = ReplayDraws()

    monkeypatch.setattr(TI.Engine, "__post_init__", replaying)


def _workload(w, n_requests=24, seed=11, rate=2.0, **kw):
    return w.Workload(w.PoissonArrivals(rate=rate, seed=seed),
                      n_requests=n_requests, vocab=JC.CFG.vocab, **kw)


def _graded_kw(port: bool):
    hc = (THealthConfig if port else JHealthConfig)(
        k_eject=12.0, trip_after=8, cooldown=10, recover_after=2,
        probe_patience=10, graded_weights=True)
    sl = TS if port else JS
    return dict(n_instances=3, slots=6, policy=JR.POLICY_WEIGHTED,
                health_cfg=hc, epoch_interval=6,
                faults={0: sl.FaultInjector([sl.Fault(0, "slow", factor=3,
                                                      start=0)])})


# name: (mode, workload kwargs, run kwargs (port: bool) -> dict)
SCENARIOS = {
    "istio": ("istio", {}, lambda port: dict(depth=3)),
    "cilium": ("cilium", {}, lambda port: dict(depth=3)),
    "xlb": ("xlb", {}, lambda port: dict(depth=3)),
    "chain_liveops": ("xlb", {}, lambda port: dict(
        depth=3, policy=JR.POLICY_WEIGHTED, label="chain_liveops",
        ops=[(TW if port else JW).Op(6, "canary", hop=1,
                                     args={"instance": 1, "pct": 75.0}),
             (TW if port else JW).Op(10, "scale", hop=2,
                                     args={"target": 1}),
             (TW if port else JW).Op(16, "scale", hop=2,
                                     args={"target": 2})])),
    "chain_graded": ("xlb", dict(n_requests=40, seed=7, rate=1.5),
                     lambda port: dict(depth=3, label="chain_graded",
                                       **_graded_kw(port))),
}


@functools.lru_cache(maxsize=None)
def _reference(name):
    mode, wkw, kw = SCENARIOS[name]
    out = JC.run_chain_scenario(mode, workload=_workload(JW, **wkw),
                                **kw(False))
    return out["row"], out["result"]


def _port(name, **extra):
    mode, wkw, kw = SCENARIOS[name]
    return H.run_chain_scenario(mode, workload=_workload(TW, **wkw),
                                params=_params(), device="cpu",
                                **{**kw(True), **extra})


@functools.lru_cache(maxsize=None)
def _port_row(name):
    """The port's row of a scenario without weighted draws (none to
    replay), run once per process."""
    return _port(name)["row"]


def _same_result(want, got):
    for f in ("depth", "completed", "dropped", "ticks", "submit_tick",
              "done_tick", "hop_submit", "hop_done", "n_submitted"):
        assert getattr(got, f) == getattr(want, f), f


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_chain_scenario_rows_match_reference(name, replay):
    want, wres = _reference(name)
    out = _port(name)
    assert json.dumps(out["row"]) == json.dumps(want)
    _same_result(wres, out["result"])
    row = out["row"]
    assert row["completed"] == row["n_requests"] and row["dropped"] == 0
    for h in out["hops"]:                  # every hop drained its load
        assert not np.asarray(h.routing.ep_load).any()


def test_recorded_chain_rows_match_the_live_runs():
    """``BENCH_chain.json`` (the reference's recorded rows) against the
    live reference runs and so, by the test above, the port's: depth 3
    24/24 at p99 3 ticks in 18 ticks on every engine, 3 live-ops
    transactions.  The graded leg's recorded row (35 ticks, p99 4.61, 13
    health transactions) is older than the reference's code: the live
    run, which the port matches, completes the same 40 of 40 in 37 ticks
    at p99 5.0 with 17 health transactions."""
    rec = json.loads((ROOT / "BENCH_chain.json").read_text())["rows"]
    by = {(r["scenario"], r["mode"]): r for r in rec}
    for name in ("istio", "cilium", "xlb", "chain_liveops"):
        want, _ = _reference(name)
        assert json.dumps(by[(want["scenario"], want["mode"])]) \
            == json.dumps(want), name
    assert by[("chain_liveops", "xlb")]["txns"] == 3
    live, _ = _reference("chain_graded")
    old = by[("chain_graded", "xlb")]
    for k in ("n_requests", "completed", "dropped", "seed", "depth"):
        assert live[k] == old[k], k
    assert (live["ticks"], live["p99_ticks"], live["health_txns"]) \
        == (37, 5.0, 17)
    assert (old["ticks"], old["p99_ticks"], old["health_txns"]) \
        == (35, 4.609999999999999, 13)


def test_chain_gate_holds_on_the_port():
    """The reference's chain gate: xlb's p99 at depth 3 is at most each
    sidecar's, and xlb completes every request."""
    rows = {m: _port_row(m) for m in ("istio", "cilium", "xlb")}
    assert rows["xlb"]["completed"] == rows["xlb"]["n_requests"]
    for side in ("istio", "cilium"):
        assert rows["xlb"]["p99_ticks"] <= rows[side]["p99_ticks"]


# --------------------------------------------------------------------------- #
# the reference's workload chain tests, on both packages
# --------------------------------------------------------------------------- #


def _flap_and_scale(port: bool):
    w, sl = (TW, TS) if port else (JW, JS)
    inj = sl.FaultInjector([sl.Fault(1, "flap", start=0, end=6, period=1),
                            sl.Fault(7, "flap", start=0, period=2)])
    kw = dict(workload=w.Workload(w.PoissonArrivals(rate=2.0, seed=5),
                                  n_requests=6),
              ops=[w.Op(1, "scale", args={"target": 1}),
                   w.Op(4, "scale", args={"target": 2})],
              faults={0: inj}, depth=1)
    if port:
        return H.run_chain_scenario("istio", params=_params(), device="cpu",
                                    **kw)
    return JC.run_chain_scenario("istio", **kw)


def _sum_of_hops(port: bool):
    w = TW if port else JW
    kw = dict(depth=3, workload=w.Workload(w.PoissonArrivals(rate=2.0,
                                                             seed=11),
                                           n_requests=10))
    if port:
        return H.run_chain_scenario("istio", params=_params(), device="cpu",
                                    **kw)
    return JC.run_chain_scenario("istio", **kw)


def test_flap_fault_composes_with_elastic_scale():
    want, got = _flap_and_scale(False), _flap_and_scale(True)
    assert json.dumps(got["row"]) == json.dumps(want["row"])
    row = got["row"]
    assert row["completed"] == row["n_requests"] and row["dropped"] == 0
    assert row["txns"] == 2


def test_chain_end_to_end_is_sum_of_hops():
    want, got = _sum_of_hops(False), _sum_of_hops(True)
    assert json.dumps(got["row"]) == json.dumps(want["row"])
    _same_result(want["result"], got["result"])
    res = got["result"]
    assert res.completed == 10
    for r in res.done_tick:
        e2e = res.done_tick[r] - res.submit_tick[r]
        assert e2e == sum(res.hop_done[k][r] - res.hop_submit[k][r]
                          for k in range(res.depth))
        for k in range(res.depth - 1):     # synchronous forwarding
            assert res.hop_submit[k + 1][r] == res.hop_done[k][r]


REPLAYS = {
    "poisson": (lambda w: w.Workload(w.PoissonArrivals(rate=2.0, seed=11),
                                     n_requests=8), lambda w: dict(depth=3)),
    "bursty_lognormal": (lambda w: w.Workload(
        w.BurstyArrivals(rate=4.0, seed=21, on_ticks=3, off_ticks=3),
        service=w.LognormalServiceTimes(seed=6, median=2.5, sigma=0.6,
                                        cap=10),
        n_requests=8), lambda w: dict(depth=2)),
    "midrun_canary": (lambda w: w.Workload(w.PoissonArrivals(rate=2.0,
                                                             seed=11),
                                           n_requests=8),
                      lambda w: dict(depth=3, policy=JR.POLICY_WEIGHTED,
                                     ops=[w.Op(3, "canary", hop=1,
                                               args={"instance": 1,
                                                     "pct": 75.0})])),
}


@pytest.mark.parametrize("case", list(REPLAYS))
def test_replay_rows_bit_identical_on_both_packages(case):
    """The reference's replay cases: two port runs give the same JSONL
    row, and it is the reference's."""
    wl, kw = REPLAYS[case]
    want = JC.run_chain_scenario("istio", workload=wl(JW), **kw(JW))["row"]
    rows = [H.run_chain_scenario("istio", workload=wl(TW), params=_params(),
                                 device="cpu", **kw(TW))["row"]
            for _ in range(2)]
    assert json.dumps(rows[0]) == json.dumps(rows[1]) == json.dumps(want)
    if case == "midrun_canary":
        assert rows[0]["ops"] == 1 and rows[0]["txns"] == 1
    if case == "bursty_lognormal":
        assert rows[0]["service"] == "lognormal"


# --------------------------------------------------------------------------- #
# sharding, the sanitizer, run_chain, the refusals
# --------------------------------------------------------------------------- #


def test_sharded_chain_row_equals_unsharded():
    """Two shards of the one CPU device: the same row (but its "shards"
    key) and the same tick records as the unsharded xlb chain."""
    _, want = _reference("xlb")
    sharded = _port("xlb", shards=2)
    row = dict(sharded["row"])
    assert row.pop("shards") == 2
    assert json.dumps(row) == json.dumps(_port_row("xlb"))
    _same_result(want, sharded["result"])
    assert all(h.eng.shards == 2 for h in sharded["hops"])


@pytest.mark.parametrize("mode", ["xlb", "cilium"])
def test_chain_under_the_sanitizer_fires_no_law(mode, monkeypatch):
    """``XLB_SANITIZE=1``: the chain law at every global tick and the
    kernel laws at every admission and completion; none fires and the row
    is the plain run's."""
    plain = _port_row(mode)
    monkeypatch.setenv("XLB_SANITIZE", "1")
    assert json.dumps(_port(mode)["row"]) == json.dumps(plain)


@pytest.mark.parametrize("chain_len", [1, 3])
@pytest.mark.parametrize("mode", ["xlb", "istio"])
def test_run_chain_completes_the_reference_counts(mode, chain_len):
    want = JC.run_chain(mode, chain_len=chain_len, n_requests=12)
    got = H.run_chain(mode, chain_len=chain_len, n_requests=12,
                      params=_params(), device="cpu")
    assert got["completed"] == want["completed"] == 12
    assert got["mode"] == mode and got["chain"] == chain_len


def test_service_refusals_and_defaults():
    with pytest.raises(ValueError, match="shards > 1 needs the in-graph"):
        H.Service("istio", 2, 4, 2, shards=2, params=_params(),
                  device="cpu")
    s = H.make_service("xlb", 2, 4, 2, device="cpu")     # drawn weights
    assert s.cfg == H.default_config() and s.cfg.vocab == JC.CFG.vocab
    b = H.request_batch([5, 9], 4, s.cfg.vocab)
    w = JC.request_batch([5, 9], 4)
    for f in b._fields:
        np.testing.assert_array_equal(getattr(b, f).numpy(),
                                      np.asarray(getattr(w, f)))
    assert not s.busy
    s.submit([1, 2])
    assert s.busy and H.warm(s) is s


# --------------------------------------------------------------------------- #
# serve --arch
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("arch", ["xlb-service-model", "minitron-4b",
                                  "mamba2-2.7b", "granite-20b",
                                  "internlm2-20b", "yi-34b",
                                  "chameleon-34b", "arctic-480b",
                                  "deepseek-v2-236b", "jamba-v0.1-52b"])
def test_serve_arch_smoke_matches_reference_count(arch, capsys):
    argv = ["--arch", arch, "--instances", "2", "--slots", "2",
            "--requests", "6", "--max-len", "5"]
    want = jserve.main(argv)
    got = tserve.main(argv + ["--smoke", "--device", "cpu"])
    assert got == want == 6
    assert f"{arch}-smoke" in capsys.readouterr().out


def test_serve_arch_refusals():
    with pytest.raises(SystemExit, match="enc-dec serving needs prompt"):
        tserve.main(["--arch", "whisper-large-v3", "--device", "cpu"])
    with pytest.raises(SystemExit, match="enc-dec serving needs prompt"):
        tserve.main(["--arch", "whisper-large-v3", "--smoke", "--device",
                     "cpu"])
    with pytest.raises(SystemExit):            # argparse: not a choice
        tserve.main(["--arch", "gpt-2", "--device", "cpu"])

"""The traffic is a pure function of the run's seed: the same seed sends
the same calls, with the same headers, tokens and order, tick for tick;
an open loop offers every seed the same gaps in another order."""

from __future__ import annotations

import numpy as np
import pytest

from xlbench import deploy, seeded
from xlbench.reference.datapath import Datapath
from xlbench.tests import tiny
from xlbench.traffic.generator import Traffic

SIZES = {"E": 512, "S": 64, "CL": 64, "A": 512}


def _drive(cfg: dict, spec: dict, seed: int, ticks: int) -> list:
    """The calls the traffic sends over ``ticks`` ticks of the reference
    datapath standing in for the served system."""
    lay = deploy.layout(cfg)
    sl, e = cfg["serve_loop"], cfg["engine"]
    dp = Datapath(lay, slots=e["slots"], max_len=e["max_len"], eos=e["eos"],
                  admit_batch=sl["admit_batch"],
                  max_retries=sl["max_retries"],
                  backoff_base=sl["backoff_base"],
                  backoff_cap=sl["backoff_cap"],
                  backoff_seed=seeded.subseed(seed, seeded.BACKOFF),
                  sizes=SIZES)
    sent = []

    def submit(rid, svc, headers, token, nbytes):
        sent.append((rid, svc, tuple(sorted(headers.items())), token,
                     nbytes))
        dp.submit(rid, svc, headers, token, nbytes)

    tr = Traffic(spec, seed, cfg["model"]["vocab"], lay.svc_id,
                 lay.lane_subset, submit)
    draws = seeded.Draws(seed, "cpu")
    for t in range(ticks):
        tr.before_tick(t, 0.01 * t)
        dp.tick(lambda: tuple(x.numpy() for x in draws(sl["admit_batch"])))
        for rid in list(tr.by_rid):
            r = dp.reqs[rid]
            if r.done_tick == t or r.dropped:
                tr.finished(t, rid, 0.01 * t, r.dropped, r.lane)
    return sent + [("log", t, rid) for rid, t in enumerate(tr.sent_tick)]


@pytest.mark.parametrize("cell", ["bookinfo", "gateway"])
def test_same_seed_same_traffic(cell):
    cfg, spec = getattr(tiny, cell)()
    a = _drive(cfg, spec, 2**40 + 3, 60)
    assert a == _drive(cfg, spec, 2**40 + 3, 60)
    assert a != _drive(cfg, spec, 2**40 + 4, 60)
    assert len(a) > 20


def test_bookinfo_graph_follows_the_reviews_subset():
    cfg, spec = tiny.bookinfo()
    sent = _drive(cfg, spec, 7, 80)
    paths = [dict(h)["path"] for *_, h, _, _ in
             [s for s in sent if s[0] != "log"]]
    n = {p: paths.count(p) for p in set(paths)}
    # every user request calls productpage, details and reviews; ratings
    # only after reviews v2 or v3
    assert n["/details"] <= n["/productpage"]
    assert 0 < n["/ratings"] < n["/reviews"]
    jason = sum(1 for s in sent if s[0] != "log"
                and dict(s[2]).get("user") == "jason")
    assert jason > 0


def test_open_loop_offers_every_seed_the_same_gaps():
    _, spec = tiny.gateway("open")
    seconds = 25.0
    q = round(spec["rate_per_s"] * (spec["warmup_s"] + seconds))
    got = []
    for seed in (1, 2**35):
        tr = Traffic(spec, seed, 64, {"gateway": 0}, [], lambda *a: None,
                     seconds)
        got.append([tr._next_gap() for _ in range(q)])
    assert got[0] != got[1]
    assert np.allclose(sorted(got[0]), sorted(got[1]))
    # the run's gaps fill its warm-up and window at the rate
    assert np.isclose(sum(got[0]), spec["warmup_s"] + seconds, rtol=2e-2)

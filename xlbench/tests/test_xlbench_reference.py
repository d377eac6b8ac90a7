"""The plain reference against the program on the CPU at a tiny size: a
whole run of each cell's kind comes out correct with every comparison
made, the reference model agrees with the program's model, and the
header hash with the program's ingress."""

from __future__ import annotations

import pytest
import torch

from xlbench import run, seeded
from xlbench.reference import fnv
from xlbench.reference import model as ref_model
from xlbench.tests import tiny

CELLS = {"bookinfo": ("bookinfo.closed", tiny.bookinfo),
         "gateway": ("minitron-gw.closed", lambda: tiny.gateway("closed")),
         "poisson": ("minitron-gw.poisson80", lambda: tiny.gateway("open"))}


@pytest.mark.parametrize("kind", sorted(CELLS))
def test_a_run_on_the_cpu_is_correct(kind):
    name, make = CELLS[kind]
    cfg, spec = make()
    out = run.execute(name, 2**33 + 1, 1.0, False, device="cpu",
                      bench=tiny.bench_for(name, cfg, "tiny"), cfg=cfg,
                      spec=spec, t0=0.0)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0
    listed = run.reported(tiny.bench_for(name, cfg, "tiny"),
                          {"name": name}, False)
    e2e = {m["name"] for m in listed}
    assert {"setup_s"} < e2e
    # a device metric's CUDA events exist only on a card
    assert set(out["metrics"]) == {m["name"] for m in listed
                                   if m["source"] == "host_clock"}
    assert list(out)[-2:] == ["checks", "_notes"]


def test_a_traced_run_on_the_cpu_reads_its_host_metrics():
    name, make = CELLS["bookinfo"]
    cfg, spec = make()
    out = run.execute(name, 5, 0.6, True, device="cpu",
                      bench=tiny.bench_for(name, cfg, "tiny"), cfg=cfg,
                      spec=spec, t0=0.0)
    assert out["correct"], out["checks"]
    got = out["metrics"]
    assert got["ingress_ms_per_tick.mesh"]["value"] > 0
    assert got["mesh_req_per_s"]["value"] > 0
    assert got["tick_call_ms.mesh"]["value"] > 0
    assert 0 <= got["admit_hold_pct"]["value"] <= 100
    assert "breakdown" in out


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_reference_model_matches_the_program_model(act):
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import model as M
    m = dict(tiny.MODEL, ffn_act=act)
    params = seeded.make_params(m, 11, "cpu")
    cfg = ModelConfig(**{k: m[k] for k in m})
    tokens = torch.randint(0, m["vocab"], (3, 7),
                           generator=torch.Generator().manual_seed(0))
    want, _ = M.forward(cfg, params, tokens)
    got = ref_model.forward(m, params, tokens)
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5)


def test_header_hash_matches_the_program_ingress():
    from repro_torch.runtime.serve_loop import parse_features
    headers = {"path": "/reviews", "user": "jason", "region": "eu-west-1"}
    assert fnv.features(headers).tolist() == \
        parse_features(headers).tolist()

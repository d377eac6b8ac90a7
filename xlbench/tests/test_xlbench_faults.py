"""The check fails a broken timed path: a whole run on the CPU with one
fault planted underneath (the chip's look skipped) comes out not
correct, once for each fault a serving cell can have."""

from __future__ import annotations

import pytest
import torch

from xlbench import run
from xlbench.tests import tiny


def _state_unchanged(monkeypatch):
    from repro_torch.core.interpose import Engine
    step = Engine.step

    def broken(self, params, state):
        _, out = step(self, params, state)
        return state, out                # the tick's new state dropped
    monkeypatch.setattr(Engine, "step", broken)


def _half_batch(monkeypatch):
    from repro_torch.core.interpose import Engine
    admit = Engine.admit

    def broken(self, state, reqs, live=None, draws=None):
        rid = reqs.req_id.clone()
        rid[1::2] = -1                   # half the rows left out
        return admit(self, state, reqs._replace(req_id=rid), live, draws)
    monkeypatch.setattr(Engine, "admit", broken)


def _token_altered(monkeypatch):
    from repro_torch.models import model as M
    decode = M.decode_step

    def broken(cfg, params, token, lengths, cache, **kw):
        logits, cache = decode(cfg, params, token, lengths, cache, **kw)
        return torch.roll(logits, 1, dims=-1), cache   # argmax moved
    monkeypatch.setattr(M, "decode_step", broken)


FAULTS = {"state_unchanged": (_state_unchanged, "datapath_mismatches"),
          "half_batch": (_half_batch, "datapath_mismatches"),
          "token_altered": (_token_altered, "token_gap")}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_planted_fault_makes_the_run_not_correct(fault, monkeypatch):
    plant, number = FAULTS[fault]
    plant(monkeypatch)
    cfg, spec = tiny.gateway("closed")
    name = "minitron-gw.closed"
    out = run.execute(name, 9, 0.5, False, device="cpu",
                      bench=tiny.bench_for(name, cfg, "tiny"), cfg=cfg,
                      spec=spec, t0=0.0)
    assert not out["correct"]
    c = out["checks"][number]
    assert c["value"] > c["limit"], out["checks"]

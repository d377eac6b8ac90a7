"""The control of ``correct`` on the card: the served path's tokens are
judged against the reference in float32 (TF32 off), and the tokens that
the reference one precision lower (TF32 products) puts first fail the
same limit.  At the Bookinfo cell's model (the full-width service model,
31-token calls, 512 calls judged) over a small deployment, on three
seeds.  Needs a CUDA device: ``pytest -m gpu xlbench/tests``."""

from __future__ import annotations

import pytest

from xlbench import control, deploy
from xlbench.tests import tiny


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the control runs the program's "
                    "kernels)")
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [3, 2**33 + 5, 2**40 + 7])
def test_control_fails_where_the_program_passes(card, seed):
    cfg, spec = tiny.bookinfo()
    full = deploy.read_config(
        {"file": "xlbench/configs/bookinfo-65.json"})
    cfg["model"] = full["model"]
    cfg["engine"] = dict(cfg["engine"], max_len=full["engine"]["max_len"])
    spec["check"] = dict(spec["check"], token_calls=512)
    name = "bookinfo.closed"
    r = control.readings(name, seed, 3.0, card,
                         bench=tiny.bench_for(name, cfg, "tiny"), cfg=cfg,
                         spec=spec)
    limit = cfg["token_gap_limit"]
    assert r["correct"], r
    assert r["checks"]["token_gap"] <= limit
    assert r["control_token_gap"] > limit, r

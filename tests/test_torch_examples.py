"""The port's examples (``examples/torch/``) on the CPU, and the hop
driver's ``run_graph`` against the reference's on bookinfo.

Each example's ``main(["--device", "cpu", ...])`` is held to the facts
the reference's example prints: the quickstart completes its 8 requests
with no unroutable one, then the 9th after one transaction, at routing
version 1 and control-plane commit #1; serve_cluster completes every
request on istio, cilium and xlb; train_moe takes its steps with finite
losses and writes its checkpoint.  ``run_graph`` on the xlb engine with
the reference's weights completes as many requests as the reference's
``benchmarks/common.py::run_graph``.  Tolerance: exact (counts).
"""

import importlib.util
import math
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from benchmarks import common as JC
from repro.configs import BOOKINFO as J_BOOKINFO
from repro_torch import convert
from repro_torch.configs import BOOKINFO
from repro_torch.workload import hops

ROOT = Path(__file__).resolve().parents[1]


def _example(name: str):
    path = ROOT / "examples" / "torch" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"torch_example_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_on_the_cpu():
    out = _example("quickstart").main(["--device", "cpu"])
    assert out["completed"] == 8 and out["requests"] == 8
    assert out["no_route"] == 0 and out["overflow"] == 0
    assert out["completed_after"] == 9
    assert out["routing_version"] == 1 and out["cp_version"] == 1
    assert out["lines"][-1].endswith(
        "routing version = 1 (control plane commit #1)")


def test_serve_cluster_completes_every_request_on_each_engine():
    out = _example("serve_cluster").main(["--device", "cpu"])
    assert list(out["rows"]) == ["istio", "cilium", "xlb"]
    for mode, row in out["rows"].items():
        assert row["completed"] == 8, (mode, row)
        assert row["graph"] == "bookinfo"
    assert out["lines"][0] == ("topology: bookinfo: client -> productpage "
                               "-> details -> reviews -> ratings")


def test_train_moe_steps_and_checkpoints(tmp_path):
    out = _example("train_moe").main(
        ["--device", "cpu", "--steps", "3", "--seq", "32", "--batch", "2",
         "--ckpt-dir", str(tmp_path)])
    assert len(out["losses"]) == 3 and out["restarts"] == 0
    assert all(math.isfinite(x) for x in out["losses"])
    assert [h["step"] for h in out["out"]["history"]] == [0, 1, 2]
    assert [p.name for p in tmp_path.iterdir()] == ["step-000000003"]
    # the deepseek-v2-shaped MoE: routed experts, one shared, a dense first
    assert out["params"] > out["active"] > 0


def test_examples_default_to_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name, argv in (("quickstart", []), ("serve_cluster", []),
                       ("train_moe", ["--ckpt-dir", str(tmp_path)])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _example(name).main(argv)
    assert not list(tmp_path.iterdir())


def test_run_graph_matches_the_reference_on_bookinfo():
    assert (BOOKINFO.name, BOOKINFO.services, BOOKINFO.edges) == \
        (J_BOOKINFO.name, J_BOOKINFO.services, J_BOOKINFO.edges)
    want = JC.run_graph("xlb", J_BOOKINFO, n_requests=4)
    params = convert.params_from_jax(jax.tree.map(np.asarray, JC.PARAMS),
                                     torch.device("cpu"))
    got = hops.run_graph("xlb", BOOKINFO, n_requests=4, params=params,
                         device="cpu")
    assert got["completed"] == want["completed"] == 4
    assert set(got) == set(want)
    assert (got["mode"], got["graph"]) == (want["mode"], want["graph"])

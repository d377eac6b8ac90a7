"""Package rules of the port: it never imports JAX or the reference
package, its entry points default to the card and refuse to run without
one, and a kernel wrapper handed CUDA tensors launches its kernel or
raises — it never runs the plain version instead."""

import ast
from pathlib import Path

import pytest
import torch

from repro_torch.configs import XLB_SERVICE_MODEL
from repro_torch.core import interpose
from repro_torch.core.balancer import PoolState, RequestBatch
from repro_torch.core.routing_table import (POLICY_RR, Cluster, Rule,
                                            ServiceConfig, build_state)
from repro_torch.kernels import (_build, completion, decode_attention, ops,
                                 flash_attention, relay_dispatch, route_match,
                                 ssd_scan)
from repro_torch.launch import prefill_decode, serve
from repro_torch.models import model
from repro_torch.core.control import ControlPlane
from repro_torch.runtime import transport
from repro_torch.runtime.serve_loop import Fault, FaultInjector, ServeLoop

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + sorted((ROOT / "examples" / "torch").glob("*.py")) \
        + [ROOT / "chip_smoke.py"]


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_never_imports_jax_or_the_reference():
    files = _port_files()
    assert len(files) > 15 and all(f.exists() for f in files)
    names = {f.relative_to(ROOT / "src" / "repro_torch").as_posix()
             for f in files[:-1] if "examples" not in f.parts}
    assert {"kernels/decode_attention.py", "kernels/flash_attention.py",
            "kernels/ssd_scan.py", "models/ssm.py", "models/transformer.py",
            "configs/minitron_4b.py", "configs/mamba2_2_7b.py",
            "launch/prefill_decode.py", "convert.py", "core/health.py",
            "runtime/transport.py", "runtime/elastic.py",
            "runtime/trace.py",
            "workload/generators.py", "workload/scenarios.py",
            "workload/slo.py", "analysis/invariants.py",
            "workload/hops.py", "workload/chain.py", "analysis/lint.py",
            "analysis/__main__.py", "analysis/kernel_sweep.py",
            "optim/adamw.py", "optim/schedules.py", "optim/compression.py",
            "data/pipeline.py", "runtime/checkpoint.py",
            "runtime/train_loop.py", "launch/train.py", "tree.py",
            "roofline/constants.py", "roofline/analysis.py",
            "sharding/specs.py", "launch/dryrun.py", "launch/mesh.py",
            "core/relay.py", "models/moe.py", "models/attention.py",
            "models/layers.py", "models/model.py", "kernels/ops.py"} <= names
    examples = {f.name for f in files if "examples" in f.parts}
    assert examples == {"quickstart.py", "serve_cluster.py", "train_moe.py"}
    bad = [(f.relative_to(ROOT).as_posix(), m) for f in files
           for m in _imports(f) if m.split(".")[0] in FORBIDDEN]
    assert bad == []


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_engine_defaults_to_cuda_and_raises_without_gpu(no_gpu):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        interpose.Engine(XLB_SERVICE_MODEL, 2, 2, 8)
    assert interpose.Engine.__dataclass_fields__["device"].default == "cuda"


def test_model_init_defaults_to_cuda_and_raises_without_gpu(no_gpu):
    g = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init_params(XLB_SERVICE_MODEL, g)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init_cache(XLB_SERVICE_MODEL, 2, 8)
    p = model.init_params(XLB_SERVICE_MODEL, g, torch.float32, device="cpu")
    c = model.init_cache(XLB_SERVICE_MODEL, 2, 8, torch.float32, "cpu")
    assert p["embed"].device.type == "cpu"
    assert c["blocks"]["self"]["k"].device.type == "cpu"


def test_sidecars_default_to_cuda_and_raise_without_gpu(no_gpu):
    from repro_torch.core import sidecar
    for cls in (sidecar.IstioEngine, sidecar.CiliumEngine):
        assert cls.__dataclass_fields__["device"].default == "cuda"
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls(XLB_SERVICE_MODEL, 2, 2, 8)


def test_serve_loop_and_launcher_raise_without_gpu(no_gpu):
    eng = interpose.Engine(XLB_SERVICE_MODEL, 2, 2, 8, device="cpu")
    routing, _ = build_state([ServiceConfig("s", [Rule(0, None, "p")])],
                             [Cluster("p", [0, 1], POLICY_RR)], "cpu")
    eng.device = torch.device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeLoop(eng, {}, routing)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeLoop(eng, {}, routing,
                  fault=FaultInjector([Fault(0, "stall")]))
    cp = ControlPlane([ServiceConfig("s", [Rule(0, None, "p")])],
                      [Cluster("p", [0, 1], POLICY_RR)])
    rc = transport.Transport(cp).consumer("ingress-0")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeLoop(eng, {}, rc)
    assert rc.sink is not None and not isinstance(rc.sink, ServeLoop)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--requests", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prefill_decode.main(["--smoke", "--prompt", "4", "--steps", "1"])


def test_training_defaults_to_cuda_and_raises_without_gpu(no_gpu, tmp_path):
    from repro_torch.data.pipeline import DataConfig, Pipeline
    from repro_torch.launch import train
    from repro_torch.runtime import train_loop
    pipe = Pipeline(DataConfig(vocab=16, seq_len=4, global_batch=2))
    tcfg = train_loop.TrainConfig(steps=1, ckpt_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_loop.run(XLB_SERVICE_MODEL, pipe, tcfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "xlb-service-model", "--steps", "1",
                    "--ckpt-dir", str(tmp_path)])
    assert not list(tmp_path.iterdir())


@pytest.fixture
def fake_cuda(monkeypatch):
    """Every wrapper sees its (CPU) tensors as CUDA tensors; the plain
    versions fail loudly if anything reaches them."""
    monkeypatch.setattr(ops, "device_kind", lambda t: "cuda")

    def plain(*a, **k):
        raise AssertionError("plain version ran for a CUDA tensor")

    for mod, name in ((route_match, "admit"), (route_match, "admit_commit"),
                      (route_match, "route_match"), (completion, "complete"),
                      (relay_dispatch, "relay_slots"),
                      (decode_attention, "decode_attention"),
                      (flash_attention, "flash_attention"),
                      (ssd_scan, "ssd_scan")):
        monkeypatch.setattr(mod, name, plain)
    monkeypatch.setattr(_build, "_lib", None)


def _inputs():
    routing, _ = build_state([ServiceConfig("s", [Rule(0, None, "p")])],
                             [Cluster("p", [0, 1], POLICY_RR)], "cpu")
    R = 4
    z = torch.zeros(R, dtype=torch.int32)
    reqs = RequestBatch(torch.arange(R, dtype=torch.int32), z,
                        torch.zeros((R, 8), dtype=torch.int32), z, z)
    return routing, reqs, PoolState.init(2, 2, "cpu"), z, torch.zeros((R, 64))


def test_wrappers_raise_without_a_built_library(fake_cuda, no_gpu):
    routing, reqs, pool, rnd, gum = _inputs()
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.admit_commit(reqs, routing, pool, rnd, gum)
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.admit(reqs, routing, torch.ones((2, 2)), rnd, gum)
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.complete(pool, torch.zeros((2, 2), dtype=torch.int32),
                     routing.ep_load, torch.zeros(64, dtype=torch.int32),
                     eos=1, max_len=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.route_match(reqs.svc, reqs.features, routing)
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.relay_slots(reqs.svc, 3)
    q = torch.zeros((2, 4, 32))
    kv = torch.zeros((2, 8, 2, 32))
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.decode_attention(q, kv, kv, torch.zeros(2, dtype=torch.int32))
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.flash_attention(torch.zeros((2, 8, 4, 32)), kv, kv)
    x, bc = torch.zeros((1, 64, 2, 32)), torch.zeros((1, 64, 2, 32))
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.ssd_scan(x, torch.zeros((1, 64, 2)), bc, bc, chunk=32)
    assert ops.LAUNCHES == {"admit": 0, "admit_commit": 0, "complete": 0,
                            "route_match": 0, "relay_slots": 0,
                            "decode_attention": 0, "flash_attention": 0,
                            "ssd_scan": 0, "dense_x9": 0}


def test_wrappers_on_meta_tensors_take_the_plain_versions(monkeypatch):
    """Meta tensors (the dry run's) get meta outputs of the plain
    versions' shapes and never reach a launch or the library."""
    monkeypatch.setattr(_build, "_lib", None)

    def no_build(*a, **k):
        raise AssertionError("a kernel was built or launched for meta")

    monkeypatch.setattr(_build, "library", no_build)
    before = dict(ops.LAUNCHES)
    meta = lambda t: t.to("meta") if isinstance(t, torch.Tensor) else t
    q, kv = torch.zeros((2, 4, 32)), torch.zeros((2, 8, 2, 32))
    lengths = torch.full((2,), 5, dtype=torch.int32)
    calls = [
        (ops.decode_attention, (q, kv, kv, lengths), {}),
        (ops.flash_attention, (torch.zeros((2, 8, 4, 32)), kv, kv), {}),
        (ops.ssd_scan, (torch.zeros((1, 64, 2, 32)), torch.zeros((1, 64, 2)),
                        torch.zeros((1, 64, 2, 16)),
                        torch.zeros((1, 64, 2, 16))),
         {"chunk": 32, "return_state": True}),
        (ops.relay_slots, (torch.tensor([0, 2, 1, 2, 3],
                                        dtype=torch.int32), 3), {}),
    ]
    for fn, args, kw in calls:
        want = fn(*args, **kw)
        got = fn(*(meta(a) for a in args), **kw)
        want = want if isinstance(want, tuple) else (want,)
        got = got if isinstance(got, tuple) else (got,)
        assert [(g.device.type, g.shape, g.dtype) for g in got] == \
            [("meta", w.shape, w.dtype) for w in want], fn.__name__
    assert ops.LAUNCHES == before


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.library()
    assert not list(tmp_path.glob("*.so"))


def test_argtypes_cover_every_c_parameter():
    """Each exported C function's parameter count equals its ctypes
    signature (a missing c_void_p would truncate a pointer)."""
    import re
    src = "".join((_build.CSRC / s).read_text() for s in _build.SOURCES)
    for name, argtypes in _build.SIGNATURES.items():
        m = re.search(r'extern "C" [\w\s\*]+?\b' + name + r"\((.*?)\)\s*\{",
                      src, re.S)
        assert m, name
        params = m.group(1).strip()
        assert (params.count(",") + 1 if params else 0) == len(argtypes), \
            name


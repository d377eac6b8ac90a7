"""The benchmark's definition: ``BENCHMARK.json`` against the contract's
shapes, every name found by the harness, and the imports of every file
of the benchmark (nothing of JAX or the JAX package; nothing of the
program in the reference)."""

from __future__ import annotations

import ast
import json
import re
from pathlib import Path

import pytest

from xlbench import deploy, run

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _reports(cell: str) -> tuple[set, set]:
    bench_cell = {"name": cell}
    e2e = {m["name"] for m in run.reported(BENCH, bench_cell, False)}
    layer = {m["name"] for m in run.reported(BENCH, bench_cell, True)}
    return e2e, layer


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["xlbench"]
    assert BENCH["command"][1].startswith("xlbench/")
    assert (ROOT / BENCH["command"][1]).is_file()
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_and_units_use_the_allowed_characters(kind):
    names = [e["name"] for e in BENCH[kind]]
    assert len(names) == len(set(names))
    for e in BENCH[kind]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("config", "traffic"):
            if key in e:
                assert NAME.match(e[key]), e[key]
        for text in ("why", "layer", "source"):
            if text in e:
                assert 1 <= len(e[text]) <= 200 and "\n" not in e[text]


def test_every_moves_names_an_end_to_end_metric_of_the_same_cells():
    cells = [w["name"] for w in BENCH["workloads"]]
    for m in BENCH["per_layer"]:
        for cell in m.get("workloads", cells):
            e2e, _ = _reports(cell)
            assert m["moves"] in e2e, (m["name"], cell)


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for w in BENCH["workloads"]:
        e2e, layer = _reports(w["name"])
        assert "setup_s" in e2e and len(e2e) >= 2 and layer, w["name"]
        assert w["chips"] == 1


def test_bounds_are_within_the_contract():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_configs_traffic_and_readers_are_found_by_name():
    for c in BENCH["configs"]:
        assert c["file"].startswith("xlbench/configs/")
        cfg = deploy.read_config(c)
        assert cfg["name"] == c["name"]
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
        deploy.layout(cfg)
    for w in BENCH["workloads"]:
        spec = deploy.read_traffic(w["traffic"])
        assert spec["kind"] in ("closed", "open")
    for m in BENCH["per_layer"]:
        assert callable(__import__("xlbench.metrics", fromlist=["reader"])
                        .reader(m["name"]))
    assert any("mfu" in m["name"] for m in BENCH["per_layer"])


def test_layouts_match_the_published_counts():
    book = deploy.layout(deploy.read_config(
        {"file": "xlbench/configs/bookinfo-65.json"}))
    assert book.lanes == 65
    assert [len(book.subset_lanes[("reviews", v)])
            for v in ("v1", "v2", "v3")] == [2, 1, 2]
    gw = deploy.read_config({"file": "xlbench/configs/minitron-4b-gateway"
                                     ".json"})
    pub, m = gw["published"], gw["model"]
    assert (m["d_model"], m["d_ff"], m["n_layers"], m["n_heads"],
            m["n_kv_heads"], m["head_dim"], m["vocab"]) == (
        pub["hidden_size"], pub["intermediate_size"],
        pub["num_hidden_layers"], pub["num_attention_heads"],
        pub["num_key_value_heads"], pub["head_dim"], pub["vocab_size"])


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            out.add(node.module)
    return out


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_file_imports_jax_or_the_jax_package(path):
    tops = {m.split(".", 1)[0] for m in _imports(path)}
    assert not tops & {"jax", "jaxlib", "flax", "repro"}, tops
    if "reference" in path.parts:
        assert "repro_torch" not in tops


def test_foreign_modules_compares_whole_top_level_names():
    mods = ["repro_torch", "repro_torch.core", "reproduce", "jaxtyping",
            "numpy"]
    assert run.foreign_modules(mods) == []
    assert run.foreign_modules(mods + ["repro.core", "jax._src"]) == [
        "jax._src", "repro.core"]


def test_no_card_exits_non_zero_and_prints_no_result(capsys, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for var in ("TORCH_EXTENSIONS_DIR", "TRITON_CACHE_DIR"):
        monkeypatch.setenv(var, "")     # main sets them; restored after
    rc = run.main(["--workload", "bookinfo.closed", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""

"""Small cells for the CPU tests: the Bookinfo deployment and a gateway
cut to a few lanes and a tiny model, with their traffic, as the
``bench`` / ``cfg`` / ``spec`` stand-ins that ``run.execute`` takes."""

from __future__ import annotations

import copy

from xlbench import deploy

MODEL = {"name": "tiny", "family": "dense", "n_layers": 2, "d_model": 32,
         "n_heads": 4, "n_kv_heads": 2, "d_ff": 64, "vocab": 64,
         "head_dim": 8, "ffn_act": "swiglu", "rope_theta": 10000.0,
         "norm_eps": 1e-05, "dtype": "float32"}


def bookinfo() -> tuple[dict, dict]:
    """(config, traffic) of Bookinfo on 11 lanes x 4 slots."""
    cfg = copy.deepcopy(deploy.read_config(
        {"file": "xlbench/configs/bookinfo-65.json"}))
    counts = {"productpage": {"v1": 4}, "details": {"v1": 2},
              "reviews": {"v1": 1, "v2": 1, "v3": 1}, "ratings": {"v1": 2}}
    for s in cfg["services"]:
        s["subsets"] = counts[s["name"]]
        s["instances"] = sum(s["subsets"].values())
    cfg["model"] = dict(MODEL)
    cfg["engine"] = {"slots": 4, "max_len": 6, "eos": -1}
    cfg["serve_loop"] = {"admit_batch": 16, "max_retries": 6,
                         "backoff_base": 1, "backoff_cap": 4}
    spec = copy.deepcopy(deploy.read_traffic("bookinfo-closed256"))
    spec.update(sessions=24, stagger_ticks=4, warmup_ticks=16)
    spec["check"] = {"grid_every": 2, "token_calls": 16}
    return cfg, spec


def gateway(kind: str = "closed") -> tuple[dict, dict]:
    """(config, traffic) of the gateway on 4 replicas x 4 slots."""
    cfg = copy.deepcopy(deploy.read_config(
        {"file": "xlbench/configs/minitron-4b-gateway.json"}))
    cfg["services"][0].update(instances=4, subsets={"replica": 4})
    cfg["model"] = dict(MODEL, ffn_act=cfg["model"]["ffn_act"])
    cfg["engine"] = {"slots": 4, "max_len": 8, "eos": -1}
    cfg["serve_loop"] = {"admit_batch": 8, "max_retries": 64,
                         "backoff_base": 1, "backoff_cap": 4}
    name = "gateway-closed128" if kind == "closed" else "gateway-poisson80"
    spec = copy.deepcopy(deploy.read_traffic(name))
    if kind == "closed":
        spec.update(sessions=16, stagger_ticks=8, warmup_ticks=16)
    else:
        # calls of 3 ticks, and a warm-up that holds some on a loaded CPU
        cfg["engine"]["max_len"] = 4
        spec.update(rate_per_s=60.0, warmup_s=0.5)
    spec["check"] = {"grid_every": 2, "token_calls": 8}
    return cfg, spec


def bench_for(name: str, cfg: dict, traffic: str, chips: int = 1) -> dict:
    """A ``BENCHMARK.json`` stand-in holding the one cell ``name``, with
    the real file's metrics."""
    real = deploy.load_benchmark()
    real_cell = {w["name"]: w for w in real["workloads"]}[name]
    return dict(real, configs=[{"name": real_cell["config"],
                                "file": "unused"}],
                workloads=[dict(real_cell, traffic=traffic, chips=chips)])

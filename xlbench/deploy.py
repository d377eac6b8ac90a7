"""A configuration file read into the deployment it describes.

Both the harness (which builds the program's routing tables from it) and
the plain reference (which routes by it on its own) read the deployment
through ``layout``; nothing here imports the program.

Lanes are laid out service by service and, inside a service, subset by
subset, in file order.  A cluster's endpoints are its subsets' lanes in
the order the cluster lists the subsets; clusters take consecutive
endpoint indices in file order (the flattening of Envoy's
listener → route → cluster → endpoint tree).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

#: the header fields hashed into the request's feature columns, in
#: column order (the ingress's parse of an L7 request)
FIELDS = ("path", "user", "version", "tenant", "method", "content-type",
          "region", "abtest")


@dataclasses.dataclass
class Cluster:
    name: str
    policy: str
    endpoints: list          # instance lanes, endpoint order
    weights: list            # one per endpoint


@dataclasses.dataclass
class Layout:
    """The deployment of one configuration file."""

    services: list           # names, service id order
    lanes: int
    subset_lanes: dict       # (service, subset) -> [lane]
    lane_subset: list        # lane -> (service, subset)
    clusters: list           # [Cluster], cluster id order
    rules: dict              # service id -> [(column, value, cluster id)]

    @property
    def svc_id(self) -> dict:
        return {s: i for i, s in enumerate(self.services)}

    @property
    def endpoint_lanes(self) -> list:
        """Instance lane of each endpoint index, clusters in order."""
        return [lane for c in self.clusters for lane in c.endpoints]


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def find_cell(bench: dict, workload: str) -> tuple[dict, dict]:
    """(the workload entry, its configuration entry) of ``BENCHMARK.json``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"xlbench: no workload {workload!r} in "
                         f"BENCHMARK.json; there are {sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    return cell, configs[cell["config"]]


def read_config(entry: dict, root: Path = ROOT) -> dict:
    return json.loads((root / entry["file"]).read_text())


def read_traffic(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def layout(cfg: dict) -> Layout:
    services = [s["name"] for s in cfg["services"]]
    subset_lanes, lane_subset = {}, []
    for s in cfg["services"]:
        if sum(s["subsets"].values()) != s["instances"]:
            raise ValueError(f"{s['name']}: subsets {s['subsets']} do not "
                             f"add up to {s['instances']} instances")
        for sub, n in s["subsets"].items():
            first = len(lane_subset)
            subset_lanes[(s["name"], sub)] = list(range(first, first + n))
            lane_subset += [(s["name"], sub)] * n
    clusters = []
    for c in cfg["clusters"]:
        eps, ws = [], []
        for sub in c["subsets"]:
            lanes = subset_lanes[(c["service"], sub)]
            eps += lanes
            ws += [float(c.get("weights", {}).get(sub, 1.0))] * len(lanes)
        clusters.append(Cluster(c["name"], c["policy"], eps, ws))
    cid = {c.name: i for i, c in enumerate(clusters)}
    rules = {}
    for i, s in enumerate(cfg["services"]):
        rules[i] = [(FIELDS.index(r["field"]), r.get("value"),
                     cid[r["cluster"]]) for r in s["rules"]]
    return Layout(services, len(lane_subset), subset_lanes, lane_subset,
                  clusters, rules)

"""One reader a per-layer metric, ``<metric name>.py`` with ``read(t)``:
the metric's value from a traced run's ``t`` (``xlbench/run.py::
trace_data``), or None where the run gave it nothing to read."""

from __future__ import annotations

import importlib.util
from pathlib import Path

HERE = Path(__file__).resolve().parent


def reader(name: str):
    """The ``read`` function of metric ``name``'s file."""
    path = HERE / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "xlbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read

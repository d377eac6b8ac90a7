"""The port's roofline models (``repro_torch/roofline/``) against the
reference's (``repro/roofline/``) on the CPU.

``attn_layers``, ``model_flops``, ``analytic_memory_bytes`` (with and
without ``param_shards``), ``cache_bytes`` and ``trip_hint`` for every
assigned arch × shape × {256, 512} chips: equal as floats (``==``), the
same arithmetic in the same order.  Then the H100 constants, the traced
FLOP count of a known step, and ``analyze_traced``'s report.
"""

import math

import pytest
import torch

from repro.configs import ASSIGNED_ARCHS as J_ARCHS
from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.roofline import analysis as JRA
from repro.roofline import constants as JRC
from repro_torch.configs import ASSIGNED_ARCHS, SHAPES, get_config
from repro_torch.roofline import analysis as RA
from repro_torch.roofline import constants as RC
from repro_torch.sharding.specs import LogicalMesh, MeshSpec

CELLS = [(a, s, n) for a in ASSIGNED_ARCHS for s in SHAPES
         for n in (256, 512)]


def test_archs_and_shapes_are_the_reference_s():
    assert ASSIGNED_ARCHS == J_ARCHS and list(SHAPES) == list(J_SHAPES)


@pytest.mark.parametrize("arch,shape,n_chips", CELLS)
def test_analytic_models_equal_the_reference(arch, shape, n_chips):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    sh, jsh = SHAPES[shape], J_SHAPES[shape]
    assert RA.attn_layers(cfg) == JRA.attn_layers(jcfg)
    assert RA.trip_hint(cfg) == JRA.trip_hint(jcfg)
    assert RA.model_flops(cfg, sh) == JRA.model_flops(jcfg, jsh)
    assert RA.cache_bytes(cfg, sh) == JRA.cache_bytes(jcfg, jsh)
    for kw in ({}, {"param_shards": 16}, {"moment_bytes": 2}):
        assert RA.analytic_memory_bytes(cfg, sh, n_chips, **kw) == \
            JRA.analytic_memory_bytes(jcfg, jsh, n_chips, **kw), kw


def test_h100_constants():
    assert (RC.BF16_OPS_PS, RC.OPS_PS, RC.MEM_BPS, RC.LINK_BPS) == \
        (989e12, 67e12, 3.35e12, 450e9)
    assert 80e9 <= RC.HBM_BYTES < 80 * 2**30
    # XLA's names keep the reference's sizes; torch's name the same sizes
    assert {k: RC.BYTES[k] for k in JRC.BYTES} == JRC.BYTES
    for dt in (torch.bool, torch.int8, torch.int16, torch.bfloat16,
               torch.float16, torch.float32, torch.int32, torch.int64,
               torch.float64, torch.complex64):
        name = str(dt).removeprefix("torch.")
        assert RC.BYTES[name] == torch.empty((), dtype=dt).element_size()


def test_trace_step_flops_counts_matmuls_and_the_backward():
    M, K, N = 8, 16, 32
    a = torch.empty((M, K), device="meta", requires_grad=True)
    b = torch.empty((K, N), device="meta", requires_grad=True)

    def fwd(a, b):
        return (a @ b).sum()

    def fwd_bwd(a, b):
        torch.autograd.grad(fwd(a, b), (a, b))

    assert RA.trace_step_flops(fwd, a, b) == 2 * M * K * N
    # the backward's two products: dA = g Bᵀ and dB = Aᵀ g
    assert RA.trace_step_flops(fwd_bwd, a, b) == 3 * 2 * M * K * N
    q = torch.empty((2, 3, 4, 5), device="meta")
    assert RA.trace_step_flops(lambda x: torch.einsum(
        "bhqd,bhkd->bhqk", x, x), q) == 2 * 2 * 3 * 4 * 4 * 5


def test_analyze_traced_report():
    cfg, shape = get_config("minitron-4b"), SHAPES["train_4k"]
    ms = MeshSpec(LogicalMesh((16, 16)))
    traced = {"flops": 3.2e16, "argument_bytes": 2**30,
              "output_bytes": 0.0, "temp_bytes": 2 * 2**30,
              "temp_rule": "saved for backward / chips"}
    rep = RA.analyze_traced(cfg, shape, ms, traced)
    r, m = rep["roofline"], rep["memory_analysis"]
    assert rep["n_chips"] == 256
    assert r["compute_s"] == 3.2e16 / 256 / RC.BF16_OPS_PS
    mem = JRA.analytic_memory_bytes(j_get_config("minitron-4b"),
                                    J_SHAPES["train_4k"], 256)
    assert r["analytic_hbm_bytes_per_device"] == mem
    assert r["memory_s"] == mem / RC.MEM_BPS
    # no collectives traced: no collective term, the bound over the two
    assert r["collective_s"] is None and "NVLink" in r["collective_note"]
    assert r["dominant"] == "compute"
    assert r["step_lower_bound_s"] == max(r["compute_s"], r["memory_s"])
    # with the sharded trace's wire bytes: the third term at LINK_BPS
    coll = {"kinds": {"all-gather": {"bytes": 9e12, "count": 3}},
            "collective_bytes": 9e12}
    rc = RA.analyze_traced(cfg, shape, ms, {**traced, "collectives": coll})
    assert rc["roofline"]["collective_s"] == 9e12 / RC.LINK_BPS
    assert rc["roofline"]["dominant"] == "collective"
    assert rc["roofline"]["step_lower_bound_s"] == 9e12 / RC.LINK_BPS
    assert rc["roofline"]["collectives"] == coll["kinds"]
    assert r["model_flops"] == RA.model_flops(cfg, shape)
    assert math.isclose(r["useful_flops_ratio"],
                        r["model_flops"] / 3.2e16)
    assert (m["argument_GiB"], m["temp_GiB"], m["total_GiB"]) == \
        (1.0, 2.0, 3.0)
    assert m["fits_hbm"] is True
    assert rep["traced"]["recompute_included"] is True
    # tp-only parameters: the analytic bytes read the params over tp only
    rep = RA.analyze_traced(cfg, shape, MeshSpec(ms.mesh, True), traced)
    assert rep["roofline"]["analytic_hbm_bytes_per_device"] == \
        JRA.analytic_memory_bytes(j_get_config("minitron-4b"),
                                  J_SHAPES["train_4k"], 256,
                                  param_shards=16)


def test_wire_bytes_follow_the_reference_formulas():
    """``wire_bytes`` from a collective's operand (the local input) equals
    the reference's ``parse_hlo`` formulas over its result b: all-gather
    b(g-1)/g (b = operand x g), all-reduce 2b(g-1)/g, reduce-scatter
    b(g-1) (b = operand / g), all-to-all b(g-1)/g, permute b."""
    b, g = 3 * 2**20, 16
    assert RA.wire_bytes("all-gather", b, g) == (b * g) * (g - 1) / g
    assert RA.wire_bytes("all-reduce", b, g) == 2.0 * b * (g - 1) / g
    assert RA.wire_bytes("reduce-scatter", b, g) == (b / g) * (g - 1)
    assert RA.wire_bytes("all-to-all", b, g) == b * (g - 1) / g
    assert RA.wire_bytes("collective-permute", b, g) == b
    assert RA.wire_bytes("all-gather", b, 1) == 0.0

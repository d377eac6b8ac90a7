"""The port's dry run (``repro_torch/launch/dryrun.py``) against the
reference's (``repro/launch/dryrun.py``) on the CPU.

* ``input_specs`` and ``abstract_state`` (meta tensors) have the shapes
  and dtypes of the reference's ``jax.eval_shape`` trees, path by path,
  for every applicable arch × shape (the moments' dtype by the "auto"
  rule of one pod).
* One smoke-config training step, without and with block remat: the
  port's traced FLOPs against the reference's ``parse_hlo`` of its own
  step compiled with ``jax.jit`` on one CPU device.  They differ by
  design (the tolerances below say how).
* What the trace counts on a step whose answer is known (and, under
  block remat, what the checkpoints keep); a full-width cell's report
  with its collective term, a skipped cell, the variants, the JSON
  cache and the CLI; an expert-parallel cell's all-to-all bytes against
  their analytic count; and that a traced cell leaves CUDA untouched.
* One smoke-config training step on a (2, 2) mesh: the port's
  collective wire bytes, kind by kind, against the reference's
  ``parse_hlo`` of its own step compiled on four forced host devices
  (in a process of its own, since this one's JAX has one device).
"""

import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch

jax.devices()     # fix the device count before the reference's dryrun
_XLA_FLAGS = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as JD  # noqa: E402  (sets XLA_FLAGS)
if _XLA_FLAGS is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _XLA_FLAGS

from repro.configs import SHAPES as J_SHAPES  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import smoke_config as j_smoke_config  # noqa: E402
from repro.configs.base import ShapeConfig as JShapeConfig  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.roofline import analysis as JRA  # noqa: E402
from repro.sharding.specs import MeshSpec as JMeshSpec  # noqa: E402
from repro_torch.configs import (ASSIGNED_ARCHS, SHAPES, get_config,  # noqa
                                 shape_applicable, smoke_config)
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch import dryrun as DR  # noqa: E402
from repro_torch.roofline import analysis as RA  # noqa: E402
from repro_torch.sharding.specs import LogicalMesh, MeshSpec  # noqa: E402
from repro_torch.tree import items  # noqa: E402

#: the block-remat smoke step's FLOPs over the reference's (read: see the
#: test's docstring)
RATIO_BLOCK = 1.042
RATIO_BLOCK_LO, RATIO_BLOCK_HI = RATIO_BLOCK - 0.03, RATIO_BLOCK + 0.03
CELLS = [(a, s) for a in ASSIGNED_ARCHS for s in SHAPES
         if shape_applicable(get_config(a), SHAPES[s])[0]]
SRC = Path(__file__).resolve().parents[1] / "src"

#: the reference's smoke training step on a (data, model) mesh of forced
#: host devices: its ``parse_hlo`` collectives as JSON on stdout
_REF_COLLECTIVES = """
import json, sys
import jax
jax.devices()
import jax.numpy as jnp
from repro.launch import dryrun as JD
from repro.configs import get_config, smoke_config
from repro.configs.base import ShapeConfig
from repro.launch.mesh import make_host_mesh
from repro.optim import adamw
from repro.roofline import analysis as JRA
from repro.sharding.specs import MeshSpec
arch, data, model, B, S = sys.argv[1], *map(int, sys.argv[2:])
cfg = smoke_config(get_config(arch))
sh = ShapeConfig("smoke_train", S, B, "train")
mesh = make_host_mesh(data, model)
ms = MeshSpec(mesh)
st, inp = JD.abstract_state(cfg, sh), JD.input_specs(cfg, sh)
p_sh = ms.params_shardings(st["params"])
rep = ms.named(jax.sharding.PartitionSpec())
with mesh:
    fn, _ = JD.build_train_step(cfg, ms, sh, jnp.float32)
    opt_sh = adamw.AdamWState(step=rep, m=p_sh, v=p_sh)
    compiled = jax.jit(
        fn, in_shardings=(p_sh, opt_sh, rep,
                          ms.batch_shardings(inp["batch"])),
        out_shardings=(p_sh, opt_sh, rep, None), donate_argnums=(0, 1),
    ).lower(st["params"], st["opt"], st["bias"], inp["batch"]).compile()
print(json.dumps(JRA.parse_hlo(compiled.as_text(),
                               JRA.trip_hint(cfg))["collectives"]))
"""


def _jpath(kp) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx",
                                                  getattr(k, "name", k))))
                    for k in kp)


def _j_tree(tree) -> dict:
    return {_jpath(kp): (tuple(leaf.shape), str(jnp.dtype(leaf.dtype)))
            for kp, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _t_tree(tree) -> dict:
    return {path: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
            for path, t in items(tree)}


@functools.lru_cache(maxsize=None)
def _j_params(arch):
    cfg = j_get_config(arch)
    return _j_tree(jax.eval_shape(
        lambda: JD.M.init_params(cfg, jax.random.PRNGKey(0))))


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_and_abstract_state_equal_the_reference(arch, shape):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    sh, jsh = SHAPES[shape], J_SHAPES[shape]
    assert _t_tree(DR.input_specs(cfg, sh)) == \
        _j_tree(JD.input_specs(jcfg, jsh))
    moment = DR._moment_dtype(cfg, multi_pod=False)
    big = jcfg.param_count() > 2e11
    assert moment == (torch.bfloat16 if big else torch.float32)
    state = DR.abstract_state(cfg, sh, moment)
    assert all(t.device.type == "meta" for _, t in items(state))
    got = _t_tree(state)
    params = {k[len("params/"):]: v for k, v in got.items()
              if k.startswith("params/")}
    assert params == _j_params(arch)
    if sh.kind == "train":
        # the reference's optimizer and bias trees, shapes only
        jopt = jax.eval_shape(functools.partial(
            JD._init_opt, jnp.bfloat16 if big else jnp.float32),
            jax.eval_shape(lambda: JD.M.init_params(
                jcfg, jax.random.PRNGKey(0))))
        want = {f"opt/{k}": v for k, v in _j_tree(jopt).items()}
        want["bias"] = ((max(jcfg.moe.n_experts, 1),), "float32")
    else:
        jcache = jax.eval_shape(lambda: JD.M.init_cache(
            jcfg, jsh.global_batch, jsh.seq_len))
        want = {f"cache/{k}": v for k, v in _j_tree(jcache).items()}
    rest = {k: v for k, v in got.items() if not k.startswith("params/")}
    assert rest == want


@pytest.mark.parametrize("remat,lo,hi", [("none", 0.80, 0.90),
                                         ("block", RATIO_BLOCK_LO,
                                          RATIO_BLOCK_HI)])
def test_smoke_train_flops_against_the_reference_hlo(remat, lo, hi):
    """minitron-4b's smoke config, 4 × 64 tokens, one training step.

    The reference's step rematerialises every block (``remat="block"``):
    its HLO runs each block's forward matmuls twice (forward, and again
    in the backward) beside the backward's two, 4× the forward; the head
    runs 3×.  The port under ``remat="none"`` keeps its activations and
    recomputes only the attention inside B7's backward: 3× the forward
    plus the attention scores.  So that count is between 3/4 of the
    reference's (all blocks, no head) and 1; at this config it reads
    0.854, tolerance [0.80, 0.90].  Under ``remat="block"`` (the dry
    run's default for training, as the reference's) the port runs each
    block's forward again too: it reads 1.0417 (``RATIO_BLOCK``), the
    excess over 1 being B7's backward recompute of the scores, which the
    reference's autodiff of the plain attention does not run; tolerance
    ± 0.03 about it."""
    jcfg = j_smoke_config(j_get_config("minitron-4b"))
    cfg = smoke_config(get_config("minitron-4b"))
    jsh = JShapeConfig("smoke_train", 64, 4, "train")
    sh = ShapeConfig("smoke_train", 64, 4, "train")
    ms = JMeshSpec(make_host_mesh(1, 1))
    st, inp = JD.abstract_state(jcfg, jsh), JD.input_specs(jcfg, jsh)
    with ms.mesh:
        fn, _ = JD.build_train_step(jcfg, ms, jsh, jnp.float32)
        compiled = jax.jit(fn).lower(st["params"], st["opt"], st["bias"],
                                     inp["batch"]).compile()
    ref = JRA.parse_hlo(compiled.as_text(), JRA.trip_hint(jcfg))
    rep = DR.trace_cell_for(cfg, sh, MeshSpec(LogicalMesh((1, 1))),
                            remat=remat)
    ratio = rep["traced"]["flops"] / ref["dot_flops"]
    assert lo <= ratio <= hi, ratio
    assert rep["remat"] == remat
    assert rep["roofline"]["model_flops"] == JRA.model_flops(jcfg, jsh)
    assert rep["traced"]["recompute_included"] is True
    assert not torch.cuda.is_initialized()


def test_trace_step_counts_saved_and_live_bytes():
    B, K, N = 4, 8, 16
    x = torch.empty((B, K), device="meta")
    w = torch.empty((K, N), device="meta", requires_grad=True)

    def step(x, w):
        y = torch.tanh(x @ w)          # tanh saves y; mm saves x (an arg)
        return torch.autograd.grad(y.sum(), w)

    t = DR.trace_step(step, (x, w))
    assert t["flops"] == 2 * (2 * B * K * N)     # x @ w and xᵀ g
    assert t["saved_bytes"] == B * N * 4
    assert t["peak_bytes"] >= B * N * 4 + K * N * 4
    assert t["output_bytes"] == K * N * 4        # the gradient


def test_full_width_cell_report_and_skips():
    rep = DR.trace_cell("minitron-4b", "decode_32k", False)
    assert (rep["arch"], rep["shape"], rep["mesh"], rep["variant"]) == \
        ("minitron-4b", "decode_32k", "16x16", "baseline")
    assert rep["n_chips"] == 256 and rep["ep_relay"] is False
    m, r = rep["memory_analysis"], rep["roofline"]
    assert m["fits_hbm"] is True and m["argument_GiB"] > 0
    # the sharded trace's collectives at NVLink's rate, split by mesh
    # axis and by call site, each adding up to the bytes by kind
    assert r["collectives"]["all-gather"]["count"] > 0
    for kind, c in r["collectives"].items():
        assert sum(rep["collective_axes"][kind].values()) == \
            pytest.approx(c["bytes"])
    assert sum(sum(v.values()) for v in rep["collective_sites"].values()) \
        == pytest.approx(r["collective_bytes_per_device"])
    assert r["collective_s"] == r["collective_bytes_per_device"] / 450e9 > 0
    assert r["step_lower_bound_s"] == max(r["compute_s"], r["memory_s"],
                                          r["collective_s"])
    assert r["model_flops"] == JRA.model_flops(
        j_get_config("minitron-4b"), J_SHAPES["decode_32k"])
    assert rep["traced"]["flops"] > 0
    assert DR.trace_cell("minitron-4b", "long_500k", False) == \
        {"skipped": shape_applicable(
            get_config("minitron-4b"), SHAPES["long_500k"])[1]}
    # exp_fsdp changes training cells only (the relay's gather)
    exp = DR.trace_cell("minitron-4b", "decode_32k", False,
                        variant="exp_fsdp")
    assert exp["variant"] == "exp_fsdp"
    assert exp["roofline"]["collective_s"] == r["collective_s"]
    with pytest.raises(ValueError, match="unknown variant"):
        DR.trace_cell("minitron-4b", "decode_32k", False, variant="mb3")
    assert not torch.cuda.is_initialized()


def test_run_cell_caches_and_main(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(DR, "OUT_DIR", tmp_path)
    assert DR.main(["--arch", "mamba2-2.7b", "--shape", "long_500k",
                    "--both-meshes"]) == 0
    files = sorted(p.name for p in tmp_path.iterdir())
    assert files == ["mamba2-2.7b__long_500k__16x16.json",
                     "mamba2-2.7b__long_500k__2x16x16.json"]
    rep = json.loads((tmp_path / files[1]).read_text())
    assert rep["n_chips"] == 512 and rep["mesh"] == "2x16x16"
    assert "2 cells, 0 failures" in capsys.readouterr().out
    # cached: a second run reads the file back
    (tmp_path / files[0]).write_text(json.dumps({"cached": True}))
    assert DR.run_cell("mamba2-2.7b", "long_500k", False) == {"cached": True}
    assert DR.main(["--arch", "minitron-4b", "--shape", "decode_32k",
                    "--variant", "nonesuch"]) == 1
    assert "ValueError" in json.loads(
        (tmp_path / "minitron-4b__decode_32k__16x16__nonesuch.json")
        .read_text())["error"]
    assert not torch.cuda.is_initialized()


def test_saved_bytes_are_one_microbatch_s():
    """With microbatches the saved tensors of one are freed by its
    backward before the next forward: the count is the most held at
    once, not the sum."""
    cfg = smoke_config(get_config("minitron-4b"))
    sh = ShapeConfig("smoke_train", 32, 8, "train")
    ms = MeshSpec(LogicalMesh((1, 1)))
    state, inputs = DR.abstract_state(cfg, sh), DR.input_specs(cfg, sh)
    args = (state["params"], state["opt"], state["bias"], inputs["batch"])
    whole, mb4 = (DR.trace_step(DR.build_train_step(
        cfg, ms, sh, torch.float32, variant), args)
        for variant in ("", "mb4"))
    ratio = mb4["saved_bytes"] / whole["saved_bytes"]
    assert 0.2 <= ratio <= 0.3, ratio
    # the same matmuls, a quarter of the rows at a time
    assert mb4["flops"] == whole["flops"]


def _arctic_smoke_cf1():
    """arctic-480b's smoke config (2 layers, both MoE, E 4, top-2, D 64,
    bf16) at capacity factor 1: pools exactly the routed rows."""
    cfg = smoke_config(get_config("arctic-480b"))
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=1.0))


def test_ep_cell_all_to_all_wire_bytes_are_the_relays():
    """A prefill cell with the expert-parallel relay on a (2, 4) fake
    mesh: the relay's ``all_to_all_single`` wire bytes a device are
    2 · L_moe · T·k·D·bytes · (g − 1)/g, with T this rank's 8 × 64 / 8
    tokens, k 2, D 64, bf16 and g the 4-way model axis (two hops a MoE
    layer, the pools exactly the routed rows at capacity factor 1)."""
    cfg = _arctic_smoke_cf1()
    sh = ShapeConfig("smoke_prefill", 64, 8, "prefill")
    mesh = LogicalMesh((2, 4))
    assert DR._ep_applies(cfg, MeshSpec(mesh), sh)
    got = DR.trace_collectives(cfg, sh, mesh)
    T, k, D, g, L = 8 * 64 // 8, 2, 64, 4, 2
    assert got["ops"]["all_to_all_single"] == \
        2 * L * T * k * D * 2 * (g - 1) / g
    assert got["kinds"]["all-to-all"]["bytes"] >= \
        got["ops"]["all_to_all_single"]
    assert not torch.distributed.is_initialized()
    assert not torch.cuda.is_initialized()


def test_block_remat_keeps_block_inputs_and_one_recompute():
    """Under block remat a training cell's saved bytes are the blocks'
    inputs plus one block's recompute: far under the bytes the blocks
    save without it, and not zero."""
    cfg = dataclasses.replace(smoke_config(get_config("minitron-4b")),
                              n_layers=8)
    sh = ShapeConfig("smoke_train", 64, 4, "train")
    ms = MeshSpec(LogicalMesh((1, 1)))
    state, inputs = DR.abstract_state(cfg, sh), DR.input_specs(cfg, sh)
    args = (state["params"], state["opt"], state["bias"], inputs["batch"])
    none, block = (DR.trace_step(DR.build_train_step(
        cfg, ms, sh, torch.float32, remat=r), args)
        for r in ("none", "block"))
    resid = 4 * 64 * cfg.d_model * 2                     # one block input
    assert block["saved_bytes"] >= 8 * resid
    assert block["saved_bytes"] < none["saved_bytes"] / 2
    assert block["flops"] > none["flops"]


@pytest.mark.timeout(600)
def test_smoke_train_collectives_against_the_reference_hlo():
    """minitron-4b's smoke config, 4 × 64 tokens, one training step
    (block remat) on a (2, 2) mesh: the port's collective wire bytes a
    device against the reference's ``parse_hlo`` of its step.

    The two partitioners (DTensor's per-op rules, GSPMD's whole-program
    one) choose their own schedules, so the kinds are held at the ratios
    this cell reads, ± 0.03:

    * all-gather 0.907: the same 89 gathers (the sequence-sharded
      activations before each matmul, the FSDP weights), in the same
      places;
    * the reductions (all-reduce + reduce-scatter) 0.466: the reference
      all-reduces each gradient (2b(g−1)/g) where the port reduce-scatters
      it to its parameter's shard (b(g−1)/g), half the wire by the
      formulas;
    * all-to-all 0.308: DTensor moves a shard from one dim to another in
      5 of them where GSPMD issues 20 (its own re-layouts of the
      activations between the sequence- and head-sharded forms);
    * all of them 0.628.

    Also: the port's bytes by mesh axis and by call site each add up to
    its bytes by kind."""
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    out = subprocess.run(
        [sys.executable, "-c", _REF_COLLECTIVES, "minitron-4b", "2", "2",
         "4", "64"], env=env, capture_output=True, text=True, timeout=500)
    assert out.returncode == 0, out.stderr[-3000:]
    ref = json.loads(out.stdout.strip().splitlines()[-1])
    cfg = smoke_config(get_config("minitron-4b"))
    got = DR.trace_collectives(cfg, ShapeConfig("smoke_train", 64, 4,
                                                "train"), LogicalMesh((2, 2)))
    k, r = got["kinds"], {n: c["bytes"] for n, c in ref.items()}
    ratios = {
        "all-gather": k["all-gather"]["bytes"] / r["all-gather"],
        "reductions": (k["all-reduce"]["bytes"]
                       + k["reduce-scatter"]["bytes"])
        / (r["all-reduce"] + r["reduce-scatter"]),
        "all-to-all": k["all-to-all"]["bytes"] / r["all-to-all"],
        "all": got["collective_bytes"] / sum(r.values()),
    }
    want = {"all-gather": 0.907, "reductions": 0.466, "all-to-all": 0.308,
            "all": 0.628}
    assert all(abs(ratios[n] - want[n]) <= 0.03 for n in want), ratios
    assert k["all-gather"]["count"] == ref["all-gather"]["count"] == 89
    for kind, c in k.items():
        assert sum(got["axes"][kind].values()) == pytest.approx(c["bytes"])
    assert sum(sum(v.values()) for v in got["sites"].values()) == \
        pytest.approx(got["collective_bytes"])
    assert not torch.distributed.is_initialized()


def test_trace_collectives_follows_the_remat():
    """``trace_collectives(remat=)`` traces the step it is given: block
    remat's recompute issues the forward's collectives again in the
    backward (its activation gathers, its reduce-scatters to the
    sequence shards), so it puts more bytes of each of those kinds on
    the wire than ``remat="none"``, and no fewer of any."""
    cfg = smoke_config(get_config("minitron-4b"))
    sh = ShapeConfig("smoke_train", 64, 4, "train")
    none, block = (DR.trace_collectives(cfg, sh, LogicalMesh((2, 2)),
                                        remat=r)["kinds"]
                   for r in ("none", "block"))
    for kind in ("all-gather", "reduce-scatter"):
        assert block[kind]["bytes"] > none[kind]["bytes"], kind
    assert all(block[k]["bytes"] >= none[k]["bytes"] for k in block)

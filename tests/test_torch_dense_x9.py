"""The nine-product f32 matrix product (``kernels/dense_x9.py``) on the CPU.

* The split is exact: hi + mid + lo == w in float64, each plane bf16, for
  normal values from 1e-30 to 1e30 of both signs, powers of two and their
  neighbours, and zeros.
* The plain nine-product version is within the error bound of f32
  accumulation of a float64 product.
* ``ops.dense``'s gate: the plain ``x @ W``, bitwise, for CPU tensors,
  grad-enabled calls, bf16 weights and weights under ``MIN_ELEMS``.
* ``with_planes``: on the meta device the gateway's configuration gives
  planes to its six stacked leaves and its head, ``bookinfo-65``'s to
  none; a planed tree decodes bitwise as the plain one on the CPU.
The kernel itself runs in ``tests/test_torch_cuda.py`` (marker ``gpu``).
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.base import ModelConfig, get_config, smoke_config
from repro_torch.core import interpose
from repro_torch.kernels import dense_x9 as x9
from repro_torch.kernels import ops
from repro_torch.models import model

ROOT = Path(__file__).resolve().parents[1]
U = 2.0 ** -24


def _model_config(name: str) -> ModelConfig:
    """A benchmark configuration's model, as the harness builds it."""
    m = json.loads((ROOT / "xlbench" / "configs" / f"{name}.json")
                   .read_text())["model"]
    keys = ("name", "family", "n_layers", "d_model", "n_heads", "n_kv_heads",
            "d_ff", "vocab", "head_dim", "ffn_act", "rope_theta", "norm_eps",
            "dtype")
    return ModelConfig(**{k: m[k] for k in keys})


def _assert_exact(w: torch.Tensor) -> None:
    p = x9.split_planes(w)
    assert p.dtype == torch.bfloat16 and p.shape == (3, *w.shape)
    assert torch.equal(p[0].double() + p[1].double() + p[2].double(),
                       w.double())


@pytest.mark.parametrize("exp10", range(-30, 31, 5))
def test_the_split_is_exact_at_every_scale(exp10):
    rng = np.random.default_rng(exp10 + 100)
    sig = rng.uniform(1.0, 10.0, (64, 48)) * rng.choice([-1.0, 1.0],
                                                         (64, 48))
    _assert_exact(torch.from_numpy(sig * 10.0 ** exp10).float())


def test_the_split_is_exact_at_powers_of_two_their_neighbours_and_zeros():
    twos = torch.tensor([2.0 ** e for e in range(-99, 100)],
                        dtype=torch.float32)
    vals = torch.cat([twos, torch.nextafter(twos, torch.zeros(1)),
                      torch.nextafter(twos, torch.full((1,), np.inf)),
                      torch.tensor([0.0, -0.0, 1.0 - U, 1.0 + 2 * U])])
    vals = torch.cat([vals, -vals])
    w = vals.reshape(-1, 2)
    _assert_exact(w)
    planes = x9.split_planes(torch.tensor([[0.0, -0.0]]))
    assert not planes.float().any()


@pytest.mark.parametrize("shape", [(128, 256, 384), (7, 96, 40),
                                   (64, 1024, 136), (256, 64, 8)])
def test_the_plain_nine_products_are_within_f32_accumulation(shape):
    M, K, N = shape
    g = torch.Generator().manual_seed(M * K + N)
    x = torch.randn((M, K), generator=g)
    w = torch.randn((K, N), generator=g) / K ** 0.5
    got = x9.dense_x9(x, x9.split_planes(w))
    want = x.double() @ w.double()
    bound = 1.01 * (K + 9) * U * (x.double().abs() @ w.double().abs())
    assert got.dtype == torch.float32 and got.shape == (M, N)
    assert bool(((got.double() - want).abs() <= bound).all())


def test_the_plain_version_takes_leading_axes():
    g = torch.Generator().manual_seed(3)
    x = torch.randn((4, 1, 32), generator=g)
    planes = x9.split_planes(torch.randn((32, 16), generator=g))
    assert torch.equal(x9.dense_x9(x, planes),
                       x9.dense_x9(x.reshape(4, 32), planes)
                       .reshape(4, 1, 16))


def _holder(K=64, N=32, seed=0):
    w = torch.randn((K, N), generator=torch.Generator().manual_seed(seed))
    return w, x9.X9Weight(w, x9.split_planes(w))


def test_the_gate_is_the_plain_product_on_the_cpu():
    w, h = _holder()
    x = torch.randn((5, 1, 64))
    n0 = ops.LAUNCHES["dense_x9"]
    assert not ops.takes_x9(x, h)
    assert torch.equal(ops.dense(x, h), x @ w)
    assert torch.equal(ops.dense(x, w), x @ w)
    assert ops.LAUNCHES["dense_x9"] == n0


def test_the_gate_is_the_plain_product_under_autograd():
    w, h = _holder(seed=1)
    x = torch.randn((3, 64), requires_grad=True)
    assert not ops.takes_x9(x, h)
    y = ops.dense(x, h)
    assert torch.equal(y, x @ w)
    y.sum().backward()
    assert torch.equal(x.grad, torch.ones(3, 32) @ w.T)


def test_bf16_and_small_weights_get_no_planes():
    big = torch.zeros((1024, 1024))
    assert x9.eligible(big)
    assert not x9.eligible(big.to(torch.bfloat16))
    assert not x9.eligible(torch.zeros((1024, 1023)))        # N % 8
    assert not x9.eligible(torch.zeros((1022, 1024)))        # K % 4
    assert not x9.eligible(torch.zeros((512, 1024)))         # < 2^20
    params = {"head": torch.zeros((128, 4096), dtype=torch.bfloat16),
              "blocks": {"ffn": {"w_in": torch.zeros((2, 256, 256))}}}
    planed, roots = x9.with_planes(params)
    assert roots == []
    assert planed["head"] is params["head"]
    assert planed["blocks"]["ffn"]["w_in"] is params["blocks"]["ffn"]["w_in"]
    x = torch.randn((2, 128), dtype=torch.bfloat16)
    assert torch.equal(ops.dense(x, planed["head"]), x @ params["head"])


def _planed_leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _planed_leaves(v, f"{path}.{k}" if path else k)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _planed_leaves(v, f"{path}.{i}")
    elif isinstance(tree, x9.X9Weight):
        yield path, tree


def test_the_gateway_gets_planes_on_its_six_stacked_leaves_and_head():
    cfg = _model_config("minitron-4b-gateway")
    params = model.init_params(cfg, torch.Generator(), device="meta")
    planed, roots = x9.with_planes(params)
    got = dict(_planed_leaves(planed))
    assert set(got) == {"blocks.attn.wq", "blocks.attn.wk", "blocks.attn.wv",
                        "blocks.attn.wo", "blocks.ffn.w_in",
                        "blocks.ffn.w_out", "head"}
    assert len(roots) == 7
    for path, h in got.items():
        w = h.w
        assert h.planes.shape == (*w.shape[:-2], 3, *w.shape[-2:])
        assert h.planes.dtype == torch.bfloat16
        assert (w.dim() == 3) == path.startswith("blocks.")
    L, D, F = cfg.n_layers, cfg.d_model, cfg.d_ff
    HD, KD = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    weights = L * (2 * D * HD + 2 * D * KD + 2 * D * F) \
        + D * cfg.vocab_padded
    assert sum(h.planes.numel() for h in roots) == 3 * weights
    assert planed["embed"] is params["embed"]


def test_bookinfo_gets_no_planes():
    cfg = _model_config("bookinfo-65")
    params = model.init_params(cfg, torch.Generator(), device="meta")
    planed, roots = x9.with_planes(params)
    assert roots == [] and not list(_planed_leaves(planed))


def test_a_stacked_weight_slices_and_refreshes_its_planes():
    w = torch.randn((3, 16, 24))
    h = x9.X9Weight(w, x9.split_planes(w))
    assert torch.equal(h[1].w, w[1])
    assert torch.equal(h[1].planes, x9.split_planes(w[1]))
    parts = h.unbind(0)
    assert len(parts) == 3 and torch.equal(parts[2].planes, h.planes[2])
    assert not h.refresh()
    w[2].mul_(3.0)                           # an in-place update of the stack
    assert h.refresh()
    assert torch.equal(h.planes, x9.split_planes(w))


def test_a_planed_tree_decodes_bitwise_as_the_plain_one(monkeypatch):
    monkeypatch.setattr(x9, "MIN_ELEMS", 1)
    cfg = smoke_config(get_config("minitron-4b"))
    cfg = type(cfg)(**{**cfg.__dict__, "dtype": "float32"})
    params = model.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    planed, roots = x9.with_planes(params)
    ffn = ("w_in", "w_out") + (("w_gate",) if cfg.ffn_act == "swiglu"
                               else ())
    assert {p for p, _ in _planed_leaves(planed)} == \
        {f"blocks.attn.{k}" for k in x9.WEIGHTS["attn"]} \
        | {f"blocks.ffn.{k}" for k in ffn} | {"head"}
    outs = []
    for tree in (params, planed):
        cache = model.init_cache(cfg, 3, 8, device="cpu")
        tok = torch.tensor([[5], [7], [11]])
        lens = torch.tensor([0, 2, 4], dtype=torch.int32)
        logits, cache = model.decode_step(cfg, tree, tok, lens, cache)
        outs.append((logits, cache))
    assert torch.equal(outs[0][0], outs[1][0])
    for a, b in zip(torch.utils._pytree.tree_leaves(outs[0][1]),
                    torch.utils._pytree.tree_leaves(outs[1][1])):
        assert torch.equal(a, b)


def test_the_engine_makes_no_planes_off_the_card():
    cfg = _model_config("bookinfo-65")
    eng = interpose.Engine(cfg, 2, 2, 8, device="cpu")
    params = {"head": torch.zeros((1024, 1024))}
    assert eng.serving_params(params) is params
    assert (eng.plane_weights, eng.plane_bytes) == (0, 0)


def test_the_engine_keeps_one_plane_set_a_params_object(monkeypatch):
    """Params A, then B, then A again after an in-place update of A: A's
    serving tree and planes are the ones made at its first call (the
    captured programs read those), split again from the update; one set
    a params object, none made anew at the switch back."""
    cfg = _model_config("bookinfo-65")
    eng = interpose.Engine(cfg, 2, 2, 8, device="cpu")
    # planes are made on the card only; the cache's logic is the same
    monkeypatch.setattr(eng, "device", torch.device("cuda"))
    A, B = ({"head": torch.randn((1024, 1024),
                                 generator=torch.Generator().manual_seed(s))}
            for s in (0, 1))
    a = eng.serving_params(A)
    planes = a["head"].planes
    b = eng.serving_params(B)
    assert b is not a and b["head"].w is B["head"]
    with torch.no_grad():
        A["head"].mul_(3.0)
    again = eng.serving_params(A)
    assert again is a and again["head"].planes is planes
    assert torch.equal(planes, x9.split_planes(A["head"]))
    assert (eng.plane_weights, eng.plane_bytes) == (2, 2 * 3 * 2 * 1024**2)

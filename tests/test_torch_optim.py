"""The port's optimizer, schedule and gradient compression against the
JAX reference (``repro/optim/``) on the same numpy-seeded inputs: AdamW
steps (params, both moments, the step and grad_norm) within f32 rounding
(the global norm's sums run in another order: an ulp, and through the
clip scale a few ulps in the update) and within one bf16 rounding on a
bf16 leaf, with and without clipping; ``update_router_bias``;
``warmup_cosine`` and ``constant`` at steps 0..50 (within one f32 ulp:
the cosine's libm); int8 ``quantize``,
``compress_pytree`` / ``decompress_pytree`` bit-exact, and the error
feedback unbiased over steps (the dequantised sum plus the last residual
is the sum of the gradients)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as JA
from repro.optim import compression as JC
from repro.optim import schedules as JS
from repro_torch.optim import adamw as TA
from repro_torch.optim import compression as TC
from repro_torch.tree import leaves


def _trees(seed, scale=1.0):
    rng = np.random.RandomState(seed)
    tree = {"w": rng.randn(6, 5).astype(np.float32) * scale,
            "blocks": {"a": rng.randn(3, 4, 4).astype(np.float32) * scale},
            "first": [rng.randn(7).astype(np.float32) * scale]}
    return tree


def _torch(tree, dtype=None):
    return jax.tree.map(lambda a: torch.tensor(np.asarray(a), dtype=dtype),
                        tree)


@pytest.mark.parametrize("gscale,lr_scale", [(0.01, 0.5), (30.0, 1.0)])
def test_adamw_steps_match_reference(gscale, lr_scale):
    """Three steps (clipped when gscale is large): every parameter and
    moment within 4e-6 relative, or 1e-6 of its leaf's largest value
    where a moment's terms cancel; grad_norm within an ulp; the step
    equal."""
    cfg = dict(lr=1e-2, weight_decay=0.1, clip_norm=1.0)
    jp = jax.tree.map(jnp.asarray, _trees(0))
    tp = _torch(_trees(0))
    js, ts = JA.init(jp), TA.init(tp)
    assert ts.step.dtype == torch.int32 and all(
        m.dtype == torch.float32 for m in leaves(ts.m))
    for i in range(3):
        g = _trees(10 + i, gscale)
        jp, js, jst = JA.apply(jp, jax.tree.map(jnp.asarray, g), js,
                               JA.AdamWConfig(**cfg), lr_scale)
        tp, ts, tst = TA.apply(tp, _torch(g), ts, TA.AdamWConfig(**cfg),
                               torch.tensor(lr_scale))
        np.testing.assert_allclose(float(tst["grad_norm"]),
                                   float(jst["grad_norm"]), rtol=4e-7)
        assert int(ts.step) == int(js.step) == i + 1
        for want, got in ((jp, tp), (js.m, ts.m), (js.v, ts.v)):
            for w, t in zip(jax.tree.leaves(want), leaves(got)):
                w = np.asarray(w)
                np.testing.assert_allclose(t.numpy(), w, rtol=4e-6,
                                           atol=1e-6 * np.abs(w).max())


def test_adamw_bf16_leaf_updates_in_f32_and_casts_on_write():
    rng = np.random.RandomState(3)
    p = rng.randn(64).astype(np.float32)
    g = rng.randn(64).astype(np.float32)
    jp = {"x": jnp.asarray(p, jnp.bfloat16)}
    tp = {"x": torch.tensor(p).to(torch.bfloat16)}
    js, ts = JA.init(jp), TA.init(tp)
    jp, js, _ = JA.apply(jp, {"x": jnp.asarray(g, jnp.bfloat16)}, js,
                         JA.AdamWConfig(lr=1e-2))
    tp, ts, _ = TA.apply(tp, {"x": torch.tensor(g).to(torch.bfloat16)}, ts,
                         TA.AdamWConfig(lr=1e-2))
    assert tp["x"].dtype == torch.bfloat16 and ts.m["x"].dtype == \
        torch.float32
    np.testing.assert_array_equal(ts.m["x"].numpy(), np.asarray(js.m["x"]))
    np.testing.assert_allclose(tp["x"].float().numpy(),
                               np.asarray(jp["x"], np.float32),
                               rtol=2 ** -8, atol=0)


def test_bias_correction_is_an_f32_power():
    """b1 ** step in f32 (the reference's), not a Python f64 power: at
    step 7 the two differ in the last f32 bits of the bias correction."""
    s = TA.init({"x": torch.zeros(1)})
    s = s._replace(step=torch.tensor(6, dtype=torch.int32))
    p, g = {"x": torch.ones(1)}, {"x": torch.full((1,), 0.3)}
    _, _, _ = TA.apply(p, g, s, TA.AdamWConfig())
    jp, js = {"x": jnp.ones(1)}, JA.init({"x": jnp.zeros(1)})
    js = js._replace(step=jnp.int32(6))
    jp, _, _ = JA.apply(jp, {"x": jnp.full((1,), 0.3)}, js, JA.AdamWConfig())
    np.testing.assert_array_equal(p["x"].numpy(), np.asarray(jp["x"]))


def test_update_router_bias_matches_reference():
    rng = np.random.RandomState(4)
    bias = rng.randn(16).astype(np.float32) * 1e-3
    for load in (rng.randint(0, 50, 16).astype(np.int32),
                 np.full(16, 7, np.int32)):
        want = JA.update_router_bias(jnp.asarray(bias), jnp.asarray(load))
        got = TA.update_router_bias(torch.tensor(bias), torch.tensor(load))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("warmup,total", [(10, 50), (0, 30), (20, 20)])
def test_schedules_match_reference(warmup, total):
    from repro_torch.optim import schedules as TS
    for step in range(51):
        js, ts = jnp.int32(step), torch.tensor(step, dtype=torch.int32)
        want = JS.warmup_cosine(js, warmup=warmup, total=total)
        got = TS.warmup_cosine(ts, warmup=warmup, total=total)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=2e-7,
                                   atol=1e-7)
        assert float(TS.constant(ts, 0.5)) == float(JS.constant(js, 0.5))


def test_quantize_and_compress_bit_exact():
    rng = np.random.RandomState(5)
    g = {"a": rng.randn(33, 7).astype(np.float32),
         "b": [rng.randn(5).astype(np.float32) * 1e-3]}
    jef, tef = JC.init(jax.tree.map(jnp.asarray, g)), TC.init(_torch(g))
    for _ in range(3):
        jq, js_, jef = JC.compress_pytree(jax.tree.map(jnp.asarray, g), jef)
        tq, ts_, tef = TC.compress_pytree(_torch(g), tef)
        for want, got in ((jq, tq), (js_, ts_), (jef.residual,
                                                 tef.residual)):
            for w, t in zip(jax.tree.leaves(want), leaves(got)):
                assert str(t.dtype).split(".")[-1] == str(w.dtype)
                np.testing.assert_array_equal(t.numpy(), np.asarray(w))
        for w, t in zip(jax.tree.leaves(JC.decompress_pytree(jq, js_)),
                        leaves(TC.decompress_pytree(tq, ts_))):
            np.testing.assert_array_equal(t.numpy(), np.asarray(w))


def test_error_feedback_is_unbiased_over_steps():
    rng = np.random.RandomState(6)
    ef = TC.init({"g": torch.zeros(256)})
    total, sent = torch.zeros(256), torch.zeros(256)
    for _ in range(20):
        g = {"g": torch.tensor(rng.randn(256).astype(np.float32))}
        q, s, ef = TC.compress_pytree(g, ef)
        total += g["g"]
        sent += TC.decompress_pytree(q, s)["g"]
    np.testing.assert_allclose((sent + ef.residual["g"]).numpy(),
                               total.numpy(), rtol=0, atol=1e-5)


@pytest.fixture
def one_rank_group(tmp_path):
    """A one-rank ``gloo`` group through a ``FileStore`` in ``tmp_path``,
    made and torn down here."""
    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def test_cross_pod_allreduce_raises_naming_the_roadmap():
    """The int8 all-reduce is ported (four ranks in
    ``tests/test_torch_distributed.py``); without a process group it
    raises torch's own error rather than running on one device."""
    with pytest.raises(ValueError, match="process group"):
        TC.cross_pod_allreduce({"g": torch.zeros(2)},
                               TC.init({"g": torch.zeros(2)}))


def test_cross_pod_allreduce_on_one_rank_is_the_int8_round_trip(
        one_rank_group):
    rng = np.random.RandomState(3)
    g = {"g": torch.tensor(rng.randn(33).astype(np.float32))}
    ef = TC.init(g)
    red, ef2 = TC.cross_pod_allreduce(g, ef, group=one_rank_group)
    q, s, ef3 = TC.compress_pytree(g, ef)
    assert torch.equal(red["g"], TC.decompress_pytree(q, s)["g"])
    assert torch.equal(ef2.residual["g"], ef3.residual["g"])

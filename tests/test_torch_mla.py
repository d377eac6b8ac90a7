"""The port's MLA (DeepSeek-V2 multi-head latent attention,
``models/attention.py``) against the JAX reference's on the same numpy
inputs, with the reference's weights carried across by
``convert.params_from_jax``: ``mla_full`` with its cache write,
``mla_decode`` (the absorbed latent-space decode) at ragged lengths over
a filled cache, the query-chunked attention against the unchunked one,
and ``attn_full`` / ``attn_decode`` dispatching on ``cfg.mla``.  At the
smoke config of deepseek-v2-236b (q_lora 32, kv_lora 32, rope 8) and the
same without q compression.

Tolerance: rtol = atol = 1e-4 (f32, summation order differs between
XLA:CPU and torch)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import smoke_config as jsmoke
from repro.models import attention as JA
from repro_torch import convert
from repro_torch.configs import get_config, smoke_config
from repro_torch.models import attention as TA
from repro_torch.models.layers import Draw

TOL = dict(rtol=1e-4, atol=1e-4)
CPU = torch.device("cpu")
B, S = 3, 24


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


@pytest.fixture(scope="module", params=[32, 0], ids=["q_lora", "no_q_lora"])
def mla(request):
    j = jsmoke(jget_config("deepseek-v2-236b"))
    t = smoke_config(get_config("deepseek-v2-236b"))
    j = dataclasses.replace(j, mla=dataclasses.replace(
        j.mla, q_lora_rank=request.param))
    t = dataclasses.replace(t, mla=dataclasses.replace(
        t.mla, q_lora_rank=request.param))
    jp = JA.init_attn(jax.random.PRNGKey(7), j, jnp.float32)
    return j, t, jp, convert.params_from_jax(_np(jp), CPU)


def test_mla_init_layout_matches_reference(mla):
    j, t, jp, _ = mla
    gen = torch.Generator().manual_seed(0)
    own = TA.init_attn(Draw(gen, torch.float32, CPU), t)
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    jc = JA.init_attn_cache(j, B, S, jnp.float32)
    tc = TA.init_attn_cache(t, B, S, torch.float32, CPU)
    assert {k: tuple(v.shape) for k, v in tc.items()} == \
        {k: tuple(v.shape) for k, v in jc.items()}


def test_mla_full_and_cache_write_match_reference(mla):
    j, t, jp, tp = mla
    x = np.random.RandomState(1).randn(B, S, j.d_model).astype(np.float32)
    pos = np.arange(S)[None]
    jc = JA.init_attn_cache(j, B, S + 4, jnp.float32)
    want, jc = JA.attn_full(j, jp, jnp.asarray(x), jnp.asarray(pos),
                            cache=jc)
    tc = TA.init_attn_cache(t, B, S + 4, torch.float32, CPU)
    got, tc2 = TA.attn_full(t, tp, torch.from_numpy(x),
                            torch.from_numpy(pos), cache=tc)
    assert tc2 is tc                       # written in place
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for name in ("ckv", "krope"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   **TOL)


def test_mla_decode_at_ragged_lengths_matches_reference(mla):
    j, t, jp, tp = mla
    rng = np.random.RandomState(2)
    x = rng.randn(B, 1, j.d_model).astype(np.float32)
    lengths = np.array([0, 9, S - 1], np.int32)
    cache = {"ckv": rng.randn(B, S, j.mla.kv_lora_rank),
             "krope": rng.randn(B, S, j.mla.qk_rope_head_dim)}
    cache = {k: v.astype(np.float32) for k, v in cache.items()}
    want, jc = JA.attn_decode(j, jp, jnp.asarray(x), jnp.asarray(lengths),
                              {k: jnp.asarray(v) for k, v in cache.items()})
    tc = convert.params_from_jax(cache, CPU)
    got, _ = TA.attn_decode(t, tp, torch.from_numpy(x),
                            torch.from_numpy(lengths), tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for name in ("ckv", "krope"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   **TOL)


@pytest.mark.parametrize("q_chunk", [4, 8])
def test_chunked_mla_attention_matches_reference(mla, q_chunk):
    """Query chunks (the full-width prefill runs 512-row ones at S = 4096,
    ``q_chunk_for``) give the unchunked attention, as the reference's."""
    j, _, _, _ = mla
    m, H = j.mla, j.n_heads
    rng = np.random.RandomState(q_chunk)
    r = lambda *shape: rng.randn(*shape).astype(np.float32)
    args = (r(B, S, H, m.qk_nope_head_dim), r(B, S, H, m.qk_rope_head_dim),
            r(B, S, H, m.qk_nope_head_dim), r(B, S, m.qk_rope_head_dim),
            r(B, S, H, m.v_head_dim))
    scale = 1.0 / np.sqrt(m.qk_head_dim)
    want = JA._mla_sdpa(*map(jnp.asarray, args), jnp.float32(scale),
                        q_chunk=q_chunk)
    ta = [torch.from_numpy(a) for a in args]
    got = TA._mla_sdpa(*ta, scale, q_chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.numpy(),
                               TA._mla_sdpa(*ta, scale, 0).numpy(),
                               rtol=1e-6, atol=1e-6)


def test_q_chunk_follows_the_reference():
    assert [TA.q_chunk_for(s) for s in (64, 4095, 4096, 8192, 8193)] == \
        [0, 0, 512, 512, 256]

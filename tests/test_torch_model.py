"""The port's decode model against the JAX reference at the full width of
``xlb-service-model`` (2 layers, d_model 128, 4 heads / 2 KV heads, d_ff
256, vocab 512), with the reference's weights carried across as numpy.

Tolerance: logits and KV caches within rtol = atol = 1e-4 (f32 matmul
summation order differs between XLA:CPU and torch)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.xlb_microbench import XLB_SERVICE_MODEL as JCFG
from repro.models import model as JM
from repro_torch import convert
from repro_torch.configs import XLB_SERVICE_MODEL as TCFG
from repro_torch.models import model as TM

TOL = dict(rtol=1e-4, atol=1e-4)
CPU = torch.device("cpu")


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


@pytest.fixture(scope="module")
def weights():
    jp = JM.init_params(JCFG, jax.random.PRNGKey(0), jnp.float32)
    return jp, convert.params_from_jax(_np(jp), CPU)


def test_config_matches_reference():
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff", "vocab",
              "head_dim", "ffn_act", "rope_theta", "norm_eps", "dtype",
              "vocab_padded"):
        assert getattr(TCFG, f) == getattr(JCFG, f), f


def test_params_from_jax_keeps_layout(weights):
    jp, tp = weights
    flat_j = jax.tree_util.tree_leaves_with_path(jp)
    assert len(flat_j) == len(jax.tree_util.tree_leaves(
        jax.tree.map(lambda t: 0, tp, is_leaf=torch.is_tensor)))
    for path, leaf in flat_j:
        t = tp
        for k in path:
            t = t[k.key]
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))
    own = TM.init_params(TCFG, torch.Generator().manual_seed(0),
                         torch.float32, CPU)
    assert jax.tree.map(lambda t: tuple(t.shape), own,
                        is_leaf=torch.is_tensor) == \
        jax.tree.map(lambda a: tuple(a.shape), jp)


def _run(jp, tp, steps, B=12, max_len=16, seed=0):
    """Decode ``steps`` tokens from ragged starting lengths on both sides;
    each step feeds the reference's argmax back to both."""
    rng = np.random.RandomState(seed)
    tok = rng.randint(0, JCFG.vocab, (B, 1)).astype(np.int32)
    lengths = rng.randint(0, max_len - steps, B).astype(np.int32)
    jc = JM.init_cache(JCFG, B, max_len, jnp.float32)
    tc = TM.init_cache(TCFG, B, max_len, torch.float32, CPU)
    for _ in range(steps):
        jl, jc = JM.decode_step(JCFG, jp, jnp.asarray(tok),
                                jnp.asarray(lengths), jc)
        tl, tc = TM.decode_step(TCFG, tp, torch.from_numpy(tok),
                                torch.from_numpy(lengths), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
        lengths = lengths + 1
    for name in ("k", "v"):
        np.testing.assert_allclose(
            tc["blocks"]["self"][name].numpy(),
            np.asarray(jc["blocks"]["self"][name]), **TOL)
    return tl


def test_one_decode_step_logits_and_cache(weights):
    tl = _run(*weights, steps=1)
    assert tl.shape == (12, TCFG.vocab_padded)
    assert torch.isfinite(tl).all()


def test_decode_steps_at_ragged_lengths(weights):
    _run(*weights, steps=4, seed=1)


def test_decode_rejects_write_past_the_cache(weights):
    _, tp = weights
    tc = TM.init_cache(TCFG, 2, 4, torch.float32, CPU)
    with pytest.raises(IndexError):
        TM.decode_step(TCFG, tp, torch.zeros((2, 1), dtype=torch.int32),
                       torch.tensor([1, 4], dtype=torch.int32), tc)


def test_registry_serves_the_service_model_as_the_reference():
    """``get_config("xlb-service-model")`` in the port is the reference's
    registered config, field by field."""
    import dataclasses

    from repro.configs import get_config as jget_config
    from repro_torch.configs import get_config
    j, t = jget_config("xlb-service-model"), get_config("xlb-service-model")
    assert t is TCFG
    for f in dataclasses.fields(t):
        got, want = getattr(t, f.name), getattr(j, f.name)
        if dataclasses.is_dataclass(want):   # a sub-config: field by field
            got, want = dataclasses.asdict(got), dataclasses.asdict(want)
        assert got == want, f.name


def test_bank_of_anthos_matches_reference():
    from repro.configs import BANK_OF_ANTHOS as JG
    from repro_torch.configs import BANK_OF_ANTHOS as TG
    assert (TG.name, TG.services, TG.instances, TG.edges) == \
        (JG.name, JG.services, JG.instances, JG.edges)
    assert TG.chain() == JG.chain()

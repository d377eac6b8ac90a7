"""The port's config registry (``repro_torch/configs``) against the JAX
reference's (``repro/configs``): every registered arch, its full and
reduced (smoke) configs field by field, the parameter counts, the input
shapes and which (arch, shape) cells apply.  Pure data: equal, not close.
"""

import dataclasses

import pytest
import torch

from repro import configs as J
from repro_torch import configs as T
from repro_torch.models import model as TM

ARCHS = J.list_configs()


def _fields(cfg) -> dict:
    return dataclasses.asdict(cfg)


def test_list_configs_matches_reference():
    assert T.list_configs() == ARCHS
    assert T.ASSIGNED_ARCHS == J.ASSIGNED_ARCHS
    assert set(J.ASSIGNED_ARCHS) < set(ARCHS)


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch):
    j, t = J.get_config(arch), T.get_config(arch)
    for jc, tc in ((j, t), (J.smoke_config(j), T.smoke_config(t))):
        assert _fields(tc) == _fields(jc)
        for prop in ("vocab_padded", "attn_free", "sub_quadratic",
                     "is_hybrid"):
            assert getattr(tc, prop) == getattr(jc, prop), (arch, prop)
        assert tc.moe.enabled == jc.moe.enabled
        if jc.mla is not None:
            assert tc.mla.qk_head_dim == jc.mla.qk_head_dim
        if jc.ssm is not None:
            assert tc.ssm.n_heads(tc.d_model) == jc.ssm.n_heads(jc.d_model)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_match_reference(arch):
    j, t = J.get_config(arch), T.get_config(arch)
    for jc, tc in ((j, t), (J.smoke_config(j), T.smoke_config(t))):
        assert tc.param_count() == jc.param_count()
        assert tc.active_param_count() == jc.active_param_count()
        assert tc.active_param_count() <= tc.param_count()


@pytest.mark.parametrize("arch", ARCHS)
def test_shape_applicable_matches_reference(arch):
    assert {k: _fields(v) for k, v in T.SHAPES.items()} == \
        {k: _fields(v) for k, v in J.SHAPES.items()}
    for name in J.SHAPES:
        assert T.shape_applicable(T.get_config(arch), T.SHAPES[name]) == \
            J.shape_applicable(J.get_config(arch), J.SHAPES[name])


def test_unknown_arch_raises_as_the_reference():
    with pytest.raises(KeyError, match="unknown arch 'gpt-2'"):
        T.get_config("gpt-2")
    with pytest.raises(KeyError, match="unknown arch 'gpt-2'"):
        J.get_config("gpt-2")


def _shapes(tree):
    """Dicts and lists of (shape, dtype name) in place of the leaves."""
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_shapes(v) for v in tree]
    return tuple(tree.shape), str(tree.dtype).split(".")[-1]


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "arctic-480b",
                                  "jamba-v0.1-52b", "whisper-large-v3"])
def test_unported_families_raise_naming_the_roadmap(arch):
    """Every family is ported now, the audio one (whisper) last: the moe,
    hybrid and audio archs build their smoke configs in the reference's
    tree (``blocks``, deepseek's ``first``, the MLA, MoE and ``pos{i}``
    leaves, whisper's ``enc`` and ``norm_x`` / ``cross``), leaf for leaf
    in shape and dtype.  A family outside ``FAMILIES`` is still refused,
    naming ROADMAP.md item 12."""
    cfg = T.smoke_config(T.get_config(arch))
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(NotImplementedError, match="ROADMAP.md item 12"):
        TM.init_params(dataclasses.replace(cfg, family="video"), gen,
                       torch.float32, "cpu")
    import jax
    import jax.numpy as jnp
    from repro.models import model as JM
    jcfg = J.smoke_config(J.get_config(arch))
    want = jax.eval_shape(lambda k: JM.init_params(jcfg, k, jnp.float32),
                          jax.random.PRNGKey(0))
    assert _shapes(TM.init_params(cfg, gen, torch.float32, "cpu")) == \
        _shapes(want)

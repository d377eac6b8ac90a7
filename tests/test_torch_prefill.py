"""The port's serving path of the model stack (prefill, then decode)
against the JAX reference, for the reduced configs of minitron-4b,
granite-20b (MQA), internlm2-20b, yi-34b (rope theta 5e6) and
chameleon-34b (vlm: a dense decoder) (dense GQA: prefill through
``ops.flash_attention``, decode through ``ops.decode_attention``),
mamba2-2.7b (SSD prefill through ``ops.ssd_scan``, recurrent decode) and
the MoE family: arctic-480b (GQA, MoE with a dense residual),
deepseek-v2-236b (MLA, a dense first layer, shared experts) and
jamba-v0.1-52b (one period of 7 mamba layers and 1 attention layer, MoE
on odd layers), the MoE dispatch taking its slots from
``ops.relay_slots``; with the reference's weights carried across as
numpy.  On the CPU the wrappers run their plain versions.

Tolerance: f32 logits and every cache leaf (KV caches, MLA latents, SSM
states) within rtol = atol = 1e-4 (summation order differs between
XLA:CPU and torch).  Prompts of 31, 32 and 64 tokens: the smoke SSD chunk
is 32, so 31 is one short chunk and 64 crosses a chunk boundary."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import smoke_config as jsmoke
from repro.models import model as JM
from repro_torch import convert
from repro_torch.configs import get_config, smoke_config
from repro_torch.launch import prefill_decode
from repro_torch.models import model as TM
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import Draw

TOL = dict(rtol=1e-4, atol=1e-4)
CPU = torch.device("cpu")
ARCHS = ("minitron-4b", "mamba2-2.7b", "xlb-service-model", "granite-20b",
         "internlm2-20b", "yi-34b", "chameleon-34b", "arctic-480b",
         "deepseek-v2-236b", "jamba-v0.1-52b")
MOE_ARCHS = ARCHS[-3:]
B, STEPS = 2, 3


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    jcfg = jsmoke(jget_config(request.param))
    tcfg = smoke_config(get_config(request.param))
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    return jcfg, tcfg, jp, convert.params_from_jax(_np(jp), CPU)


def test_configs_match_reference():
    fields = ("family", "n_layers", "d_model", "n_heads", "n_kv_heads",
              "d_ff", "vocab", "head_dim", "ffn_act", "rope_theta",
              "norm_eps", "dtype", "vocab_padded", "attn_free", "source")
    for arch in ARCHS:
        for full in (False, True):
            j = jget_config(arch) if full else jsmoke(jget_config(arch))
            t = get_config(arch) if full else smoke_config(get_config(arch))
            assert t.name == j.name
            for f in fields:
                assert getattr(t, f) == getattr(j, f), (arch, f)
            if j.ssm is not None:
                for f in ("d_state", "expand", "head_dim", "n_groups",
                          "conv_width", "chunk"):
                    assert getattr(t.ssm, f) == getattr(j.ssm, f), (arch, f)
                assert t.ssm.n_heads(t.d_model) == j.ssm.n_heads(j.d_model)
            else:
                assert t.ssm is None


def test_params_layout_matches_reference(model):
    jcfg, tcfg, jp, tp = model
    own = TM.init_params(tcfg, torch.Generator().manual_seed(0),
                         torch.float32, CPU)
    shapes = lambda tree, leaf: jax.tree.map(
        lambda a: (tuple(a.shape), str(a.dtype).split(".")[-1]), tree,
        is_leaf=leaf)
    assert shapes(own, torch.is_tensor) == shapes(jp, None)
    if tcfg.family == "ssm":     # the same numpy draws as the reference
        for name in ("A_log", "dt_bias", "D"):
            np.testing.assert_array_equal(own["blocks"]["mamba"][name],
                                          np.asarray(jp["blocks"]["mamba"]
                                                     [name]))


def _caches_close(tcfg, tc, jc):
    """Every leaf of the port's cache against the reference's: the same
    paths (dict keys, list indices, ``SSMState`` fields), shapes and
    dtypes, and values within TOL."""
    flat = jax.tree_util.tree_flatten_with_path
    got, want = flat(tc)[0], flat(jc)[0]
    assert [jax.tree_util.keystr(p) for p, _ in got] == \
        [jax.tree_util.keystr(p) for p, _ in want], tcfg.name
    for (path, t), (_, j) in zip(got, want):
        assert tuple(t.shape) == j.shape, jax.tree_util.keystr(path)
        assert str(t.dtype).split(".")[-1] == str(j.dtype)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


@pytest.mark.parametrize("prompt", [31, 32, 64])
def test_prefill_then_decode_matches_reference(model, prompt):
    """Prefill a prompt, then decode STEPS tokens fed back from the
    reference's argmax; logits and caches after each call."""
    jcfg, tcfg, jp, tp = model
    rng = np.random.RandomState(prompt)
    tok = rng.randint(0, jcfg.vocab, (B, prompt)).astype(np.int32)
    max_len = prompt + STEPS + 1
    jc = JM.init_cache(jcfg, B, max_len, jnp.float32)
    tc = TM.init_cache(tcfg, B, max_len, torch.float32, CPU)
    jl, jc = JM.prefill(jcfg, jp, jnp.asarray(tok), jc)
    tl, tc = TM.prefill(tcfg, tp, torch.from_numpy(tok), tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _caches_close(tcfg, tc, jc)
    lengths = np.full((B,), prompt, np.int32)
    for _ in range(STEPS):
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
        jl, jc = JM.decode_step(jcfg, jp, jnp.asarray(nxt),
                                jnp.asarray(lengths), jc)
        tl, tc = TM.decode_step(tcfg, tp, torch.from_numpy(nxt),
                                torch.from_numpy(lengths), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        lengths = lengths + 1
    _caches_close(tcfg, tc, jc)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_prefill_then_ragged_decode_matches_reference(arch):
    """The MoE family: a 32-token prefill, then three decode steps at
    ragged lengths (each sequence rewrites its cache from its own
    position), logits and every cache leaf after each call."""
    jcfg, tcfg = jsmoke(jget_config(arch)), smoke_config(get_config(arch))
    jp = JM.init_params(jcfg, jax.random.PRNGKey(2), jnp.float32)
    tp = convert.params_from_jax(_np(jp), CPU)
    rng = np.random.RandomState(7)
    Bm, prompt = 3, 32
    tok = rng.randint(0, jcfg.vocab, (Bm, prompt)).astype(np.int32)
    jc = JM.init_cache(jcfg, Bm, prompt + STEPS, jnp.float32)
    tc = TM.init_cache(tcfg, Bm, prompt + STEPS, torch.float32, CPU)
    jl, jc = JM.prefill(jcfg, jp, jnp.asarray(tok), jc)
    tl, tc, metrics = TM.prefill(tcfg, tp, torch.from_numpy(tok), tc,
                                 return_metrics=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _caches_close(tcfg, tc, jc)
    n_moe = sum(tfm._is_moe_layer(tcfg, i) for i in range(tcfg.n_layers))
    assert int(metrics.load.sum()) == Bm * prompt * tcfg.moe.top_k * n_moe
    assert float(metrics.overflow_frac) == 0.0      # drop-free smoke config
    lengths = np.array([prompt, 17, prompt - 5], np.int32)
    for _ in range(STEPS):
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
        jl, jc = JM.decode_step(jcfg, jp, jnp.asarray(nxt),
                                jnp.asarray(lengths), jc)
        tl, tc = TM.decode_step(tcfg, tp, torch.from_numpy(nxt),
                                torch.from_numpy(lengths), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        _caches_close(tcfg, tc, jc)
        lengths = lengths + 1


def test_hybrid_cache_from_numpy_decodes_as_the_reference():
    """A jamba cache of random states, carried across by
    ``params_from_jax`` (its ``SSMState`` included), decodes one step
    as the reference does from the same cache."""
    arch = "jamba-v0.1-52b"
    jcfg, tcfg = jsmoke(jget_config(arch)), smoke_config(get_config(arch))
    jp = JM.init_params(jcfg, jax.random.PRNGKey(3), jnp.float32)
    tp = convert.params_from_jax(_np(jp), CPU)
    rng = np.random.RandomState(8)
    jc = jax.tree.map(lambda a: (rng.randn(*a.shape) * 0.5).astype(a.dtype),
                      JM.init_cache(jcfg, B, 12, jnp.float32))
    tc = convert.params_from_jax(jc, CPU)
    assert isinstance(tc["ssm"], tssm.SSMState)
    tok = rng.randint(0, jcfg.vocab, (B, 1)).astype(np.int32)
    lengths = np.array([3, 11], np.int32)
    jl, jc2 = JM.decode_step(jcfg, jp, jnp.asarray(tok),
                             jnp.asarray(lengths), jc)
    tl, tc = TM.decode_step(tcfg, tp, torch.from_numpy(tok),
                            torch.from_numpy(lengths), tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _caches_close(tcfg, tc, jc2)


def test_ssm_state_from_numpy_round_trips():
    jc = JM.init_cache(jsmoke(jget_config("mamba2-2.7b")), B, 8,
                       jnp.float32)
    rng = np.random.RandomState(0)
    arrays = {n: rng.randn(*getattr(jc, n).shape).astype(np.float32)
              for n in ("ssm", "conv")}
    st = convert.ssm_state_from_numpy(arrays, CPU)
    for n in ("ssm", "conv"):
        np.testing.assert_array_equal(getattr(st, n).numpy(), arrays[n])


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_runs_on_the_cpu(arch, capsys):
    prefill_decode.main(["--arch", arch, "--smoke", "--device", "cpu",
                         "--batch", "2", "--prompt", "32", "--steps", "3"])
    out = capsys.readouterr().out
    assert "prefill" in out and "tokens/s" in out


def test_init_fills_the_stack_as_stacking_did():
    """``init_params`` allocates each stacked leaf once and fills it layer
    by layer (expert weights slab by slab); from the same CPU generator it
    gives exactly the tensors that drawing every layer and then stacking
    them gave."""
    for arch in ("internlm2-20b", "mamba2-2.7b", "arctic-480b",
                 "jamba-v0.1-52b"):
        cfg = smoke_config(get_config(arch))
        got = TM.init_params(cfg, torch.Generator().manual_seed(5),
                             torch.float32, CPU)
        gen = torch.Generator().manual_seed(5)
        D, Vp = cfg.d_model, cfg.vocab_padded
        draw = Draw(gen, torch.float32, CPU)
        embed, head = draw.embed((Vp, D)), draw.dense((D, Vp))
        if cfg.attn_free:
            init = lambda: tfm._init_mamba_layer(draw, cfg, cfg.d_ff > 0)
        elif cfg.is_hybrid:
            init = lambda: tfm._init_jamba_period(draw, cfg)
        else:
            init = lambda: tfm._init_attn_layer(draw, cfg,
                                                cfg.family == "moe")
        layers = [init() for _ in range(TM.n_scan_blocks(cfg))]
        stack = lambda ls: ({k: stack([l[k] for l in ls]) for k in ls[0]}
                            if isinstance(ls[0], dict) else torch.stack(ls))
        want = {"embed": embed, "head": head, "blocks": stack(layers)}
        for name in ("embed", "head"):
            assert torch.equal(got[name], want[name]), (arch, name)
        flat = lambda t, p="": ([(p, t)] if torch.is_tensor(t) else
                                [x for k, v in t.items()
                                 for x in flat(v, f"{p}/{k}")])
        g, w = flat(got["blocks"]), flat(want["blocks"])
        assert [n for n, _ in g] == [n for n, _ in w]
        for (n, a), (_, b) in zip(g, w):
            assert a.shape == b.shape and torch.equal(a, b), (arch, n)

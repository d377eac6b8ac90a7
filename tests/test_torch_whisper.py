"""whisper-large-v3 in the port (encoder, decoder with cross-attention)
against the JAX reference on its smoke config (2 + 2 layers, d 64, 4 / 2
heads, hd 16, 16 encoder frames), with the reference's weights carried
across as numpy: the sinusoid (exact), the gelu FFN (jax.nn.gelu's tanh
form), the encoder, prefill logits and every cache leaf (the stored
cross K/V included), three decode steps, and the cross decode through
``ops.decode_attention``; also B7's non-causal mode against the Pallas
kernel in the interpreter at the encoder's heads.  f32 within rtol = atol
= 1e-4 (summation order differs between XLA:CPU and torch)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import smoke_config as jsmoke
from repro.kernels import ops as jops
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import model as JM
from repro_torch import convert
from repro_torch.configs import get_config, smoke_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import model as TM

TOL = dict(rtol=1e-4, atol=1e-4)
CPU = torch.device("cpu")
ARCH = "whisper-large-v3"
B, PROMPT, STEPS = 2, 12, 3


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


@pytest.fixture(scope="module")
def model():
    jcfg = jsmoke(jget_config(ARCH))
    tcfg = smoke_config(get_config(ARCH))
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    frames = np.random.RandomState(1).randn(
        B, jcfg.enc_frames, jcfg.d_model).astype(np.float32)
    return jcfg, tcfg, jp, convert.params_from_jax(_np(jp), CPU), frames


@pytest.mark.parametrize("n_pos,d", [(16, 64), (1500, 1280), (7, 10)])
def test_sinusoid_positions_exact(n_pos, d):
    got = tlayers.sinusoid_positions(n_pos, d)
    want = np.asarray(jlayers.sinusoid_positions(n_pos, d))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_gelu_ffn_is_the_tanh_form():
    """jax.nn.gelu defaults to the tanh approximation; torch's default
    (erf) differs by more than the tolerance on these inputs."""
    rng = np.random.RandomState(0)
    p = {"w_in": rng.randn(64, 128).astype(np.float32) * 0.3,
         "w_out": rng.randn(128, 64).astype(np.float32) * 0.1}
    x = rng.randn(4, 9, 64).astype(np.float32)
    want = np.asarray(jlayers.ffn(jax.tree.map(jnp.asarray, p),
                                  jnp.asarray(x), "gelu"))
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    got = tlayers.ffn(tp, torch.from_numpy(x), "gelu")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    erf = torch.nn.functional.gelu(torch.from_numpy(x) @ tp["w_in"]) \
        @ tp["w_out"]
    assert np.abs(erf.numpy() - want).max() > 1e-4


def test_encode_matches_reference(model):
    jcfg, tcfg, jp, tp, frames = model
    want = JM.encode(jcfg, jp, jnp.asarray(frames), JM.DEFAULT_CTX)
    got = TM.encode(tcfg, tp, torch.from_numpy(frames))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _caches_close(tc, jc):
    flat = jax.tree_util.tree_flatten_with_path
    got, want = flat(tc)[0], flat(jc)[0]
    assert [jax.tree_util.keystr(p) for p, _ in got] == \
        [jax.tree_util.keystr(p) for p, _ in want]
    for (path, t), (_, j) in zip(got, want):
        assert tuple(t.shape) == j.shape, jax.tree_util.keystr(path)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


def test_prefill_then_decode_matches_reference(model):
    """Encode + prefill, then STEPS decode steps fed the reference's
    argmax; logits after each call, every cache leaf (self K/V, cross
    K/V) after the prefill and after the last step."""
    jcfg, tcfg, jp, tp, frames = model
    tok = np.random.RandomState(2).randint(
        0, jcfg.vocab, (B, PROMPT)).astype(np.int32)
    max_len = PROMPT + STEPS + 1
    jc = JM.init_cache(jcfg, B, max_len, jnp.float32)
    tc = TM.init_cache(tcfg, B, max_len, torch.float32, CPU)
    jl, jc = JM.prefill(jcfg, jp, jnp.asarray(tok), jc,
                        enc_frames=jnp.asarray(frames))
    tl, tc = TM.prefill(tcfg, tp, torch.from_numpy(tok), tc,
                        enc_frames=torch.from_numpy(frames))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _caches_close(tc, jc)
    assert float(tc["blocks"]["cross_v"].abs().max()) > 0
    lengths = np.full((B,), PROMPT, np.int32)
    for _ in range(STEPS):
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
        jl, jc = JM.decode_step(jcfg, jp, jnp.asarray(nxt),
                                jnp.asarray(lengths), jc)
        tl, tc = TM.decode_step(tcfg, tp, torch.from_numpy(nxt),
                                torch.from_numpy(lengths), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        lengths = lengths + 1
    _caches_close(tc, jc)


@pytest.mark.parametrize("grad", [False, True])
def test_cross_prefill_checkpoints_only_under_a_gradient(grad, monkeypatch):
    """The cross prefill runs the plain scores when no input takes a
    gradient (serving) and ``torch.utils.checkpoint`` when one does
    (training); both give the same output, and the checkpointed backward
    the plain one's gradients."""
    calls = []
    real = torch.utils.checkpoint.checkpoint
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    rng = np.random.RandomState(3)
    q = torch.from_numpy(rng.randn(2, 5, 4, 16).astype(np.float32))
    k, v = (torch.from_numpy(rng.randn(2, 16, 2, 16).astype(np.float32))
            for _ in range(2))
    ins = [t.clone().requires_grad_(grad) for t in (q, k, v)]
    got = tattn._cross_sdpa(*ins)
    assert len(calls) == int(grad)
    ref = [t.clone().requires_grad_() for t in (q, k, v)]
    want = fa.attention_rows(*ref, 0, causal=False)
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                               rtol=1e-6, atol=1e-6)
    if grad:
        dy = torch.from_numpy(rng.randn(*got.shape).astype(np.float32))
        for g, w in zip(torch.autograd.grad(got, ins, dy),
                        torch.autograd.grad(want, ref, dy)):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6,
                                       atol=1e-6)


def test_cross_decode_matches_reference(model, monkeypatch):
    """``gqa_cross_decode`` against the reference's: one query a sequence
    against every encoder frame, through ``ops.decode_attention`` with
    lengths F - 1."""
    jcfg, tcfg, jp, tp, _ = model
    rng = np.random.RandomState(3)
    F, K, hd = jcfg.enc_frames, jcfg.n_kv_heads, jcfg.head_dim
    x = rng.randn(B, 1, jcfg.d_model).astype(np.float32)
    ck, cv = (rng.randn(B, F, K, hd).astype(np.float32) for _ in range(2))
    jcross = jax.tree.map(lambda a: a[1], jp["blocks"]["cross"])
    want = jattn.gqa_cross_decode(jcfg, jcross, jnp.asarray(x),
                                  jnp.asarray(ck), jnp.asarray(cv))
    seen = []
    decode = ops.decode_attention
    monkeypatch.setattr(ops, "decode_attention", lambda q, k, v, lengths: (
        seen.append(lengths.tolist()), decode(q, k, v, lengths))[1])
    tcross = {k: v[1] for k, v in tp["blocks"]["cross"].items()}
    got = tattn.gqa_cross_decode(tcfg, tcross, torch.from_numpy(x),
                                 torch.from_numpy(ck), torch.from_numpy(cv))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert seen == [[F - 1] * B]


def test_launcher_runs_whisper_on_the_cpu(capsys):
    from repro_torch.launch import prefill_decode
    res = prefill_decode.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                               "--batch", "2", "--prompt", "8",
                               "--steps", "2"])
    assert res["tokens"].shape == (2, 2)
    assert bool(torch.isfinite(res["logits"]).all())
    assert "whisper-large-v3-smoke [cpu]" in capsys.readouterr().out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_non_causal_matches_pallas(dtype):
    """B7's encoder mode (no mask) at whisper's heads (20 / 20, hd 64),
    S 256: the port's plain version against the Pallas kernel in the
    interpreter (its blocks need S % 128 == 0)."""
    rng = np.random.RandomState(20)
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    q, k, v = (rng.randn(1, 256, 20, 64).astype(np.float32)
               for _ in range(3))
    got = ops.flash_attention(*(torch.from_numpy(t).to(td)
                                for t in (q, k, v)), causal=False)
    want = jops.flash_attention(*(jnp.asarray(t, jd) for t in (q, k, v)),
                                causal=False, block_q=128, block_k=128)
    tol = TOL if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)

"""The port's training forward (``models/model.py::loss_fn``) and its
gradients against ``jax.value_and_grad`` of the reference's ``loss_fn``,
in f32 at the smoke config of one arch a family: the serving model
(dense), arctic-480b (moe, GQA + a dense residual), deepseek-v2-236b (moe,
MLA, a dense first layer), mamba2-2.7b (ssm), jamba-v0.1-52b (hybrid) and
whisper-large-v3 (audio: encoder + cross-attention); the reference's
weights carried across as numpy.  The loss within rtol 1e-5, every
gradient leaf within 1e-4 of that leaf's largest |g|.

The gradients of B7 and B8 come from the autograd Functions of
``kernels/ops.py`` (the forward the kernel's or its plain version, the
backward a recompute of the plain function): held here against
``jax.vjp`` of the reference's ``attention.sdpa`` and
``ssm.ssd_chunked``, causal and not, across the backward's query
chunks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import smoke_config as jsmoke
from repro.models import attention as jattn
from repro.models import model as JM
from repro.models import ssm as jssm
from repro_torch import convert
from repro_torch.configs import get_config, smoke_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.models import model as TM
from repro_torch.tree import items, leaves

CPU = torch.device("cpu")
ARCHS = ("xlb-service-model", "arctic-480b", "deepseek-v2-236b",
         "mamba2-2.7b", "jamba-v0.1-52b", "whisper-large-v3")
B, S = 2, 32


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


def _batch(cfg, seed):
    rng = np.random.RandomState(seed)
    tok = rng.randint(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    labels = tok[:, 1:].copy()
    labels[:, :3] = -1                       # masked positions
    batch = {"tokens": tok[:, :-1], "labels": labels}
    if cfg.is_encdec:
        batch["enc_frames"] = rng.randn(B, cfg.enc_frames,
                                        cfg.d_model).astype(np.float32)
    return batch


def _by_path(tree):
    """{key path: numpy array} of a reference tree, keys joined as
    ``repro_torch.tree.items`` joins them."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in kp): np.asarray(a) for kp, a in flat}


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_reference(arch):
    jcfg, tcfg = jsmoke(jget_config(arch)), smoke_config(get_config(arch))
    jp = JM.init_params(jcfg, jax.random.PRNGKey(1), jnp.float32)
    tp = convert.params_from_jax(_np(jp), CPU)
    batch = _batch(jcfg, 5)
    vg = jax.jit(jax.value_and_grad(
        lambda p, b: JM.loss_fn(jcfg, p, b), has_aux=True))
    (jloss, jaux), jg = vg(jp, jax.tree.map(jnp.asarray, batch))
    for p in leaves(tp):
        p.requires_grad_(True)
    tloss, taux = TM.loss_fn(tcfg, tp, {k: torch.from_numpy(v)
                                        for k, v in batch.items()})
    tg = torch.autograd.grad(tloss, leaves(tp))
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=1e-5)
    for name in ("ce", "aux", "z", "overflow"):
        np.testing.assert_allclose(float(taux[name]), float(jaux[name]),
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(taux["expert_load"].numpy(),
                                  np.asarray(jaux["expert_load"]))
    want = _by_path(jg)
    got = {k: g for (k, _), g in zip(items(tp), tg)}
    assert sorted(got) == sorted(want)
    for k, g in got.items():
        w = want[k]
        assert tuple(g.shape) == w.shape, k
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-4 * max(np.abs(w).max(), 1e-30),
                                   err_msg=k)


@pytest.mark.parametrize("S_,H,K,hd,causal", [
    (40, 4, 2, 16, True), (40, 4, 2, 16, False),
    # past one backward chunk (VJP_Q_CHUNK rows): the encoder's 20 / 20
    # heads not causal, and GQA causal with a ragged last chunk
    (fa.VJP_Q_CHUNK + 88, 4, 4, 16, False),
    (fa.VJP_Q_CHUNK + 88, 4, 1, 16, True)])
def test_flash_attention_gradient_matches_sdpa_vjp(S_, H, K, hd, causal):
    rng = np.random.RandomState(S_ + H + causal)
    q = rng.randn(1, S_, H, hd).astype(np.float32)
    k, v = (rng.randn(1, S_, K, hd).astype(np.float32) for _ in range(2))
    dout = rng.randn(1, S_, H, hd).astype(np.float32)
    out, vjp = jax.vjp(jax.jit(lambda q, k, v: jattn.sdpa(
        q, k, v, 1.0 / np.sqrt(hd).astype(np.float32), causal=causal)),
        *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(dout))
    tq, tk, tv = (torch.from_numpy(t).requires_grad_() for t in (q, k, v))
    got = ops.flash_attention(tq, tk, tv, causal=causal)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               rtol=1e-4, atol=1e-5)
    grads = torch.autograd.grad(got, (tq, tk, tv), torch.from_numpy(dout))
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4 * float(jnp.abs(w).max()))


@pytest.mark.parametrize("S_,chunk,state", [(64, 32, False), (64, 16, True),
                                            (40, 40, True)])
def test_ssd_scan_gradient_matches_ssd_chunked_vjp(S_, chunk, state):
    """The four inputs' gradients; B and C broadcast over the heads from
    one group as the mixer passes them (their gradient summed back)."""
    rng = np.random.RandomState(S_ + chunk)
    nh, hd, N = 4, 8, 16
    x = rng.randn(2, S_, nh, hd).astype(np.float32) * 0.5
    a = -np.abs(rng.randn(2, S_, nh)).astype(np.float32) * 0.3
    Bg, Cg = (rng.randn(2, S_, 1, N).astype(np.float32) * 0.3
              for _ in range(2))
    dy = rng.randn(2, S_, nh, hd).astype(np.float32)
    dh = rng.randn(2, nh, hd, N).astype(np.float32)

    def jf(x, a, Bg, Cg):
        y, h = jssm.ssd_chunked(x, a, jnp.repeat(Bg, nh, 2),
                                jnp.repeat(Cg, nh, 2), chunk)
        return (y, h) if state else y
    out, vjp = jax.vjp(jax.jit(jf), *map(jnp.asarray, (x, a, Bg, Cg)))
    want = vjp((jnp.asarray(dy), jnp.asarray(dh)) if state
               else jnp.asarray(dy))
    tx, ta, tB, tC = (torch.from_numpy(t).requires_grad_()
                      for t in (x, a, Bg, Cg))
    got = ops.ssd_scan(tx, ta, tB.expand(-1, -1, nh, -1),
                       tC.expand(-1, -1, nh, -1), chunk=chunk,
                       return_state=state)
    outs, grads = (got, (torch.from_numpy(dy), torch.from_numpy(dh))) \
        if state else ((got,), (torch.from_numpy(dy),))
    g = torch.autograd.grad(outs, (tx, ta, tB, tC), grads)
    for t, w in zip(g, want):
        np.testing.assert_allclose(t.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4 * float(jnp.abs(w).max()))


def test_functions_launch_in_the_forward_only(monkeypatch):
    """On tensors seen as CUDA tensors the B7 and B8 Functions launch
    their kernel in the forward (counted once each) and recompute the
    plain function in the backward (no launch)."""
    from repro_torch.kernels import ssd_scan as ssd
    monkeypatch.setattr(ops, "device_kind", lambda t: "cuda")
    monkeypatch.setattr(fa, "flash_attention_cuda",
                        lambda q, k, v, causal: fa.flash_attention(
                            q, k, v, causal=causal))
    monkeypatch.setattr(ssd, "ssd_scan_cuda",
                        lambda x, a, Bm, Cm: ssd.ssd_scan(x, a, Bm, Cm, 8))
    monkeypatch.setattr(ops, "LAUNCHES", dict.fromkeys(ops.LAUNCHES, 0))
    q = torch.randn(1, 8, 2, 16, requires_grad=True)
    ops.flash_attention(q, q, q, causal=True).sum().backward()
    x = torch.randn(1, 8, 2, 16, requires_grad=True)
    a = -torch.rand(1, 8, 2)
    ops.ssd_scan(x, a, x, x, chunk=8).sum().backward()
    assert q.grad is not None and x.grad is not None
    assert ops.LAUNCHES == {**dict.fromkeys(ops.LAUNCHES, 0),
                            "flash_attention": 1, "ssd_scan": 1}

"""``RunCtx`` on one device: the port's ``loss_fn(ctx=RunCtx(...))`` and
the gradient of every leaf against ``jax.value_and_grad`` of the
reference's ``loss_fn(ctx=RunCtx(...))``, in f32 at the smoke configs,
the reference's weights carried across as numpy:

* block remat (``remat="block"``: ``torch.utils.checkpoint`` around each
  block, where the reference wraps its scan body in ``jax.checkpoint``)
  and none, for the six archs of ``tests/test_torch_train.py``;
* each ``moe_method`` and a ``q_chunk`` that splits S: in
  ``tests/test_torch_runctx_knobs.py``, with this file's ``_check``.

The loss within rtol 1e-5 and every gradient leaf within 1e-4 of that
leaf's largest |g|: the tolerances of ``tests/test_torch_train.py``
(the order of the gradient sums may change under checkpoint, so not bit
for bit).  Also the port's ``_auto_q_chunk`` and ``_expand_kv`` against
the reference's over a grid, and the ctx-free forward equal bit for bit
to ``RunCtx()``'s."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import smoke_config as jsmoke
from repro.models import model as JM
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.configs import ASSIGNED_ARCHS, get_config, smoke_config
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT
from repro_torch.tree import items, leaves

CPU = torch.device("cpu")
ARCHS = ("xlb-service-model", "arctic-480b", "deepseek-v2-236b",
         "mamba2-2.7b", "jamba-v0.1-52b", "whisper-large-v3")
B, S = 2, 32


def _batch(cfg, seed):
    rng = np.random.RandomState(seed)
    tok = rng.randint(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    labels = tok[:, 1:].copy()
    labels[:, :3] = -1
    batch = {"tokens": tok[:, :-1], "labels": labels}
    if cfg.is_encdec:
        batch["enc_frames"] = rng.randn(B, cfg.enc_frames,
                                        cfg.d_model).astype(np.float32)
    return batch


def _by_path(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in kp): np.asarray(a) for kp, a in flat}


def _check(arch, **knobs):
    """The port's loss and gradients under ``TT.RunCtx(**knobs)`` against
    the reference's under ``JT.RunCtx(**knobs)``."""
    jcfg, tcfg = jsmoke(jget_config(arch)), smoke_config(get_config(arch))
    jp = JM.init_params(jcfg, jax.random.PRNGKey(1), jnp.float32)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), CPU)
    batch = _batch(jcfg, 5)
    jctx = JT.RunCtx(**knobs)
    (jloss, jaux), jg = jax.jit(jax.value_and_grad(
        lambda p, b: JM.loss_fn(jcfg, p, b, ctx=jctx), has_aux=True))(
        jp, jax.tree.map(jnp.asarray, batch))
    for p in leaves(tp):
        p.requires_grad_(True)
    tloss, taux = TM.loss_fn(tcfg, tp, {k: torch.from_numpy(v)
                                        for k, v in batch.items()},
                             ctx=TT.RunCtx(**knobs))
    tg = torch.autograd.grad(tloss, leaves(tp))
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=1e-5)
    for name in ("ce", "aux", "z", "overflow"):
        np.testing.assert_allclose(float(taux[name].detach()),
                                   float(jaux[name]), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(taux["expert_load"].numpy(),
                                  np.asarray(jaux["expert_load"]))
    want = _by_path(jg)
    got = {k: g for (k, _), g in zip(items(tp), tg)}
    assert sorted(got) == sorted(want)
    for k, g in got.items():
        w = want[k]
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-4 * max(np.abs(w).max(), 1e-30),
                                   err_msg=k)


@pytest.mark.parametrize("remat", ["none", "block"])
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_loss_and_gradients_match_reference(arch, remat):
    _check(arch, remat=remat)


def test_auto_q_chunk_and_expand_kv_follow_the_reference():
    for q_chunk in (0, 16):
        jctx, tctx = JT.RunCtx(q_chunk=q_chunk), TT.RunCtx(q_chunk=q_chunk)
        for Sq in (1, 64, 4095, 4096, 8192, 8193, 32768):
            assert TT._auto_q_chunk(tctx, Sq) == \
                JT._auto_q_chunk(jctx, Sq), (q_chunk, Sq)
    shapes = [(H, K) for H in (1, 8, 20, 32, 48, 56, 64) for K in
              (1, 2, 4, 8, 20) if H % K == 0]
    for arch in ASSIGNED_ARCHS + ["xlb-service-model"]:
        for H, K in shapes + [(None, None)]:
            jcfg, tcfg = jget_config(arch), get_config(arch)
            if H is not None:
                jcfg = dataclasses.replace(jcfg, n_heads=H, n_kv_heads=K)
                tcfg = dataclasses.replace(tcfg, n_heads=H, n_kv_heads=K)
            for tp in (1, 2, 4, 8, 16):
                assert TT._expand_kv(tcfg, TT.RunCtx(tp_size=tp)) == \
                    JT._expand_kv(jcfg, JT.RunCtx(tp_size=tp)), \
                    (arch, H, K, tp)


@pytest.mark.parametrize("arch", ["xlb-service-model", "jamba-v0.1-52b"])
def test_forward_without_ctx_is_the_default_ctx_bit_for_bit(arch):
    """``forward(cfg, params, tokens)`` is ``RunCtx()``'s forward, and
    ``remat="block"``'s is the same bit for bit (a checkpoint changes
    what is kept, not what is computed)."""
    cfg = smoke_config(get_config(arch))
    p = TM.init_params(cfg, torch.Generator().manual_seed(0), torch.float32,
                       "cpu")
    tok = torch.randint(0, cfg.vocab, (B, S),
                        generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        plain, _ = TM.forward(cfg, p, tok)
        dflt, _ = TM.forward(cfg, p, tok, ctx=TT.DEFAULT_CTX)
    remat, _ = TM.forward(cfg, {k: v for k, v in p.items()}, tok,
                          ctx=TT.RunCtx(remat="block"))
    assert torch.equal(plain, dflt)
    assert torch.equal(plain, remat.detach())
    assert TT.RunCtx() == TT.DEFAULT_CTX and TT.RunCtx().scan_unroll == 1
    assert [f.name for f in dataclasses.fields(TT.RunCtx)] == \
        [f.name for f in dataclasses.fields(JT.RunCtx)]

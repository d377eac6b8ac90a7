"""The plain PyTorch version of the port's SSD kernel (B8 ``ssd_scan``)
against the JAX package's Pallas kernel (run in the interpreter, as
``tests/test_kernels.py`` runs it), its sequential oracle
``ref.ssd_scan_ref`` and the model's chunked form ``ssm.ssd_chunked``
(output and final state), on the shapes of ``tests/test_kernels.py`` at
its tolerance (rtol = atol = 2e-4, the sums of a 512-step recurrence in
f32); and the port's mamba mixer and recurrent decode against the
reference's.  Inputs come from a numpy seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import smoke_config as jsmoke
from repro.kernels import ops as jops
from repro.kernels import ref
from repro.models import ssm as jssm
from repro_torch import convert
from repro_torch.configs import get_config, smoke_config
from repro_torch.kernels import _build, ops
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.models import ssm as tssm

TOL = dict(rtol=2e-4, atol=2e-4)
CPU = torch.device("cpu")


def _inputs(B, S, nh, hd, N, seed):
    """dt*x, dt*A (negative: a stable recurrence), B and C, as numpy."""
    rng = np.random.RandomState(seed)
    xdt = (rng.randn(B, S, nh, hd) * 0.5).astype(np.float32)
    a = -np.log1p(np.exp(rng.randn(B, S, nh))) * 0.5
    Bm = (rng.randn(B, S, nh, N) * 0.3).astype(np.float32)
    Cm = (rng.randn(B, S, nh, N) * 0.3).astype(np.float32)
    return xdt, a.astype(np.float32), Bm, Cm


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("B,S,nh,hd,N,chunk", [
    (1, 256, 2, 64, 32, 128),
    (2, 256, 4, 32, 64, 64),
    (1, 512, 2, 128, 128, 128),
])
def test_ssd_scan_matches_pallas_ref_and_chunked(B, S, nh, hd, N, chunk):
    arrs = _inputs(B, S, nh, hd, N, seed=S + nh)
    jx = [jnp.asarray(a) for a in arrs]
    y, h = ops.ssd_scan(*_t(*arrs), chunk=chunk, return_state=True)
    assert y.shape == (B, S, nh, hd) and h.shape == (B, nh, hd, N)
    assert h.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(
        jops.ssd_scan(*jx, chunk=chunk)), **TOL)
    np.testing.assert_allclose(y.numpy(), np.asarray(ref.ssd_scan_ref(*jx)),
                               **TOL)
    jy, jh = jssm.ssd_chunked(*jx, chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **TOL)


def test_ssd_scan_does_not_depend_on_the_chunk():
    t = _t(*_inputs(2, 128, 3, 16, 16, seed=1))
    y32, h32 = ops.ssd_scan(*t, chunk=32, return_state=True)
    y128, h128 = ops.ssd_scan(*t, chunk=128, return_state=True)
    torch.testing.assert_close(y32, y128, **TOL)
    torch.testing.assert_close(h32, h128, **TOL)
    assert torch.equal(ops.ssd_scan(*t, chunk=32), y32)


def test_ssd_scan_takes_heads_broadcast_by_stride():
    """Bm/Cm of one group broadcast over the heads with stride 0, as the
    mamba mixer passes them, give the result of the repeated arrays."""
    xdt, a, Bm, Cm = _t(*_inputs(1, 64, 4, 16, 16, seed=2))
    Bg, Cg = Bm[:, :, :1], Cm[:, :, :1]
    view = lambda t: t.expand(-1, -1, 4, -1)
    assert view(Bg).stride(2) == 0
    y = ops.ssd_scan(xdt, a, view(Bg), view(Cg), chunk=32)
    want = ops.ssd_scan(xdt, a, view(Bg).contiguous(),
                        view(Cg).contiguous(), chunk=32)
    torch.testing.assert_close(y, want, rtol=0, atol=0)


def test_ssd_scan_rejects_a_ragged_chunk():
    t = _t(*_inputs(1, 48, 1, 16, 16, seed=3))
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ops.ssd_scan(*t, chunk=32)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ssd.ssd_scan(*t, chunk=32)


@pytest.mark.parametrize("hd,N,dtype", [
    (16, 16, torch.float32), (16, 16, torch.bfloat16),
    (16, 128, torch.bfloat16), (64, 16, torch.bfloat16)])
def test_ssd_cuda_wrapper_takes_hd16_and_n16(monkeypatch, hd, N, dtype):
    """hd 16 and N 16 (the smoke config) get past every shape check of the
    CUDA wrapper and stop only where the library needs a card; in bf16
    they run the FMA kernel, which needs no 16-byte layout, so a view of
    odd strides is taken."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(_build, "_lib", None)
    B, S, nh = 1, 64, 2
    x = torch.zeros((B, S, nh * hd + 1), dtype=dtype)[..., 1:] \
        .reshape(B, S, nh, hd)
    bc = torch.zeros((B, S, nh, N), dtype=dtype)
    assert not ssd.runs_passes(hd, N)
    with pytest.raises(RuntimeError, match="need a CUDA device"):
        ssd.ssd_scan_cuda(x, torch.zeros((B, S, nh)), bc, bc)


@pytest.fixture(scope="module")
def mamba():
    jcfg = jsmoke(jget_config("mamba2-2.7b"))
    tcfg = smoke_config(get_config("mamba2-2.7b"))
    from repro.models import transformer as jtfm
    jp = jtfm._init_mamba_layer(jax.random.PRNGKey(4), jcfg, jnp.float32,
                                with_ffn=False, is_moe=False)["mamba"]
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), CPU)
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("S", [32, 64])
def test_mamba_mixer_matches_reference(mamba, S):
    jcfg, tcfg, jp, tp = mamba
    x = np.random.RandomState(S).randn(2, S, jcfg.d_model).astype(np.float32)
    jo, jst = jssm.mamba_mixer(jcfg, jp, jnp.asarray(x), return_state=True)
    to, tst = tssm.mamba_mixer(tcfg, tp, torch.from_numpy(x))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(tst.ssm.numpy(), np.asarray(jst.ssm), **TOL)
    np.testing.assert_allclose(tst.conv.numpy(), np.asarray(jst.conv),
                               **TOL)


def test_mamba_decode_matches_reference_from_a_warm_state(mamba):
    jcfg, tcfg, jp, tp = mamba
    rng = np.random.RandomState(9)
    st = jssm.init_ssm_state(jcfg, 3, jnp.float32)
    arrays = {n: rng.randn(*getattr(st, n).shape).astype(np.float32)
              for n in ("ssm", "conv")}
    x = rng.randn(3, 1, jcfg.d_model).astype(np.float32)
    jo, jst = jssm.mamba_decode(jcfg, jp, jnp.asarray(x),
                                jssm.SSMState(**{k: jnp.asarray(v)
                                                 for k, v in arrays.items()}))
    to, tst = tssm.mamba_decode(tcfg, tp, torch.from_numpy(x),
                                convert.ssm_state_from_numpy(arrays, CPU))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(tst.ssm.numpy(), np.asarray(jst.ssm), **TOL)
    np.testing.assert_allclose(tst.conv.numpy(), np.asarray(jst.conv),
                               **TOL)

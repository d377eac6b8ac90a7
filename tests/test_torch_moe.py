"""The port's MoE FFN (``models/moe.py``) against the JAX reference's
(``repro/models/moe.py``) on the same numpy inputs, with the reference's
weights carried across by ``convert.params_from_jax``: the router, the
three dispatches (``sort`` through ``ops.relay_slots``, ``cumsum``,
``einsum``) at the smoke configs of arctic-480b (dense residual),
deepseek-v2-236b (shared experts) and jamba-v0.1-52b, a deepseek-shaped
top-6 of 16, and a batch that overflows the experts' capacity.

Tolerance: the router's ids and the loads equal, ``overflow_frac``
within one f32 ulp of 1 (the jitted reference contracts its
``1 - mean(ok)`` into an FMA); the router's weights, ``aux`` and ``z``
within rtol = atol = 1e-6; the MoE output within rtol = atol = 1e-5 (f32
sums in another order)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as J
from repro.core import relay as JRel
from repro.models import moe as JMoE
from repro_torch import configs as T
from repro_torch import convert
from repro_torch.core import relay
from repro_torch.kernels import ops
from repro_torch.kernels import relay_dispatch
from repro_torch.models import moe

CPU = torch.device("cpu")
ARCHS = ("arctic-480b", "deepseek-v2-236b", "jamba-v0.1-52b")
# (arch, MoEConfig overrides): the smoke configs (drop-free), a
# deepseek-shaped top-6 of 16 at the published capacity factor, and an
# overflowing one
CASES = {"arctic": ("arctic-480b", {}),
         "deepseek": ("deepseek-v2-236b", {}),
         "jamba": ("jamba-v0.1-52b", {}),
         "deepseek-top6": ("deepseek-v2-236b",
                           dict(n_experts=16, top_k=6, capacity_factor=1.25)),
         "overflow": ("arctic-480b", dict(capacity_factor=0.5))}


def _configs(arch, **moe_kw):
    j = J.smoke_config(J.get_config(arch))
    t = T.smoke_config(T.get_config(arch))
    if moe_kw:
        j = dataclasses.replace(j, moe=dataclasses.replace(j.moe, **moe_kw))
        t = dataclasses.replace(t, moe=dataclasses.replace(t.moe, **moe_kw))
    return j, t


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    arch, kw = CASES[request.param]
    jcfg, tcfg = _configs(arch, **kw)
    jp = JMoE.init_moe(jax.random.PRNGKey(1), jcfg, jnp.float32)
    x = np.random.RandomState(2).randn(2, 32, jcfg.d_model) \
        .astype(np.float32)
    return request.param, jcfg, tcfg, jp, convert.params_from_jax(
        _np(jp), CPU), x


def test_route_matches_reference(case):
    _, jcfg, tcfg, jp, tp, x = case
    xf = x.reshape(-1, jcfg.d_model)
    bias = (np.random.RandomState(3).rand(jcfg.moe.n_experts) * 0.1) \
        .astype(np.float32)
    for b in (None, bias):
        want = JMoE.route(jcfg, jp, jnp.asarray(xf),
                          None if b is None else jnp.asarray(b))
        got = moe.route(tcfg, tp, torch.from_numpy(xf),
                        None if b is None else torch.from_numpy(b))
        assert got[1].dtype == torch.int32
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        for g, w in zip(got[:1] + got[2:], want[:1] + want[2:]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-6)


def test_route_breaks_ties_toward_the_lower_expert():
    """Equal gates pick the lower ids first, as ``lax.top_k`` does."""
    jcfg, tcfg = _configs("deepseek-v2-236b", n_experts=8, top_k=3)
    p = {"router": np.zeros((jcfg.d_model, 8), np.float32)}
    p["router"][:, 5] = 1.0
    xf = np.ones((4, jcfg.d_model), np.float32)
    want = JMoE.route(jcfg, {"router": jnp.asarray(p["router"])},
                      jnp.asarray(xf))[1]
    got = moe.route(tcfg, {"router": torch.from_numpy(p["router"])},
                    torch.from_numpy(xf))[1]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[0].tolist() == [5, 0, 1]


@pytest.mark.parametrize("method", ["sort", "cumsum", "einsum"])
def test_moe_ffn_matches_reference(case, method):
    name, jcfg, tcfg, jp, tp, x = case
    want_out, want_m = jax.jit(lambda p, xx: JMoE.moe_ffn(
        jcfg, p, xx, method=method))(jp, jnp.asarray(x))
    got_out, got_m = moe.moe_ffn(tcfg, tp, torch.from_numpy(x),
                                 method=method)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got_m.load.numpy(),
                                  np.asarray(want_m.load))
    # within an f32 ulp of 1: the jitted reference contracts
    # 1 - sum(ok) * f32(1/N) into one FMA (-2**-25 at N = 384, no drop)
    assert abs(float(got_m.overflow_frac) - float(want_m.overflow_frac)) \
        <= 2.0 ** -23
    for g, w in ((got_m.aux_loss, want_m.aux_loss),
                 (got_m.z_loss, want_m.z_loss)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)
    assert (float(got_m.overflow_frac) > 0) == (name == "overflow")


def test_overflowing_batch_drops_the_reference_rows():
    """At capacity factor 0.5 half the routed rows find no slot: the
    dispatch at the slots of ``ops.relay_slots`` keeps exactly the rows
    the reference's sort dispatch keeps, in the same pool cells."""
    jcfg, tcfg = _configs("arctic-480b", capacity_factor=0.5)
    jp = JMoE.init_moe(jax.random.PRNGKey(1), jcfg, jnp.float32)
    x = np.random.RandomState(4).randn(64, jcfg.d_model).astype(np.float32)
    _, idx, _, _ = JMoE.route(jcfg, jp, jnp.asarray(x))
    k, E = jcfg.moe.top_k, jcfg.moe.n_experts
    cap = JMoE.capacity_for(x.shape[0], jcfg)
    assert moe.capacity_for(x.shape[0], tcfg) == cap
    x_rep = np.repeat(x, k, axis=0)
    idx = np.array(idx).reshape(-1)
    wbuf, wmeta = JRel.relay_dispatch(jnp.asarray(x_rep), jnp.asarray(idx),
                                      E, cap, method="sort")
    ti = torch.from_numpy(idx)
    gbuf, gmeta = relay.relay_dispatch_at(torch.from_numpy(x_rep), ti,
                                          *ops.relay_slots(ti, E), E, cap)
    ok = np.asarray(wmeta.ok)
    assert 0 < ok.sum() < ok.size
    np.testing.assert_array_equal(gmeta.ok.numpy(), ok)
    np.testing.assert_array_equal(gmeta.slot.numpy()[ok],
                                  np.asarray(wmeta.slot)[ok])
    np.testing.assert_array_equal(gbuf.numpy(), np.asarray(wbuf))


def test_capacity_matches_reference():
    for arch in ARCHS:
        j, t = J.get_config(arch), T.get_config(arch)
        for n in (1, 2, 8192, 16384):
            assert moe.capacity_for(n, t) == JMoE.capacity_for(n, j)


def test_expert_parallel_moe_raises_naming_the_roadmap(case):
    """The expert-parallel relay is ported (``tests/test_torch_distributed.py``
    runs it over four processes); an ``ep`` without a ``DeviceMesh`` is
    refused before any dispatch."""
    _, _, tcfg, _, tp, x = case
    with pytest.raises(ValueError, match="needs a DeviceMesh"):
        moe.moe_ffn(tcfg, tp, torch.from_numpy(x), ep=(None, ("model",)))


def test_cuda_tensors_take_their_slots_from_the_relay_kernel(monkeypatch,
                                                             case):
    """With the tensors seen as CUDA tensors, the sort dispatch takes its
    slots from ``relay_slots_cuda`` (once a call, counted in
    ``LAUNCHES``), never from the plain version."""
    _, _, tcfg, _, tp, x = case
    calls = []

    def kernel(idx, n_dest):
        calls.append((idx.clone(), n_dest))
        return relay.positions_sort(idx, n_dest)

    def plain(*a, **k):
        raise AssertionError("plain version ran for a CUDA tensor")

    monkeypatch.setattr(ops, "device_kind", lambda t: "cuda")
    monkeypatch.setattr(relay_dispatch, "relay_slots_cuda", kernel)
    monkeypatch.setattr(relay_dispatch, "relay_slots", plain)
    monkeypatch.setitem(ops.LAUNCHES, "relay_slots", 0)
    moe.moe_ffn(tcfg, tp, torch.from_numpy(x))
    assert ops.LAUNCHES["relay_slots"] == 1
    (idx, n_dest), = calls
    assert n_dest == tcfg.moe.n_experts
    assert idx.shape == (x.shape[0] * x.shape[1] * tcfg.moe.top_k,)

"""The port's relay (``core/relay.py``) and relay slot assignment
(``kernels/relay_dispatch.py`` behind ``ops.relay_slots``, plain PyTorch on
the CPU) against the JAX reference on the same numpy inputs.

Tolerance: bit-exact everywhere.  Slots and loads are integers; the
dispatched buffers and the combined rows copy or scale one f32 value per
cell (every pool cell and every output row receives at most one row), so
no sum is reordered."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import relay as JRel
from repro.kernels import ops as jops
from repro.kernels import ref
from repro_torch.core import relay
from repro_torch.kernels import ops
from repro_torch.kernels.relay_dispatch import MAX_DEST

# the reference functions compiled once per shape (eager dispatch of each
# jnp operation costs far more at these sizes)
j_positions = {m: jax.jit(getattr(JRel, f"positions_{m}"), static_argnums=1)
               for m in ("sort", "cumsum")}
j_dispatch = jax.jit(JRel.relay_dispatch, static_argnums=(2, 3, 4))
j_combine = jax.jit(JRel.relay_combine)
j_dispatch_einsum = jax.jit(JRel.relay_dispatch_einsum,
                            static_argnums=(2, 3))
j_combine_einsum = jax.jit(JRel.relay_combine_einsum)


def _idx(N, E, seed, sentinel=False, fill="random"):
    """N destinations in [0, E) from numpy; with ``sentinel`` about one row
    in five sits at the sentinel destination E.  ``fill`` "one_destination"
    sends every row to destination 0, "all_sentinel" every row to E."""
    rng = np.random.RandomState(seed)
    idx = rng.randint(0, E, N).astype(np.int32)
    if sentinel:
        idx[rng.rand(N) < 0.2] = E
    if fill != "random":
        idx[:] = 0 if fill == "one_destination" else E
    return idx


@pytest.mark.parametrize("method", ["sort", "cumsum"])
@pytest.mark.parametrize("N,E,sentinel", [(64, 4, False), (300, 17, True),
                                          (1, 3, False), (256, 65, True)])
def test_positions_match_reference(method, N, E, sentinel):
    idx = _idx(N, E, seed=N + E, sentinel=sentinel)
    want = j_positions[method](jnp.asarray(idx), E)
    got = getattr(relay, f"positions_{method}")(torch.from_numpy(idx), E)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _relay_case(N, E, bn, fill="random"):
    return pytest.param(N, E, bn, fill, id=f"{N}-{E}-{bn}" + (
        "" if fill == "random" else f"-{fill}"))


# every (N, E, block_n) case of the reference's relay kernel tests, then
# the edges of the CUDA kernel: every row on one destination, many tiles
# (8192 standing for the card's 65536, kept short in the interpreter), the
# kernel's destination limit, one row past a tile and past a cluster of
# blocks walking one tile each (257, 2049) and past 16 tiles (4097), and
# every row at the sentinel
RELAY_CASES = [_relay_case(*c) for c in (
    (1024, 16, 256), (2048, 160, 1024), (512, 4, 512), (1536, 16, 1024),
    (1, 4, 1024), (7, 3, 4), (1000, 8, 256), (5, 2, 8))] + [
    _relay_case(4096, 1, 1024, "one_destination"),
    _relay_case(8192, 65, 1024), _relay_case(1000, MAX_DEST, 256),
    _relay_case(257, 65, 256), _relay_case(2049, 65, 1024),
    _relay_case(4097, 65, 1024), _relay_case(1000, 65, 256, "all_sentinel")]


@pytest.mark.parametrize("N,E,bn,fill", RELAY_CASES)
def test_relay_slots_match_pallas_and_oracle(N, E, bn, fill):
    """Slots on the rows with a real destination and loads everywhere;
    a sentinel row's slot is outside the contract (the Pallas value
    depends on block_n)."""
    idx = _idx(N, E, seed=N * 7 + E, sentinel=N > 1, fill=fill)
    slot, load = ops.relay_slots(torch.from_numpy(idx), E)
    assert slot.dtype == load.dtype == torch.int32
    assert slot.shape == (N,) and load.shape == (E,)
    live = idx < E
    for ws, wl in (jops.relay_slots(jnp.asarray(idx), E, block_n=bn),
                   ref.relay_slots_ref(jnp.asarray(idx), E)):
        np.testing.assert_array_equal(slot.numpy()[live],
                                      np.asarray(ws)[live])
        np.testing.assert_array_equal(load.numpy(), np.asarray(wl))
    assert (slot.numpy()[~live] == 0).all()


def test_relay_slots_empty_input_has_zero_loads():
    before = dict(ops.LAUNCHES)
    slot, load = ops.relay_slots(torch.zeros((0,), dtype=torch.int32), 5)
    assert slot.shape == (0,) and load.tolist() == [0] * 5
    assert ops.LAUNCHES == before
    wslot, wload = jops.relay_slots(jnp.zeros((0,), jnp.int32), 5)
    assert wslot.shape == (0,) and np.asarray(wload).tolist() == [0] * 5


def _payload(N, D, E, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(N, D).astype(np.float32),
            rng.randint(0, E, N).astype(np.int32),
            rng.rand(N).astype(np.float32))


def _assert_meta(got, want):
    for name in ("idx", "slot", "ok", "load"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert float(got.overflow_frac) == float(want.overflow_frac)


@pytest.mark.parametrize("method", ["sort", "cumsum"])
@pytest.mark.parametrize("N,D,E,C", [(64, 16, 4, 32), (40, 8, 3, 6)])
def test_relay_dispatch_combine_match_reference(method, N, D, E, C):
    """(64, 16, 4, 32) fits every row; (40, 8, 3, 6) drops rows past each
    destination's capacity."""
    x, idx, w = _payload(N, D, E, seed=N + C)
    jbuf, jmeta = j_dispatch(jnp.asarray(x), jnp.asarray(idx), E, C, method)
    tbuf, tmeta = relay.relay_dispatch(torch.from_numpy(x),
                                       torch.from_numpy(idx), E, C,
                                       method=method)
    np.testing.assert_array_equal(tbuf.numpy(), np.asarray(jbuf))
    _assert_meta(tmeta, jmeta)
    for weights in (None, w):
        want = j_combine(jbuf, jmeta,
                         None if weights is None else jnp.asarray(weights))
        got = relay.relay_combine(tbuf, tmeta,
                                  None if weights is None
                                  else torch.from_numpy(weights))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_relay_capacity_drop():
    """All ten rows to one backend of capacity 4: four fit, six drop."""
    x = torch.ones((10, 4))
    idx = torch.zeros((10,), dtype=torch.int32)
    buf, meta = relay.relay_dispatch(x, idx, 2, 4)
    assert int(meta.ok.sum()) == 4
    assert float(meta.overflow_frac) == pytest.approx(0.6)
    out = relay.relay_combine(buf, meta)
    assert int((out.abs().sum(1) > 0).sum()) == 4


@pytest.mark.parametrize("N,D,E,C", [(64, 16, 4, 32), (40, 8, 3, 6)])
def test_relay_einsum_pair_matches_reference(N, D, E, C):
    x, idx, w = _payload(N, D, E, seed=N * 3 + C)
    jbuf, jmeta, jd = j_dispatch_einsum(jnp.asarray(x), jnp.asarray(idx), E,
                                        C)
    tbuf, tmeta, td = relay.relay_dispatch_einsum(torch.from_numpy(x),
                                                  torch.from_numpy(idx), E, C)
    np.testing.assert_array_equal(tbuf.numpy(), np.asarray(jbuf))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    _assert_meta(tmeta, jmeta)
    want = j_combine_einsum(jbuf, jd, jnp.asarray(w))
    got = relay.relay_combine_einsum(tbuf, td, torch.from_numpy(w))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the einsum path agrees with the sort path on the same rows
    sbuf, smeta = relay.relay_dispatch(torch.from_numpy(x),
                                       torch.from_numpy(idx), E, C)
    np.testing.assert_array_equal(
        relay.relay_combine(sbuf, smeta, torch.from_numpy(w)).numpy(),
        got.numpy())

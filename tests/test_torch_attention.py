"""The plain PyTorch versions of the port's attention kernels (B6
``decode_attention``, B7 ``flash_attention``) against the JAX package's
Pallas kernels (run in the interpreter, as ``tests/test_kernels.py`` runs
them) and against its oracles in ``repro/kernels/ref.py``, on the shapes
and dtypes of ``tests/test_kernels.py``, at its tolerances (f32 2e-5,
bf16 2e-2).  Inputs come from a numpy seed; bf16 inputs are rounded from
the same f32 values on both sides."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref
from repro_torch.kernels import _build
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops

TOLS = {"float32": dict(rtol=2e-5, atol=2e-5),
        "bfloat16": dict(rtol=2e-2, atol=2e-2)}
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(a, dtype):
    """The same values as a JAX array and a CPU tensor of ``dtype``."""
    jd, td = DT[dtype]
    return jnp.asarray(a, jd), torch.from_numpy(a).to(td)


def _close(got: torch.Tensor, want, dtype):
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32), **TOLS[dtype])


# --------------------------------------------------------------------------- #
# B6 decode attention
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("B,S,H,K,hd,bk", [
    (2, 1024, 8, 2, 64, 256),
    (4, 512, 4, 4, 128, 512),
    (1, 2048, 8, 1, 64, 512),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_matches_pallas_and_ref(B, S, H, K, hd, bk, dtype):
    rng = np.random.RandomState(B * S + H)
    jq, tq = _pair(rng.randn(B, H, hd).astype(np.float32), dtype)
    jk, tk = _pair(rng.randn(B, S, K, hd).astype(np.float32), dtype)
    jv, tv = _pair(rng.randn(B, S, K, hd).astype(np.float32), dtype)
    lengths = rng.randint(0, S - 1, B).astype(np.int32)
    got = ops.decode_attention(tq, tk, tv, torch.from_numpy(lengths))
    assert got.dtype == DT[dtype][1] and got.shape == (B, H, hd)
    _close(got, jops.decode_attention(jq, jk, jv, jnp.asarray(lengths),
                                      block_k=bk), dtype)
    _close(got, ref.decode_attention_ref(jq, jk, jv, jnp.asarray(lengths)),
           dtype)


@pytest.mark.parametrize("lengths", [[0, 36, 5], [-1, 40, 36]])
def test_decode_attention_any_length_and_edges(lengths):
    """S = 37 (no block multiple); a length of 0 (one key), S - 1 and past
    the cache (every key) and -1 (every key masked: the reference's
    softmax of an all -1e30 row is uniform)."""
    rng = np.random.RandomState(7)
    B, S, H, K, hd = 3, 37, 6, 2, 32
    jq, tq = _pair(rng.randn(B, H, hd).astype(np.float32), "float32")
    jk, tk = _pair(rng.randn(B, S, K, hd).astype(np.float32), "float32")
    jv, tv = _pair(rng.randn(B, S, K, hd).astype(np.float32), "float32")
    lens = np.asarray(lengths, np.int32)
    got = ops.decode_attention(tq, tk, tv, torch.from_numpy(lens))
    _close(got, ref.decode_attention_ref(jq, jk, jv, jnp.asarray(lens)),
           "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_any_group_matches_ref(dtype):
    """G = 48 query heads over one KV head (granite-20b's MQA), past the
    16 heads per KV head the kernel once took."""
    rng = np.random.RandomState(48)
    B, S, H, K, hd = 2, 300, 48, 1, 128
    jq, tq = _pair(rng.randn(B, H, hd).astype(np.float32), dtype)
    jk, tk = _pair(rng.randn(B, S, K, hd).astype(np.float32), dtype)
    jv, tv = _pair(rng.randn(B, S, K, hd).astype(np.float32), dtype)
    lens = np.asarray([17, 299], np.int32)
    got = ops.decode_attention(tq, tk, tv, torch.from_numpy(lens))
    assert got.shape == (B, H, hd)
    _close(got, ref.decode_attention_ref(jq, jk, jv, jnp.asarray(lens)),
           dtype)


def test_decode_attention_reads_a_strided_cache_view():
    """A layer of a stacked (L, B, S, K, hd) cache, as the model passes it."""
    rng = np.random.RandomState(3)
    L, B, S, H, K, hd = 3, 2, 40, 4, 2, 32
    kc = torch.from_numpy(rng.randn(L, B, S, K, hd).astype(np.float32))
    vc = torch.from_numpy(rng.randn(L, B, S, K, hd).astype(np.float32))
    q = torch.from_numpy(rng.randn(B, H, hd).astype(np.float32))
    lens = torch.tensor([11, 39], dtype=torch.int32)
    got = ops.decode_attention(q, kc[1], vc[1], lens)
    want = da.decode_attention(q, kc[1].clone(), vc[1].clone(), lens)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("pairs,S,n", [(2048, 32, 1), (16, 4128, 33),
                                       (1, 100, 1), (4, 4096, 32)])
def test_decode_splits_cover_the_key_axis(pairs, S, n):
    """Splits cover [0, S) exactly in multiples of the kernel's tile, and
    give 4 blocks per SM (132 SMs) where the key axis has enough tiles:
    minitron-4b's decode (16 pairs x 4128 keys) 33 x 16 = 528 blocks, the
    serving model's 2048 pairs of 32 keys one split each."""
    sms = 132
    split_len, n_split = da._splits(pairs, S, sms=sms)
    assert n_split == n and split_len % da._TILE == 0
    assert (n_split - 1) * split_len < S <= n_split * split_len
    assert pairs * n_split >= min(4 * sms, pairs * -(-S // da._TILE))
    if pairs >= 4 * sms:
        assert n_split == 1


# --------------------------------------------------------------------------- #
# B7 flash attention
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("B,S,H,K,hd", [
    (1, 256, 4, 4, 64),        # MHA
    (2, 256, 8, 2, 64),        # GQA
    (1, 512, 4, 1, 128),       # MQA
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_pallas_and_ref(B, S, H, K, hd, dtype,
                                                causal):
    rng = np.random.RandomState(B * S + H + K)
    jq, tq = _pair(rng.randn(B, S, H, hd).astype(np.float32), dtype)
    jk, tk = _pair(rng.randn(B, S, K, hd).astype(np.float32), dtype)
    jv, tv = _pair(rng.randn(B, S, K, hd).astype(np.float32), dtype)
    got = ops.flash_attention(tq, tk, tv, causal=causal)
    assert got.dtype == DT[dtype][1] and got.shape == (B, S, H, hd)
    _close(got, jops.flash_attention(jq, jk, jv, causal=causal, block_q=128,
                                     block_k=128), dtype)
    _close(got, ref.flash_attention_ref(jq, jk, jv, causal=causal), dtype)


@pytest.mark.parametrize("S", [31, 256])
def test_flash_attention_where_pallas_blocks_cannot_follow(S):
    """Against the oracle only: S = 31 is no block multiple (the smoke
    prefill's prompt), and at S = 256 the Pallas kernel with block_q 128 >
    block_k 64 skips KV blocks that hold valid keys (max error 0.70
    against the oracle); the port computes the oracle's function."""
    rng = np.random.RandomState(S)
    B, H, K, hd = 1, 2, 1, 64
    jq, tq = _pair(rng.randn(B, S, H, hd).astype(np.float32), "float32")
    jk, tk = _pair(rng.randn(B, S, K, hd).astype(np.float32), "float32")
    jv, tv = _pair(rng.randn(B, S, K, hd).astype(np.float32), "float32")
    got = ops.flash_attention(tq, tk, tv, causal=True)
    _close(got, ref.flash_attention_ref(jq, jk, jv, causal=True), "float32")


def test_flash_attention_reads_strided_views():
    """q, k, v as column slices of one fused projection (last axis
    contiguous, rows strided)."""
    rng = np.random.RandomState(5)
    B, S, H, K, hd = 2, 48, 4, 2, 32
    qkv = torch.from_numpy(rng.randn(B, S, (H + 2 * K) * hd)
                           .astype(np.float32))
    q, k, v = torch.split(qkv, [H * hd, K * hd, K * hd], dim=-1)
    q, k, v = (t.reshape(B, S, -1, hd) for t in (q, k, v))
    got = ops.flash_attention(q, k, v, causal=True)
    want = fa.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                              causal=True)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("what", ["token stride", "head stride", "base"])
def test_flash_bf16_refuses_views_tma_cannot_read(what):
    """The bf16 kernel reads q, k, v with TMA (16-byte aligned base, strides
    of 16-byte multiples): the wrapper raises before any launch or build."""
    B, S, H, K, hd = 1, 16, 2, 1, 32
    pad = {"token stride": 1, "head stride": 0, "base": 0}[what]
    qkv = torch.zeros((B, S, (H + 2 * K) * hd + pad), dtype=torch.bfloat16)
    q, k, v = (t.reshape(B, S, -1, hd) for t in torch.split(
        qkv[..., :(H + 2 * K) * hd], [H * hd, K * hd, K * hd], dim=-1))
    if what == "head stride":
        q = torch.zeros((B, S, H, hd + 1), dtype=torch.bfloat16)[..., :hd]
    if what == "base":
        k = torch.zeros((B * S * K * hd + 1,), dtype=torch.bfloat16)[1:] \
            .reshape(B, S, K, hd)
    with pytest.raises(ValueError, match="TMA"):
        fa.flash_attention_cuda(q, k, v, causal=True)


def test_decode_refuses_a_cache_it_cannot_read_in_16_byte_loads():
    B, S, K, hd = 2, 8, 1, 32
    q = torch.zeros((B, 2, hd))
    kc = torch.zeros((B, S, K, hd + 1))[..., :hd]
    with pytest.raises(ValueError, match="16-byte"):
        da.decode_attention_cuda(q, kc, kc, torch.zeros(B, dtype=torch.int32))


def test_cpu_calls_launch_no_kernel():
    before = dict(ops.LAUNCHES)
    x = torch.zeros((1, 8, 2, 32))
    ops.flash_attention(x, x[:, :, :1], x[:, :, :1])
    ops.decode_attention(x[:, 0], x[:, :, :1], x[:, :, :1],
                         torch.zeros(1, dtype=torch.int32))
    assert ops.LAUNCHES == before


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(_build, "_lib", None)


@pytest.mark.parametrize("what", ["decode hd 16", "decode hd 16 bf16",
                                  "decode G 48", "flash hd 16",
                                  "flash hd 16 bf16",
                                  "flash hd 16 bf16 odd stride"])
def test_cuda_wrappers_take_hd16_and_any_group(what, no_card):
    """The CUDA wrappers take head dim 16 (the smoke configs) and G = 48:
    on CPU tensors they get past every shape check and stop only where
    the library needs a card.  bf16 at hd 16 runs the FMA kernel, which
    does not read through TMA, so a view TMA could not read is taken."""
    dt = torch.bfloat16 if "bf16" in what else torch.float32
    if what.startswith("decode"):
        H, K, hd = (48, 1, 128) if "G 48" in what else (4, 2, 16)
        q = torch.zeros((2, H, hd), dtype=dt)
        kv = torch.zeros((2, 40, K, hd), dtype=dt)
        call = lambda: da.decode_attention_cuda(
            q, kv, kv, torch.zeros(2, dtype=torch.int32))
    else:
        pad = 1 if "odd stride" in what else 0
        x = torch.zeros((2, 64, 4 * 16 + pad), dtype=dt)[..., :64] \
            .reshape(2, 64, 4, 16)
        kv = torch.zeros((2, 64, 2, 16), dtype=dt)
        call = lambda: fa.flash_attention_cuda(x, kv, kv, causal=True)
    with pytest.raises(RuntimeError, match="need a CUDA device"):
        call()

"""Everything a run makes from its ``--seed``: the sub-seeds, the served
model's weights and the policy draws.  The weights and the draws are the
benchmark's inputs: the program and the plain reference are both handed
the same tensors (the reference never reads anything the program made).
"""

from __future__ import annotations

import numpy as np
import torch

#: sub-seed tags
WEIGHTS, DRAWS, TRAFFIC, BACKOFF, SAMPLE = range(5)
#: lanes of a cluster's endpoint window (the weighted policy's noise width)
WINDOW = 64


def subseed(seed: int, tag: int) -> int:
    """A 63-bit seed from the run's seed (any whole number) and a tag."""
    ss = np.random.SeedSequence([int(seed) % (1 << 64), tag])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def rng(seed: int, tag: int) -> np.random.Generator:
    return np.random.default_rng(subseed(seed, tag))


def padded_vocab(vocab: int) -> int:
    return -(-vocab // 256) * 256


def make_params(m: dict, seed: int, device, dtype=torch.float32) -> dict:
    """The dense GQA decoder's weights in the program's layout
    (``embed``, ``head``, ``norm_f`` and the ``blocks`` stacked on a
    leading layer axis), drawn on ``device`` from a generator there, one
    call a stacked leaf: normal with std 1/sqrt(fan-in), the embedding
    0.02, the norms' scales one."""
    g = torch.Generator(device=device)
    g.manual_seed(subseed(seed, WEIGHTS))
    L, D, F = m["n_layers"], m["d_model"], m["d_ff"]
    H, K, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    Vp = padded_vocab(m["vocab"])

    def normal(shape, std):
        t = torch.empty(shape, dtype=dtype, device=device)
        return t.normal_(0.0, std, generator=g)

    def ones(shape):
        return torch.ones(shape, dtype=dtype, device=device)

    blocks = {"norm1": ones((L, D)),
              "attn": {"wq": normal((L, D, H * hd), D ** -0.5),
                       "wk": normal((L, D, K * hd), D ** -0.5),
                       "wv": normal((L, D, K * hd), D ** -0.5),
                       "wo": normal((L, H * hd, D), (H * hd) ** -0.5)},
              "norm2": ones((L, D)),
              "ffn": {"w_in": normal((L, D, F), D ** -0.5),
                      "w_out": normal((L, F, D), F ** -0.5)}}
    if m["ffn_act"] == "swiglu":
        blocks["ffn"]["w_gate"] = normal((L, D, F), D ** -0.5)
    return {"embed": normal((Vp, D), 0.02), "head": normal((D, Vp), D ** -0.5),
            "norm_f": ones((D,)), "blocks": blocks}


class Draws:
    """The policy draws of each admission, in order: ``rnd`` (R,) int32 in
    [0, 2**30) and ``gumbel`` (R, 64) f32 Gumbel noise, from one generator
    on ``device`` seeded from the run's seed.  The k-th call of a fresh
    ``Draws`` of the same seed gives the same tensors, so the reference
    replays the k-th admission with the program's noise."""

    def __init__(self, seed: int, device):
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(subseed(seed, DRAWS))
        self.device = torch.device(device)
        self.calls = 0

    def __call__(self, R: int):
        self.calls += 1
        rnd = torch.randint(0, 1 << 30, (R,), generator=self.gen,
                            dtype=torch.int32, device=self.device)
        u = torch.rand((R, WINDOW), generator=self.gen, dtype=torch.float32,
                       device=self.device)
        tiny = torch.finfo(torch.float32).tiny
        return rnd, -torch.log(-torch.log(u.clamp_min(tiny)))

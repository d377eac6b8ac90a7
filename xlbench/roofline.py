"""The yardstick: one NVIDIA H100's data-sheet peaks and the operations
and bytes each measured kernel needs, from the shapes and from what the
reference replay says a tick did.  Each input byte is counted read once
and each output byte written once, whatever a kernel reads again.

The peaks are NVIDIA's H100 SXM data sheet's (dense, at the part's full
700 W); a card set below it runs slower, so a share is reported with the
card's power limit beside it.
"""

from __future__ import annotations

import numpy as np

from xlbench.seeded import padded_vocab

#: float32 outside the tensor cores, operations/s (also the integer rate
#: the datapath kernels are held to)
F32_OPS_PS = 67e12
#: HBM3 bytes/s
MEM_BPS = 3.35e12
#: rules a service's chain may hold and lanes of a cluster's window
MAX_RULES_PER_SVC = 16
WINDOW = 64


def bound_s(nbytes: float, ops: float) -> float:
    """The least seconds the card could take: bytes or operations."""
    return max(nbytes / MEM_BPS, ops / F32_OPS_PS)


def admit_work(w: dict, lay, sizes: dict, R: int, F: int, I: int, C: int,
               tile: int) -> tuple[int, int]:
    """(bytes, operations) of one admission with commit (B2) of a batch of
    ``R`` rows of which the reference's ``w`` (one tick's work) holds the
    first ``w["rows"]``: the rows, the tables they index, the (I, C) pool
    in and out and the outputs."""
    S, E, CL, A = sizes["S"], sizes["E"], sizes["CL"], sizes["A"]
    n = w["rows"]
    cl_rows = list(w["cluster"])
    ok = np.array(w["ok"], bool)
    svc = np.array(w["svc"], np.int64)
    routable = np.array([e >= 0 for e in w["ep"]], bool)
    pol = w["policy"]
    # every row reads a cluster; padding and unmatched rows read cluster 0
    ucl = set(max(c, 0) for c in cl_rows) | ({0} if n < R else set())
    sv = set(int(s) for s in svc)
    rule_reads = sum(min(len(lay.rules.get(s, [])), MAX_RULES_PER_SVC)
                     for s in sv)
    counts = [len(c.endpoints) for c in lay.clusters]
    wt = [j for j in range(n) if routable[j] and pol[j] == "weighted"]
    lr = [j for j in range(n) if routable[j] and pol[j] == "least_request"]
    rnd = sum(1 for j in range(n) if routable[j] and pol[j] == "random")
    eps = set(int(e) for e, r in zip(w["ep"], routable) if r)
    ints = (R * (2 + F) + int((ok & (svc < S)).sum()) + int(ok.sum()) + rnd
            + 2 * len(sv) + 3 * rule_reads + 2 * CL + 2 * len(ucl)
            + sum(min(counts[c], WINDOW) for c in ucl if c < len(counts))
            + len(eps) + E + 2 * A)
    wt_cl = [cl_rows[j] for j in wt]
    floats = sum(min(counts[c], WINDOW) for c in wt_cl) \
        + sum(min(counts[c], WINDOW) for c in set(wt_cl))
    bytes_in = 4 * (ints + floats) + I * C + 5 * 4 * I * C
    bytes_out = 4 * (5 * R + E + CL + 2 * S + 2 + 2 * A) + 5 * 4 * I * C \
        + I * C
    lr_tables = len(set((j // tile, cl_rows[j]) for j in lr))
    ops = R * (2 * F + MAX_RULES_PER_SVC + 2 * 9 + 6) + 2 * WINDOW * len(wt) \
        + 4 * WINDOW * WINDOW * lr_tables
    return bytes_in + bytes_out, ops


def complete_work(I: int, C: int, sizes: dict) -> tuple[int, int]:
    """(bytes, operations) of one completion (B1) over an (I, C) pool:
    the six pool fields and the tokens in, the seven out, the (E,) load
    and EWMAs and the (S,) rx counters in and out, the (E,) completions
    out."""
    E, S = sizes["E"], sizes["S"]
    IC = I * C
    bytes_in = (5 * 4 + 1) * IC + 4 * IC + 4 * E + 4 * S + 8 * E
    bytes_out = 5 * 4 * IC + 2 * IC + 4 * E + 4 * S + 4 * E + 8 * E
    return bytes_in + bytes_out, 12 * IC + 8 * E


def decode_attn_work(m: dict, lanes: int, valid_keys: int,
                     elem: int = 4) -> tuple[int, int]:
    """(bytes, operations) of one decode attention launch (B6) over
    ``lanes`` sequences whose lengths let them attend to ``valid_keys``
    cached positions in all: q in, the output out, the lengths, and each
    valid key and value read once; 4 operations a (query head, key, dim)."""
    H, K, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    return (2 * lanes * H * hd * elem + 4 * lanes
            + 2 * valid_keys * K * hd * elem, 4 * valid_keys * H * hd)


def matmul_params(m: dict) -> int:
    """Weights a decoded token multiplies: every layer's projections and
    FFN and the output head (the embedding is a gather)."""
    D, H, K, hd, F = (m["d_model"], m["n_heads"], m["n_kv_heads"],
                      m["head_dim"], m["d_ff"])
    ffn = (3 if m["ffn_act"] == "swiglu" else 2) * D * F
    layer = D * H * hd + 2 * D * K * hd + H * hd * D + ffn
    return m["n_layers"] * layer + D * padded_vocab(m["vocab"])


def decode_flops(m: dict, lanes: int, valid_keys: int) -> int:
    """Model FLOPs of one decode step of ``lanes`` lanes: two a weight a
    lane, plus attention's 4 a (query head, key, dim) a layer."""
    return 2 * matmul_params(m) * lanes \
        + m["n_layers"] * 4 * valid_keys * m["n_heads"] * m["head_dim"]

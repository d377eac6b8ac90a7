"""Connection-completion datapath (twin of ``repro/kernels/completion.py``).

``complete`` is the close path of one engine tick over the (I, C)
connection pool: done detection (EOS or the length budget), endpoint load
release, per-service rx bytes, slot free, and the f32 health-EWMA epilogue
``health_update``.  ``complete`` here is the plain PyTorch version;
``complete_cuda`` launches the hand-written kernel in
``csrc/complete.cu``.  ``kernels/ops.py`` picks one by the tensors' device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import as_f32, as_i32

RX_BYTES_PER_TOKEN = 2     # response payload attributed per decoded token

# EWMA smoothing for the health accumulators.
ALPHA_INFLIGHT = 0.25
ALPHA_TPUT = 0.125


class CompleteResult(NamedTuple):
    """Everything ``Engine.step`` needs from one completion launch."""

    req_id: torch.Tensor     # (I, C) i32, -1 on freed slots
    endpoint: torch.Tensor   # (I, C) i32, -1 on freed slots
    svc: torch.Tensor        # (I, C) i32 (unchanged)
    length: torch.Tensor     # (I, C) i32, 0 on freed slots
    token: torch.Tensor      # (I, C) i32 last emitted token
    active: torch.Tensor     # (I, C) bool
    done: torch.Tensor       # (I, C) bool finished this step
    ep_load: torch.Tensor    # (E,) i32 counters after release
    rx_bytes: torch.Tensor   # (S,) i32 per-service rx metric after this step
    done_cnt: torch.Tensor   # (E,) i32 completions this step
    inflight_ewma: torch.Tensor  # (E,) f32 updated in-flight EWMA
    tput_ewma: torch.Tensor  # (E,) f32 updated completions-per-step EWMA


def health_update(inflight_ewma, tput_ewma, ep_load, done_cnt, *,
                  alpha_inflight: float = ALPHA_INFLIGHT,
                  alpha_tput: float = ALPHA_TPUT):
    """One EWMA step ``x + α·(obs − x)`` over the integer observations.

    ``ep_load`` is the occupancy before this step's releases and
    ``done_cnt`` the per-endpoint completions.  Written as a separate
    subtraction, multiply and add (no fused op) so no backend contracts it
    into an FMA: the CUDA epilogue rounds each step the same way.
    """
    occ = ep_load.to(torch.float32)
    cnt = done_cnt.to(torch.float32)
    inflight = inflight_ewma + alpha_inflight * (occ - inflight_ewma)
    tput = tput_ewma + alpha_tput * (cnt - tput_ewma)
    return inflight, tput


def complete(pool_req_id, pool_endpoint, pool_svc, pool_length, pool_token,
             pool_active, nxt, ep_load, rx_bytes, ep_inflight_ewma,
             ep_tput_ewma, *, eos: int, max_len: int) -> CompleteResult:
    """Plain PyTorch completion over the pool after one decode step.

    pool_*: (I, C) connection state (active bool, or int with > 0 =
    active); nxt: (I, C)
    tokens emitted this step; ep_load: (E,) i32; rx_bytes: (S,) i32;
    ep_inflight_ewma / ep_tput_ewma: (E,) f32.
    """
    E, S = ep_load.shape[0], rx_bytes.shape[0]
    i32 = torch.int32
    act = pool_active > 0
    plen = pool_length.to(i32)
    new_len = torch.where(act, plen + 1, plen)
    done = act & ((nxt == eos) | (new_len >= max_len - 1))
    pep = pool_endpoint.to(i32)

    rel = done & (pep >= 0) & (pep < E)
    dec = torch.bincount(pep[rel].to(torch.int64), minlength=E).to(i32)
    svc = pool_svc.to(i32).clamp_min(0)
    counted = act & (svc < S)                    # svc >= S drops
    rxd = torch.bincount(svc[counted].to(torch.int64), minlength=S).to(i32)
    ewl, ewt = health_update(ep_inflight_ewma.to(torch.float32),
                             ep_tput_ewma.to(torch.float32), ep_load, dec)
    return CompleteResult(
        req_id=torch.where(done, -1, pool_req_id.to(i32)),
        endpoint=torch.where(done, -1, pep),
        svc=pool_svc.to(i32),
        length=torch.where(done, 0, new_len),
        token=torch.where(act, nxt.to(i32), pool_token.to(i32)),
        active=act & ~done,
        done=done,
        ep_load=ep_load.to(i32) - dec,
        rx_bytes=rx_bytes.to(i32) + RX_BYTES_PER_TOKEN * rxd,
        done_cnt=dec,
        inflight_ewma=ewl,
        tput_ewma=ewt)


def complete_cuda(pool_req_id, pool_endpoint, pool_svc, pool_length,
                  pool_token, pool_active, nxt, ep_load, rx_bytes,
                  ep_inflight_ewma, ep_tput_ewma, *, eos: int,
                  max_len: int) -> CompleteResult:
    """Launch ``csrc/complete.cu`` on the tensors' CUDA device; same
    contract and result as ``complete``.  Inputs that are contiguous and
    of the kernel's type are passed as they are; the int32 and f32
    outputs are views of one allocation, the two bool ones of another.
    Raises if E + S counters do not fit in a block's default shared
    memory, the library cannot be built or the launch fails."""
    I, C = pool_req_id.shape
    E, S = ep_load.shape[0], rx_bytes.shape[0]
    if E + S > _build.SMEM_DEFAULT // 4:
        raise ValueError(f"complete keeps E + S = {E + S} counters in "
                         f"shared memory; at most {_build.SMEM_DEFAULT // 4}"
                         " fit")
    act = pool_active if pool_active.dtype == torch.bool else pool_active > 0
    ins = [*map(as_i32, (pool_req_id, pool_endpoint, pool_svc, pool_length,
                         pool_token)),
           act if act.is_contiguous() else act.contiguous(), as_i32(nxt)]
    for t in ins:
        if t.shape != (I, C):
            raise ValueError(f"pool tensors must all be {(I, C)}, got "
                             f"{tuple(t.shape)}")
    load0, rx0 = as_i32(ep_load), as_i32(rx_bytes)
    ewl0, ewt0 = as_f32(ep_inflight_ewma), as_f32(ep_tput_ewma)
    if ewl0.shape != (E,) or ewt0.shape != (E,):
        raise ValueError("EWMA tensors must be (E,)")
    dev = load0.device
    _build.check_device(dev, *ins, rx0, ewl0, ewt0)
    lib = _build.library(dev)
    *outs, load_out, rx_out, cnt, ewl, ewt = _build.packed(
        [(I, C)] * 5 + [(E,), (S,), (E,), (E,), (E,)], torch.int32, dev)
    outs += _build.packed([(I, C)] * 2, torch.bool, dev)
    ewl, ewt = ewl.view(torch.float32), ewt.view(torch.float32)
    err = lib.xlb_complete(
        *[t.data_ptr() for t in (*ins, load0, rx0, ewl0, ewt0, *outs,
                                 load_out, rx_out, cnt, ewl, ewt)],
        I * C, E, S, int(eos), int(max_len), ALPHA_INFLIGHT, ALPHA_TPUT,
        _build.stream(dev))
    _build.check(err, "complete")
    return CompleteResult(*outs, load_out, rx_out, cnt, ewl, ewt)

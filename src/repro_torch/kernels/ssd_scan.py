"""Mamba-2 SSD chunked scan (twin of ``repro/kernels/ssd_scan.py``; the
plain version is the twin of ``repro/models/ssm.py::ssd_chunked``).

``ssd_scan`` here is the plain PyTorch version, in f32 whatever the
inputs' dtype (as the Pallas kernel computes); ``ssd_scan_cuda`` launches
``csrc/ssd_scan.cu``.  ``kernels/ops.py`` picks one by the tensors'
device.  Both start from a zero state and return ``(y, h_last)``: y
(B, S, nh, hd) in xdt's dtype and the final state (B, nh, hd, N) f32.

``ssd_scan_vjp`` is the training path's gradient (through the autograd
Function in ``kernels/ops.py``): the reference has no backward kernel,
and its gradient is JAX's autodiff of ``ssd_chunked``, so this recomputes
the plain version from the saved inputs and returns its vector-Jacobian
product.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

#: head dims and state sizes the kernels are built for
HEAD_DIMS = (16, 32, 64, 128)
STATE_DIMS = (16, 32, 64, 128)


def runs_passes(hd: int, N: int) -> bool:
    """Whether a bf16 call at (hd, N) runs the four tensor-core passes;
    where hd or N is 16 (the smoke configs) it runs the FMA kernel."""
    return hd != 16 and N != 16


def _segsum(a):
    """a: (..., Q) → (..., Q, Q), out[i, j] = sum_{j<k<=i} a_k (i >= j),
    -inf above the diagonal."""
    Q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((Q, Q), dtype=torch.bool, device=a.device).tril()
    return torch.where(mask, seg, -torch.inf)


def ssd_scan(xdt, a_log, Bm, Cm, chunk: int):
    """The SSD dual form over chunks of ``chunk`` rows (S % chunk == 0).
    xdt: (B, S, nh, hd) = dt * x; a_log: (B, S, nh) = dt * A; Bm/Cm:
    (B, S, nh, N).  Returns (y, h_last)."""
    B, S, nh, hd = xdt.shape
    N = Bm.shape[-1]
    Q = chunk
    if S % Q:
        raise ValueError(f"S = {S} is not a multiple of the chunk {Q}")
    nc = S // Q
    f32 = torch.float32
    xc = xdt.to(f32).reshape(B, nc, Q, nh, hd)
    ac = a_log.to(f32).reshape(B, nc, Q, nh).permute(0, 3, 1, 2)
    Bc = Bm.to(f32).reshape(B, nc, Q, nh, N)
    Cc = Cm.to(f32).reshape(B, nc, Q, nh, N)
    A_cum = torch.cumsum(ac, dim=-1)                        # (B, nh, nc, Q)

    # 1) intra-chunk (diagonal blocks)
    L = torch.exp(_segsum(ac))                              # (B,nh,nc,Q,Q)
    Y_diag = torch.einsum("bclhn,bcshn,bhcls,bcshp->bclhp", Cc, Bc, L, xc)
    # 2) chunk states
    decay_states = torch.exp(A_cum[..., -1:] - A_cum)       # (B, nh, nc, Q)
    states = torch.einsum("bclhn,bhcl,bclhp->bchpn", Bc, decay_states, xc)
    # 3) inter-chunk recurrence, in order over the chunks
    chunk_decay = torch.exp(A_cum[..., -1]).permute(0, 2, 1)  # (B, nc, nh)
    h = torch.zeros((B, nh, hd, N), dtype=f32, device=xdt.device)
    prev = []
    for c in range(nc):
        prev.append(h)
        h = chunk_decay[:, c, :, None, None] * h + states[:, c]
    h_prev = torch.stack(prev, dim=1)                       # (B,nc,nh,hd,N)
    # 4) inter-chunk output
    Y_off = torch.einsum("bclhn,bchpn,bhcl->bclhp", Cc, h_prev,
                         torch.exp(A_cum))
    y = (Y_diag + Y_off).reshape(B, S, nh, hd)
    return y.to(xdt.dtype), h


def ssd_scan_vjp(xdt, a_log, Bm, Cm, chunk: int, dy, dh=None):
    """(dxdt, da_log, dBm, dCm) of ``ssd_scan`` at the output gradients
    ``dy`` and, where the final state was used, ``dh``; recomputed under
    autograd, in the inputs' dtypes and shapes (a broadcast Bm or Cm gets
    its per-head gradient; the caller's expand sums it)."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_() for t in (xdt, a_log, Bm, Cm)]
        y, h = ssd_scan(*ins, chunk)
        outs, grads = ([y, h], [dy, dh]) if dh is not None else ([y], [dy])
        return torch.autograd.grad(outs, ins, grads)


def ssd_scan_cuda(xdt, a_log, Bm, Cm):
    """Launch ``csrc/ssd_scan.cu`` on the tensors' CUDA device; same result
    as ``ssd_scan`` at any chunk (the form is exact for any chunk, and the
    kernels use their own).  bf16 runs four chunk-parallel passes on the
    tensor cores over scratch this wrapper allocates (``ssd_chunk_state``,
    ``ssd_scores`` where Bm and Cm are broadcast over the heads by stride
    0, ``ssd_state_pass``, ``ssd_chunk_scan``); f32, and bf16 where hd or
    N is 16 (``runs_passes``), one FMA kernel (``ssd_kernel``), picked
    before the launch.  Inputs are read through their strides; the last
    axis of xdt, Bm and Cm must be contiguous, and for the passes their
    bases and other strides 16-byte multiples.  Raises on a shape, dtype
    or layout the kernels do not take, if the library cannot be built or
    a launch fails."""
    B, S, nh, hd = xdt.shape
    N = Bm.shape[-1]
    if Bm.shape != (B, S, nh, N) or Cm.shape != Bm.shape \
            or a_log.shape != (B, S, nh):
        raise ValueError(f"ssd_scan takes xdt (B, S, nh, hd), a_log "
                         f"(B, S, nh), Bm/Cm (B, S, nh, N); got "
                         f"{tuple(xdt.shape)}, {tuple(a_log.shape)}, "
                         f"{tuple(Bm.shape)}, {tuple(Cm.shape)}")
    if S == 0 or hd not in HEAD_DIMS or N not in STATE_DIMS:
        raise ValueError(f"ssd_scan takes S > 0, hd in {HEAD_DIMS} and N in "
                         f"{STATE_DIMS}; got S={S}, hd={hd}, N={N}")
    if xdt.dtype not in _build.DTYPE_CODES or Bm.dtype != xdt.dtype \
            or Cm.dtype != xdt.dtype or a_log.dtype != torch.float32:
        raise ValueError(f"xdt, Bm and Cm must share one of "
                         f"{list(_build.DTYPE_CODES)} and a_log be f32; got "
                         f"{xdt.dtype}, {Bm.dtype}, {Cm.dtype}, "
                         f"{a_log.dtype}")
    if xdt.stride(3) != 1 or Bm.stride(3) != 1 or Cm.stride(3) != 1:
        raise ValueError("the last axis of xdt, Bm and Cm must be "
                         "contiguous")
    dev = xdt.device
    _build.check_device(dev, a_log, Bm, Cm)
    dtype = _build.DTYPE_CODES[xdt.dtype]
    if xdt.dtype == torch.bfloat16 and runs_passes(hd, N):
        for name, t in (("xdt", xdt), ("Bm", Bm), ("Cm", Cm)):
            _build.check_16_byte("ssd_scan", name, t)
    lib = _build.library(dev)
    y = torch.empty((B, S, nh, hd), dtype=xdt.dtype, device=dev)
    h_last = torch.empty((B, nh, hd, N), dtype=torch.float32, device=dev)
    scratch = torch.empty(
        (lib.xlb_ssd_scratch_floats(B, S, nh, hd, N, dtype, Bm.stride(2),
                                    Cm.stride(2)),),
        dtype=torch.float32, device=dev)
    p = _build.ptr
    err = lib.xlb_ssd_scan(
        p(xdt), p(a_log), p(Bm), p(Cm), p(y), p(h_last), p(scratch), B, S,
        nh, hd, N, dtype, *xdt.stride()[:3], *a_log.stride(),
        *Bm.stride()[:3], *Cm.stride()[:3], _build.stream(dev))
    _build.check(err, "ssd_scan")
    return y, h_last

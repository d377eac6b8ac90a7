"""Relay slot assignment (twin of ``repro/kernels/relay_dispatch.py``).

Per payload row, its stable rank among the rows with the same destination
(the slot in that destination's pool), plus the per-destination totals:
the counting sort behind ``core/relay.py`` and the three ranks of the
staged admission chain (``policies.select``, ``request_map.allocate_slots``
and ``policy_defs.affinity_staged_update``).

``relay_slots`` here is the plain PyTorch version; ``relay_slots_cuda``
launches ``csrc/relay.cu``.  ``kernels/ops.py`` picks one by the tensor's
device.  Rows whose destination lies outside ``[0, n_dest)`` (callers
steer dropped rows to the sentinel ``n_dest``) take no rank and count no
load; both versions give them slot 0, which is not part of the contract.
"""

from __future__ import annotations

import torch

from repro_torch.core import relay
from repro_torch.kernels import _build


def relay_slots(idx, n_dest: int) -> tuple[torch.Tensor, torch.Tensor]:
    """idx: (N,) int → (slot (N,) i32, load (n_dest,) i32).  Plain PyTorch:
    the counting sort ``core/relay.py::positions_sort``, with the sentinel
    rows' slots written as 0, as the kernel writes them."""
    slot, load = relay.positions_sort(idx, n_dest)
    live = (idx >= 0) & (idx < n_dest)
    return torch.where(live, slot, 0), load


#: destinations ``relay_slots_cuda`` takes: ``csrc/relay.cu`` keeps a 64-bit
#: word of per-warp counts and an int of running count per destination in
#: a block's default shared memory
MAX_DEST = _build.SMEM_DEFAULT // 12


def relay_slots_cuda(idx, n_dest: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/relay.cu`` on the tensor's CUDA device; same contract
    and result as ``relay_slots``.  Raises if ``n_dest`` exceeds
    ``MAX_DEST``, the library cannot be built or the launch fails.  The
    caller skips empty inputs."""
    if idx.dim() != 1 or idx.shape[0] == 0:
        raise ValueError("idx must be a non-empty (N,) tensor")
    if not 0 <= n_dest <= MAX_DEST:
        raise ValueError(f"relay_slots keeps n_dest counters in shared "
                         f"memory: 0 <= n_dest <= {MAX_DEST}, got {n_dest}")
    N = idx.shape[0]
    dev = idx.device
    lib = _build.library(dev)
    x = _build.as_i32(idx)
    slot, load = _build.packed([(N,), (n_dest,)], torch.int32, dev)
    p = _build.ptr
    err = lib.xlb_relay(p(x), N, n_dest, p(slot), p(load), _build.stream(dev))
    _build.check(err, "relay_slots")
    return slot, load

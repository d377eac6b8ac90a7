"""Device resolution for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without a GPU raises.

    Entry points default to ``"cuda"`` and call this, so a run that was
    meant for the card never carries on quietly on the CPU.  ``"meta"``
    (shapes and dtypes only, no data) is taken too: the dry run builds
    its states there.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch finds no CUDA device; "
            "pass device='cpu' to run the plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {str(dev)!r} "
                         "(cuda, cpu or meta)")
    return dev

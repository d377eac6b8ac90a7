"""PyTorch/CUDA port of the XLB serving datapath.

The package mirrors ``repro`` (the JAX reference) module for module:
``repro_torch/core/routing_table.py`` is the twin of
``repro/core/routing_table.py`` and so on.  It imports only ``torch``,
numpy and the standard library.

Entry points run on the card unless the caller asks for the CPU: the
engine, the serve loop and the launcher default to ``device="cuda"`` and
raise when no GPU is present.  On the CPU every kernel wrapper runs its
plain PyTorch version; on a CUDA tensor it launches the hand-written
kernel (``kernels/csrc``) or raises.
"""

from repro_torch.device import resolve_device  # noqa: F401

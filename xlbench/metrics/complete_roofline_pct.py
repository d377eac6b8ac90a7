"""Kernels: B1 (``csrc/complete.cu``, the completion over the whole pool)
as a share of its roofline over the profiled slice: the least time the
card needs for a completion's bytes and operations
(``roofline.complete_work``), once a tick, over B1's device time."""

from xlbench import devicetrace, roofline


def read(t):
    dev_s, n = devicetrace.kernel_s(t.device, ("complete_kernel",))
    if not n:
        return None
    need = n * roofline.bound_s(*roofline.complete_work(t.I, t.C, t.sizes))
    return 100.0 * need / dev_s

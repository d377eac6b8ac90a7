"""Decode: device ms a tick of every kernel but B1 and B2 (the decode
step's GEMMs, norms, rope, B6 and the argmax, and the policy draws'
small kernels), copies and fills left out, over the profiled slice."""

SKIP = ("admit_kernel", "complete_kernel", "Memcpy", "Memset")


def read(t):
    if not t.slice_ticks or not t.device:
        return None
    s = sum(e - b for n, b, e in t.device if not any(k in n for k in SKIP))
    return 1e3 * s / t.slice_ticks

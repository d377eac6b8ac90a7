"""Kernels: B2 (``csrc/admit.cu``, the admission with commit) as a share
of its roofline over the profiled slice: the least time the card needs
for each admission's bytes and operations (``roofline.admit_work``, from
what the reference's replay says each row did) over B2's device time."""

from xlbench import devicetrace, roofline


def read(t):
    dev_s, n = devicetrace.kernel_s(t.device, ("admit_kernel",))
    works = [w for w in t.works if w["rows"]]
    if not n or not works:
        return None
    need = sum(roofline.bound_s(*roofline.admit_work(
        w, t.lay, t.sizes, t.R, t.sizes["F"], t.I, t.C, t.tile))
        for w in works)
    return 100.0 * need / dev_s

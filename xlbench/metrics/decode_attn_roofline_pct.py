"""Decode: B6 (``csrc/decode_attention.cu``) as a share of its roofline
over the profiled slice: for each tick, one launch a layer over every
lane at the lengths the reference's replay says the lanes had (each
valid key and value read once, ``roofline.decode_attn_work``), over the
device time of B6's kernels (the split pass and its merge)."""

from xlbench import devicetrace, roofline

KEYS = ("decode_kernel", "decode_merge_kernel")


def read(t):
    dev_s, n = devicetrace.kernel_s(t.device, KEYS)
    if not n or not t.works:
        return None
    lanes = t.I * t.C
    need = sum(t.m["n_layers"] * roofline.bound_s(*roofline.decode_attn_work(
        t.m, lanes, w["valid_keys"])) for w in t.works)
    return 100.0 * need / dev_s

"""Device: the whole tick's share of the card's float32 peak: the
decode's model FLOPs a tick (two a weight a lane over every lane the
engine decodes, plus attention at the lanes' lengths from the reference's
replay, ``roofline.decode_flops``, over the profiled slice's ticks) over
(the window's time a tick, host clock, x 67 TFLOP/s, the data sheet's
float32 rate; the engine turns TF32 off)."""

from xlbench import roofline


def read(t):
    if not t.works or not t.window_ticks:
        return None
    flops = sum(roofline.decode_flops(t.m, t.I * t.C, w["valid_keys"])
                for w in t.works) / len(t.works)
    tick_s = t.window_s / t.window_ticks
    return 100.0 * flops / (tick_s * roofline.F32_OPS_PS)

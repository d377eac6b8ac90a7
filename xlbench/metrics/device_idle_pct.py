"""Device: the share of a tick in which no operation runs on the device:
100 - 100 x the device's busy time a tick (the union of its operations'
intervals over the profiled slice after the window) / the window's time
a tick (host clock, no profiler; the profiler slows the host, not the
device).  Two stretches of one run: a traced run prints the work that
sets the device's time a tick (rows admitted, ticks with arrivals,
active slots) over each, to show that they match (PERF.md, section 3)."""

from xlbench import devicetrace


def read(t):
    if not t.slice_ticks or not t.device or not t.window_ticks:
        return None
    busy = devicetrace.busy_s(t.device) / t.slice_ticks
    return 100.0 - 100.0 * busy / (t.window_s / t.window_ticks)

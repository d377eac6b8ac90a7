"""ServeLoop host: ms a tick in which the device runs nothing: the
window's ms a tick (host clock, no profiler) less the device's busy ms a
tick (the union of its operations' intervals) over the profiled slice
after the window.  The profiler slows the host, not the device, so the
slice gives the busy time and the window the tick; most of the number
is the window's host clock.  The traced run prints the device's work a
tick over both stretches (as ``device_idle_pct``)."""

from xlbench import devicetrace


def read(t):
    if not t.slice_ticks or not t.device or not t.window_ticks:
        return None
    busy = devicetrace.busy_s(t.device) / t.slice_ticks
    return 1e3 * (t.window_s / t.window_ticks - busy)

"""Captured tick: host ms a tick inside ``ServeLoop.serve_step``, the
captured ``StaticTick.__call__`` (the gates, staging the batch, the
draws, the graph's replay), from the benchmark's span around it, over
the window's ticks outside the profiled slice."""


def read(t):
    if not t.window_ticks or "tick_call" not in t.spans:
        return None
    return 1e3 * t.spans["tick_call"] / t.window_ticks

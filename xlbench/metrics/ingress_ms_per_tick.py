"""ServeLoop host: host ms a tick in ``ServeLoop._next_admission`` (the
queue, ``parse_features``, the batch's host tensors), from the
benchmark's span around it over the window's ticks outside the profiled
slice."""


def read(t):
    if not t.window_ticks or "ingress" not in t.spans:
        return None
    return 1e3 * t.spans["ingress"] / t.window_ticks

"""Balancing: admission attempts held (a request in the batch that got
no slot, so ``Request.retries`` grew) per 100 attempts, over the
window's ticks outside the profiled slice."""


def read(t):
    if not t.attempts:
        return None
    return 100.0 * t.held / t.attempts

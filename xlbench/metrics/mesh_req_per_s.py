"""ServeLoop host: the Bookinfo mesh's user requests completed in the
window a second (host clock; each user request counted once, when its
last call completes).  The host's speed sets it, and that speed differs
by more than a bound can hold from run to run of one machine, so it is
read here beside the cell's device cost a request (PERF.md, section 2)."""


def read(t):
    if not t.window_s or not t.completed:
        return None
    return t.completed / t.window_s

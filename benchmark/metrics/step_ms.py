"""step_ms: the whole window's seconds over the calls of the cell's entry, ms (host
clock; the window ends when the device has done every call)."""


def read(run):
    return 1e3 * run['window_s'] / run['calls']

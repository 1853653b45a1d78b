"""sharded_step_ms: rank 0's whole window over its sharded steps, ms (host clock; the
ranks start together after a barrier and the window ends when rank 0's card has
done every step)."""


def read(run):
    return 1e3 * run['window_s'] / run['calls']

"""frames_per_s: frames completed over the whole window's seconds (host clock)."""


def read(run):
    return run['calls'] / run['window_s']

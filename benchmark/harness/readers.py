"""Arithmetic the metric readers share: the traced slice's shares and sums, and the
timing of one operation alone with CUDA events."""
import numpy as np
import torch

#: the card is held back this long before a timed batch, so that the host has queued
#: the whole batch and the events time the device alone
PRELOAD_CYCLES = 100_000_000
#: larger than the card's 50 MB L2, written between launches of a timed kernel
FLUSH_BYTES = 128 << 20


def idle_percent(run):
    """100 (1 - union of device operations / slice length), or None untraced."""
    t = run.get('trace')
    if not t or t['window_s'] <= 0:
        return None
    return 100.0 * (1.0 - t['busy_s'] / t['window_s'])


def ops_per_call(run):
    """Device operations (kernels, copies, sets) in the slice per call in it."""
    t = run.get('trace')
    if not t or not t['calls']:
        return None
    return t['device_ops'] / t['calls']


def device_ms_per_call(run, patterns):
    """Device ms per call of the operations whose lower-cased name holds a pattern, or
    None where the slice holds none."""
    t = run.get('trace')
    if not t or not t['calls']:
        return None
    hit = [s for name, s in t['by_name'].items()
           if any(p in name.lower() for p in patterns)]
    if not hit:
        return None
    return 1e3 * sum(hit) / t['calls']


def _preload(device):
    sleep = getattr(torch.cuda, '_sleep', None)  # private; without it the host may pace
    if sleep is not None:
        sleep(PRELOAD_CYCLES)


def time_each(fn, device, launches=50, warm=5):
    """Median device seconds of one ``fn()``: each launch between its own pair of CUDA
    events, an L2-sized write before each (the caller's inputs come from HBM, as they
    do in the step), the batch queued while the card is held back so that no launch
    waits for the host."""
    for _ in range(warm):
        fn()
    buf = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=device)
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(launches)]
    torch.cuda.synchronize(device)
    _preload(device)
    for a, b in pairs:
        buf.zero_()
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize(device)
    return float(np.median([a.elapsed_time(b) for a, b in pairs])) / 1e3


def time_batch(fn, device, calls=10, warm=3):
    """Device seconds per ``fn()`` over a batch between two CUDA events, queued while
    the card is held back."""
    for _ in range(warm):
        fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    _preload(device)
    a.record()
    for _ in range(calls):
        fn()
    b.record()
    torch.cuda.synchronize(device)
    return a.elapsed_time(b) / 1e3 / calls

"""Profiling and timing utilities.

Counterpart of ``prysm_tpu/profiling.py``: thin wrappers over
``torch.profiler`` and a wall-clock timer that is honest about
asynchronous launches (it synchronises the CUDA devices of a call's
outputs before each clock read).  ``compiled_stats`` counts floating-point
operations with ``torch.utils.flop_counter.FlopCounterMode`` by running
the function once; torch has no compiled cost model to ask for bytes, so
FLOPs are all it reports.
"""
import contextlib
import json
import time
from pathlib import Path

import numpy as np
import torch


@contextlib.contextmanager
def trace(logdir):
    """Capture a torch.profiler trace (host and, with a card, CUDA) for the block.

    The Chrome trace is written into ``logdir`` as
    ``trace_<nanoseconds>.json``; view it in Perfetto or chrome://tracing.
    """
    logdir = Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(logdir / f'trace_{time.time_ns()}.json'))


def annotate(name):
    """Named region that shows up on the profiler timeline."""
    return torch.profiler.record_function(str(name))


def _cuda_devices(out, found):
    """The CUDA devices of the tensors in a (nested) call result."""
    if torch.is_tensor(out):
        if out.is_cuda:
            found.add(out.device)
    elif isinstance(out, dict):
        for v in out.values():
            _cuda_devices(v, found)
    elif isinstance(out, (list, tuple)):
        for v in out:
            _cuda_devices(v, found)
    return found


def _block(out):
    for dev in _cuda_devices(out, set()):
        torch.cuda.synchronize(dev)
    return out


def time_fn(fn, *args, iters=10, warmup=2, **kwargs):
    """Wall-clock statistics for fn(*args, **kwargs), launch-safe.

    Runs ``warmup`` untimed calls (builds and caches), then ``iters`` timed
    calls, synchronising the CUDA devices of each call's outputs before the
    clock is read, so asynchronous launches cannot hide device time.
    Returns a TimingResult.
    """
    for _ in range(int(warmup)):
        _block(fn(*args, **kwargs))
    samples = np.empty(int(iters), dtype=float)
    for i in range(int(iters)):
        t0 = time.perf_counter()
        _block(fn(*args, **kwargs))
        samples[i] = time.perf_counter() - t0
    return TimingResult(samples)


class TimingResult:
    """Per-call wall-clock samples plus summary statistics."""

    __slots__ = ('samples',)

    def __init__(self, samples):
        self.samples = np.asarray(samples, dtype=float)

    @property
    def mean(self):
        """Mean seconds per call."""
        return float(self.samples.mean())

    @property
    def median(self):
        """Median seconds per call."""
        return float(np.median(self.samples))

    @property
    def best(self):
        """Fastest call, seconds."""
        return float(self.samples.min())

    @property
    def std(self):
        """Standard deviation, seconds."""
        return float(self.samples.std())

    @property
    def per_second(self):
        """Calls per second at the median."""
        return 1.0 / self.median

    def __repr__(self):
        return (f'TimingResult(median={self.median * 1e3:.3f} ms, '
                f'best={self.best * 1e3:.3f} ms, n={self.samples.size})')


def device_memory_stats(device=None):
    """The CUDA caching allocator's statistics for one device, or {} without a card."""
    if device is None:
        if not torch.cuda.is_available():
            return {}
        device = torch.cuda.current_device()
    elif torch.device(device).type != 'cuda':
        return {}
    return dict(torch.cuda.memory_stats(device))


def compiled_stats(fn, *args, **kwargs):
    """{'flops': the floating-point operations of one call of fn}.

    Counted by ``FlopCounterMode`` while fn runs once; operations it has no
    formula for (elementwise ones among them) count 0.
    """
    from torch.utils.flop_counter import FlopCounterMode
    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args, **kwargs)
    return {'flops': float(counter.get_total_flops())}


def report(label, timing, flops=None, stream=None):
    """One machine-readable JSON line summarizing a timing run."""
    rec = {
        'label': str(label),
        'median_ms': round(timing.median * 1e3, 4),
        'best_ms': round(timing.best * 1e3, 4),
        'per_second': round(timing.per_second, 2),
    }
    if flops:
        rec['tflops_per_s'] = round(flops / timing.median / 1e12, 3)
    line = json.dumps(rec)
    print(line, file=stream)
    return rec


__all__ = [
    'trace', 'annotate', 'time_fn', 'TimingResult',
    'device_memory_stats', 'compiled_stats', 'report',
]

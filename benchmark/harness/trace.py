"""The traced slice: a bounded run of the cell's calls under ``torch.profiler``, reduced to
the numbers the per-layer readers take.

The slice is wrapped in a ``record_function`` span, so the device operations
and the slice share the profiler's clock.  The reduction keeps no trace on
disk: the device operations' intervals inside the slice, their union (the
busy time), their sums by name, the idle gaps between them named by the
innermost host operation that ran at each gap's middle, and the call count.
"""
import bisect
from collections import defaultdict

import torch

SLICE = 'benchmark.slice'
TRIES = 3
NAME_CHARS = 160
GAP_SCAN = 64


def _cuda(ev):
    return ev.device_type == torch.autograd.DeviceType.CUDA


def union(intervals):
    """(total length, merged (start, end) list) of possibly overlapping intervals."""
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1][1] = b
        else:
            merged.append([a, b])
    return sum(b - a for a, b in merged), merged


def _host_at(cpu, starts, t):
    """The innermost host operation running at time t, or 'python (between ops)'."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - GAP_SCAN, -1), -1):
        a, b, name = cpu[j]
        if b >= t:
            return name
    return 'python (between ops)'


def summarize(device, host, slice_span, calls):
    """The reduction of one slice.

    device: (start_us, end_us, name) of every device operation; host: the same of
    every host operation; slice_span: (start_us, end_us); calls: calls in the slice.
    """
    s0, s1 = slice_span
    inside = [(max(a, s0), min(b, s1), n) for a, b, n in device if b > s0 and a < s1]
    busy_us, merged = union([(a, b) for a, b, _ in inside])
    by_name = defaultdict(float)
    for a, b, n in inside:
        by_name[n[:NAME_CHARS]] += (b - a) / 1e6
    cpu = sorted((a, b, n) for a, b, n in host if n != SLICE)
    starts = [c[0] for c in cpu]
    gaps = defaultdict(float)
    edges = [s0] + [x for ab in merged for x in ab] + [s1]
    for a, b in zip(edges[::2], edges[1::2]):
        if b > a:
            gaps[_host_at(cpu, starts, (a + b) / 2)[:NAME_CHARS]] += (b - a) / 1e6
    return {'window_s': (s1 - s0) / 1e6, 'busy_s': busy_us / 1e6, 'device_ops': len(inside),
            'calls': calls, 'by_name': dict(by_name), 'gaps': dict(gaps)}


def top(d, n=10):
    """The n largest entries of a {name: seconds} dict as [[name, seconds], ...]."""
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def profile_slice(run_calls, calls, agree=lambda found: found):
    """Profile ``run_calls(n)`` (which runs n calls and synchronises) until the trace holds
    device operations, at most ``TRIES`` times; ``agree`` makes ranks decide alike.

    Returns (summary or None, calls run in all).
    """
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    ran = 0
    for _ in range(TRIES):
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function(SLICE):
                run_calls(calls)
        ran += calls
        device, host, span = [], [], None
        events = prof.events()
        # a user annotation also appears on the device's timeline: not an operation
        spans = {ev.name for ev in events if getattr(ev, 'is_user_annotation', False)}
        spans.add(SLICE)
        for ev in events:
            item = (ev.time_range.start, ev.time_range.end, ev.name)
            if _cuda(ev):
                if ev.name not in spans:
                    device.append(item)
            elif ev.name == SLICE:
                span = item[:2]
            else:
                host.append(item)
        found = bool(device) and span is not None
        if agree(found):
            return summarize(device, host, span, calls), ran
    return None, ran

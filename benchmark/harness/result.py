"""The contract's result object, from the records of a run's processes."""
import math

from .trace import top


def within(value, limit):
    """A compared number passes only if it is finite and at most its limit: a NaN or an
    infinity from the program is a failure, never a pass."""
    return limit is not None and math.isfinite(value) and value <= limit


def worst(values):
    """The worst of a number's readings: a non-finite one first (as its string, which
    JSON can carry), else the largest."""
    values = list(values)
    for v in values:
        if not math.isfinite(v):
            return str(v)
    return max(values, default=None)


def result_line(records, trace, chips):
    """The contract's result object from the ranks' records (rank 0 first)."""
    head = records[0]
    limits = head['limits']
    rows = head['judged']
    names = list(limits)
    checks = {n: {'value': worst(r[n] for r in rows), 'limit': limits[n]} for n in names}
    failed = sum(not all(within(r[n], limits[n]) for n in names) for r in rows)
    correct = bool(rows) and failed == 0
    device = {'platform': 'gpu', 'kind': head['kind'], 'count': chips,
              'memory_peak_bytes': max(r['memory_peak_bytes'] for r in records)}
    out = {'correct': correct, 'attempted': head['calls'], 'failed': failed,
           'metrics': head['metrics'], 'device': device}
    if trace:
        traces = [r['trace'] for r in records]
        if any(t is None for t in traces):
            raise RuntimeError('a traced slice held no device operation in 3 tries')
        device['busy_s'] = sum(t['busy_s'] for t in traces) / len(traces)
        device['window_s'] = sum(t['window_s'] for t in traces) / len(traces)
        out['breakdown'] = {'device_ops': top(traces[0]['by_name']),
                            'idle_gaps': top(traces[0]['gaps'])}
    out['checks'] = checks
    return out

"""The general generator: every input sequence a cell needs, from its traffic mix's
parameters and the run's seed.

Seeds are any whole number (more than 32 bits are common); each purpose draws
from its own stream, ``numpy.random.default_rng([seed mod 2**64, purpose])``,
so that adding a purpose leaves the others' draws alone.  The same seed gives
the same inputs in every run.
"""
import numpy as np
from scipy.signal import lfilter

STATE, DRIFT, KEEP, JUDGE, DRIFT2 = range(5)


def rng(seed, purpose):
    """The generator of one purpose of one seed."""
    return np.random.default_rng([int(seed) % 2 ** 64, purpose])


def drift(seed, purpose, steps, dims, rms, corr, bound=None):
    """(steps, dims) float64: a stationary AR(1) walk of ``rms`` per component whose
    correlation falls by 1/e over ``corr`` steps, clipped to +-``bound``."""
    g = rng(seed, purpose)
    rho = float(np.exp(-1.0 / corr))
    shocks = g.standard_normal((steps, dims)) * (rms * np.sqrt(1 - rho * rho))
    start = g.standard_normal(dims) * rms
    walk, _ = lfilter([1.0], [1.0, -rho], shocks, axis=0, zi=(rho * start)[None, :])
    if bound is not None:
        walk = np.clip(walk, -bound, bound)
    return walk


def keep_offset(seed, every):
    """Calls k with k % every == offset keep their outputs for the judge."""
    return int(rng(seed, KEEP).integers(every))


def judge_sample(seed, kept, n):
    """Up to n of the kept call indices, drawn from the seed, with the first and last."""
    kept = sorted(kept)
    if len(kept) <= n:
        return kept
    g = rng(seed, JUDGE)
    inner = g.choice(np.arange(1, len(kept) - 1), size=n - 2, replace=False)
    return sorted({kept[0], kept[-1], *(kept[i] for i in inner)})

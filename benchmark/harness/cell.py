"""What every cell is to the harness, and the measured window.

A cell holds the program's state for one configuration under one traffic
mix.  ``call(k)`` makes the k-th call of its entry as the traffic says
(uploads, the entry, the host reads); ``finish()`` waits for the device.
It keeps the outputs of the calls the judge will look at, hands them over
in ``answers()``, and ``free()`` drops the program's state before the
reference runs.
"""
import time

import torch


class Cell:
    """The common part of a cell; subclasses define ``call`` and ``answers``."""

    #: a call count all ranks agree on before the window, or None to run by the clock
    fixed_calls = None

    def __init__(self, device):
        self.device = torch.device(device)

    def call(self, k):
        raise NotImplementedError

    def finish(self):
        """Wait until the device has done every call."""
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)

    def warm(self, calls):
        """Run ``calls`` calls that build, plan and allocate everything, then forget them."""
        for k in range(calls):
            self.call(k)
        self.finish()
        self.reset()

    def reset(self):
        """Return to the seeded starting state, keeping the program's built state."""
        raise NotImplementedError

    def answers(self, calls):
        """What the judge needs of the first ``calls`` calls, on the host."""
        raise NotImplementedError

    def free(self):
        """Drop the program's state (the device memory goes back to the allocator)."""
        self.__dict__.clear()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


def run_window(cell, seconds):
    """(window seconds, calls): calls from 0 until ``seconds`` have passed (or the cell's
    fixed count is reached), then one wait for the device; every call's whole time
    counts, the wait included."""
    n = 0
    fixed = cell.fixed_calls
    start = time.perf_counter()
    while True:
        cell.call(n)
        n += 1
        if fixed is not None:
            if n >= fixed:
                break
        elif time.perf_counter() - start >= seconds:
            break
    cell.finish()
    return time.perf_counter() - start, n

"""idle_share.broadband: the share of the traced slice in which no operation ran on the
card (rank 0's card in a distributed cell), percent: 1 minus the union of the
device operations' intervals over the slice (torch.profiler)."""
from benchmark.harness.readers import idle_percent


def read(run):
    return idle_percent(run)

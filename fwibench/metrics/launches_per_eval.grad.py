"""Kernel launches an evaluation made, from the port's launch counters (an
exact count)."""
from fwibench.harness import readers


def read(run):
    return readers.launches_per_unit(run)

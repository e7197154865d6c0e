"""1 - busy / window of the traced stretch of evaluations: busy is the union
of the device intervals, the window the stretch's host-clock length, in
percent."""
from fwibench.harness import readers


def read(run):
    return readers.idle_share(run)

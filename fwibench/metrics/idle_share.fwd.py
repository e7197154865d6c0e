"""1 - busy / window of the traced stretch of forward calls, in percent."""
from fwibench.harness import readers


def read(run):
    return readers.idle_share(run)

"""GCell/s of the window's gradient evaluations: nz nx (nt-1) shots on the
padded grid, times the evaluations completed, over the window from the
first evaluation's start to the end of the first one that finished after
--seconds."""
from fwibench.harness import readers


def read(run):
    return readers.rate_gcell_s(run, "invert")

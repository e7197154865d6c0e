"""GCell/s of the window's forward calls, each with its data on the host: nz
nx (nt-1) shots, times the calls, over the window from the first call's
start to the end of the first that finished after --seconds."""
from fwibench.harness import readers


def read(run):
    return readers.rate_gcell_s(run, "forward")

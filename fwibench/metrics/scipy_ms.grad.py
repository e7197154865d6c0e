"""Self time of the port's `optimize.lbfgsb` span inside the window
(scipy's L-BFGS-B between the evaluations), less the profiler's start
and stop, per evaluation, in ms."""
from fwibench.harness import program


def read(run):
    return program.outer_self_ms(run, "optimize.lbfgsb")

"""The 90th percentile of the evaluations' wall time
(ScipyObjective._evaluate: unpack, the loss, autograd.grad, the gradient to
the host), in ms, with its sample count."""
from fwibench.harness import readers


def read(run):
    return readers.p90_ms(run)

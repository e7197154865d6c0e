"""The 90th percentile of the port's `optimize.evaluate` spans (one
evaluation: unpack, the loss, autograd.grad, the gradient to the host),
in ms, with its sample count."""
from fwibench.harness import program


def read(run):
    return program.p90_ms(run, "optimize.evaluate")

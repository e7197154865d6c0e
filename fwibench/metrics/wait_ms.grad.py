"""Self time of the port's `optimize.to_host` spans (the wait for the
card, the loss and the gradients copied back), per evaluation, in ms."""
from fwibench.harness import program


def read(run):
    return program.per_unit_ms(run, {"optimize.to_host"})

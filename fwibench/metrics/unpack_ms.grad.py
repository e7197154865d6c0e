"""Self time of the port's `optimize.unpack` spans (scipy's float64 x to
the device tensors), per evaluation, in ms."""
from fwibench.harness import program


def read(run):
    return program.per_unit_ms(run, {"optimize.unpack"})

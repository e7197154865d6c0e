"""The port's `cuda_engine.forward` spans (the kernel library's call that
enqueues a forward's launches), per forward call, in ms."""
from fwibench.harness import program


def read(run):
    return program.per_unit_ms(run, {"cuda_engine.forward"}, own=False)

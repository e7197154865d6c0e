"""Self time of the port's `parallel.chunk` spans (a shot chunk's host
work outside the kernel library's forward call: the propagation's set-up,
the gather of a ragged survey's receivers, the misfit's operations and the
chunk's sum, enqueued), per evaluation, in ms.  It holds a wait for the
card: the misfit's blocking upload of its channel index waits for the
forward's queued kernels, so most of the number is the forward's device
time that the library's call did not wait for."""
from fwibench.harness import program


def read(run):
    return program.per_unit_ms(run, {"parallel.chunk"})

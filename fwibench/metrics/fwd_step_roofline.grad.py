"""fwd_step_kernel's share of its roofline over the traced evaluations: the
bound of the forward-with-strips work (work/forward_strips.json) over the
device time the trace gives the kernel, in percent."""
from fwibench.harness import readers


def read(run):
    return readers.roofline(run, "fwd_step_kernel")

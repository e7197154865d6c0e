"""bwd_step_kernel's share of its roofline over the traced evaluations: the
bound of the adjoint's work (work/adjoint.json) over the device time the
trace gives the kernel, in percent."""
from fwibench.harness import readers


def read(run):
    return readers.roofline(run, "bwd_step_kernel")

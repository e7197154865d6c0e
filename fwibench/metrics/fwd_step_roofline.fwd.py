"""fwd_step_kernel's share of its roofline over the traced calls: the bound of
the forward's work (work/forward.json) over the device time the trace gives
the kernel, in percent."""
from fwibench.harness import readers


def read(run):
    return readers.roofline(run, "fwd_step_kernel")

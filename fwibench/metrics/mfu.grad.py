"""The algorithm's FP32 operations of the traced evaluations (forward with
strips, adjoint, shot sum) over the traced stretch's seconds and the 67
TFLOP/s peak, in percent."""
from fwibench.harness import readers


def read(run):
    return readers.mfu(run)

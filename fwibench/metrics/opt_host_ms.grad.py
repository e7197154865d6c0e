"""Window time outside the evaluations (scipy's L-BFGS-B between them), per
evaluation, in ms."""
from fwibench.harness import readers


def read(run):
    return readers.outside_units_ms(run)

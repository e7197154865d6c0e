"""Self time of the port's `heads.apply` spans (the blend's uploads and
the physics map), per evaluation, in ms."""
from fwibench.harness import program


def read(run):
    return program.per_unit_ms(run, {"heads.apply"})

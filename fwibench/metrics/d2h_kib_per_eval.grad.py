"""KiB the port copied from the device to the host inside the window's
evaluations (its copy counters), per evaluation."""
from fwibench.harness import program


def read(run):
    return program.copied_kib(run, "d2h")

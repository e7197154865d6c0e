"""KiB the port copied from the host to the device inside the window's
evaluations (its copy counters), per evaluation."""
from fwibench.harness import program


def read(run):
    return program.copied_kib(run, "h2d")

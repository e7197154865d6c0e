"""Seconds from the start of the run to the end of the warm-up: imports, the
kernel library's load (its build on a checkout's first run), the inputs,
the observed data and one warm evaluation or call."""


def read(run):
    return run.setup_s

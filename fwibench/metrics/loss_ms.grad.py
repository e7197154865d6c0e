"""Mean of the port's `optimize.loss` spans (the call into the loss,
the head included; the forward's launches enqueued, not waited for), in
ms."""
from fwibench.harness import program


def read(run):
    return program.mean_ms(run, "optimize.loss")

"""The port's `optimize.grad` spans (the call into `torch.autograd.grad`)
less its `cuda_engine.backward` spans (the kernel library's adjoint call,
on autograd's device thread): the backward's host work outside the kernel
library, the misfit's and the head's chain rule, per evaluation, in ms."""
from fwibench.harness import program


def read(run):
    return program.less_ms(run, "optimize.grad", {"cuda_engine.backward"})

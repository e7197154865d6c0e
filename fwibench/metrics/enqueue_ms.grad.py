"""The port's `cuda_engine.forward` and `cuda_engine.backward` spans (the
kernel library's calls that enqueue the launches, any wait for a full
launch queue included), per evaluation, in ms.  Where the card is the
bottleneck (main004-invert) the launch queue fills and the calls block on
it, so the number follows the device's time there, not the host's cost of
enqueueing."""
from fwibench.harness import program


def read(run):
    return program.per_unit_ms(run, {"cuda_engine.forward",
                                      "cuda_engine.backward"}, own=False)

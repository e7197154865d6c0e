"""Mean wall time of the call into the loss cli.build_stage_loss built, the
head's map included (the forward's launches are enqueued, not waited for),
in ms."""
from fwibench.harness import readers


def read(run):
    return readers.loss_call_ms(run)

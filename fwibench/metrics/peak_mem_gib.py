"""torch.cuda.max_memory_allocated() over the run until the window closed,
set-up included, in GiB (2**30 bytes)."""


def read(run):
    return run.peak_bytes / 2 ** 30 if run.peak_bytes else None

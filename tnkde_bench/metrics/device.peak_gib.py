"""Device memory: ``torch.cuda.max_memory_allocated()`` over set-up and the
window, GiB (a cache that trades memory for time shows here). Moves
``windows_per_s``."""


def read(run):
    return run.peak_bytes / 2**30 if run.peak_bytes else None

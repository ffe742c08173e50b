"""peak_gib: `torch.cuda.max_memory_allocated` over the window, reset at
its start, in GiB; nothing where the run had no CUDA device."""


def read(run):
    return run.peak_bytes / 2**30 if run.peak_bytes else None

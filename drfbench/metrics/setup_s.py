"""setup_s: seconds from the command's start to the end of the warm fit:
imports, CUDA start, rows made on the device and handed over, the bin
cache of a streamed mix, and the warm fit (with the first kernel build in
a fresh checkout)."""


def read(run):
    return run.setup_s

"""Hand-written Hopper kernels of the port and their plain versions.

`split_scan` (exact numeric supersplit), `cat_hist` (categorical count
tables) and `feat_hist` (hist-mode bin tables) replace the Pallas TPU
kernels of `repro.kernels`.  Their CUDA
sources live in `repro_torch/csrc/` and are built on first use
(`_build.py`); nothing CUDA-specific happens when a module is imported.
"""

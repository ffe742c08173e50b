"""PyTorch / CUDA port of the exact distributed Random Forest (`repro`).

The package mirrors `repro`'s module layout and names so each counterpart
is easy to find, but it is written in PyTorch's idiom: plain functions on
tensors, frozen dataclasses for engines and parameters, an explicit
`device`, and an explicit leading tree axis where `repro` used `vmap`.

It imports `torch` and numpy only, never `jax` or `repro`.  Entry points
run on CUDA unless the caller asks for `device="cpu"`; the hand-written
Hopper kernels (`repro_torch.kernels`) are built at first use.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]

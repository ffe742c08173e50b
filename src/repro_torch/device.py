"""Device resolution and numerics settings for the port.

Every entry point takes an explicit `device`.  `None` means the card:
the port is written for an NVIDIA H100, and a missing GPU is an error, not
a silent fall back to the CPU.  The CPU is used only when the caller names
it (the parity tests do).
"""
from __future__ import annotations

import torch


def _set_numerics() -> None:
    # float32 matmuls and convolutions in full float32: TF32 keeps about
    # three decimal digits, which would break the exact-count arithmetic
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


_set_numerics()


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.

    `None` or `"cuda"` resolve to the current CUDA device and raise when no
    GPU is present; `"cpu"` (or any explicit torch device) is taken as is.
    """
    if device is None:
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on CUDA by default and no GPU is available; "
                "pass device='cpu' to run the plain PyTorch path on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev

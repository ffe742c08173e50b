"""Crash-safe file writes: temporary file + `os.replace`, ported from
`repro.core.atomicio`.

Every durable artifact of the port — `PackedForest.save` models, the
`MemmapRowSource` cache sidecar, streamed-training checkpoints — goes
through `atomic_replace`: the bytes land in a temporary file beside the
target, and `os.replace` (atomic on POSIX within one filesystem) installs
them under the final name.  A kill at any instruction leaves either the
complete old file or the complete new one, never a torn one.

`PRE_REPLACE_HOOK` exists for the fault-injection harness
(`repro_torch.testing.faults`): a test arms it to SIGKILL the process in
the worst window (temporary file written, replace pending) and then shows
that the file on disk is still the intact previous version.
"""
from __future__ import annotations

import json
import os
from typing import Callable

# Test hook: `PRE_REPLACE_HOOK[0](final_path, tmp_path)` runs after the
# temporary file is fully written, just before `os.replace`.  Production
# code never sets it.
PRE_REPLACE_HOOK: list = [None]


def atomic_replace(path, write_fn: Callable[[str], None]) -> None:
    """Write a file atomically: `write_fn(tmp_path)`, then `os.replace`.

    `write_fn` must create exactly the path it is given (open it in
    binary mode for numpy's savers, which would append ".npz" to a bare
    file name).  The temporary file sits beside the target, so the rename
    never crosses a filesystem.
    """
    path = os.fspath(path)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        write_fn(tmp)
        if PRE_REPLACE_HOOK[0] is not None:
            PRE_REPLACE_HOOK[0](path, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def atomic_write_json(path, obj) -> None:
    """`json.dump` through `atomic_replace` (manifests, cache sidecars)."""
    def write(tmp):
        with open(tmp, "w") as f:
            json.dump(obj, f, indent=1, sort_keys=True)
    atomic_replace(path, write)

"""The device mesh of the port's sharded engines, over `torch.distributed`.

The reference lays its devices out as a `jax.sharding.Mesh` with axes
`("data", "model")` and lets `shard_map` slice global arrays over them
(`repro/launch/mesh.py`, `repro/core/level/sharded.py`).  Here every
device of the mesh is one process (rank) of an initialized
`torch.distributed` group, and `Mesh` gives the engines what `shard_map`
gave them: the axis sizes, this rank's coordinates, and the collectives
over one named axis (`all_gather`, `all_reduce` with sum or max).  Ranks
are laid out row-major, as the reference reshapes its device list: the
rank at coordinates (r, f) is `ranks[r * model + f]`.  Each line of ranks
along an axis gets its own process group (`dist.new_group`), created by
every rank in the same order.

The backend is named by the caller, never guessed:

  * `"gloo"` on the CPU, and for several ranks that share one card (NCCL
    refuses two ranks on one device);
  * `"nccl"` only with one card per rank: `make_mesh` raises when the
    host has fewer cards than the mesh has ranks.

gloo takes CUDA tensors for some collectives and not for others;
`make_mesh` asks the installed gloo once per mesh, on a one-element
tensor, and the collectives it refuses as an unsupported device type are
staged through (pinned) host buffers here (`Mesh.staged` lists them).
Any other error of that probe is raised.  The engines' arithmetic stays
on the device either way.

Every collective is counted: its bytes (this rank's payload), with the
level it ran in, in `Mesh.log`.  A mesh made with `timed=True` also logs
each collective's seconds (host clock, the device synchronized before
and after on CUDA); an untimed mesh logs None there and adds no
synchronization to the training path.  Engines mark a new level with
`begin_level`; `reset_log` empties the log.
"""
from __future__ import annotations

import re
import time
from typing import Optional

import torch
import torch.distributed as dist

AXES = ("data", "model")
_OPS = ("all_gather", "all_reduce_sum", "all_reduce_max")
# how gloo refuses a tensor's device (ProcessGroupGloo's invalid-argument
# message, or the dispatcher's when gloo registers no CUDA backend)
_REFUSAL = re.compile(r"unsupported device type|no backend type associated "
                      r"with device type", re.IGNORECASE)


class Mesh:
    """This rank's view of a (data, model) mesh of processes.

    `shape` maps each axis to its size and `coords` to this rank's index
    on it; `device` is where the rank's engines run.  Create it with
    `make_mesh`.  Engines hold it as a dataclass field, so it hashes and
    compares by identity.
    """

    def __init__(self, shape: dict, coords: dict, groups: dict,
                 backend: str, device: torch.device, staged: frozenset,
                 timed: bool = False):
        self.shape = shape
        self.coords = coords
        self._groups = groups
        self.backend = backend
        self.device = device
        self.staged = staged
        self.timed = timed
        self.log: list[dict] = []
        self.level = 0
        self._level_key = None

    def __repr__(self) -> str:
        return (f"Mesh(data={self.shape['data']}, "
                f"model={self.shape['model']}, at={self.coords}, "
                f"backend={self.backend!r}, device={self.device})")

    def axis_size(self, axis: str) -> int:
        return self.shape[axis]

    def axis_index(self, axis: str) -> int:
        return self.coords[axis]

    def shard(self, size: int, axis: str, what: str) -> slice:
        """This rank's block of `size` items split evenly over `axis`.
        Raises ValueError when the axis size does not divide `size`, as
        `shard_map` refuses such an array in the reference."""
        k = self.shape[axis]
        if size % k:
            raise ValueError(f"{what}: {size} is not divisible by the "
                             f"{axis!r} axis size {k}")
        b = size // k
        i = self.coords[axis]
        return slice(i * b, (i + 1) * b)

    # -- bookkeeping --------------------------------------------------------

    def begin_level(self, key) -> None:
        """Count a new level when `key`, a tensor of the level's state, is
        not the last one seen: both engines of one level pass the same
        tensor, so the level is counted once.  The mesh holds the key until
        the next level (or `reset_log`), so no later level's tensor can
        take its place."""
        if key is not self._level_key:
            self._level_key = key
            self.level += 1

    def reset_log(self) -> None:
        self.log = []
        self.level = 0
        self._level_key = None

    # -- collectives over one axis -------------------------------------------

    def all_gather(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """(axis size, *x.shape): every rank's `x` along `axis`, in axis
        order."""
        if self.shape[axis] == 1:
            return x[None]
        kind = x.dtype
        src = x.to(torch.uint8) if kind == torch.bool else x.contiguous()
        out = self._run("all_gather", axis, src)
        return out.to(torch.bool) if kind == torch.bool else out

    def all_reduce(self, x: torch.Tensor, axis: str,
                   op: str = "sum") -> torch.Tensor:
        """The elementwise sum or max of `x` over `axis` (a new tensor)."""
        if op not in ("sum", "max"):
            raise ValueError(f"all_reduce op must be 'sum' or 'max', "
                             f"got {op!r}")
        if self.shape[axis] == 1:
            return x
        return self._run(f"all_reduce_{op}", axis, x.contiguous())

    def _run(self, op: str, axis: str, x: torch.Tensor) -> torch.Tensor:
        group = self._groups[axis]
        sync = self.timed and x.device.type == "cuda"
        staged = op in self.staged
        if sync:
            torch.cuda.synchronize(x.device)
        t0 = time.perf_counter()
        y = _host_copy(x) if staged else x
        out = _collective(op, y, group, self.shape[axis])
        if staged:
            out = out.to(x.device, non_blocking=True)
        if sync:
            torch.cuda.synchronize(x.device)
        self.log.append(dict(level=self.level, op=op, axis=axis,
                             bytes=x.numel() * x.element_size(),
                             seconds=(time.perf_counter() - t0
                                      if self.timed else None),
                             staged=staged))
        return out


def _host_copy(x: torch.Tensor) -> torch.Tensor:
    """A host copy of `x`, in pinned memory when `x` is on the card."""
    h = torch.empty(x.shape, dtype=x.dtype, pin_memory=x.is_cuda)
    h.copy_(x)
    return h


def _collective(op: str, x: torch.Tensor, group, size: int) -> torch.Tensor:
    if op == "all_gather":
        out = torch.empty((size,) + tuple(x.shape), dtype=x.dtype,
                          device=x.device)
        dist.all_gather(list(out.unbind(0)), x, group=group)
        return out
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM if op == "all_reduce_sum"
                    else dist.ReduceOp.MAX, group=group)
    return out


def _gloo_refuses(device: torch.device) -> frozenset:
    """The collectives the installed gloo refuses on a CUDA tensor, asked
    on a one-element tensor over a gloo group of every rank.  gloo checks
    the device type before it communicates, so every rank gets the same
    answer."""
    group = dist.new_group(backend="gloo")
    refused = set()
    x = torch.ones(1, device=device)
    for op in _OPS:
        try:
            _collective(op, x, group, dist.get_world_size())
        except (RuntimeError, ValueError) as e:
            if not _REFUSAL.search(str(e)):
                raise
            refused.add(op)
    torch.cuda.synchronize(device)
    return frozenset(refused)


def make_mesh(data: int, model: int, *, backend: str, device=None,
              ranks: Optional[list] = None,
              timed: bool = False) -> Optional[Mesh]:
    """The (data, model) mesh over `ranks` (default: every rank of the
    initialized default group), as this rank sees it.

    Every rank of the default group must call it with the same arguments,
    since each creates every axis group; a rank outside `ranks` gets None.
    `device` is where this rank's engines run (default: the current CUDA
    device); `timed=True` logs each collective's seconds.  Raises RuntimeError when `torch.distributed` is not
    initialized, and ValueError for a mesh whose size is not the number
    of ranks, an unknown backend, or NCCL with fewer cards than ranks.
    """
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized torch.distributed "
                           "default group (init_process_group)")
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be 'gloo' or 'nccl', got {backend!r}")
    ranks = list(range(dist.get_world_size())) if ranks is None \
        else [int(r) for r in ranks]
    if data < 1 or model < 1 or len(ranks) != data * model:
        raise ValueError(f"a ({data}, {model}) mesh needs {data * model} "
                         f"ranks, got {len(ranks)}")
    if backend == "nccl" and torch.cuda.device_count() < len(ranks):
        raise ValueError(
            f"NCCL needs one card per rank: {len(ranks)} ranks, "
            f"{torch.cuda.device_count()} cards (several ranks on one card "
            f"run gloo)")
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    lines = {"data": [[ranks[r * model + f] for r in range(data)]
                      for f in range(model)],
             "model": [[ranks[r * model + f] for f in range(model)]
                       for r in range(data)]}
    me = dist.get_rank()
    groups = {}
    for axis in AXES:
        if len(lines[axis][0]) == 1:
            continue                    # a size-1 axis has no collective
        for line in lines[axis]:
            g = dist.new_group(line, backend=backend)
            if me in line:
                groups[axis] = g
    staged = frozenset()
    if backend == "gloo" and device.type == "cuda":
        staged = _gloo_refuses(device)
    if me not in ranks:
        return None
    r, f = divmod(ranks.index(me), model)
    return Mesh({"data": data, "model": model}, {"data": r, "model": f},
                groups, backend, device, staged, timed)

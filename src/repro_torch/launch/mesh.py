"""The device meshes of the port, over `torch.distributed`: the forest
engines' `Mesh` (`make_mesh`) and the LM's `DeviceMesh`
(`make_production_mesh`, `make_host_mesh`).

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
    host has fewer cards than the mesh has ranks;
  * `"fake"` in a world of torch's placeholder process group (the dry
    run, `launch.dryrun.run_drf`): collectives move nothing and return
    no data, but every call is logged with its bytes.

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
    if backend not in ("gloo", "nccl", "fake"):
        raise ValueError(f"backend must be 'gloo' or 'nccl' (or 'fake' in "
                         f"a placeholder world), got {backend!r}")
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


# ---------------------------------------------------------------------------
# The LM meshes: torch DeviceMesh over the default group
# ---------------------------------------------------------------------------
#
# The reference's production meshes are TPU v5e pods: (16, 16) = 256 chips,
# and (2, 16, 16) = 512 with a leading "pod" axis, every axis on the pod's
# ICI torus.  An H100 cluster is built differently, so the shapes are
# re-derived for it with the same chip counts:
#
#   * "model" (tensor and expert-inner parallelism: a collective per
#     layer, on the critical path) spans one 8-GPU HGX H100 node, whose
#     NVLink 4 / NVSwitch domain gives each GPU 900 GB/s (450 GB/s each
#     way) to any other GPU of the node (NVIDIA H100 Tensor Core GPU
#     datasheet; DGX H100 user guide).  A wider "model" axis would leave
#     the NVLink domain for every per-layer collective.
#   * "data" (batch, FSDP over `embed_fsdp`, experts) crosses nodes, over
#     the node's eight ConnectX-7 InfiniBand NDR ports, one a GPU at 400
#     Gb/s = 50 GB/s each way (DGX H100 datasheet).  Its collectives are
#     the FSDP all-gathers and reduce-scatters, once a layer a step.
#   * "pod" (multi-pod: a second group of nodes) also crosses InfiniBand.
#
# So (data, model) = (32, 8) is 32 nodes of 8 cards, and (pod, data,
# model) = (2, 32, 8) two such groups.  The reference's TPU shapes stay
# reachable through `shape=`, for comparing rule tables only.

PRODUCTION_SHAPE = (32, 8)
MULTI_POD_SHAPE = (2, 32, 8)
NODE_GPUS = 8


def _device_mesh(shape: tuple, device_type: Optional[str]):
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("an LM mesh needs an initialized torch.distributed "
                           "default group (init_process_group)")
    names = ("pod", "data", "model")[-len(shape):] if len(shape) in (2, 3) \
        else None
    if names is None:
        raise ValueError(f"an LM mesh has 2 or 3 axes, got shape {shape}")
    size = 1
    for d in shape:
        size *= int(d)
    if size != dist.get_world_size():
        raise ValueError(f"a {shape} mesh needs {size} ranks, the default "
                         f"group has {dist.get_world_size()}")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type or "cuda", tuple(int(d) for d in shape),
                            mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, shape=None,
                         device_type: Optional[str] = None):
    """The production `DeviceMesh` over every rank of the default group:
    ("data", "model") = (32, 8), or ("pod", "data", "model") = (2, 32, 8)
    with `multi_pod` (see above).  `shape` replaces the shape (2 axes:
    data, model; 3: pod, data, model).  `device_type` defaults to "cuda"."""
    if shape is None:
        shape = MULTI_POD_SHAPE if multi_pod else PRODUCTION_SHAPE
    return _device_mesh(tuple(shape), device_type)


def make_host_mesh(data: int = 2, model: int = 4, *,
                   device_type: Optional[str] = None):
    """A small ("data", "model") `DeviceMesh` over every rank of the
    default group, for tests (device_type="cpu" with gloo ranks on the
    CPU) and for gloo ranks sharing one card."""
    return _device_mesh((data, model), device_type)


# ---------------------------------------------------------------------------
# DTensor's collectives on gloo with CUDA tensors
# ---------------------------------------------------------------------------
#
# DTensor communicates through torch's functional collectives
# (`_c10d_functional.*` ops, completed by `wait_tensor`).  On gloo with
# CUDA tensors those crash the process (torch 2.11 on an H100: SIGSEGV
# in `wait_tensor`, on the default group and on subgroups alike), while
# gloo's eager collectives take the same CUDA tensors (all_reduce,
# all_gather_into_tensor, reduce_scatter_tensor, all_to_all_single and
# broadcast all ran).  `eager_collectives` registers eager
# implementations of the functional ops for one dispatch key: each runs
# the matching `torch.distributed` call on the op's group, synchronously,
# and `wait_tensor` has nothing left to wait for.  It also logs each
# call's result bytes by group name (`COLLECTIVE_LOG`).  Gloo has no
# AVG: an average is a sum divided by the group size.

COLLECTIVE_LOG: list = []      # (group name, op, result bytes)
_EAGER_LIBS: dict = {}
_OPS_BY_NAME = {"sum": "SUM", "avg": "SUM", "max": "MAX", "min": "MIN",
                "product": "PRODUCT"}


def _group(name):
    if isinstance(name, dist.ProcessGroup):
        return name
    return dist.distributed_c10d._resolve_process_group(name)


def _log(name, op, t):
    key = name if isinstance(name, str) else getattr(name, "group_name", "")
    COLLECTIVE_LOG.append((key, op, t.numel() * t.element_size()))


def _reduce(op: str, out, group):
    if op == "avg":
        out.div_(group.size())
    return out


def eager_collectives(dispatch_key: str = "CUDA") -> None:
    """Route torch's functional collectives on `dispatch_key` tensors to
    the eager `torch.distributed` calls (see above).  Idempotent; stays
    in force for the process."""
    if dispatch_key in _EAGER_LIBS:
        return
    lib = torch.library.Library("_c10d_functional", "IMPL")

    def red(op):
        return getattr(dist.ReduceOp, _OPS_BY_NAME[op])

    def all_gather_into_tensor(x, group_size, name):
        g = _group(name)
        out = x.new_empty((x.shape[0] * group_size, *x.shape[1:]))
        dist.all_gather_into_tensor(out, x.contiguous(), group=g)
        _log(name, "all-gather", out)
        return out

    def reduce_scatter_tensor(x, op, group_size, name):
        g = _group(name)
        out = x.new_empty((x.shape[0] // group_size, *x.shape[1:]))
        dist.reduce_scatter_tensor(out, x.contiguous(), op=red(op), group=g)
        _log(name, "reduce-scatter", out)
        return _reduce(op, out, g)

    def all_reduce(x, op, name):
        g = _group(name)
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=red(op), group=g)
        _log(name, "all-reduce", out)
        return _reduce(op, out, g)

    def all_reduce_(x, op, name):
        out = all_reduce(x, op, name)
        return x.copy_(out)

    def all_to_all_single(x, out_splits, in_splits, name):
        g = _group(name)
        rows = sum(out_splits) if out_splits else x.shape[0]
        out = x.new_empty((rows, *x.shape[1:]))
        dist.all_to_all_single(out, x.contiguous(),
                               list(out_splits) or None,
                               list(in_splits) or None, group=g)
        _log(name, "all-to-all", out)
        return out

    def shard_dim_alltoall(x, gather_dim, shard_dim, name):
        # DTensor's Shard(gather_dim) -> Shard(shard_dim): send chunk j of
        # shard_dim to rank j, concatenate what arrives along gather_dim
        g = _group(name)
        n = g.size()
        send = torch.stack(x.chunk(n, dim=shard_dim)).contiguous()
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=g)
        _log(name, "all-to-all", recv)
        return torch.cat(recv.unbind(0), dim=gather_dim)

    def broadcast(x, src, name):
        g = _group(name)
        out = x.clone(memory_format=torch.contiguous_format)
        dist.broadcast(out, dist.get_global_rank(g, src), group=g)
        _log(name, "broadcast", out)
        return out

    for op, fn in (("all_gather_into_tensor", all_gather_into_tensor),
                   ("reduce_scatter_tensor", reduce_scatter_tensor),
                   ("all_reduce", all_reduce), ("all_reduce_", all_reduce_),
                   ("all_to_all_single", all_to_all_single),
                   ("broadcast", broadcast),
                   ("wait_tensor", lambda t: t)):
        lib.impl(op, fn, dispatch_key)
    dlib = torch.library.Library("_dtensor", "IMPL")
    dlib.impl("shard_dim_alltoall", shard_dim_alltoall, dispatch_key)
    _EAGER_LIBS[dispatch_key] = (lib, dlib)


def collective_bytes_by_axis(mesh, log=None) -> dict:
    """{axis: result bytes} of `COLLECTIVE_LOG` (or `log`) on `mesh`'s
    axis groups; an all-reduce counts twice, as in the dry run."""
    names = {mesh.get_group(a).group_name: a for a in mesh.mesh_dim_names}
    out = {}
    for name, op, b in (COLLECTIVE_LOG if log is None else log):
        a = names.get(name, name)
        out[a] = out.get(a, 0) + b * (2 if op == "all-reduce" else 1)
    return out

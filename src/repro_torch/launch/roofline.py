"""Roofline terms of one rank's step, counted from an eager run, ported
from `repro.launch.roofline` and re-derived for H100 clusters.

  compute term    = FLOPs a rank / peak FLOP/s
  memory term     = bytes a rank reads and writes / HBM bandwidth
  collective term = collective bytes over "model" / NVLink bandwidth
                  + collective bytes over "data" and "pod" / InfiniBand

The reference reads XLA's `cost_analysis()` of the partitioned module and
parses collective bytes from its optimized HLO.  Here `StepCounter`, a
dispatch mode, watches the rank's own (local) ops as DTensor runs them:

  * FLOPs: `torch.utils.flop_counter`'s formulas (the ones
    `FlopCounterMode` applies) on each local op;
  * bytes: the input and output tensor bytes of each local aten op that
    is not a view, the eager counterpart of XLA's "bytes accessed" (an
    eager op reads its inputs and writes its outputs through HBM; XLA
    fuses, so this is an upper bound a fused kernel would cut);
  * collectives: the result bytes of each functional collective that
    DTensor or FSDP issue (all_gather_into_tensor, reduce_scatter_tensor,
    all_reduce, all_to_all_single), by the mesh axis of its process
    group, an all-reduce counted twice (a ring reduce-scatter +
    all-gather), as the reference counts them.

Hardware constants (per GPU), NVIDIA's published figures, none measured:

  * PEAK_FLOPS 989e12: H100 SXM5 dense BF16 Tensor Core FLOP/s (NVIDIA
    H100 Tensor Core GPU datasheet; 1,979 TFLOP/s is with sparsity);
  * HBM_BW 3.35e12 B/s: H100 SXM5 HBM3 bandwidth (same datasheet);
  * NVLINK_BW 450e9 B/s: NVLink 4, 900 GB/s total per GPU, 450 GB/s
    each way, to any GPU of an 8-GPU HGX/DGX H100 node through NVSwitch
    (same datasheet; DGX H100 user guide);
  * IB_BW 50e9 B/s: one ConnectX-7 InfiniBand NDR port, 400 Gb/s, per
    GPU of a DGX H100 (DGX H100 datasheet: 8 x 400 Gb/s compute fabric).

None of the reference's TPU v5e constants carry over.
"""
from __future__ import annotations

import dataclasses
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
NVLINK_BW = 450e9
IB_BW = 50e9
FAST_AXES = ("model",)          # inside an NVLink domain (one node)

_COLLECTIVES = {"all_gather_into_tensor": "all-gather",
                "reduce_scatter_tensor": "reduce-scatter",
                "all_reduce": "all-reduce",
                "all_to_all_single": "all-to-all"}
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all")


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) \
        else 0


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def axis_of_groups(mesh) -> dict:
    """{process group name: mesh axis name} of `mesh`'s axis groups."""
    return {mesh.get_group(a).group_name: a for a in mesh.mesh_dim_names}


class StepCounter(TorchDispatchMode):
    """Counts one rank's local FLOPs, bytes moved, collective bytes by
    axis and kind, and the peak of live tensor bytes (each output
    storage from its creation until it is freed), over the ops run
    inside it.  Ops on DTensors are passed on to DTensor, whose local
    ops (and collectives) then come back here: what is counted is what
    this rank runs."""

    def __init__(self, mesh=None):
        super().__init__()
        self.groups = axis_of_groups(mesh) if mesh is not None else {}
        self.flops = 0
        self.bytes = 0
        self.coll = {}              # (axis, kind) -> result bytes
        self.coll_counts = {}
        self.live = 0
        self.peak = 0
        self._seen = set()
        self._paused = 0
        self._unpatch = None

    def __enter__(self):
        # DTensor infers an op's output shapes by running it on fake
        # tensors of the GLOBAL shapes; those runs move nothing on a rank
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator
        orig = ShardingPropagator._propagate_tensor_meta_non_cached

        def propagate(prop, *a, **k):
            self._paused += 1
            try:
                return orig(prop, *a, **k)
            finally:
                self._paused -= 1

        ShardingPropagator._propagate_tensor_meta_non_cached = propagate
        # on a CPU mesh DTensor swaps its all_to_all for an all_gather
        # (gloo has none); the counted world is not gloo: keep the
        # all_to_all, whose fake kernel gives the right shape
        from torch.distributed.tensor import _collective_utils as cu
        local_mode = cu.local_tensor_mode
        cu.local_tensor_mode = lambda: True

        def unpatch():
            ShardingPropagator._propagate_tensor_meta_non_cached = orig
            cu.local_tensor_mode = local_mode

        self._unpatch = unpatch
        return super().__enter__()

    def __exit__(self, *exc):
        self._unpatch()
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if self._paused:
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
        name = packet.__name__
        if (func.namespace == "_c10d_functional" and name in _COLLECTIVES) \
                or (func.namespace == "_dtensor"
                    and name == "shard_dim_alltoall"):
            group = args[-1] if args else kwargs.get("group_name")
            group = getattr(group, "group_name", group)
            key = (self.groups.get(group, group),
                   _COLLECTIVES.get(name, "all-to-all"))
            self.coll[key] = self.coll.get(key, 0) + _nbytes(out)
            self.coll_counts[key] = self.coll_counts.get(key, 0) + 1
        elif not _is_view(func):
            self.bytes += sum(_nbytes(t) for t in _tensors(args)) \
                + sum(_nbytes(t) for t in _tensors(out))
        for t in _tensors(out):
            self._track(t)
        return out

    def _track(self, t):
        try:
            st = t.untyped_storage()
        except (RuntimeError, NotImplementedError):
            return
        key = id(st)
        if key in self._seen:
            return
        size = st.nbytes()
        self._seen.add(key)
        self.live += size
        self.peak = max(self.peak, self.live)

        def gone(_, key=key, size=size):
            self._seen.discard(key)
            self.live -= size

        weakref.finalize(st, gone, None)

    def terms(self) -> dict:
        """{"flops", "bytes", "collectives": {kind: bytes},
        "collective_counts": {kind: n}, "by_axis": {axis: wire bytes},
        "wire_bytes", "peak_bytes"}: an all-reduce's wire bytes count
        twice, as the reference's."""
        kinds = dict.fromkeys(KINDS, 0)
        counts = dict.fromkeys(KINDS, 0)
        by_axis = {}
        for (axis, kind), b in self.coll.items():
            kinds[kind] += b
            counts[kind] += self.coll_counts[(axis, kind)]
            by_axis[axis] = by_axis.get(axis, 0) \
                + b * (2 if kind == "all-reduce" else 1)
        return {"flops": self.flops, "bytes": self.bytes,
                "collectives": kinds, "collective_counts": counts,
                "by_axis": by_axis, "wire_bytes": sum(by_axis.values()),
                "peak_bytes": self.peak}


def collective_seconds(by_axis: dict) -> float:
    """Collective bytes over the NVLink axes at NVLINK_BW, the rest at
    IB_BW (their phases do not overlap in this bound: they are summed)."""
    return sum(b / (NVLINK_BW if a in FAST_AXES else IB_BW)
               for a, b in by_axis.items())


@dataclasses.dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    model_flops_global: float
    collectives: dict
    collective_by_axis: dict = dataclasses.field(default_factory=dict)

    @property
    def compute_s(self) -> float:
        return self.flops_per_device / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def collective_s(self) -> float:
        return collective_seconds(self.collective_by_axis)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        hlo_global = self.flops_per_device * self.chips
        return self.model_flops_global / hlo_global if hlo_global else 0.0

    def row(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "model_flops": self.model_flops_global,
            "flops_per_dev": self.flops_per_device,
            "bytes_per_dev": self.bytes_per_device,
            "coll_bytes_per_dev": self.collective_bytes_per_device,
            "coll_bytes_by_axis": self.collective_by_axis,
            "useful_flops_ratio": self.useful_flops_ratio,
            "collective_counts": self.collectives["counts"],
            "collective_bytes": self.collectives["bytes_by_kind"],
        }


def model_flops(cfg, shape_name: str, n_active: int) -> float:
    """6·N·D for training, 2·N·D for inference (N = active params)."""
    from repro_torch.configs.base import INPUT_SHAPES
    s = INPUT_SHAPES[shape_name]
    if s["kind"] == "train":
        tokens = s["global_batch"] * s["seq_len"]
        return 6.0 * n_active * tokens
    if s["kind"] == "prefill":
        tokens = s["global_batch"] * s["seq_len"]
        return 2.0 * n_active * tokens
    return 2.0 * n_active * s["global_batch"]          # decode: 1 token/seq


def extract(t: dict, *, arch: str, shape: str, mesh_name: str, chips: int,
            model_flops_global: float) -> RooflineTerms:
    """RooflineTerms from one `StepCounter.terms()`."""
    return RooflineTerms(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        flops_per_device=float(t["flops"]),
        bytes_per_device=float(t["bytes"]),
        collective_bytes_per_device=float(t["wire_bytes"]),
        model_flops_global=model_flops_global,
        collectives={"bytes_by_kind": t["collectives"],
                     "counts": t["collective_counts"]},
        collective_by_axis=dict(t["by_axis"]))


def extrapolate(t1: dict, t2: dict, u1: int, u2: int, nb: int) -> dict:
    """The terms of an nb-block model from models of u1 < u2 blocks: every
    additive count is f(u) = outside + u·block, so total = outside +
    nb·block.  Exact when the blocks are alike (they are: one stacked
    parameter tree)."""
    def lin(a, b):
        block = (b - a) / (u2 - u1)
        return max(a + (nb - u1) * block, 0.0)

    out = {k: lin(t1[k], t2[k]) for k in ("flops", "bytes", "peak_bytes")}
    for k in ("collectives", "collective_counts", "by_axis"):
        keys = set(t1[k]) | set(t2[k])
        out[k] = {a: lin(t1[k].get(a, 0), t2[k].get(a, 0)) for a in keys}
    out["collective_counts"] = {a: int(round(v)) for a, v in
                                out["collective_counts"].items()}
    out["wire_bytes"] = sum(out["by_axis"].values())
    return out

"""Logical-axis sharding rules on a torch `DeviceMesh`, ported from
`repro.train.sharding`.

Model code names each activation's dimensions with LOGICAL axes through
`shard(x, axes)`; the launcher installs a mesh and the logical→mesh rules
(`use_mesh_rules`).  Off the mesh `shard()` is the identity, so the same
model code runs on one device and on a mesh.

The rule tables are the reference's, unchanged (DESIGN.md §5):

  batch      -> ("pod", "data")   data parallel (pod axis = DP across pods)
  seq        -> None              activations keep seq local
  cache_seq  -> "model" in decode, ("data", "model") at long context
  heads / kv_heads / ff / vocab / d_inner -> "model"  (tensor parallel)
  experts    -> "data"            expert parallel
  embed_fsdp -> "data"            the parameters' FSDP dimension

A dimension keeps its rule only when its size divides by the axis size.

What differs is the mechanism.  The reference hands a `PartitionSpec` to
XLA, whose SPMD partitioner inserts the collectives.  Here a spec (one
entry per tensor dimension: a mesh axis name, a tuple of names, or None)
becomes DTensor placements (`placements`): `Shard(i)` on every mesh
dimension that shards tensor dimension i, `Replicate()` on the others.
Parameters are placed with `distribute_tensor` by `tree_param_specs`;
on the mesh the model's tensors are DTensors, DTensor's sharding
propagation picks each op's collectives, and `shard()` redistributes an
activation to the rules' layout, the counterpart of
`with_sharding_constraint`.

The rule functions only read the mesh's axis names and sizes, so they
also take a duck-typed mesh (`axis_names` and a `shape` mapping name →
size, as a `jax.sharding.Mesh` has), which lets the tables be checked at
any mesh shape without ranks.
"""
from __future__ import annotations

import contextlib
import types
from typing import Optional, Sequence

import torch

# the installed mesh and rules: process-wide, not thread-local, because
# autograd runs a CUDA backward (and so each checkpointed block's
# recompute) in its own device thread, which must see the same rules
_state = types.SimpleNamespace(mesh=None, rules=None)

DEFAULT_RULES = {
    "batch": ("pod", "data"),
    "seq": None,
    "res_seq": None,   # residual-stream seq (Megatron-SP shards it over "model")
    "cache_seq": None,
    "heads": "model",
    "kv_heads": "model",
    "heads_flat": "model",
    "ff": "model",
    # expert parallelism over "data" (all_to_all routing), tensor parallelism
    # WITHIN each expert over "model" — experts and ff must not share an axis
    "experts": "data",
    "expert_cap": None,
    "vocab": "model",
    "embed": None,
    "embed_fsdp": "data",
    "d_inner": "model",
    "state": None,
}

# Decode recipes.  decode_32k: batch over "data", KV-cache seq over "model"
# (kv_heads rarely divide the model axis, so the cache's SEQ dim carries
# the model-axis shard).
DECODE_OVERRIDES = {
    "cache_seq": "model",
    "kv_heads": None,        # cache_seq holds the model axis (no duplicates)
}

# long_500k: batch=1 frees the data axis — shard cache seq over BOTH axes.
LONG_CONTEXT_OVERRIDES = {
    "batch": None,
    "cache_seq": ("data", "model"),
    "kv_heads": None,
    "experts": None,         # "data" carries cache_seq here
}

PARAM_LOGICAL = {
    # attention
    "wq": ("embed_fsdp", "heads_flat"),
    "wk": ("embed_fsdp", "heads_flat"),
    "wv": ("embed_fsdp", "heads_flat"),
    "wo": ("heads_flat", "embed_fsdp"),
    "q_norm": (None,), "k_norm": (None,),
    # mlp
    "w1": ("embed_fsdp", "ff"), "w3": ("embed_fsdp", "ff"),
    "w2": ("ff", "embed_fsdp"),
    # moe: experts over "data" (EP), ff over "model" (TP within expert)
    "router": ("embed_fsdp", None),
    "we1": ("experts", None, "ff"), "we3": ("experts", None, "ff"),
    "we2": ("experts", "ff", None),
    # embeddings / head
    "embedding": ("vocab", "embed_fsdp"),
    "lm_head": ("embed_fsdp", "vocab"),
    # rwkv
    "wr": ("embed_fsdp", "d_inner"), "wk_r": ("embed_fsdp", "d_inner"),
    "wv_r": ("embed_fsdp", "d_inner"), "wg": ("embed_fsdp", "d_inner"),
    "wo_r": ("d_inner", "embed_fsdp"),
    "ck": ("embed_fsdp", "ff"), "cv": ("ff", "embed_fsdp"),
    "cr": ("embed_fsdp", None),
    # mamba
    "in_proj": ("embed_fsdp", "d_inner"),
    "out_proj": ("d_inner", "embed_fsdp"),
    "x_proj": ("d_inner", None), "dt_proj": (None, "d_inner"),
    "conv_w": (None, "d_inner"), "conv_b": ("d_inner",),
    "a_log": ("d_inner", None), "dcoef": ("d_inner",),
}

# Pure-EP layout (experts carry the SAME axis as "ff" would): each device
# owns whole experts, so neither expert matmul contracts a sharded dim.
# Expert weights FSDP over the d_model dim instead.  Selected whenever the
# rules map "experts" to the same axis as "ff".
PARAM_LOGICAL_EP = {
    "we1": ("experts", "embed_fsdp", None),
    "we3": ("experts", "embed_fsdp", None),
    "we2": ("experts", None, "embed_fsdp"),
}


def _rules():
    return _state.rules


def _mesh():
    return _state.mesh


def axis_names(mesh) -> tuple:
    """The mesh's axis names: a `DeviceMesh`'s `mesh_dim_names`, or a
    duck-typed mesh's `axis_names`."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def axis_sizes(mesh) -> dict:
    """{axis name: size}."""
    if getattr(mesh, "mesh_dim_names", None) is not None:
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh.shape)


def make_rules(mesh, overrides: Optional[dict] = None) -> dict:
    """DEFAULT_RULES + overrides, restricted to axes the mesh has: each
    value is one axis name, a tuple of two or more, or None."""
    names = axis_names(mesh)
    rules = dict(DEFAULT_RULES)
    if overrides:
        rules.update(overrides)

    def filt(v):
        if v is None:
            return None
        axes = (v,) if isinstance(v, str) else tuple(v)
        axes = tuple(a for a in axes if a in names)
        return axes if len(axes) > 1 else (axes[0] if axes else None)

    return {k: filt(v) for k, v in rules.items()}


@contextlib.contextmanager
def use_mesh_rules(mesh, overrides: Optional[dict] = None):
    """Install `mesh` and its rules for the model code."""
    from torch.distributed.tensor.experimental import implicit_replication
    rules = make_rules(mesh, overrides)
    prev = (_mesh(), _rules())
    _state.mesh, _state.rules = mesh, rules
    try:
        with implicit_replication():
            yield
    finally:
        _state.mesh, _state.rules = prev


def _axis_size(mesh, axis) -> int:
    sizes = axis_sizes(mesh)
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        out = 1
        for a in axis:
            out *= sizes[a]
        return out
    return sizes[axis]


def logical_spec(axes: Sequence, mesh, rules: dict,
                 shape: Optional[Sequence[int]] = None) -> tuple:
    """Logical axis names to a per-dimension spec (the reference's
    PartitionSpec entries), dropping dimensions not divisible by their
    axis size."""
    parts = []
    for i, name in enumerate(axes):
        ax = rules.get(name) if name is not None else None
        if ax is None or (shape is not None
                          and shape[i] % _axis_size(mesh, ax) != 0):
            parts.append(None)
            continue
        parts.append(ax)
    return tuple(parts)


def placements(spec: Sequence, mesh) -> tuple:
    """A spec as DTensor placements over the mesh's dimensions: `Shard(i)`
    on each mesh dimension that shards tensor dimension i, `Replicate()`
    elsewhere.  A tuple entry shards one tensor dimension over several
    mesh dimensions, which must come in the mesh's order (the reference's
    major-to-minor order)."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    out = [Replicate()] * len(names)
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        dims = [names.index(a) for a in axes]
        if dims != sorted(dims):
            raise ValueError(f"spec entry {entry!r} is not in the mesh's "
                             f"axis order {names}")
        for d in dims:
            if not isinstance(out[d], Replicate):
                raise ValueError(f"mesh axis {names[d]!r} shards two "
                                 f"dimensions in {tuple(spec)}")
            out[d] = Shard(i)
    return tuple(out)


class _Constrain(torch.autograd.Function):
    """`with_sharding_constraint` on DTensors: the forward redistributes x
    to `want`, and the backward constrains the gradient to the same
    layout, as JAX transposes the constraint.  DTensor's own backward of
    a redistribute would hand back a partial sum where the input was
    one, and an op fed a partial gradient next to a sharded weight (a
    row-parallel product's backward) runs against the all-gathered
    weight, so every rank of the axis would do the whole product."""

    @staticmethod
    def forward(ctx, x, want):
        ctx.want, ctx.mesh = want, x.device_mesh
        if tuple(x.placements) == want:
            return x.view_as(x)
        return x.redistribute(x.device_mesh, want)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.want:
            g = g.redistribute(ctx.mesh, ctx.want)
        return g, None


def shard(x, axes: Sequence):
    """Constrain activation x, and its gradient, to the layout of logical
    `axes` (identity off the mesh, and for a tensor that is not a
    DTensor)."""
    mesh, rules = _mesh(), _rules()
    if mesh is None or not is_sharded(x):
        return x
    want = placements(logical_spec(axes, mesh, rules, x.shape), mesh)
    return _Constrain.apply(x, want)


def pure_ep(rules: dict) -> bool:
    e, f = rules.get("experts"), rules.get("ff")
    return e is not None and e == f


def param_spec_for(path: tuple, leaf_shape: tuple, mesh,
                   rules: dict) -> tuple:
    """Spec of a parameter from the last name in its path; the stacked
    block parameters' leading block dimension stays unsharded."""
    name = path[-1]
    logical = (PARAM_LOGICAL_EP.get(name) if pure_ep(rules) else None) \
        or PARAM_LOGICAL.get(name)
    if logical is None:
        return ()
    extra = len(leaf_shape) - len(logical)
    axes = (None,) * extra + tuple(logical)
    return logical_spec(axes, mesh, rules, leaf_shape)


def gather_fsdp(tree, name: Optional[str] = None):
    """Parameters with their `embed_fsdp` dimension gathered whole, the
    rest of their layout kept: FSDP's all-gather before use (its backward
    is the gradients' reduce-scatter).  Called inside each checkpointed
    block, so remat gathers again and no block holds another's weights.
    `tree`: a dict of parameters (names as in PARAM_LOGICAL) or one
    parameter named `name`; the identity off the mesh."""
    if isinstance(tree, dict):
        return {k: gather_fsdp(v, k) for k, v in tree.items()}
    rules = _rules()
    if rules is None or not is_sharded(tree):
        return tree
    logical = (PARAM_LOGICAL_EP.get(name) if pure_ep(rules) else None) \
        or PARAM_LOGICAL.get(name)
    if logical is None or "embed_fsdp" not in logical:
        return tree
    from torch.distributed.tensor import Replicate, Shard
    dim = tree.ndim - len(logical) + logical.index("embed_fsdp")
    want = tuple(Replicate() if isinstance(q, Shard) and q.dim == dim else q
                 for q in tree.placements)
    if want == tuple(tree.placements):
        return tree
    return tree.redistribute(tree.device_mesh, want)


def tree_param_specs(params: dict, mesh, rules: Optional[dict] = None,
                     path: tuple = ()) -> dict:
    """{name: placements} over a nested dict of tensors (the port's
    parameter tree, or a moment tree of the same shapes)."""
    rules = rules if rules is not None else make_rules(mesh)
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out[k] = tree_param_specs(v, mesh, rules, path + (k,))
        else:
            out[k] = placements(param_spec_for(path + (k,), tuple(v.shape),
                                               mesh, rules), mesh)
    return out


def distribute(full: torch.Tensor, mesh, pl) -> torch.Tensor:
    """A full tensor (equal on every rank, as one drawn from one seed is)
    as a DTensor of placements `pl`: this rank keeps a contiguous copy of
    its own shard, with no communication, and no view that would hold the
    full tensor alive."""
    from torch.distributed.tensor import DTensor, Shard
    local = full
    coord = mesh.get_coordinate()
    for d, q in enumerate(pl):
        if isinstance(q, Shard):
            local = local.chunk(mesh.size(d), dim=q.dim)[coord[d]]
    return DTensor.from_local(
        local.clone(memory_format=torch.contiguous_format), mesh, pl,
        run_check=False, shape=full.shape, stride=full.contiguous().stride())


def distribute_tree(tree: dict, specs: dict, mesh) -> dict:
    """Every full tensor of `tree` as a DTensor of its placements in
    `specs` (`distribute`)."""
    return {k: distribute_tree(v, specs[k], mesh) if isinstance(v, dict)
            else distribute(v, mesh, specs[k]) for k, v in tree.items()}


def full_tree(tree: dict) -> dict:
    """Every DTensor of `tree` gathered into a full local tensor (every
    rank gets the whole tensor); other tensors are returned as they are."""
    from torch.distributed.tensor import DTensor
    return {k: full_tree(v) if isinstance(v, dict)
            else (v.full_tensor() if isinstance(v, DTensor) else v)
            for k, v in tree.items()}


def is_sharded(x) -> bool:
    """x is a DTensor (the model runs on a mesh)."""
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def local_offset(x) -> tuple:
    """The global index of the first element of this rank's shard of an
    evenly sharded DTensor x, per dimension (mesh dimensions that shard
    one tensor dimension nest in mesh order)."""
    from torch.distributed.tensor import Shard
    mesh = x.device_mesh
    coord = mesh.get_coordinate()
    local = x.to_local().shape
    idx = [0] * x.ndim
    for d, q in enumerate(x.placements):
        if isinstance(q, Shard):
            idx[q.dim] = idx[q.dim] * mesh.size(d) + coord[d]
    return tuple(i * n for i, n in zip(idx, local))


def to_local_for(x, split: Sequence[bool]):
    """DTensor x as this rank's local tensor, for a computation that is
    split over the mesh dimensions marked in `split` (its rows or
    channels differ from rank to rank there): where x is replicated over
    such a dimension, each rank's local gradient is a partial sum."""
    from torch.distributed.tensor import Partial, Replicate
    grad = [Partial() if s and isinstance(q, Replicate) else q
            for s, q in zip(split, x.placements)]
    return x.to_local(grad_placements=grad)


def from_local_like(t: torch.Tensor, mesh, pl, shape) -> torch.Tensor:
    """Local results t (evenly sharded by `pl`) as a DTensor of global
    `shape` (contiguous)."""
    from torch.distributed.tensor import DTensor
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return DTensor.from_local(t, mesh, pl, run_check=False,
                              shape=torch.Size(shape),
                              stride=tuple(reversed(stride)))


def channel_layout(x, unit: int) -> tuple:
    """x's placements with its last dimension kept sharded only where each
    shard holds whole groups of `unit` channels (heads), and every other
    dimension but the batch (0) replicated: the layout of a computation
    independent per (row, group)."""
    from torch.distributed.tensor import Replicate, Shard
    local = list(x.shape)
    pl = []
    last = x.ndim - 1
    for d, q in enumerate(x.placements):
        n = x.device_mesh.size(d)
        if isinstance(q, Shard) and q.dim == 0:
            pl.append(q)
        elif isinstance(q, Shard) and q.dim == last \
                and (local[last] // n) % unit == 0:
            local[last] //= n
            pl.append(q)
        else:
            pl.append(Replicate())
    return tuple(pl)


def whole_groups(x, groups: int):
    """DTensor x with its last dimension sharded only over mesh dimensions
    that split it into whole groups (of `groups` heads laid out along it):
    a flat head dimension that divides the mesh axis while its head count
    does not (2 KV heads on 8 ranks) is gathered before it is split into
    heads.  The identity for a plain tensor."""
    if not is_sharded(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    last = x.ndim - 1
    n, pl = groups, []
    for d, q in enumerate(x.placements):
        k = x.device_mesh.size(d)
        if isinstance(q, Shard) and q.dim == last:
            if n % k == 0:
                n //= k
                pl.append(q)
            else:
                pl.append(Replicate())
        else:
            pl.append(q)
    pl = tuple(pl)
    return x if pl == tuple(x.placements) else \
        x.redistribute(x.device_mesh, pl)

"""LM checkpoints in the reference's format: one flat `.npz` whose keys are
the "/"-joined parameter-tree paths, with the stacked leading block axis
(`blocks/pos0/mixer/wq` of shape (num_blocks, d, H·hd)), as
`repro.checkpoint.io` writes them.  A checkpoint written by the reference
loads here, and one written here restores in the reference.

`from_reference_params` is the one function that carries weights across:
`restore` is built on it, and the tests hand it the reference's parameter
tree as numpy arrays.  A bfloat16 array arrives either as numpy's view of
a JAX array (dtype named "bfloat16", an extension type `torch.from_numpy`
rejects) or, read back from an `.npz`, as raw 2-byte records (`|V2`); both
are taken bit for bit through their uint16 view.  `save` writes bfloat16
tensors as float32 (exact): the reference's `restore` casts each array to
its model's dtype and cannot read the raw 2-byte records.

A train state (`repro_torch.train.step`) is written under the reference's
keys for its {"params", "opt"} tree: `params/...`, `opt/mu/...`,
`opt/nu/...` and `opt/step`, so a state written here restores in the
reference's `restore(path, like)` and a float32 state it wrote restores
here (`restore_state`, built on `from_reference_state`).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from repro_torch.models import transformer
from repro_torch.optim import adamw
from repro_torch.train import sharding as shd
from repro_torch.train import step as train_step


def _flatten(tree, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "/"))
        else:
            out[key] = v
    return out


def _to_tensor(arr: np.ndarray) -> torch.Tensor:
    arr = np.array(arr, order="C")          # a writable copy
    if arr.dtype.name == "bfloat16" or (arr.dtype.kind == "V"
                                        and arr.dtype.itemsize == 2):
        bits = torch.from_numpy(arr.view(np.uint16).view(np.int16))
        return bits.view(torch.bfloat16)
    return torch.from_numpy(arr)


def from_reference_params(tree, cfg, device=None) -> transformer.Transformer:
    """A `Transformer` of `cfg` whose weights are the reference parameter
    tree `tree` (nested dicts, or a flat dict of "/"-joined keys, of numpy
    arrays).  Every key of the config's tree must be present with its
    shape; each array is cast to the dtype the config gives its leaf."""
    flat = tree if all(not isinstance(v, dict) for v in tree.values()) \
        else _flatten(tree)
    want = _flatten(transformer.init_params(None, cfg))
    missing = sorted(set(want) - set(flat))
    extra = sorted(set(flat) - set(want))
    if missing or extra:
        raise ValueError(f"parameter tree does not match {cfg.name}: "
                         f"missing {missing}, unexpected {extra}")
    params = {}
    for key, meta in want.items():
        t = _to_tensor(np.asarray(flat[key]))
        if tuple(t.shape) != tuple(meta.shape):
            raise ValueError(f"{key}: shape {tuple(t.shape)}, {cfg.name} "
                             f"wants {tuple(meta.shape)}")
        params[key] = t.to(meta.dtype)
    return transformer.Transformer(cfg, _unflatten(params), device=device)


def _host(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _unflatten(flat: dict) -> dict:
    out = {}
    for key, v in flat.items():
        node = out
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def save(path: str, model: transformer.Transformer) -> None:
    """Write `model`'s parameters as the reference's flat `.npz`."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **{name.replace(".", "/"): _host(t)
                      for name, t in model.params.named_parameters()})


def restore(path: str, cfg, device=None) -> transformer.Transformer:
    """Load a flat `.npz` (written by either package) as a `Transformer`."""
    with np.load(path if path.endswith(".npz") else path + ".npz") as data:
        flat = {k: data[k] for k in data.files}
    return from_reference_params(flat, cfg, device=device)


def flatten_state(state: dict) -> dict:
    """A train state's tensors (detached, where they lie) under the
    reference's flat keys: `params/...`, `opt/mu/...`, `opt/nu/...`,
    `opt/step`."""
    out = {f"params/{name.replace('.', '/')}": t.detach()
           for name, t in state["model"].params.named_parameters()}
    for m in ("mu", "nu"):
        out.update((f"opt/{m}/{key}", t)
                   for key, t in _flatten(state["opt"][m]).items())
    out["opt/step"] = state["opt"]["step"]
    return out


def save_state(path: str, state: dict) -> None:
    """Write a train state as the reference writes its {"params", "opt"}.

    A state sharded on a mesh (DTensors, `train.step.shard_state`) is
    gathered into full tensors, so every rank of the mesh must call this;
    the file is written once, by global rank 0, and equals the file of
    the same state on one device."""
    flat = flatten_state(state)
    sharded = any(shd.is_sharded(t) for t in flat.values())
    arrays = {k: _host(t.full_tensor() if shd.is_sharded(t) else t)
              for k, t in flat.items()}
    if sharded and torch.distributed.get_rank() != 0:
        return
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    arrays["opt/step"] = arrays["opt/step"].astype(np.int32)
    np.savez(path, **arrays)


def from_reference_state(tree, cfg, tcfg, device=None) -> dict:
    """The port's train state from the reference's {"params", "opt"} tree
    (nested dicts, or a flat dict of "/"-joined keys, of numpy arrays):
    the weights as `from_reference_params` takes them, the moments in the
    dtype `tcfg.optimizer` gives them, the step as int32."""
    flat = tree if all(not isinstance(v, dict) for v in tree.values()) \
        else _flatten(tree)
    model = from_reference_params(
        {k[len("params/"):]: v for k, v in flat.items()
         if k.startswith("params/")}, cfg, device=device)
    mdt = adamw.moments_torch_dtype(tcfg.optimizer)
    names = [n.replace(".", "/") for n, _ in model.params.named_parameters()]
    want = {f"opt/{m}/{n}" for m in ("mu", "nu") for n in names}
    have = {k for k in flat if k.startswith("opt/")} - {"opt/step"}
    if want != have or "opt/step" not in flat:
        raise ValueError(f"optimizer state does not match {cfg.name}: "
                         f"missing {sorted(want - have)}, unexpected "
                         f"{sorted(have - want)}")
    opt = {m: _unflatten({n: _to_tensor(np.asarray(flat[f"opt/{m}/{n}"]))
                          .to(model.device, mdt) for n in names})
           for m in ("mu", "nu")}
    opt["step"] = torch.tensor(int(np.asarray(flat["opt/step"])),
                               dtype=torch.int32, device=model.device)
    return train_step.train_state(model, tcfg, opt)


def restore_state(path: str, cfg, tcfg, device=None) -> dict:
    """Load a train state `.npz` written by either package."""
    with np.load(path if path.endswith(".npz") else path + ".npz") as data:
        flat = {k: data[k] for k in data.files}
    return from_reference_state(flat, cfg, tcfg, device=device)

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
"""
from __future__ import annotations

import os

import numpy as np
import torch

from repro_torch.models import transformer


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
        node = params
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = t.to(meta.dtype)
    return transformer.Transformer(cfg, params, device=device)


def save(path: str, model: transformer.Transformer) -> None:
    """Write `model`'s parameters as the reference's flat `.npz`."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    arrays = {}
    for name, t in model.params.named_parameters():
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        arrays[name.replace(".", "/")] = t.numpy()
    np.savez(path, **arrays)


def restore(path: str, cfg, device=None) -> transformer.Transformer:
    """Load a flat `.npz` (written by either package) as a `Transformer`."""
    with np.load(path if path.endswith(".npz") else path + ".npz") as data:
        flat = {k: data[k] for k in data.files}
    return from_reference_params(flat, cfg, device=device)

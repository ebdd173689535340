"""Carry flax parameters over to a port model's `state_dict`.

Names: a flax module path `blocks_3/attn/qkv/kernel` becomes
`blocks.3.attn.qkv.weight` (a module name ending in `_<i>` is item i of a
ModuleList), `kernel` and LayerNorm's `scale` become `weight`, other leaf
names stay. Layouts: a Dense kernel `[in, out]` becomes `[out, in]`, a Conv
kernel HWIO becomes OIHW. BatchNorm statistics come from the flax
`batch_stats` tree: `mean` becomes `running_mean` and `var` `running_var`.
The leaves of another variable collection (`collections`, e.g. MoCo's `ssl`
with its `queue` and `queue_ptr`) land on the buffers of the same names,
their layouts and dtypes kept as the buffers have them. Every flax leaf must land on a torch parameter or buffer of the same shape,
and every entry of the model's `state_dict` must be filled.
"""
from __future__ import annotations

import re
from collections.abc import Mapping

import numpy as np
import torch

_LIST_ITEM = re.compile(r"_(\d+)$")


def _flatten(tree: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, path))
        else:
            out[path] = np.asarray(v)
    return out


_STATS = {"mean": "running_mean", "var": "running_var"}


def _torch_name(path: str, arr: np.ndarray, stats: bool = False,
                verbatim: bool = False) -> tuple[str, np.ndarray]:
    *modules, leaf = path.split("/")
    modules = [_LIST_ITEM.sub(r".\1", m) for m in modules]
    if verbatim:
        return ".".join([*modules, leaf]), arr
    if stats:
        if leaf not in _STATS:
            raise ValueError(f"batch_stats leaf {path!r}: expected mean or var")
        leaf = _STATS[leaf]
    elif leaf == "kernel":
        leaf = "weight"
        if arr.ndim == 2:
            arr = arr.T  # Dense [in, out] -> Linear [out, in]
        elif arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)  # Conv HWIO -> OIHW
        else:
            raise ValueError(f"{path}: no torch layout for a {arr.ndim}-d kernel")
    elif leaf == "scale":
        leaf = "weight"
    return ".".join([*modules, leaf]), arr


def flax_to_torch(params: Mapping, model: torch.nn.Module,
                  batch_stats: Mapping | None = None,
                  collections: Mapping[str, Mapping] | None = None) -> dict[str, torch.Tensor]:
    """params (and a model with BatchNorm's `batch_stats`, and any other
    variable collections by name): the flax trees as numpy arrays -> a
    state_dict for `model`."""
    target = model.state_dict()
    out: dict[str, torch.Tensor] = {}
    leaves = [(p, a, False, False) for p, a in _flatten(params).items()]
    leaves += [(p, a, True, False) for p, a in _flatten(batch_stats or {}).items()]
    for tree in (collections or {}).values():
        leaves += [(p, a, False, True) for p, a in _flatten(tree).items()]
    for path, arr, stats, verbatim in leaves:
        key, arr = _torch_name(path, arr, stats, verbatim)
        if key not in target:
            raise KeyError(f"flax leaf {path!r} maps to {key!r}, which the model does not have")
        if tuple(arr.shape) != tuple(target[key].shape):
            raise ValueError(f"flax leaf {path!r} has shape {arr.shape} after layout change, "
                             f"{key!r} has {tuple(target[key].shape)}")
        dtype = arr.dtype if arr.dtype.kind in "iub" else np.float32  # (bf16 has no torch numpy)
        out[key] = torch.from_numpy(np.array(arr, dtype=dtype)).to(target[key].dtype)
    missing = sorted(set(target) - set(out))
    if missing:
        raise KeyError(f"no flax leaf fills {missing}")
    return out

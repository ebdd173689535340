"""Carry flax parameters over to a port model's `state_dict`.

Names: a flax module path `blocks_3/attn/qkv/kernel` becomes
`blocks.3.attn.qkv.weight` (a module name ending in `_<i>` is item i of a
ModuleList where the model holds such items; CLIP's `ln_1` stays), `kernel`
and LayerNorm's `scale` become `weight`, other leaf names stay (an
`nn.Embed`'s `embedding`, as the dVAE's `codebook/embedding`; BEiT's
`relative_position_bias_table`, `gamma_1`, `gamma_2`; V-MoE's `router`
`[d, E]` and stacked experts `w1`, `b1`, `w2`, `b2`, in flax's layouts
as they are). Layouts: a Dense
kernel `[in, out]` becomes `[out, in]`, a Conv kernel HWIO becomes OIHW (a
depthwise `[k, k, 1, c]` becomes `[c, 1, k, k]`), and the kernel of a
transposed conv (a `nn.layers.ConvTranspose` in the model) HWIO becomes IOHW
flipped in H and W (`conv_transpose_to_torch`): flax's `ConvTranspose` does
not flip its kernel, torch's `conv_transpose2d` does. BatchNorm statistics come from the flax
`batch_stats` tree: `mean` becomes `running_mean` and `var` `running_var`.
The leaves of another variable collection (`collections`, e.g. MoCo's `ssl`
with its `queue` and `queue_ptr`) land on the buffers of the same names,
their layouts and dtypes kept as the buffers have them. Every flax leaf must land on a torch parameter or buffer of the same shape,
and every entry of the model's `state_dict` must be filled; an EMA target
tower's entries that the flax variables lack (MoCo v3's momentum predictor,
never run, so never initialised by flax) are copied from its online tower,
as the JAX engine copies the tower before training.

`flax_path` goes the other way on a parameter's name: the path the JAX
package's optimizer matches a config's regexes against.
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


def _modules(modules: list[str], names=None) -> list[str]:
    """Flax module names -> torch's: `blocks_3` is item 3 of `blocks`. With the
    model's `names`, a module whose items the model does not hold keeps its
    name (CLIP's `ln_1`, where `resblocks_3` is an item)."""
    out: list[str] = []
    for m in modules:
        item = _LIST_ITEM.sub(r".\1", m)
        if item != m and names is not None:
            prefix = ".".join([*out, item]) + "."
            if not any(n.startswith(prefix) for n in names):
                item = m
        out.append(item)
    return out


def conv_transpose_to_torch(kernel: np.ndarray) -> np.ndarray:
    """flax `ConvTranspose` kernel HWIO -> torch `conv_transpose2d` weight
    IOHW, flipped in H and W."""
    return np.ascontiguousarray(np.asarray(kernel)[::-1, ::-1].transpose(2, 3, 0, 1))


def conv_transpose_to_flax(weight: np.ndarray) -> np.ndarray:
    """The inverse of `conv_transpose_to_torch`: IOHW -> HWIO, unflipped."""
    return np.ascontiguousarray(np.asarray(weight).transpose(2, 3, 0, 1)[::-1, ::-1])


def transposed_convs(model: torch.nn.Module) -> frozenset:
    """The names of the model's transposed convs (`nn.layers.ConvTranspose`)."""
    from ..nn.layers import ConvTranspose

    return frozenset(n for n, m in model.named_modules() if isinstance(m, ConvTranspose))


def _torch_name(path: str, arr: np.ndarray, stats: bool = False,
                verbatim: bool = False, names=None,
                transposed: frozenset = frozenset()) -> tuple[str, np.ndarray]:
    """A flax leaf's torch name and layout (`names`: the model's, where a
    module name ends in `_<i>` without being a list item; `transposed`: the
    torch names of its transposed convs)."""
    *modules, leaf = path.split("/")
    modules = _modules(modules, names)
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
        elif arr.ndim == 4 and ".".join(modules) in transposed:
            arr = conv_transpose_to_torch(arr)  # ConvTranspose HWIO -> IOHW, flipped
        elif arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)  # Conv HWIO -> OIHW
        else:
            raise ValueError(f"{path}: no torch layout for a {arr.ndim}-d kernel")
    elif leaf == "scale":
        leaf = "weight"
    return ".".join([*modules, leaf]), arr


def flax_path(name: str, ndim: int) -> str:
    """The flax path of a port parameter (the inverse of `_torch_name` on
    parameters): `blocks.3.attn.qkv.weight` (2-D) -> `blocks_3/attn/qkv/kernel`;
    a 2-D or 4-D `weight` is a Dense, Conv or ConvTranspose `kernel`, a 1-D
    one a norm's `scale`; other leaves keep their names (`codebook/embedding`,
    `relative_position_bias_table`, `gamma_1`)."""
    *modules, leaf = name.split(".")
    path: list[str] = []
    for m in modules:
        if m.isdigit() and path:
            path[-1] += f"_{m}"
        else:
            path.append(m)
    if leaf == "weight":
        leaf = "kernel" if ndim in (2, 4) else "scale"
    return "/".join([*path, leaf])


def flax_to_torch(params: Mapping, model: torch.nn.Module,
                  batch_stats: Mapping | None = None,
                  collections: Mapping[str, Mapping] | None = None) -> dict[str, torch.Tensor]:
    """params (and a model with BatchNorm's `batch_stats`, and any other
    variable collections by name): the flax trees as numpy arrays -> a
    state_dict for `model`."""
    target = model.state_dict()
    transposed = transposed_convs(model)
    out: dict[str, torch.Tensor] = {}
    leaves = [(p, a, False, False) for p, a in _flatten(params).items()]
    leaves += [(p, a, True, False) for p, a in _flatten(batch_stats or {}).items()]
    for tree in (collections or {}).values():
        leaves += [(p, a, False, True) for p, a in _flatten(tree).items()]
    for path, arr, stats, verbatim in leaves:
        key, arr = _torch_name(path, arr, stats, verbatim, target, transposed)
        if key not in target:
            raise KeyError(f"flax leaf {path!r} maps to {key!r}, which the model does not have")
        if tuple(arr.shape) != tuple(target[key].shape):
            raise ValueError(f"flax leaf {path!r} has shape {arr.shape} after layout change, "
                             f"{key!r} has {tuple(target[key].shape)}")
        dtype = arr.dtype if arr.dtype.kind in "iub" else np.float32  # (bf16 has no torch numpy)
        out[key] = torch.from_numpy(np.array(arr, dtype=dtype)).to(target[key].dtype)
    # the entries a model says its flax variables never hold (MoCo v3's momentum
    # predictor, which the JAX model never runs) take their EMA source's, as the
    # JAX engine copies the online tower into the target before training; any
    # other gap raises below
    absent = tuple(model.flax_absent()) if hasattr(model, "flax_absent") else ()
    for src, dst, _ in (model.ema_map() if absent else ()):
        for key in sorted(set(target) - set(out)):
            if (key.startswith(absent) and key.startswith(f"{dst}.")
                    and f"{src}{key[len(dst):]}" in out):
                out[key] = out[f"{src}{key[len(dst):]}"].clone()
    missing = sorted(set(target) - set(out))
    if missing:
        raise KeyError(f"no flax leaf fills {missing}")
    return out

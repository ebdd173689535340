"""Checkpoints and the serving artifact of the port.

Checkpoints (counterpart of `passl_tpu/utils/io.py:52-136`): a train state
goes to `<output_dir>/<prefix>.pt` (`latest`, `epoch_N`, `best`) as the
`TrainState.state_dict()` read back with `torch.load(weights_only=True)`,
beside a `<prefix>.states` json with the step, the save time and metrics;
only the newest `max_num_checkpoint` `epoch_*` checkpoints are kept. The
port writes its own format: a JAX `.ckpt` (flax msgpack) is refused.

Pretrained weights (`load_pretrained`, counterpart of
`passl_tpu/utils/io.py:198 load_pretrained_into`): a torch `state_dict`
file, loaded with the JAX loader's tolerance for missing, extra and
mismatched entries.

Serving artifact (counterpart of `passl_tpu/utils/io.py:274 export`):
`<name>.pt` holds the model's `state_dict` (float32 parameters), read back
with `torch.load(weights_only=True)`. `<name>.json` holds what rebuilds the
model around it: the `Model` config, the compute dtype, and the input spec.
"""
from __future__ import annotations

import glob
import json
import os
import time
from typing import Dict, Optional

import torch
import torch.distributed as dist

from ..core.amp import dtype_name
from ..models import build_model
from . import logger


def _is_primary() -> bool:
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def save_checkpoint(state, output_dir: str, prefix: str = "latest", max_num_checkpoint: int = 3,
                    metrics: Optional[Dict[str, float]] = None) -> str:
    """Write `state` (a TrainState) to `<output_dir>/<prefix>.pt` and `.states`
    on the primary process; return the path ("" elsewhere)."""
    if not _is_primary():
        return ""
    os.makedirs(output_dir, exist_ok=True)
    path = os.path.join(output_dir, f"{prefix}.pt")
    tmp = path + ".tmp"
    torch.save(state.state_dict(), tmp)
    os.replace(tmp, path)
    with open(os.path.join(output_dir, f"{prefix}.states"), "w") as f:
        json.dump({"metric": metrics or {}, "save_time": time.time(), "step": state.step}, f)
    _gc_checkpoints(output_dir, max_num_checkpoint)
    logger.info(f"saved checkpoint {path} (step {state.step})")
    return path


def _gc_checkpoints(output_dir: str, keep: int) -> None:
    """Keep the newest `keep` epoch_* checkpoints; never touch best or latest."""
    cands = sorted((os.path.getmtime(p), p) for p in glob.glob(os.path.join(output_dir, "epoch_*.pt")))
    for _, p in cands[:-keep] if keep > 0 else []:
        os.remove(p)
        st = p[:-len(".pt")] + ".states"
        if os.path.exists(st):
            os.remove(st)


def resolve_checkpoint(path: str) -> str:
    """The port checkpoint a config's `Global.checkpoint` names (`.pt`
    optional); raises on a JAX checkpoint."""
    if path.endswith(".ckpt") or path.endswith(".orbax") or os.path.isdir(path):
        raise NotImplementedError(
            f"Global.checkpoint={path} names a checkpoint of the JAX package (flax msgpack or "
            "orbax), which the port does not read; train with the port, or convert the params "
            "with passl_tpu_torch.utils.convert and pass them as Global.pretrained_model")
    if not os.path.exists(path) and os.path.exists(path + ".pt"):
        path += ".pt"
    if not os.path.exists(path):
        raise FileNotFoundError(f"no checkpoint at {path}")
    return path


def load_checkpoint(path: str, state, device: Optional[torch.device] = None):
    """Restore `state` (a TrainState) from a port checkpoint in place; return it."""
    path = resolve_checkpoint(path)
    state.load_state_dict(torch.load(path, map_location=device or "cpu", weights_only=True))
    logger.info(f"resumed from {path} (step {state.step})")
    return state


def load_pretrained(model: torch.nn.Module, path: str) -> dict:
    """Pretrained weights (a torch `state_dict` file) into `model`, with the
    JAX loader's rules (`passl_tpu/utils/io.py:198-271`): an entry the file
    lacks keeps the model's init; a shape mismatch keeps the init, except a
    `pos_embed` of another grid, which is resized bicubically to the model's;
    keys the model lacks are ignored; each case is logged. Returns the report
    {"loaded": the model's keys taken from the file, "missing", "mismatched",
    "extra"}, whose "loaded" drives the EMA towers' re-sync as the JAX
    engine's does."""
    if path.endswith((".params", ".ckpt", ".msgpack")):
        raise NotImplementedError(
            f"Global.pretrained_model={path} names a flax msgpack file of the JAX package, which "
            "the port does not read; convert it with passl_tpu_torch.utils.convert.flax_to_torch")
    loaded = torch.load(path, map_location="cpu", weights_only=True)
    own = model.state_dict()
    take, missing, mismatched = {}, [], []
    for k, v in own.items():
        if k not in loaded:
            missing.append(k)
            continue
        lv = loaded[k]
        if tuple(lv.shape) == tuple(v.shape):
            take[k] = lv
        elif k.endswith("pos_embed") and lv.dim() == 3 and v.dim() == 3 and lv.shape[-1] == v.shape[-1]:
            # finetune at a new resolution: resize the grid part
            from ..models.vision_transformer import interpolate_pos_embed

            n_prefix = 1 if (v.shape[1] - 1) ** 0.5 % 1 == 0 else 0
            new_grid = int(round((v.shape[1] - n_prefix) ** 0.5))
            take[k] = interpolate_pos_embed(lv.to(v.dtype), new_grid, num_prefix=n_prefix)
            logger.info(f"pretrained load: interpolated {k} {tuple(lv.shape)} -> {tuple(v.shape)}")
        else:
            mismatched.append(k)
    extra = [k for k in loaded if k not in own]
    if missing:
        logger.warning(f"pretrained load: {len(missing)} entries not found (kept init): "
                       f"{missing[:5]}...")
    if mismatched:
        logger.warning(f"pretrained load: {len(mismatched)} shape mismatches (kept init): "
                       f"{mismatched[:5]}")
    if extra:
        logger.warning(f"pretrained load: {len(extra)} unused keys in file")
    model.load_state_dict(take, strict=False)
    logger.info(f"loaded pretrained weights from {path}")
    return {"loaded": set(take), "missing": missing, "mismatched": mismatched, "extra": extra}


def export(model: torch.nn.Module, output_dir: str, name: str, model_config: dict,
           compute_dtype: torch.dtype, input_spec: dict) -> str:
    """Write `<name>.pt` and `<name>.json` under output_dir; return the .pt path."""
    os.makedirs(output_dir, exist_ok=True)
    weights = os.path.join(output_dir, f"{name}.pt")
    torch.save(model.state_dict(), weights)
    spec = {
        "model": {k: v for k, v in model_config.items() if k != "dtype"},
        "compute_dtype": dtype_name(compute_dtype),
        "input": input_spec,
    }
    with open(os.path.join(output_dir, f"{name}.json"), "w") as f:
        json.dump(spec, f, indent=2)
    logger.info(f"exported model to {weights}")
    return weights


def load_exported(model_dir: str, name: str, device: torch.device) -> tuple[torch.nn.Module, dict]:
    """Rebuild an exported model on `device` in eval mode; return it and its spec."""
    with open(os.path.join(model_dir, f"{name}.json")) as f:
        spec = json.load(f)
    with torch.device("meta"):  # no init work: every tensor comes from the file
        model = build_model({**spec["model"], "dtype": spec["compute_dtype"]})
    state = torch.load(os.path.join(model_dir, f"{name}.pt"), map_location=device,
                       weights_only=True)
    model.load_state_dict(state, strict=True, assign=True)
    return model.eval(), spec

"""The port's serving artifact (counterpart of `passl_tpu/utils/io.py:274 export`).

`<name>.pt` holds the model's `state_dict` (float32 parameters), read back
with `torch.load(weights_only=True)`. `<name>.json` holds what rebuilds the
model around it: the `Model` config, the compute dtype, and the input spec.
"""
from __future__ import annotations

import json
import os

import torch

from ..core.amp import dtype_name
from ..models import build_model
from . import logger


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

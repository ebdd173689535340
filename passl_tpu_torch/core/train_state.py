"""Train state: everything a step changes, in one place a checkpoint saves whole.

Counterpart of `passl_tpu/core/train_state.py`. The JAX package threads an
immutable pytree through a pure step; here the step updates this object in
place: the global `step`, the model (parameters), the optimizer (its
moments), the dynamic loss scale, the `torch.Generator` that draws the
stochastic-depth masks (the JAX state's `rng`), and an optional full-model
EMA shadow of the parameters.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from .amp import ScalerState


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: "ParamGroupOptimizer"  # noqa: F821  (passl_tpu_torch.optimizer)
    generator: torch.Generator
    step: int = 0
    scaler_state: Optional[ScalerState] = None
    ema_params: Optional[Dict[str, torch.Tensor]] = None  # parameter name -> f32 shadow

    def state_dict(self) -> dict:
        return {
            "step": self.step,
            "model": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "rng": self.generator.get_state(),
            "scaler": dataclasses.asdict(self.scaler_state) if self.scaler_state else None,
            "ema": self.ema_params,
        }

    def load_state_dict(self, state: dict) -> None:
        if (state["ema"] is None) != (self.ema_params is None):
            raise ValueError("checkpoint and config disagree on the EMA shadow (config `EMA`)")
        if (state["scaler"] is None) != (self.scaler_state is None):
            raise ValueError("checkpoint and config disagree on loss scaling (`FP16.dtype`)")
        self.step = int(state["step"])
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.generator.set_state(state["rng"].cpu())
        if state["scaler"] is not None:
            self.scaler_state = ScalerState(**state["scaler"])
        if state["ema"] is not None:
            with torch.no_grad():
                for name, t in self.ema_params.items():
                    t.copy_(state["ema"][name])

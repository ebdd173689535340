"""BYOL: bootstrap your own latent (counterpart of `passl_tpu/models/byol.py:28-93`).

An online tower (backbone + projector neck) and a predictor learn to
regress the target tower's projection of the other view; the target tower
has the online tower's structure and follows it by an EMA that the train
step applies after the optimizer step (`ema_map`); the optimizer leaves it
alone (`frozen_patterns`). The loss is `2 - 2 cos` in f32, summed over both
view orders. The target's forward runs under `torch.no_grad()` (JAX's
`stop_gradient`) in the model's mode, so in training its BatchNorms use the
batch statistics and update their own running statistics, as in JAX.

With `use_device_augment` the model takes uint8 NHWC views and runs the
plain `ops.augment.byol_device_augment` on them with draws from the
`generator` the train step hands it (the train state's), then casts to the
compute dtype. Module names follow the flax model's (`online`, `target`,
`predictor`, each tower's `backbone` and `neck`).
"""
from __future__ import annotations

from typing import Any, Optional, Union

import torch
from torch import nn

from ..core.amp import resolve_dtype
from ..nn.norm import l2_normalize
from ..ops.augment import byol_device_augment
from .base import register_model, two_views
from .builder import Encoder, build_submodule

DtypeLike = Union[str, torch.dtype]


def byol_regression_loss(p: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """2 - 2 cos(p, z), the mean over the batch, in f32."""
    p = l2_normalize(p.float(), dim=-1)
    z = l2_normalize(z.float(), dim=-1)
    return 2.0 - 2.0 * torch.mean(torch.sum(p * z, dim=-1))


@register_model
class BYOL(nn.Module):
    """batch (view1, view2) [N, H, W, C] -> {"loss": scalar f32}."""

    def __init__(self, backbone: Any = None, neck: Any = None, predictor: Any = None,
                 base_momentum: float = 0.996, momentum_schedule: str = "cosine",
                 use_device_augment: bool = False, dtype: DtypeLike = torch.float32):
        super().__init__()
        dtype = resolve_dtype(dtype)
        self.base_momentum = base_momentum
        self.momentum_schedule = momentum_schedule
        self.use_device_augment = use_device_augment
        self.dtype = dtype
        self.online = Encoder(backbone, neck, dtype)
        self.target = Encoder(backbone, neck, dtype)
        self.predictor = build_submodule(predictor, dtype=dtype,
                                         in_channels=self.online.neck.out_channels)

    def ema_map(self) -> list:
        cfg = {"momentum": self.base_momentum}
        if self.momentum_schedule == "cosine":
            cfg["schedule"] = "cosine"
        return [("online", "target", cfg)]

    @staticmethod
    def frozen_patterns() -> list:
        return [r"^target\."]

    def forward(self, batch, generator: Optional[torch.Generator] = None) -> dict:
        v1, v2 = two_views(batch)
        if self.use_device_augment:
            if generator is None:
                raise ValueError("BYOL use_device_augment needs the train state's generator")
            v1, v2 = byol_device_augment(v1, v2, generator)
            v1, v2 = v1.to(self.dtype), v2.to(self.dtype)
        z1 = self.online(v1)
        z2 = self.online(v2)
        p1 = self.predictor(z1)
        p2 = self.predictor(z2)
        with torch.no_grad():
            t1 = self.target(v1)
            t2 = self.target(v2)
        # the sum over both view orders, as the reference's L2 head
        loss = byol_regression_loss(p1, t2) + byol_regression_loss(p2, t1)
        return {"loss": loss}

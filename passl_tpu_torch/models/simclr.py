"""SimCLR: two-view contrastive pretraining with NT-Xent and CO2
(counterpart of `passl_tpu/models/simclr.py:29-110`).

Both views go through the backbone and the neck in one concatenated pass,
so the BatchNorm statistics span both views, as in JAX. The loss
(`nt_xent_co2_loss`) is computed in f32: each view's cross-entropy over its
[cross-view, intra-view] logits with the self-pairs masked by `LARGE_NUM`,
plus the CO2 consistency term (the KL divergence of the two views'
distributions over the same candidates, both ways, batch-mean) at
`co2_weight`; `acc1` is the share of images whose positive pair leads the
cross-view logits.

With `use_device_augment` the model takes uint8 NHWC views and runs the
plain `ops.augment.simclr_device_augment` on them with draws from the
`generator` the train step hands it (the train state's), then casts to the
compute dtype. Module names follow the flax model's (`backbone`, `neck`).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..core.amp import at_least_f32, resolve_dtype
from ..nn.norm import l2_normalize
from ..ops.augment import simclr_device_augment
from .base import register_model, two_views
from .builder import build_submodule

DtypeLike = Union[str, torch.dtype]
LARGE_NUM = 1e9


def nt_xent_co2_loss(h1: torch.Tensor, h2: torch.Tensor, temperature: float = 0.5,
                     co2_weight: float = 3.0) -> Dict[str, torch.Tensor]:
    """h1, h2 [N, D] -> {"loss", "acc1"}, scalars in f32 (f64 for f64 inputs)."""
    n = h1.shape[0]
    h1 = l2_normalize(at_least_f32(h1), dim=-1)
    h2 = l2_normalize(at_least_f32(h2), dim=-1)
    mask = torch.eye(n, dtype=h1.dtype, device=h1.device) * LARGE_NUM

    logits_aa = h1 @ h1.T / temperature - mask
    logits_bb = h2 @ h2.T / temperature - mask
    logits_ab = h1 @ h2.T / temperature
    logits_ba = h2 @ h1.T / temperature
    labels = torch.arange(n, device=h1.device)

    def ce(logits: torch.Tensor) -> torch.Tensor:
        return -torch.gather(F.log_softmax(logits, dim=-1), 1, labels[:, None])[:, 0]

    loss_a = ce(torch.cat([logits_ab, logits_aa], dim=1))
    loss_b = ce(torch.cat([logits_ba, logits_bb], dim=1))
    contrast = torch.mean(loss_a + loss_b)

    log_a = F.log_softmax(torch.cat([logits_aa, logits_ab - mask], dim=1), dim=-1)
    log_b = F.log_softmax(torch.cat([logits_ba - mask, logits_bb], dim=1), dim=-1)
    p_a, p_b = torch.exp(log_a), torch.exp(log_b)
    kl_1 = torch.sum(p_b * (torch.log(torch.clamp(p_b, min=1e-12)) - log_a)) / n
    kl_2 = torch.sum(p_a * (torch.log(torch.clamp(p_a, min=1e-12)) - log_b)) / n

    acc1 = torch.mean((torch.argmax(logits_ab, dim=-1) == labels).to(h1.dtype))
    return {"loss": contrast + co2_weight * (kl_1 + kl_2), "acc1": acc1}


@register_model
class SimCLR(nn.Module):
    """batch (view1, view2) [N, H, W, C] -> {"loss", "acc1"}, scalars in f32."""

    def __init__(self, backbone: Any = None, neck: Any = None, temperature: float = 0.5,
                 co2_weight: float = 3.0, use_device_augment: bool = False,
                 jitter_strength: float = 0.5, dtype: DtypeLike = torch.float32):
        super().__init__()
        dtype = resolve_dtype(dtype)
        self.temperature = temperature
        self.co2_weight = co2_weight
        self.use_device_augment = use_device_augment
        self.jitter_strength = jitter_strength
        self.dtype = dtype
        self.backbone = build_submodule(backbone, dtype=dtype)
        self.neck = build_submodule(neck, dtype=dtype, in_channels=self.backbone.out_channels)

    def forward(self, batch, generator: Optional[torch.Generator] = None) -> dict:
        x1, x2 = two_views(batch)
        if self.use_device_augment:
            if generator is None:
                raise ValueError("SimCLR use_device_augment needs the train state's generator")
            x1, x2 = simclr_device_augment(x1, x2, generator,
                                           jitter_strength=self.jitter_strength)
            x1, x2 = x1.to(self.dtype), x2.to(self.dtype)
        z = self.neck(self.backbone(torch.cat([x1, x2], dim=0)))
        n = x1.shape[0]
        return nt_xent_co2_loss(z[:n], z[n:], self.temperature, self.co2_weight)

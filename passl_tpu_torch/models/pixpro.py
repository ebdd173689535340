"""MoCo-BYOL: BYOL's regression beside MoCo's InfoNCE over a queue
(counterpart of `passl_tpu/models/pixpro.py:133-190`; PixPro, which lives in
the same JAX file, is not ported yet).

An `online` tower (backbone and projector neck) with a `predictor`, and a
`target` tower of the same structure that follows the online tower by an
EMA with the cosine schedule from `m`, applied by the train step after the
optimizer step (`ema_map`); the optimizer leaves the target alone
(`frozen_patterns`). The target's forward runs under `torch.no_grad()` in
the model's mode, as BYOL's does. There is no shuffle-BN.

The loss is `byol_weight` times half BYOL's symmetric regression sum,
0.5 (byol_regression_loss(p1, t2) + byol_regression_loss(p2, t1)), plus
`contrast_weight` times the InfoNCE of q = l2(p1) against k = l2(t2) and
the queue, one direction only, all in f32. The queue `[dim, K]` and its
pointer are buffers (JAX's `ssl` collection), started and written as
MoCo's are (`moco.init_queue`, `moco.enqueue`: the clamped write of
`dynamic_update_slice`), after the loss and in training only.
"""
from __future__ import annotations

from typing import Any, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..core.amp import at_least_f32, resolve_dtype
from ..nn.norm import l2_normalize
from .base import register_model, two_views
from .builder import Encoder, build_submodule
from .byol import byol_regression_loss
from .moco import enqueue, info_nce_logits, init_queue

DtypeLike = Union[str, torch.dtype]


@register_model
class MoCoBYOL(nn.Module):
    """batch (view1, view2) [N, H, W, C] -> {"loss", "byol_loss", "contrast_loss"},
    scalars in f32."""

    def __init__(self, backbone: Any = None, neck: Any = None, predictor: Any = None,
                 dim: int = 256, K: int = 65536, m: float = 0.999, T: float = 0.2,
                 byol_weight: float = 1.0, contrast_weight: float = 1.0,
                 dtype: DtypeLike = torch.float32):
        super().__init__()
        dtype = resolve_dtype(dtype)
        self.K, self.m, self.T = K, m, T
        self.byol_weight, self.contrast_weight = byol_weight, contrast_weight
        self.online = Encoder(backbone, neck, dtype)
        self.target = Encoder(backbone, neck, dtype)
        self.predictor = build_submodule(predictor, dtype=dtype,
                                         in_channels=self.online.neck.out_channels)
        self.register_buffer("queue", torch.empty(dim, K))
        self.register_buffer("queue_ptr", torch.zeros((), dtype=torch.long))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        init_queue(self.queue, self.queue_ptr, generator)

    def ema_map(self) -> list:
        return [("online", "target", {"momentum": self.m, "schedule": "cosine"})]

    @staticmethod
    def frozen_patterns() -> list:
        return [r"^target\."]

    def forward(self, batch, generator: Optional[torch.Generator] = None) -> dict:
        v1, v2 = two_views(batch)
        p1 = self.predictor(self.online(v1))
        p2 = self.predictor(self.online(v2))
        with torch.no_grad():
            t1 = self.target(v1)
            t2 = self.target(v2)
        byol_loss = 0.5 * (byol_regression_loss(p1, t2) + byol_regression_loss(p2, t1))
        q = l2_normalize(at_least_f32(p1), dim=1)
        k = l2_normalize(at_least_f32(t2), dim=1)
        # a copy: the enqueue below writes the buffer before the backward reads it
        logits = info_nce_logits(q, k, self.queue.to(q.dtype, copy=True), self.T)
        contrast_loss = -torch.mean(F.log_softmax(logits, dim=-1)[:, 0])
        if self.training:
            enqueue(self.queue, self.queue_ptr, k)
        loss = self.byol_weight * byol_loss + self.contrast_weight * contrast_loss
        return {"loss": loss, "byol_loss": byol_loss, "contrast_loss": contrast_loss}

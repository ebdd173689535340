"""Classification over a backbone: the linear probe and fine-tuning wrapper
(counterpart of `passl_tpu/models/classification.py:22-52`).

`Classification` puts a fresh `fc` (normal(`head_init_std`) weight, zero
bias, from the init generator) over a backbone built from its config block,
averaging a 4-D NHWC feature map over H and W first when `with_pool` says
so. With `freeze_backbone` (`LinearProbe`'s default) the backbone runs in
eval mode whatever `model.train()` says, under `torch.no_grad()`: its
BatchNorms normalize with their running statistics and never update them,
and no gradient reaches it (JAX: `stop_gradient(backbone(x, train=False))`);
`frozen_patterns()` keeps the optimizer off it. Flax infers the head's input
width; here it is the backbone's `out_channels` (`head_dim` where the
backbone has none).
"""
from __future__ import annotations

from typing import Any, Optional, Union

import torch
from torch import nn

from ..core.amp import resolve_dtype
from ..nn.layers import Dense
from .base import register_model
from .builder import build_submodule

DtypeLike = Union[str, torch.dtype]


@register_model
class Classification(nn.Module):
    """images [N, H, W, C] -> logits [N, num_classes] at `dtype`."""

    def __init__(self, backbone: Any = None, head_dim: int = 2048, num_classes: int = 1000,
                 freeze_backbone: bool = False, head_init_std: float = 0.01,
                 with_pool: bool = True, dtype: DtypeLike = torch.float32):
        super().__init__()
        dtype = resolve_dtype(dtype)
        self.freeze_backbone = freeze_backbone
        self.with_pool = with_pool
        self.backbone = build_submodule(backbone, dtype=dtype)
        in_ch = getattr(self.backbone, "out_channels", head_dim)

        def init(t: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
            return nn.init.normal_(t, 0.0, head_init_std, generator=generator)

        self.fc = Dense(in_ch, num_classes, dtype=dtype, kernel_init=init)

    def frozen_patterns(self) -> list:
        return [r"^backbone\."] if self.freeze_backbone else []

    def train(self, mode: bool = True) -> "Classification":
        super().train(mode)
        if self.freeze_backbone:  # frozen BatchNorm statistics
            self.backbone.eval()
        return self

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.freeze_backbone:
            with torch.no_grad():
                feats = self.backbone(x)
        else:
            feats = self.backbone(x, generator=generator)
        if feats.dim() == 4 and self.with_pool:
            feats = feats.mean(dim=(1, 2))
        return self.fc(feats)


@register_model
class LinearProbe(Classification):
    """`Classification` with `freeze_backbone` on by default."""

    def __init__(self, backbone: Any = None, head_dim: int = 2048, num_classes: int = 1000,
                 freeze_backbone: bool = True, head_init_std: float = 0.01,
                 with_pool: bool = True, dtype: DtypeLike = torch.float32):
        super().__init__(backbone, head_dim, num_classes, freeze_backbone, head_init_std,
                         with_pool, dtype)

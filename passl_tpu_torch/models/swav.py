"""SwAV: online clustering of multi-crop views against prototypes
(counterpart of `passl_tpu/models/swav.py:31-110`).

A `backbone`, a `SwAVNeck` (its output unit-norm) and `prototypes`, a
bias-free Dense `[num_prototypes, dim]` kept and computed in f32 whatever
the model's dtype (the neck's output is cast to f32 before it). The crops
(a list of `[N, H, W, C]` batches, as the loader collates
`SwAVMultiCropDataset`'s samples) are grouped by their height in order of
first appearance; each group is concatenated and goes through the backbone
and the neck in one call, so its BatchNorms take one set of batch
statistics per group and the running statistics move once per group.

The loss, in f32: for each crop i of `crops_for_assign`, the target
q_i = `sinkhorn_knopp` of its scores (no gradient), and the mean over the
batch of -sum(q_i log_softmax(s_v / T)) over every other crop v, divided by
the crops less one; then the mean over `crops_for_assign`.

Hooks the engine honours, in the port's dotted idiom:
`optimizer_overrides()` freezes the prototypes for the first
`freeze_prototypes_iter` steps (their lr is 0), and `param_transforms()`
l2-normalizes each prototype (a row of the torch weight; a column of the
flax kernel `[dim, K]`) at init and after every applied step.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..core.amp import at_least_f32, resolve_dtype
from ..nn.layers import Dense
from ..nn.norm import l2_normalize
from .base import register_model
from .builder import build_submodule

DtypeLike = Union[str, torch.dtype]


@torch.no_grad()
def sinkhorn_knopp(scores: torch.Tensor, epsilon: float = 0.05,
                   iterations: int = 3) -> torch.Tensor:
    """scores [B, K] -> the balanced assignment Q [B, K], each row summing to 1.

    JAX's exact form: Q = exp(scores / eps)^T in f32 with no max subtracted
    (the scores are cosines of unit vectors, so exp(1 / 0.05) stays finite),
    Q /= sum(Q), then `iterations` times rows / K and columns / B, then (Q B)^T."""
    q = torch.exp(at_least_f32(scores) / epsilon).T
    k, b = q.shape
    q = q / torch.sum(q)
    for _ in range(iterations):
        q = q / torch.sum(q, dim=1, keepdim=True) / k
        q = q / torch.sum(q, dim=0, keepdim=True) / b
    return (q * b).T


@register_model
class SwAV(nn.Module):
    """batch [crop_0, crop_1, ...] each [N, H, W, C] -> {"loss": scalar f32}."""

    def __init__(self, backbone: Any = None, neck: Any = None, dim: int = 128,
                 num_prototypes: int = 3000, temperature: float = 0.1, epsilon: float = 0.05,
                 sinkhorn_iterations: int = 3, num_crops: Sequence[int] = (2,),
                 crops_for_assign: Sequence[int] = (0, 1), freeze_prototypes_iter: int = 0,
                 dtype: DtypeLike = torch.float32):
        super().__init__()
        dtype = resolve_dtype(dtype)
        self.temperature = temperature
        self.epsilon = epsilon
        self.sinkhorn_iterations = sinkhorn_iterations
        self.num_crops = tuple(num_crops)
        self.crops_for_assign = tuple(crops_for_assign)
        self.freeze_prototypes_iter = freeze_prototypes_iter
        self.backbone = build_submodule(backbone, dtype=dtype)
        self.neck = build_submodule(neck, dtype=dtype, in_channels=self.backbone.out_channels)
        # the flax model takes its input width from the neck, not from `dim`
        self.prototypes = Dense(self.neck.out_channels, num_prototypes, torch.float32,
                                use_bias=False)

    def optimizer_overrides(self) -> List[Dict]:
        if self.freeze_prototypes_iter > 0:
            return [{"name": r"^prototypes\.", "freeze_steps": self.freeze_prototypes_iter}]
        return []

    @staticmethod
    def param_transforms() -> list:
        # each prototype unit-norm: a row of the [K, dim] weight
        return [(r"^prototypes\.weight$", lambda w: l2_normalize(w, dim=1))]

    def forward(self, batch, generator: Optional[torch.Generator] = None) -> dict:
        crops = list(batch) if isinstance(batch, (list, tuple)) else [batch]
        groups: Dict[int, List[int]] = {}
        for i, c in enumerate(crops):  # NHWC: grouped by height
            groups.setdefault(c.shape[1], []).append(i)
        z_by_crop: Dict[int, torch.Tensor] = {}
        for idxs in groups.values():
            z = self.neck(self.backbone(torch.cat([crops[i] for i in idxs], dim=0)))
            per = crops[idxs[0]].shape[0]
            for j, i in enumerate(idxs):
                z_by_crop[i] = z[j * per:(j + 1) * per]
        scores = {i: self.prototypes(at_least_f32(z)) for i, z in z_by_crop.items()}

        total = len(crops)
        loss = 0.0
        for i in self.crops_for_assign:
            q = sinkhorn_knopp(scores[i], self.epsilon, self.sinkhorn_iterations)
            subloss = 0.0
            for v in range(total):
                if v != i:
                    logp = F.log_softmax(scores[v] / self.temperature, dim=-1)
                    subloss = subloss - torch.mean(torch.sum(q * logp, dim=-1))
            loss = loss + subloss / (total - 1)
        return {"loss": loss / len(self.crops_for_assign)}

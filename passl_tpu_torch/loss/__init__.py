"""Loss functions and their factory.

Counterpart of `passl_tpu/loss/__init__.py`: `cross_entropy` with hard or
soft (mixup/cutmix) labels and label smoothing, `CELoss`,
`SoftTargetCrossEntropy`, `CombinedLoss` (weighted sum, with the total under
"loss") and `build_loss` over the same YAML surface. Every loss is taken in
float32 from logits of any dtype (float64 from a model run in float64).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

from ..core.amp import at_least_f32
from ..utils.registry import Registry

LOSSES = Registry("losses")


def register_loss(obj=None, name=None):
    return LOSSES.register(obj, name=name)


def soft_cross_entropy(logits: torch.Tensor, soft_targets: torch.Tensor) -> torch.Tensor:
    logp = F.log_softmax(at_least_f32(logits), dim=-1)
    return -(soft_targets.to(logp.dtype) * logp).sum(-1).mean()


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, label_smoothing: float = 0.0,
                  num_classes: Optional[int] = None) -> torch.Tensor:
    """Hard or soft-label CE with optional smoothing.

    Soft labels (same rank as the logits) are smoothed again when
    `label_smoothing > 0`, as the JAX function does, even when the batch
    transform that made them already smoothed them.
    """
    if labels.dim() == logits.dim():  # soft labels (mixup/cutmix)
        targets = labels.float()
        if label_smoothing > 0:
            n = logits.shape[-1]
            targets = targets * (1 - label_smoothing) + label_smoothing / n
        return soft_cross_entropy(logits, targets)
    logp = F.log_softmax(at_least_f32(logits), dim=-1)
    nll = -logp.gather(-1, labels.long().unsqueeze(-1)).squeeze(-1)
    if label_smoothing > 0:
        smooth = -logp.mean(-1)
        nll = (1 - label_smoothing) * nll + label_smoothing * smooth
    return nll.mean()


@register_loss
class CELoss:
    def __init__(self, label_smoothing: float = 0.0, epsilon: Optional[float] = None,
                 weight: float = 1.0, **_):
        # v110 spells smoothing "epsilon"
        self.label_smoothing = label_smoothing if epsilon is None else epsilon
        self.weight = weight

    def __call__(self, logits, labels):
        return {"CELoss": self.weight * cross_entropy(logits, labels, self.label_smoothing)}


@register_loss
class SoftTargetCrossEntropy:
    def __init__(self, weight: float = 1.0, **_):
        self.weight = weight

    def __call__(self, logits, soft_targets):
        return {"SoftTargetCE": self.weight * soft_cross_entropy(logits, soft_targets)}


class CombinedLoss:
    """Weighted sum of registered losses; the total is under "loss"."""

    def __init__(self, loss_fns: List[Callable]):
        self.loss_fns = loss_fns

    def __call__(self, logits, labels) -> Dict[str, torch.Tensor]:
        out: Dict[str, torch.Tensor] = {}
        for fn in self.loss_fns:
            out.update(fn(logits, labels))
        out["loss"] = sum(out.values())
        return out


def build_loss(config) -> Optional[CombinedLoss]:
    """config: a list of {LossName: {weight: w, ...}} or {name: ...} dicts."""
    if config is None:
        return None
    fns = []
    items = config if isinstance(config, (list, tuple)) else [config]
    for item in items:
        if "name" in item:
            kwargs = {k: v for k, v in item.items() if k != "name"}
            fns.append(LOSSES.get(item["name"])(**kwargs))
        else:
            for lname, kwargs in item.items():
                fns.append(LOSSES.get(lname)(**(kwargs or {})))
    return CombinedLoss(fns)

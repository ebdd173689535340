# Copied from passl_tpu/data/batch_transforms.py; the port keeps its own copy and imports nothing of passl_tpu.
"""Batch-level transforms: Mixup / Cutmix / op sampler.

Capability parity with reference `passl/data/preprocess/
batch_transforms.py` (Mixup:72, Cutmix:109, TransformOpSampler:169).
Host-side numpy; produce soft labels consumed by SoftTargetCE/CELoss.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence

import numpy as np


def _one_hot(labels: np.ndarray, num_classes: int, smoothing: float = 0.0) -> np.ndarray:
    off = smoothing / num_classes
    on = 1.0 - smoothing + off
    out = np.full((len(labels), num_classes), off, np.float32)
    out[np.arange(len(labels)), labels] = on
    return out


class Mixup:
    def __init__(self, alpha: float = 0.2, num_classes: int = 1000, label_smoothing: float = 0.0):
        self.alpha = alpha
        self.num_classes = num_classes
        self.label_smoothing = label_smoothing

    def __call__(self, batch):
        images, labels = batch
        lam = np.random.beta(self.alpha, self.alpha)
        perm = np.random.permutation(len(images))
        images = lam * images + (1 - lam) * images[perm]
        y = _one_hot(labels, self.num_classes, self.label_smoothing)
        y = lam * y + (1 - lam) * y[perm]
        return images.astype(np.float32), y


class Cutmix:
    def __init__(self, alpha: float = 0.2, num_classes: int = 1000, label_smoothing: float = 0.0):
        self.alpha = alpha
        self.num_classes = num_classes
        self.label_smoothing = label_smoothing

    def __call__(self, batch):
        images, labels = batch
        lam = np.random.beta(self.alpha, self.alpha)
        perm = np.random.permutation(len(images))
        h, w = images.shape[1:3]
        cut = np.sqrt(1 - lam)
        ch, cw = int(h * cut), int(w * cut)
        cy, cx = np.random.randint(h), np.random.randint(w)
        y1, y2 = np.clip(cy - ch // 2, 0, h), np.clip(cy + ch // 2, 0, h)
        x1, x2 = np.clip(cx - cw // 2, 0, w), np.clip(cx + cw // 2, 0, w)
        images = images.copy()
        images[:, y1:y2, x1:x2] = images[perm][:, y1:y2, x1:x2]
        lam_adj = 1 - (y2 - y1) * (x2 - x1) / (h * w)
        y = _one_hot(labels, self.num_classes, self.label_smoothing)
        y = lam_adj * y + (1 - lam_adj) * y[perm]
        return images.astype(np.float32), y


class TransformOpSampler:
    """Pick one op per batch with given probabilities (reference :169)."""

    def __init__(self, **ops_cfg):
        self.ops: List[Callable] = []
        self.probs: List[float] = []
        for name, kwargs in ops_cfg.items():
            kwargs = dict(kwargs or {})
            prob = kwargs.pop("prob", 1.0)
            self.ops.append(BATCH_TRANSFORMS[name](**kwargs))
            self.probs.append(prob)
        total = sum(self.probs)
        self.probs = [p / total for p in self.probs]

    def __call__(self, batch):
        op = np.random.choice(len(self.ops), p=self.probs)
        return self.ops[op](batch)


class Identity:
    def __call__(self, batch):
        return batch


BATCH_TRANSFORMS: Dict[str, Any] = {
    "Mixup": Mixup,
    "Cutmix": Cutmix,
    "TransformOpSampler": TransformOpSampler,
    "Identity": Identity,
}


def build_batch_transform(cfg) -> Callable:
    items = cfg if isinstance(cfg, (list, tuple)) else [cfg]
    ops = []
    for item in items:
        for name, kwargs in item.items():
            ops.append(BATCH_TRANSFORMS[name](**(kwargs or {})))

    def apply(batch):
        for op in ops:
            batch = op(batch)
        return batch

    return apply

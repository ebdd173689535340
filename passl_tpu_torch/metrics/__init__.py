"""Metrics (counterpart of `passl_tpu/metrics/__init__.py`): `TopkAcc` in
torch, `mAP` on the host in numpy (the JAX class as it is: it takes numpy
arrays or CPU tensors), and the `build_metrics` factory."""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from ..utils.registry import Registry

METRICS = Registry("metrics")


@METRICS.register
class TopkAcc:
    def __init__(self, topk: Sequence[int] = (1, 5)):
        self.topk = tuple(topk)

    def __call__(self, logits: torch.Tensor, labels: torch.Tensor) -> Dict[str, torch.Tensor]:
        if labels.dim() == logits.dim():  # soft labels -> argmax
            labels = labels.argmax(-1)
        maxk = min(max(self.topk), logits.shape[-1])
        # stable descending order breaks ties by index, as jnp.argsort(-x) does
        pred = torch.sort(logits.float(), dim=-1, descending=True, stable=True).indices[:, :maxk]
        correct = pred == labels[:, None]
        return {f"top{k}": correct[:, :k].any(-1).float().mean() for k in self.topk}


@METRICS.register
class mAP:
    """Mean average precision over multi-label targets (host-side numpy,
    reference metrics.py:58-101)."""

    def __call__(self, scores, targets) -> Dict[str, float]:
        scores = np.asarray(scores)
        targets = np.asarray(targets)
        aps = []
        for c in range(scores.shape[1]):
            t = targets[:, c]
            if t.sum() == 0:
                continue
            order = np.argsort(-scores[:, c])
            t = t[order]
            tp = np.cumsum(t)
            precision = tp / (np.arange(len(t)) + 1)
            aps.append((precision * t).sum() / t.sum())
        return {"mAP": float(np.mean(aps)) if aps else 0.0}


def build_metrics(config) -> List:
    if config is None:
        return []
    out = []
    items = config if isinstance(config, (list, tuple)) else [config]
    for item in items:
        if isinstance(item, str):
            out.append(METRICS.get(item)())
        elif "name" in item:
            kwargs = {k: v for k, v in item.items() if k != "name"}
            out.append(METRICS.get(item["name"])(**kwargs))
        else:
            for mname, kwargs in item.items():
                out.append(METRICS.get(mname)(**(kwargs or {})))
    return out

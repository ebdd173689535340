"""Metrics (counterpart of `passl_tpu/metrics/__init__.py:18-30, 50-67`):
`TopkAcc` in torch and the `build_metrics` factory."""
from __future__ import annotations

from typing import Dict, List, Sequence

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

"""Inference predictor over the port's exported artifact.

Counterpart of `passl_tpu/engine/inference.py:20-60`, with the same
`preprocess`/`predict`/`postprocess`/`__call__` surface. It serves
`<name>.pt` + `<name>.json` written by `passl_tpu_torch.tools.export` on an
explicit device, `cuda` by default, under `torch.inference_mode()`.
"""
from __future__ import annotations

from typing import Any, Sequence, Union

import numpy as np
import torch

from ..data.transforms import build_transform
from ..utils import io, logger


class Predictor:
    def __init__(self, model_dir: str, name: str = "inference", transform=None,
                 device: Union[str, torch.device] = "cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Predictor: device is cuda but torch.cuda.is_available() is False")
        self.model, self.spec = io.load_exported(model_dir, name, self.device)
        self._transform = build_transform(transform) if transform is not None else None
        logger.info(f"Predictor loaded {model_dir}/{name}.pt on {self.device} "
                    f"({self.spec['compute_dtype']} compute)")

    def preprocess(self, images: Sequence[Any]) -> np.ndarray:
        if self._transform is None:
            return np.asarray(images)
        return np.stack([np.asarray(self._transform(im)) for im in images])

    def predict(self, batch: np.ndarray) -> np.ndarray:
        """NHWC batch -> float32 logits [n, num_classes] on the host."""
        x = torch.as_tensor(np.asarray(batch), dtype=torch.float32).to(self.device)
        with torch.inference_mode():
            return self.model(x).float().cpu().numpy()

    def postprocess(self, logits: np.ndarray, topk: int = 5):
        ex = np.exp(logits - logits.max(axis=-1, keepdims=True))
        probs = ex / ex.sum(axis=-1, keepdims=True)
        idx = np.argsort(-probs, axis=-1)[:, :topk]
        return [
            {"class_ids": list(map(int, idx[i])),
             "scores": [float(probs[i, j]) for j in idx[i]]}
            for i in range(len(logits))
        ]

    def __call__(self, images, topk: int = 5):
        batch = self.preprocess(images)
        return self.postprocess(self.predict(batch), topk=topk)

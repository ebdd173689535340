# Copied from passl_tpu/data/token_label.py; the port keeps its own copy and imports nothing of passl_tpu.
# Unchanged: its imports are relative, so they reach the port's own `datasets` and `transforms` copies.
"""LV-ViT token-label data pipeline.

Capability parity with reference `passl_v110/datasets/lvdataset.py`
(LVViT_ImageNet: image + precomputed per-patch score-map .npy) and the
label-aware transforms in `passl_v110/datasets/preprocess/lvvit/
transforms.py` (crop/flip applied to image and label map together).

Label-map format (the public token-labeling release the reference
consumes): one float .npy per image shaped [2, K, H, W] — channel 0 the
top-K soft-label *values*, channel 1 the top-K class *indices* — on a
coarse grid. The transform crops the map region matching the image
crop, resizes it to the model's patch grid, and the sample becomes
{'image', 'label', 'token_value' [gh,gw,K], 'token_idx' [gh,gw,K]}.
The device side (models/t2t_vit.py LVViTTokenLabel) does the MixToken
cutmix and soft-CE in-graph — per-sample work stays on host, per-batch
math on TPU.
"""
from __future__ import annotations

import math
import os
import random
from typing import Any, Optional, Sequence, Tuple

import numpy as np

from .datasets import Dataset, ImageNetDataset
from .transforms import (NormalizeImage, RandomResizedCrop, _crop, _img_size,
                         build_transform)


def _resize_label_map(lab: np.ndarray, gh: int, gw: int) -> np.ndarray:
    """[2, K, H, W] → [2, K, gh, gw] by nearest-neighbor (indices must
    not be interpolated; values follow to stay aligned)."""
    _, k, h, w = lab.shape
    ys = (np.arange(gh) * h / gh).astype(np.int64).clip(0, h - 1)
    xs = (np.arange(gw) * w / gw).astype(np.int64).clip(0, w - 1)
    return lab[:, :, ys[:, None], xs[None, :]]


class TokenLabelRandomResizedCrop(RandomResizedCrop):
    """RRC applied to (img, label_map) consistently: the label-map crop
    box is the image crop box scaled to label-grid coordinates
    (reference LVViTRandomResizedCropAndInterpolation + affine_label)."""

    def __init__(self, size, grid_size: int, scale=(0.08, 1.0),
                 ratio=(3.0 / 4, 4.0 / 3), interpolation="bicubic", backend="pil"):
        super().__init__(size, scale, ratio, interpolation, backend)
        self.grid = grid_size

    def __call__(self, sample):
        img, lab = sample
        x, y, cw, ch = self.get_params(img)
        w, h = _img_size(img)
        img = _crop(img, x, y, cw, ch)
        img = self._resize(img, (self.size[1], self.size[0]))
        _, _, lh, lw = lab.shape
        lx1 = int(math.floor(x * lw / w))
        ly1 = int(math.floor(y * lh / h))
        lx2 = max(lx1 + 1, int(math.ceil((x + cw) * lw / w)))
        ly2 = max(ly1 + 1, int(math.ceil((y + ch) * lh / h)))
        lab = lab[:, :, ly1:ly2, lx1:lx2]
        return img, _resize_label_map(lab, self.grid, self.grid)


class TokenLabelFlip:
    """Horizontal flip of image + label map together."""

    def __init__(self, prob: float = 0.5):
        self.prob = prob

    def __call__(self, sample):
        img, lab = sample
        if random.random() < self.prob:
            if isinstance(img, np.ndarray):
                img = img[:, ::-1]
            else:
                from PIL import Image

                img = img.transpose(Image.FLIP_LEFT_RIGHT)
            lab = lab[:, :, :, ::-1]
        return img, lab


class LVViTImageNetDataset(ImageNetDataset):
    """ImageNet with token-label maps (reference lvdataset.py:26-57).

    Args mirror ImageNetDataset plus `label_root` (directory of per-image
    .npy score maps, same relative path with .npy suffix), `grid_size`
    (the model's patch grid, e.g. 14 for LVViT-S @ 224/16), crop/flip
    knobs, and `post_transform` (image-only ops after the joint ones)."""

    def __init__(self, image_root: str, cls_label_path: str, label_root: str,
                 grid_size: int = 14, image_size: int = 224,
                 scale=(0.08, 1.0), interpolation: str = "bicubic",
                 flip_prob: float = 0.5, post_transform=None):
        super().__init__(image_root=image_root, cls_label_path=cls_label_path,
                         transform=None)
        self.label_root = label_root
        self.grid = grid_size
        self.joint = [TokenLabelRandomResizedCrop(image_size, grid_size,
                                                  scale=scale, interpolation=interpolation),
                      TokenLabelFlip(flip_prob)]
        self.post = build_transform(post_transform or
                                    [{"NormalizeImage": {"scale": 0.00392157,
                                                         "mean": [0.485, 0.456, 0.406],
                                                         "std": [0.229, 0.224, 0.225]}}])

    def _label_path(self, img_path: str) -> str:
        rel = os.path.relpath(img_path, self.root)
        return os.path.join(self.label_root, os.path.splitext(rel)[0] + ".npy")

    def __getitem__(self, idx):
        path, label = self.samples[idx]
        img = self._load(path)
        lab = np.load(self._label_path(path)).astype(np.float32)
        sample = (img, lab)
        for t in self.joint:
            sample = t(sample)
        img, lab = sample
        img = self.post(img)
        # [2, K, gh, gw] → value/idx [gh, gw, K]
        return {"image": img, "label": np.int32(label),
                "token_value": np.ascontiguousarray(lab[0].transpose(1, 2, 0)),
                "token_idx": np.ascontiguousarray(lab[1].transpose(1, 2, 0)).astype(np.int32)}


class SyntheticTokenLabelDataset(Dataset):
    """Deterministic synthetic twin for golden CI: fake images + fake
    top-K token-label maps with the image class always in the top-K."""

    def __init__(self, size: int = 256, image_size: int = 32, grid_size: int = 4,
                 num_classes: int = 10, topk: int = 3, transform=None):
        self.size = size
        self.image_size = image_size
        self.grid = grid_size
        self.num_classes = num_classes
        self.topk = topk
        self.post = build_transform(transform or
                                    [{"NormalizeImage": {"scale": 0.00392157}}])

    def __len__(self):
        return self.size

    def __getitem__(self, idx):
        rs = np.random.RandomState(idx % 4096)
        img = rs.randint(0, 256, (self.image_size, self.image_size, 3), np.uint8)
        label = idx % self.num_classes
        g, k = self.grid, self.topk
        vals = rs.rand(g, g, k).astype(np.float32)
        vals /= vals.sum(-1, keepdims=True)
        idxs = rs.randint(0, self.num_classes, (g, g, k)).astype(np.int32)
        idxs[..., 0] = label  # ground-truth class always present
        return {"image": self.post(img), "label": np.int32(label),
                "token_value": vals, "token_idx": idxs}

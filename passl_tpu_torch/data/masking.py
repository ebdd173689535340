# Copied from passl_tpu/data/masking.py; the port keeps its own copy and imports nothing of passl_tpu.
# Unchanged: its imports are relative, so they reach the port's own `transforms` copy.
"""Host-side mask generators for masked-image-modeling.

Capability parity with reference `passl_v110/datasets/preprocess/
masking_generator.py`: `MaskingGenerator:27` (BEiT block-wise masking
with min/max block size and aspect jitter) and
`RandomMaskingGenerator:91` (uniform random, MAE-style), plus the
BEiT dual-view dataset wrapper (`passl_v110/datasets/beitdataset.py`).
"""
from __future__ import annotations

import math
import random
from typing import Optional, Tuple

import numpy as np


class MaskingGenerator:
    """BEiT block-wise masking."""

    def __init__(
        self,
        input_size: int = 14,
        num_masking_patches: int = 75,
        min_num_patches: int = 16,
        max_num_patches: Optional[int] = None,
        min_aspect: float = 0.3,
        max_aspect: Optional[float] = None,
    ):
        self.height = self.width = input_size if isinstance(input_size, int) else None
        if not isinstance(input_size, int):
            self.height, self.width = input_size
        self.num_patches = self.height * self.width
        self.num_masking_patches = num_masking_patches
        self.min_num_patches = min_num_patches
        self.max_num_patches = num_masking_patches if max_num_patches is None else max_num_patches
        max_aspect = max_aspect or 1 / min_aspect
        self.log_aspect_ratio = (math.log(min_aspect), math.log(max_aspect))

    def _mask_block(self, mask: np.ndarray, max_mask_patches: int) -> int:
        delta = 0
        for _ in range(10):
            target_area = random.uniform(self.min_num_patches, max_mask_patches)
            aspect = math.exp(random.uniform(*self.log_aspect_ratio))
            h = int(round(math.sqrt(target_area * aspect)))
            w = int(round(math.sqrt(target_area / aspect)))
            if w < self.width and h < self.height:
                top = random.randint(0, self.height - h)
                left = random.randint(0, self.width - w)
                num_masked = mask[top : top + h, left : left + w].sum()
                if 0 < h * w - num_masked <= max_mask_patches:
                    mask[top : top + h, left : left + w] = 1
                    delta = h * w - num_masked
            if delta > 0:
                break
        return delta

    def __call__(self) -> np.ndarray:
        mask = np.zeros((self.height, self.width), np.int32)
        mask_count = 0
        while mask_count < self.num_masking_patches:
            max_mask_patches = min(self.num_masking_patches - mask_count, self.max_num_patches)
            delta = self._mask_block(mask, max_mask_patches)
            if delta == 0:
                break
            mask_count += delta
        return mask.reshape(-1)


class RandomMaskingGenerator:
    """Uniform random masking (reference :91, MAE-style host masks)."""

    def __init__(self, input_size: int = 14, mask_ratio: float = 0.75):
        self.num_patches = input_size * input_size
        self.num_mask = int(mask_ratio * self.num_patches)

    def __call__(self) -> np.ndarray:
        mask = np.hstack([
            np.zeros(self.num_patches - self.num_mask, np.int32),
            np.ones(self.num_mask, np.int32),
        ])
        np.random.shuffle(mask)
        return mask


class BEiTTwoViewsWithMask:
    """Transform: image → (model_view, tokenizer_view, bool_mask).

    Mirrors reference beitdataset.py: a shared geometric aug, then
    separate photometric/normalization pipelines for the patch view and
    the dVAE tokenizer view, plus a block mask."""

    def __init__(self, common_transform=None, patch_transform=None,
                 visual_token_transform=None, masking: Optional[dict] = None):
        from .transforms import build_transform

        self.common = build_transform(common_transform)
        self.patch = build_transform(patch_transform)
        self.token = build_transform(visual_token_transform)
        self.mask_gen = MaskingGenerator(**(masking or {}))

    def __call__(self, img):
        img = self.common(img)
        return self.patch(img), self.token(img), self.mask_gen()


from .transforms import TRANSFORMS  # noqa: E402

TRANSFORMS["BEiTTwoViewsWithMask"] = BEiTTwoViewsWithMask
TRANSFORMS["MaskingGenerator"] = MaskingGenerator
TRANSFORMS["RandomMaskingGenerator"] = RandomMaskingGenerator

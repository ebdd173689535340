"""Global-norm gradient clipping (counterpart of `passl_tpu/core/grad_clip.py`).

`ClipGradByGlobalNorm` takes the L2 norm over the gradients of every
parameter whose name matches no `no_clip_list` pattern, scales those
gradients by `min(1, clip_to / (norm + eps))` in place (the excluded ones
too when `always_clip`), with `clip_to = min(clip_norm, clip_norm_max)`, and
returns the pre-clip norm.
"""
from __future__ import annotations

import re
from typing import Mapping, Optional, Sequence

import torch


class ClipGradByGlobalNorm:
    def __init__(self, clip_norm: float, no_clip_list: Optional[Sequence[str]] = None,
                 always_clip: bool = False, clip_norm_max: Optional[float] = None,
                 eps: float = 1e-6):
        self.clip_norm = float(clip_norm)
        self.no_clip_list = list(no_clip_list or [])
        self.always_clip = always_clip
        self.clip_norm_max = clip_norm_max
        self.eps = eps

    def _excluded(self, name: str) -> bool:
        return any(re.search(p, name) for p in self.no_clip_list)

    def __call__(self, grads: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """grads: parameter name -> gradient, clipped in place; returns the
        f32 norm of the included gradients (0 when none is included)."""
        included = [g for name, g in grads.items() if not self._excluded(name)]
        if not included:
            return torch.zeros((), dtype=torch.float32)
        norms = torch._foreach_norm([g.float() for g in included])
        norm = torch.linalg.vector_norm(torch.stack(norms))
        clip_to = self.clip_norm
        if self.clip_norm_max is not None:
            clip_to = min(self.clip_norm, self.clip_norm_max)
        scale = torch.clamp(clip_to / (norm + self.eps), max=1.0)
        scaled = [g for name, g in grads.items() if self.always_clip or not self._excluded(name)]
        torch._foreach_mul_(scaled, scale.to(scaled[0].dtype))
        return norm

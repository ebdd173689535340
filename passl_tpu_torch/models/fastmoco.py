"""Fast-MoCo: combinatorial-patch contrastive learning (counterpart of
`passl_tpu/models/fastmoco.py:35-110`).

Each view [N, H, W, C] is split into an s x s grid of patches in row-major
order (`split_patches`), every patch goes through the `online` tower
(backbone and projector neck) on its own, and the embeddings of every
r-subset of a view's s^2 patches are averaged (`combine_embeddings`: the
{0, 1/r} selection matrix over `itertools.combinations(range(s^2), r)`, in
f32) into C(s^2, r) queries per image, which the `predictor` takes at the
model's compute dtype. The `target` tower (the online tower's structure,
following it by an EMA with the cosine schedule from `base_momentum`; the
optimizer leaves it alone) embeds the whole other view under
`torch.no_grad()` in the model's mode. The loss is, for both view orders,
the cross-entropy of each query's cosine logits over the batch's keys / T
against its own image's key (the labels `arange(N)` each repeated C(s^2, r)
times, as `jnp.repeat`), times 2 T, in f32; `acc1` is the share of view 1's
queries whose most similar view-2 key is their image's. Module names follow
the flax model's (`online`, `target`, `predictor`).
"""
from __future__ import annotations

import itertools
from typing import Any, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..core.amp import at_least_f32, resolve_dtype
from ..nn.norm import l2_normalize
from .base import register_model, two_views
from .builder import Encoder, build_submodule

DtypeLike = Union[str, torch.dtype]


def split_patches(x: torch.Tensor, s: int) -> torch.Tensor:
    """[N, H, W, C] -> [N s^2, H/s, W/s, C], image-major, the patches of an image
    in row-major order."""
    n, h, w, c = x.shape
    x = x.reshape(n, s, h // s, s, w // s, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n * s * s, h // s, w // s, c)


def combine_embeddings(z: torch.Tensor, s2: int, r: int) -> torch.Tensor:
    """z [N s^2, D] patch embeddings -> [N C(s^2, r), D], the mean of every
    r-subset of an image's patches as one product with the {0, 1/r} selection
    matrix, in z's dtype."""
    combos = list(itertools.combinations(range(s2), r))
    sel = torch.zeros(len(combos), s2, dtype=z.dtype, device=z.device)
    for i, cmb in enumerate(combos):
        sel[i, list(cmb)] = 1.0 / r
    n = z.shape[0] // s2
    return torch.einsum("ks,nsd->nkd", sel, z.reshape(n, s2, -1)).reshape(n * len(combos), -1)


def query_labels(n: int, k_per: int, device=None) -> torch.Tensor:
    """The key each of the N k_per queries belongs to: arange(N), each repeated
    k_per times (`jnp.repeat`; `.repeat` would tile them and pair each query
    with another image's key)."""
    return torch.arange(n, device=device).repeat_interleave(k_per)


@register_model
class FastMoCo(nn.Module):
    """batch (view1, view2) [N, H, W, C] -> {"loss", "acc1"}, scalars in f32."""

    def __init__(self, backbone: Any = None, neck: Any = None, predictor: Any = None,
                 divide: int = 2, combine_r: int = 2, T: float = 1.0,
                 base_momentum: float = 0.99, dtype: DtypeLike = torch.float32):
        super().__init__()
        dtype = resolve_dtype(dtype)
        self.divide, self.combine_r, self.T = divide, combine_r, T
        self.base_momentum = base_momentum
        self.compute_dtype = dtype
        self.online = Encoder(backbone, neck, dtype)
        self.target = Encoder(backbone, neck, dtype)
        self.predictor = build_submodule(predictor, dtype=dtype,
                                         in_channels=self.online.neck.out_channels)

    def ema_map(self) -> list:
        return [("online", "target", {"momentum": self.base_momentum, "schedule": "cosine"})]

    @staticmethod
    def frozen_patterns() -> list:
        return [r"^target\."]

    def _queries(self, view: torch.Tensor) -> torch.Tensor:
        z = self.online(split_patches(view, self.divide))  # [N s^2, D]
        combos = combine_embeddings(at_least_f32(z), self.divide ** 2, self.combine_r)
        return self.predictor(combos.to(self.compute_dtype))  # [N C(s^2, r), D]

    def _ctr(self, q: torch.Tensor, k: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        q = l2_normalize(at_least_f32(q), dim=1)
        k = l2_normalize(at_least_f32(k), dim=1)
        logp = F.log_softmax(q @ k.T / self.T, dim=-1)  # [N C, N]
        loss = -torch.mean(torch.gather(logp, 1, labels[:, None]))
        return loss * 2 * self.T

    def forward(self, batch, generator: Optional[torch.Generator] = None) -> dict:
        v1, v2 = two_views(batch)
        n = v1.shape[0]
        q1 = self._queries(v1)
        q2 = self._queries(v2)
        with torch.no_grad():
            k1 = self.target(v1)
            k2 = self.target(v2)
        labels = query_labels(n, q1.shape[0] // n, q1.device)
        loss = self._ctr(q1, k2, labels) + self._ctr(q2, k1, labels)
        with torch.no_grad():
            sim = l2_normalize(at_least_f32(q1), dim=1) @ l2_normalize(at_least_f32(k2), dim=1).T
            acc1 = torch.mean((torch.argmax(sim, dim=1) == labels).float())
        return {"loss": loss, "acc1": acc1}

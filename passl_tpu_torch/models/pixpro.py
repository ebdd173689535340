"""PixPro and MoCo-BYOL (counterpart of `passl_tpu/models/pixpro.py:26-190`).

**PixPro** (`:26-130`): pixel-level propagation contrast. `encoder` and
`encoder_k` are each a backbone (the NHWC map) and an `MLP2d` neck; the key
tower follows the online one by an EMA with the cosine schedule from
`pixpro_momentum` (`ema_map`), and the optimizer leaves it alone
(`frozen_patterns`). `propagation` (`PixelPropagation`, one module for both
views) turns each online map into y_i = sum_j relu(cos(x_i, x_j))^p g(x_j),
g being `transform_layers` 1x1 convs c -> c with bias, the similarities and
the product in f32. Both key passes run under `torch.no_grad()` in the
model's mode, after both online passes, as in JAX. The batch is the dict
{view1, view2, coord1, coord2} of `PixProTwoViewsTransform` (or the four as
a tuple): each crop's box (x1, y1, x2, y2) in source-image space, with
x1 > x2 where the crop was flipped (a negative box width mirrors the cell
grid; the loss takes it as it is). The loss is
`pixpro_regression_loss(y1, k2, c1, c2) + pixpro_regression_loss(y2, k1, c2, c1)`.

**MoCo-BYOL** (`:133-190`): BYOL's regression beside MoCo's InfoNCE over a
queue. An `online` tower (backbone and projector neck) with a `predictor`,
and a `target` tower of the same structure that follows the online tower by
an EMA with the cosine schedule from `m`, applied by the train step after
the optimizer step (`ema_map`); the optimizer leaves the target alone
(`frozen_patterns`). The target's forward runs under `torch.no_grad()` in
the model's mode, as BYOL's does. There is no shuffle-BN.

The loss is `byol_weight` times half BYOL's symmetric regression sum,
0.5 (byol_regression_loss(p1, t2) + byol_regression_loss(p2, t1)), plus
`contrast_weight` times the InfoNCE of q = l2(p1) against k = l2(t2) and
the queue, one direction only, all in f32. The queue `[dim, K]` and its
pointer are buffers (JAX's `ssl` collection), started and written as
MoCo's are (`moco.init_queue`, `moco.enqueue`: the clamped write of
`dynamic_update_slice`), after the loss and in training only.
"""
from __future__ import annotations

from typing import Any, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..core.amp import at_least_f32, resolve_dtype
from ..nn.layers import Conv1x1
from ..nn.norm import l2_normalize
from .base import register_model, two_views
from .builder import Encoder, build_submodule
from .byol import byol_regression_loss
from .moco import enqueue, info_nce_logits, init_queue

DtypeLike = Union[str, torch.dtype]


def cell_distances(coord_q: torch.Tensor, coord_k: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """coord [N, 4] crop boxes (x1, y1, x2, y2) in source-image space -> [N, hw, hw]
    distances between the centres of q's and k's h x w cells, ((x + 0.5) box
    width / w + x1, likewise y), over the larger box diagonal (at least
    1e-6); in f32, as JAX takes the boxes, without gradient. A flipped crop's
    x1 > x2 gives a negative width, which mirrors its cell grid."""
    f32 = dict(dtype=torch.float32, device=coord_q.device)
    with torch.no_grad():
        x_arr = torch.arange(w, **f32)[None, None, :].expand(1, h, w)
        y_arr = torch.arange(h, **f32)[None, :, None].expand(1, h, w)
        coord_q, coord_k = coord_q.to(**f32), coord_k.to(**f32)
        q_bw = ((coord_q[:, 2] - coord_q[:, 0]) / w)[:, None, None]
        q_bh = ((coord_q[:, 3] - coord_q[:, 1]) / h)[:, None, None]
        k_bw = ((coord_k[:, 2] - coord_k[:, 0]) / w)[:, None, None]
        k_bh = ((coord_k[:, 3] - coord_k[:, 1]) / h)[:, None, None]
        q_sx, q_sy = coord_q[:, 0][:, None, None], coord_q[:, 1][:, None, None]
        k_sx, k_sy = coord_k[:, 0][:, None, None], coord_k[:, 1][:, None, None]
        max_diag = torch.maximum(torch.sqrt(q_bw ** 2 + q_bh ** 2),
                                 torch.sqrt(k_bw ** 2 + k_bh ** 2))
        cqx = (x_arr + 0.5) * q_bw + q_sx
        cqy = (y_arr + 0.5) * q_bh + q_sy
        ckx = (x_arr + 0.5) * k_bw + k_sx
        cky = (y_arr + 0.5) * k_bh + k_sy
        n = coord_q.shape[0]
        return torch.sqrt(
            (cqx.reshape(n, h * w, 1) - ckx.reshape(n, 1, h * w)) ** 2
            + (cqy.reshape(n, h * w, 1) - cky.reshape(n, 1, h * w)) ** 2
        ) / torch.clamp(max_diag.reshape(n, 1, 1), min=1e-6)


def pixpro_regression_loss(q: torch.Tensor, k: torch.Tensor, coord_q: torch.Tensor,
                           coord_k: torch.Tensor, pos_ratio: float = 0.7) -> torch.Tensor:
    """q, k [N, H, W, C] projections, coord [N, 4] crop boxes -> -2 times the
    mean over images of each image's mean cosine over its positive cell
    pairs, those whose `cell_distances` lie below `pos_ratio` (the mask
    without gradient). The cosines in f32 (f64 for f64 inputs), the
    distances in f32."""
    n, h, w, c = q.shape
    qf = l2_normalize(at_least_f32(q).reshape(n, h * w, c), dim=-1)
    kf = l2_normalize(at_least_f32(k).reshape(n, h * w, c), dim=-1)
    pos_mask = (cell_distances(coord_q, coord_k, h, w) < pos_ratio).to(qf.dtype)
    logit = torch.einsum("nsc,ntc->nst", qf, kf)
    loss = torch.sum(logit * pos_mask, dim=(1, 2)) / (torch.sum(pos_mask, dim=(1, 2)) + 1e-6)
    return -2.0 * torch.mean(loss)


class PixelPropagation(nn.Module):
    """x [N, H, W, C] -> y_i = sum_j relu(cos(x_i, x_j))^p g(x_j), in f32 (f64 for
    f64 inputs); g is `transform_layers` 1x1 convs c -> c with bias at `dtype`
    (flax names `transform_{i}`: the ModuleList `transform`)."""

    def __init__(self, channels: int, p: float = 2.0, transform_layers: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.p = p
        self.transform = nn.ModuleList(Conv1x1(channels, channels, dtype)
                                       for _ in range(transform_layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, h, w, c = x.shape
        xn = l2_normalize(at_least_f32(x), dim=-1).reshape(n, h * w, c)
        sim = torch.clamp(torch.einsum("nsc,ntc->nst", xn, xn), min=0.0) ** self.p
        g = x.reshape(n, h * w, c)
        for t in self.transform:
            g = t(g)
        y = torch.einsum("nst,ntc->nsc", sim, at_least_f32(g))
        return y.reshape(n, h, w, c)


@register_model
class PixPro(nn.Module):
    """batch {view1, view2, coord1, coord2} (views [N, H, W, C], boxes [N, 4])
    -> {"loss": scalar f32}."""

    def __init__(self, backbone: Any = None, neck: Any = None, pixpro_p: float = 2.0,
                 pixpro_momentum: float = 0.99, pixpro_pos_ratio: float = 0.7,
                 pixpro_transform_layer: int = 1, dtype: DtypeLike = torch.float32):
        super().__init__()
        dtype = resolve_dtype(dtype)
        self.pixpro_momentum, self.pixpro_pos_ratio = pixpro_momentum, pixpro_pos_ratio
        self.encoder = Encoder(backbone, neck, dtype)
        self.encoder_k = Encoder(backbone, neck, dtype)
        self.propagation = PixelPropagation(self.encoder.neck.out_channels, pixpro_p,
                                            pixpro_transform_layer, dtype)

    def ema_map(self) -> list:
        return [("encoder", "encoder_k", {"momentum": self.pixpro_momentum,
                                          "schedule": "cosine"})]

    @staticmethod
    def frozen_patterns() -> list:
        return [r"^encoder_k\."]

    def forward(self, batch, generator: Optional[torch.Generator] = None) -> dict:
        if isinstance(batch, dict):
            v1, v2, c1, c2 = batch["view1"], batch["view2"], batch["coord1"], batch["coord2"]
        else:
            v1, v2, c1, c2 = batch
        y1 = self.propagation(self.encoder(v1))
        y2 = self.propagation(self.encoder(v2))
        with torch.no_grad():
            k1 = self.encoder_k(v1)
            k2 = self.encoder_k(v2)
        r = self.pixpro_pos_ratio
        loss = pixpro_regression_loss(y1, k2, c1, c2, r) + pixpro_regression_loss(y2, k1, c2, c1, r)
        return {"loss": loss}


@register_model
class MoCoBYOL(nn.Module):
    """batch (view1, view2) [N, H, W, C] -> {"loss", "byol_loss", "contrast_loss"},
    scalars in f32."""

    def __init__(self, backbone: Any = None, neck: Any = None, predictor: Any = None,
                 dim: int = 256, K: int = 65536, m: float = 0.999, T: float = 0.2,
                 byol_weight: float = 1.0, contrast_weight: float = 1.0,
                 dtype: DtypeLike = torch.float32):
        super().__init__()
        dtype = resolve_dtype(dtype)
        self.K, self.m, self.T = K, m, T
        self.byol_weight, self.contrast_weight = byol_weight, contrast_weight
        self.online = Encoder(backbone, neck, dtype)
        self.target = Encoder(backbone, neck, dtype)
        self.predictor = build_submodule(predictor, dtype=dtype,
                                         in_channels=self.online.neck.out_channels)
        self.register_buffer("queue", torch.empty(dim, K))
        self.register_buffer("queue_ptr", torch.zeros((), dtype=torch.long))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        init_queue(self.queue, self.queue_ptr, generator)

    def ema_map(self) -> list:
        return [("online", "target", {"momentum": self.m, "schedule": "cosine"})]

    @staticmethod
    def frozen_patterns() -> list:
        return [r"^target\."]

    def forward(self, batch, generator: Optional[torch.Generator] = None) -> dict:
        v1, v2 = two_views(batch)
        p1 = self.predictor(self.online(v1))
        p2 = self.predictor(self.online(v2))
        with torch.no_grad():
            t1 = self.target(v1)
            t2 = self.target(v2)
        byol_loss = 0.5 * (byol_regression_loss(p1, t2) + byol_regression_loss(p2, t1))
        q = l2_normalize(at_least_f32(p1), dim=1)
        k = l2_normalize(at_least_f32(t2), dim=1)
        # a copy: the enqueue below writes the buffer before the backward reads it
        logits = info_nce_logits(q, k, self.queue.to(q.dtype, copy=True), self.T)
        contrast_loss = -torch.mean(F.log_softmax(logits, dim=-1)[:, 0])
        if self.training:
            enqueue(self.queue, self.queue_ptr, k)
        loss = self.byol_weight * byol_loss + self.contrast_weight * contrast_loss
        return {"loss": loss, "byol_loss": byol_loss, "contrast_loss": contrast_loss}

"""DenseCL: dense contrastive learning (counterpart of
`passl_tpu/models/densecl.py:24-118`).

MoCo's momentum encoders with two queues. `encoder_q` and `encoder_k` are
each a backbone and a `DenseCLNeck`, and return the neck's global
projection g, its dense grid [N, S, C], the grid's mean (unused by the loss,
as in JAX `:65`, `:73`) and the backbone's map flattened to [N, HW, C]. The
key encoder follows the query encoder by an EMA of constant momentum `m`
(`ema_map`), and the optimizer leaves it alone (`frozen_patterns`).

In training the key batch takes MoCo's shuffle-BN (`moco.shuffle_permutation`
from the train step's generator; the key encoder runs under `no_grad` in
the model's mode, as JAX's always runs with `train=True` in training) and
is put back in order by `argsort(perm)`. Everything below is in f32 (f64 for
an f64 model): queries, keys, grids and backbone features l2-normalized;
each query cell's positive is the key grid cell whose **backbone** feature
is most similar (`argmax q_b . k_b`, `:82-85`); the global loss is MoCo's
InfoNCE over `queue`, the dense one the cross-entropy on column 0 of
[q_grid . k_grid_matched, q_grid . queue2] / T with the negatives' logits
taking no gradient (`:102`); the loss is (1 - lambda) single + lambda
dense (`:106`), and `acc1` comes from the global logits. Then, in training
only, `queue` takes the keys and `queue2` the l2-normalized mean over S of
the normalized grid keys (`:112`), both at the same clamped start of the
one pointer (`:91`, `:113-115`; `moco.enqueue_pairs`), which advances once.
"""
from __future__ import annotations

from typing import Any, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..core.amp import at_least_f32, resolve_dtype
from ..nn.norm import l2_normalize
from . import moco
from .base import register_model, two_views
from .builder import Encoder

DtypeLike = Union[str, torch.dtype]


class _DenseEncoder(Encoder):
    """A backbone (with_pool=False: the NHWC map) and a `DenseCLNeck` ->
    (g, grid, avg_grid, the backbone's map [N, HW, C])."""

    def forward(self, x: torch.Tensor) -> tuple:
        feats = self.backbone(x)
        g, grid, avg_grid = self.neck(feats)
        n, h, w, c = feats.shape
        return g, grid, avg_grid, feats.reshape(n, h * w, c)


def match_positives(q_b: torch.Tensor, k_b: torch.Tensor, k_grid: torch.Tensor) -> tuple:
    """Each query cell's positive (JAX `:82-85`): q_b, k_b [N, S, C] normalized
    backbone features, k_grid [N, S, D] -> (ind [N, S], the argmax over the key
    cells of q_b . k_b, the first on a tie; k_grid's rows at ind)."""
    ind = torch.argmax(torch.einsum("nsc,ntc->nst", q_b, k_b), dim=2)
    return ind, torch.gather(k_grid, 1, ind[:, :, None].expand(-1, -1, k_grid.shape[-1]))


def dense_info_nce(q_grid: torch.Tensor, k_matched: torch.Tensor, queue2: torch.Tensor,
                   temperature: float) -> torch.Tensor:
    """The dense loss (JAX `:99-104`): the cross-entropy on column 0 of
    [q_grid . k_matched, q_grid . queue2] / T over the N S cells, the
    negatives' logits without gradient (`stop_gradient`, `:102`), so the
    queries take gradient through their positives only. Computed as JAX
    writes it, in q_grid's dtype: the logits [N S, 1 + K] are 3.3 GB at
    DenseCL-R50's 256 images and K 65,536, and `queue2` is read before the
    enqueue writes it."""
    n, s, c = q_grid.shape
    l_pos = torch.sum(q_grid * k_matched, dim=-1).reshape(n * s, 1)
    with torch.no_grad():
        l_neg = q_grid.reshape(n * s, c) @ queue2.to(q_grid.dtype)
    logits = torch.cat([l_pos, l_neg], dim=1) / temperature
    del l_neg
    return -torch.mean(F.log_softmax(logits, dim=-1)[:, 0])


@register_model
class DenseCL(nn.Module):
    """batch (view1, view2) [N, H, W, C] -> {"loss", "loss_single", "loss_dense",
    "acc1"}, scalars in f32."""

    def __init__(self, backbone: Any = None, neck: Any = None, dim: int = 128, K: int = 65536,
                 m: float = 0.999, T: float = 0.2, loss_lambda: float = 0.5,
                 dtype: DtypeLike = torch.float32):
        super().__init__()
        dtype = resolve_dtype(dtype)
        self.K, self.m, self.T, self.loss_lambda = K, m, T, loss_lambda
        self.encoder_q = _DenseEncoder(backbone, neck, dtype)
        self.encoder_k = _DenseEncoder(backbone, neck, dtype)
        self.register_buffer("queue", torch.empty(dim, K))
        self.register_buffer("queue2", torch.empty(dim, K))
        self.register_buffer("queue_ptr", torch.zeros((), dtype=torch.long))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        moco.init_queue(self.queue, self.queue_ptr, generator)
        moco.init_queue(self.queue2, self.queue_ptr, generator)

    def ema_map(self) -> list:
        return [("encoder_q", "encoder_k", {"momentum": self.m})]

    @staticmethod
    def frozen_patterns() -> list:
        return [r"^encoder_k\."]

    def forward(self, batch, generator: Optional[torch.Generator] = None) -> dict:
        img_q, img_k = two_views(batch)
        n = img_q.shape[0]
        q, q_grid, _, q_b = self.encoder_q(img_q)
        q = l2_normalize(at_least_f32(q), dim=1)
        q_grid = l2_normalize(at_least_f32(q_grid), dim=-1)  # [N, S, C]
        with torch.no_grad():
            q_b = l2_normalize(at_least_f32(q_b), dim=-1)  # only the argmax reads it
            if self.training:
                if generator is None:
                    raise ValueError("DenseCL's shuffle-BN needs the train state's generator")
                perm = moco.shuffle_permutation(n, generator, img_k.device)
                inv = torch.argsort(perm)
                k, k_grid, _, k_b = (t[inv] for t in self.encoder_k(img_k[perm]))
            else:
                k, k_grid, _, k_b = self.encoder_k(img_k)
            k = l2_normalize(at_least_f32(k), dim=1)
            k_grid = l2_normalize(at_least_f32(k_grid), dim=-1)
            k_b = l2_normalize(at_least_f32(k_b), dim=-1)
            k_grid_matched = match_positives(q_b, k_b, k_grid)[1]

        # global InfoNCE over queue (a copy: the enqueue below writes the
        # buffer before the backward reads it)
        logits = moco.info_nce_logits(q, k, self.queue.to(q.dtype, copy=True), self.T)
        loss_single = -torch.mean(F.log_softmax(logits, dim=-1)[:, 0])

        loss_dense = dense_info_nce(q_grid, k_grid_matched, self.queue2, self.T)
        loss = loss_single * (1 - self.loss_lambda) + loss_dense * self.loss_lambda
        acc1 = torch.mean((torch.argmax(logits, dim=-1) == 0).float())
        if self.training:
            k2 = l2_normalize(torch.mean(k_grid, dim=1), dim=-1)
            moco.enqueue_pairs(self.queue_ptr, [(self.queue, k), (self.queue2, k2)])
        return {"loss": loss, "loss_single": loss_single, "loss_dense": loss_dense, "acc1": acc1}

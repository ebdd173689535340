"""MoCo v1/v2: momentum contrast with a queue of negatives (counterpart of
`passl_tpu/models/moco.py:34-119`).

`encoder_q` and `encoder_k` are each a backbone and a neck. The key encoder
follows the query encoder by an EMA of constant momentum `m` that the train
step applies after the optimizer step (`ema_map`), and the optimizer leaves
it alone (`frozen_patterns`). The queue `[dim, K]` of past keys and its
pointer are buffers (JAX's `ssl` collection): the queue starts as an
l2-normalized normal drawn from the init generator, and checkpoints carry
both through the `state_dict`.

In training, shuffle-BN: the key batch is permuted (`shuffle_permutation`,
from the `generator` the train step hands the model), run through the key
encoder, and put back in order, so that with `bn_splits` on the backbone
each split's BatchNorm statistics come from other images than the
queries'. Keys and queries are l2-normalized in f32, and keys take no
gradient. The loss is InfoNCE, the cross-entropy on column 0 of
[q.k, q.queue] / T; the model returns it with `acc1`. Then the keys are
written into the queue at the pointer, as JAX's `dynamic_update_slice`
writes them: where ptr + N > K the start is clamped to K - N. The pointer
advances by N mod K. In eval there is no shuffle and no enqueue.

MoCo v1 and v2 differ only in their configs (v2: the MLP neck and the
blur augmentation); `MoCoV2` is an alias.
"""
from __future__ import annotations

from typing import Any, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..core.amp import at_least_f32, resolve_dtype
from ..nn.norm import l2_normalize
from .base import register_model, two_views
from .builder import Encoder

DtypeLike = Union[str, torch.dtype]


def info_nce_logits(q: torch.Tensor, k: torch.Tensor, queue: torch.Tensor,
                    temperature: float) -> torch.Tensor:
    """l_pos [N, 1] beside l_neg [N, K], over the temperature."""
    l_pos = torch.einsum("nc,nc->n", q, k)[:, None]
    l_neg = torch.einsum("nc,ck->nk", q, queue)
    return torch.cat([l_pos, l_neg], dim=1) / temperature


def init_queue(queue: torch.Tensor, queue_ptr: torch.Tensor,
               generator: Optional[torch.Generator] = None) -> None:
    """A queue of keys [dim, K] as l2-normalized normal columns, the pointer at 0."""
    with torch.no_grad():
        queue.normal_(generator=generator)
        queue.copy_(l2_normalize(queue, dim=0))
        queue_ptr.zero_()


@torch.no_grad()
def enqueue(queue: torch.Tensor, queue_ptr: torch.Tensor, k: torch.Tensor) -> None:
    """Write the keys k [N, dim] into the queue's columns at the pointer, as
    JAX's `dynamic_update_slice` writes them (the start clamped to K - N),
    and advance the pointer by N mod K."""
    enqueue_pairs(queue_ptr, [(queue, k)])


@torch.no_grad()
def enqueue_pairs(queue_ptr: torch.Tensor, pairs) -> None:
    """`enqueue` for queues [dim, K] of one length that share one pointer
    (DenseCL's two): each (queue, keys [N, dim]) pair is written at the same
    clamped start, then the pointer advances once, by N mod K."""
    n, size = pairs[0][1].shape[0], pairs[0][0].shape[1]
    if n > size:
        raise ValueError(f"a batch of {n} keys does not fit a queue of K={size}")
    if any(k.shape[0] != n or queue.shape[1] != size for queue, k in pairs):
        raise ValueError("queues sharing a pointer need one length K and one batch N")
    start = torch.clamp(queue_ptr, max=size - n)
    cols = start + torch.arange(n, device=queue_ptr.device)
    for queue, k in pairs:
        queue.index_copy_(1, cols, k.T.to(queue.dtype))
    queue_ptr.copy_((queue_ptr + n) % size)


def shuffle_permutation(n: int, generator: torch.Generator, device: torch.device) -> torch.Tensor:
    """The shuffle-BN permutation of a key batch of n images."""
    return torch.randperm(n, generator=generator, device=device)


@register_model
class MoCo(nn.Module):
    """batch (view1, view2) [N, H, W, C] -> {"loss", "acc1"}, scalars in f32."""

    def __init__(self, backbone: Any = None, neck: Any = None, dim: int = 128, K: int = 65536,
                 m: float = 0.999, T: float = 0.07, dtype: DtypeLike = torch.float32):
        super().__init__()
        dtype = resolve_dtype(dtype)
        self.K, self.m, self.T = K, m, T
        self.encoder_q = Encoder(backbone, neck, dtype)
        self.encoder_k = Encoder(backbone, neck, dtype)
        self.register_buffer("queue", torch.empty(dim, K))
        self.register_buffer("queue_ptr", torch.zeros((), dtype=torch.long))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        init_queue(self.queue, self.queue_ptr, generator)

    def ema_map(self) -> list:
        return [("encoder_q", "encoder_k", {"momentum": self.m})]

    @staticmethod
    def frozen_patterns() -> list:
        return [r"^encoder_k\."]

    def forward(self, batch, generator: Optional[torch.Generator] = None) -> dict:
        img_q, img_k = two_views(batch)
        n = img_q.shape[0]
        q = l2_normalize(at_least_f32(self.encoder_q(img_q)), dim=1)
        with torch.no_grad():
            if self.training:
                if generator is None:
                    raise ValueError("MoCo's shuffle-BN needs the train state's generator")
                perm = shuffle_permutation(n, generator, img_k.device)
                k = self.encoder_k(img_k[perm])[torch.argsort(perm)]
            else:
                k = self.encoder_k(img_k)
            k = l2_normalize(at_least_f32(k), dim=1)
        # a copy: the enqueue below writes the buffer before the backward reads it
        logits = info_nce_logits(q, k, self.queue.to(q.dtype, copy=True), self.T)
        logp = F.log_softmax(logits, dim=-1)
        loss = -torch.mean(logp[:, 0])
        acc1 = torch.mean((torch.argmax(logits, dim=-1) == 0).float())
        if self.training:
            enqueue(self.queue, self.queue_ptr, k)
        return {"loss": loss, "acc1": acc1}


@register_model(name="MoCoV2")
class MoCoV2(MoCo):
    """Alias; v2 is the MLP neck and the augmentation recipe (config-level differences)."""

"""CAE: context-autoencoder pretraining and its finetune ViT (counterpart of
`passl_tpu/models/cae.py`).

`CAEPretrain` (JAX `:56-151`): batches of (view, tokenizer view, bool mask
[N, L]) from `BEiTTwoViewsWithMask`. The patch embedding plus the fixed 2-D
sin-cos table (`models/utils/pos_embed.py`, no class token, not a
parameter); each image's patches in visible-first order, the stable sort of
the integer key mask L + position (JAX `:98`): the first L - `num_masked`
are `ids_vis`, the rest `ids_mask`. The mask generator's count is not
checked: where a mask holds fewer than `num_masked` patches (BEiT's block
generator falls short of 98 of 196 in about a third of its draws), the last
visible patches in raster order join `ids_mask`, as in the JAX function.
The encoder (`blocks`, `norm`: the ViT `Block`s with a qkv bias) runs over
the visible patches only; the same encoder over the whole image, under
`torch.no_grad()`, is the teacher of the masked patches' latents. The
regressor: mask queries (`mask_token`, truncated normal 0.02, plus the
masked positions' table entries) cross-attend to the visible latents through
`regressor_depth` `CrossAttentionBlock`s and `regressor_norm`.
`align_loss` is the mean squared error of the regressed latents against the
teacher's, `token_loss` the cross-entropy of `head`'s tokens against the
frozen `tokenizer`'s (a `DiscreteVAE`, as BEiT's, under `torch.no_grad()`,
its grid subsampled to the patch grid) at the masked patches, `acc1` their
accuracy; loss = `token_weight` token_loss + `align_weight` align_loss.
Every attention here is the JAX model's own einsum: no kernel.

`CAEFinetune` (JAX `:154-178`): the same encoder over every patch, the mean
of its tokens and a `head` (truncated normal 0.02); `freeze_encoder` keeps
the optimizer off `^(patch_embed|blocks\\.|norm)`. A deliberate difference:
at `num_classes: 0` (configs/cae/cae_base_lp_in1k.yaml, the probe's
backbone) the port returns the pooled features, as `ConvViT` does; the JAX
model keeps a `Dense(0)` there, whose empty output gives the probe logits
that do not depend on the image (ROADMAP, reference faults).
"""
from __future__ import annotations

import functools
from typing import Any, Optional, Union

import torch
from torch import nn

from ..core.amp import at_least_f32, resolve_dtype
from ..nn import init as tinit
from ..nn.layers import Block, Dense, LayerNorm, Mlp, PatchEmbed
from .base import register_model
from .beit import _pool_targets
from .discrete_vae import DiscreteVAE
from .utils import FixedTable
from .utils.pos_embed import get_2d_sincos_pos_embed

DtypeLike = Union[str, torch.dtype]
_trunc02 = functools.partial(tinit.trunc_normal_, std=0.02)


def _gather_tokens(x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """x [N, L, D], ids [N, K] -> x's rows at ids, [N, K, D]."""
    return torch.gather(x, 1, ids[:, :, None].expand(-1, -1, x.shape[-1]))


class CrossAttentionBlock(nn.Module):
    """Queries attend to keys and values with their own norms (`norm_q`,
    `norm_kv`) and projections (`q`, `k`, `v`, `proj`: flax's default
    lecun-normal Dense), the scores in f32; then a pre-norm MLP."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.compute_dtype = dtype
        self.norm_q = LayerNorm(dim, eps=1e-6, dtype=dtype)
        self.norm_kv = LayerNorm(dim, eps=1e-6, dtype=dtype)
        self.q = Dense(dim, dim, dtype)
        self.k = Dense(dim, dim, dtype)
        self.v = Dense(dim, dim, dtype)
        self.proj = Dense(dim, dim, dtype)
        self.norm2 = LayerNorm(dim, eps=1e-6, dtype=dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype=dtype)

    def forward(self, q_tokens: torch.Tensor, kv_tokens: torch.Tensor) -> torch.Tensor:
        n, lq, c = q_tokens.shape
        h = self.num_heads
        d = c // h
        y = self.norm_q(q_tokens)
        kv = self.norm_kv(kv_tokens)
        q = self.q(y).reshape(n, lq, h, d).transpose(1, 2)
        k = self.k(kv).reshape(n, -1, h, d).transpose(1, 2)
        v = self.v(kv).reshape(n, -1, h, d).transpose(1, 2)
        ct = at_least_f32(q).dtype  # an einsum with preferred_element_type f32
        attn = torch.matmul((q * d ** -0.5).to(ct), k.to(ct).transpose(-1, -2))
        attn = torch.softmax(attn, dim=-1).to(self.compute_dtype)
        out = torch.matmul(attn, v.to(self.compute_dtype)).transpose(1, 2).reshape(n, lq, c)
        x = q_tokens + self.proj(out)
        return x + self.mlp(self.norm2(x))


class _Encoder(nn.Module):
    """The patch embedding, the sin-cos table and the ViT blocks and norm of
    both CAE models (flax names at the model's top level)."""

    def __init__(self, img_size: int, patch_size: int, embed_dim: int, depth: int,
                 num_heads: int, mlp_ratio: float, dtype: DtypeLike):
        super().__init__()
        dtype = resolve_dtype(dtype)
        self.compute_dtype = dtype
        self.embed_dim = embed_dim
        self.patch_embed = PatchEmbed(patch_size, embed_dim, dtype=dtype)
        self.pos_embed = FixedTable(
            get_2d_sincos_pos_embed(embed_dim, img_size // patch_size)[None])
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio, qkv_bias=True, dtype=dtype)
            for _ in range(depth))
        self.norm = LayerNorm(embed_dim, eps=1e-6, dtype=dtype)

    def _embed(self, x: torch.Tensor) -> torch.Tensor:
        """[N, H, W, 3] -> the patch tokens plus the table, [N, L, D]."""
        x = self.patch_embed(x)
        return x + self.pos_embed.on(x.device).to(x.dtype)

    def _encode(self, x: torch.Tensor) -> torch.Tensor:
        for blk in self.blocks:  # no stochastic depth: nothing to draw
            x = blk(x)
        return self.norm(x)


@register_model
class CAEPretrain(_Encoder):
    """(view, tokenizer view, bool mask [N, L]) -> {"loss", "token_loss",
    "align_loss", "acc1"}."""

    def __init__(self, img_size: int = 224, patch_size: int = 16, embed_dim: int = 768,
                 depth: int = 12, num_heads: int = 12, regressor_depth: int = 4,
                 mlp_ratio: float = 4.0, vocab_size: int = 8192, tokenizer: Any = None,
                 align_weight: float = 2.0, token_weight: float = 1.0, num_masked: int = 98,
                 dtype: DtypeLike = torch.float32):
        super().__init__(img_size, patch_size, embed_dim, depth, num_heads, mlp_ratio, dtype)
        dtype = self.compute_dtype
        self.align_weight = align_weight
        self.token_weight = token_weight
        self.num_masked = num_masked
        self.mask_token = nn.Parameter(torch.empty(1, 1, embed_dim))
        self.regressor = nn.ModuleList(CrossAttentionBlock(embed_dim, num_heads, mlp_ratio, dtype)
                                       for _ in range(regressor_depth))
        self.regressor_norm = LayerNorm(embed_dim, eps=1e-6, dtype=dtype)
        self.head = Dense(embed_dim, vocab_size, dtype, kernel_init=_trunc02)
        self.tokenizer = DiscreteVAE(dtype=dtype, with_decoder=False,
                                     **dict(tokenizer or {"vocab_size": vocab_size}))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        _trunc02(self.mask_token, generator=generator)

    @staticmethod
    def frozen_patterns() -> list:
        return [r"^tokenizer\."]

    def split(self, bool_mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """bool mask [N, L] -> (ids_vis [N, L - num_masked], ids_mask [N,
        num_masked]): the patches in the order of the key mask L + position."""
        n, l = bool_mask.shape
        key = bool_mask.to(torch.int64) * l + torch.arange(l, device=bool_mask.device)[None]
        order = torch.argsort(key, dim=1, stable=True)
        return order[:, :l - self.num_masked], order[:, l - self.num_masked:]

    def forward(self, batch, generator: Optional[torch.Generator] = None) -> dict:
        view, tok_view, bool_mask = batch[0], batch[1], batch[2]
        x = self._embed(view)
        n, l, c = x.shape
        ids_vis, ids_mask = self.split(bool_mask)
        x_vis = self._encode(_gather_tokens(x, ids_vis))

        # the teacher: the same encoder over every patch, no gradient (the
        # blocks draw nothing, so train and eval are one function)
        with torch.no_grad():
            t_masked = _gather_tokens(self._encode(x.detach()), ids_mask)

        # the regressor: mask queries cross-attend to the visible latents
        pos = self.pos_embed.on(x.device).to(x.dtype).expand(n, -1, -1)
        q = self.mask_token.to(x.dtype) + _gather_tokens(pos, ids_mask)
        for blk in self.regressor:
            q = blk(q, x_vis)
        q = self.regressor_norm(q)
        at = at_least_f32(q).dtype
        align_loss = torch.mean(torch.square(q.to(at) - t_masked.to(at)))

        logits = self.head(q)
        with torch.no_grad():
            target = _pool_targets(self.tokenizer.tokenize(tok_view), l)
        target = torch.gather(target, 1, ids_mask)
        logp = torch.log_softmax(at_least_f32(logits), dim=-1)
        token_loss = -torch.mean(torch.gather(logp, -1, target[:, :, None]))
        acc = torch.mean((torch.argmax(logits, dim=-1) == target).to(logp.dtype))
        loss = self.token_weight * token_loss + self.align_weight * align_loss
        return {"loss": loss, "token_loss": token_loss, "align_loss": align_loss, "acc1": acc}


@register_model
class CAEFinetune(_Encoder):
    """images [N, H, W, 3] -> logits [N, num_classes], or at num_classes 0 the
    pooled features [N, embed_dim]."""

    def __init__(self, img_size: int = 224, patch_size: int = 16, embed_dim: int = 768,
                 depth: int = 12, num_heads: int = 12, mlp_ratio: float = 4.0,
                 num_classes: int = 1000, global_pool: bool = True, freeze_encoder: bool = False,
                 dtype: DtypeLike = torch.float32):
        super().__init__(img_size, patch_size, embed_dim, depth, num_heads, mlp_ratio, dtype)
        self.freeze_encoder = freeze_encoder
        self.head = (Dense(embed_dim, num_classes, self.compute_dtype, kernel_init=_trunc02)
                     if num_classes > 0 else None)
        self.out_channels = num_classes if num_classes > 0 else embed_dim

    def frozen_patterns(self) -> list:
        return [r"^(patch_embed|blocks\.|norm)"] if self.freeze_encoder else []

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        feats = self._encode(self._embed(x)).mean(dim=1)
        return self.head(feats) if self.head is not None else feats

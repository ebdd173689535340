"""DeiT (counterpart of `passl_tpu/models/deit.py`).

The plain DeiT names are ViTs (`VisionTransformer`, the DeiT recipe lies in
the data). `DistilledVisionTransformer` (JAX `:23-69`) adds a distillation
token beside the class token (both trunc-normal 0.02, f32), a position
embedding of P + 2 (trunc-normal 0.02) and a second head `head_dist` over
token 1 (`head` over token 0, both trunc-normal 0.02 with zero bias); its
logits are the mean of the two heads' in training and in eval alike, as in
the JAX model. Blocks, precision and `attn_impl` are the ViT's, so the flash
kernels see P + 2 tokens (198 at 224). Parameter names follow the flax
model's. Dropout (`drop_rate`, `attn_drop_rate`) is refused, as in the ViT.
"""
from __future__ import annotations

import functools
from typing import Optional, Union

import numpy as np
import torch
from torch import nn

from ..core.amp import resolve_dtype
from ..nn import init as tinit
from ..nn.layers import Block, Dense, LayerNorm, PatchEmbed
from .base import MODELS, register_model
from .vision_transformer import VisionTransformer

DtypeLike = Union[str, torch.dtype]
_trunc02 = functools.partial(tinit.trunc_normal_, std=0.02)


@register_model
class DistilledVisionTransformer(nn.Module):
    """images [n, H, W, 3] (NHWC) -> logits [n, num_classes] at `dtype`, the
    mean of the class token's and the distillation token's heads. In training,
    `generator` draws the stochastic-depth masks of every block, in block order."""

    def __init__(self, img_size: int = 224, patch_size: int = 16, embed_dim: int = 768,
                 depth: int = 12, num_heads: int = 12, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, drop_rate: float = 0.0, attn_drop_rate: float = 0.0,
                 drop_path_rate: float = 0.0, num_classes: int = 1000,
                 softmax_dtype: DtypeLike = "float32", attn_impl: str = "einsum",
                 dtype: DtypeLike = torch.float32, in_chans: int = 3):
        super().__init__()
        if drop_rate or attn_drop_rate:
            raise NotImplementedError("DeiT drop_rate / attn_drop_rate > 0 are not ported yet")
        dtype = resolve_dtype(dtype)
        softmax_dtype = resolve_dtype(softmax_dtype)
        self.img_size = img_size
        self.in_chans = in_chans
        self.embed_dim = embed_dim
        self.num_classes = num_classes
        self.patch_embed = PatchEmbed(patch_size, embed_dim, in_chans, dtype=dtype)
        num_patches = (img_size // patch_size) ** 2
        self.cls_token = nn.Parameter(torch.empty(1, 1, embed_dim))
        self.dist_token = nn.Parameter(torch.empty(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.empty(1, num_patches + 2, embed_dim))
        dpr = np.linspace(0, drop_path_rate, depth)
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio, qkv_bias, drop_path=float(dpr[i]), dtype=dtype,
                  softmax_dtype=softmax_dtype, attn_impl=attn_impl)
            for i in range(depth))
        self.norm = LayerNorm(embed_dim, eps=1e-6, dtype=dtype)
        self.head = Dense(embed_dim, num_classes, dtype=dtype, kernel_init=_trunc02)
        self.head_dist = Dense(embed_dim, num_classes, dtype=dtype, kernel_init=_trunc02)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for t in (self.cls_token, self.dist_token, self.pos_embed):
            _trunc02(t, generator=generator)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        n = x.shape[0]
        x = self.patch_embed(x)
        cls = self.cls_token.to(x.dtype).expand(n, -1, -1)
        dist = self.dist_token.to(x.dtype).expand(n, -1, -1)
        x = torch.cat([cls, dist, x], dim=1) + self.pos_embed.to(x.dtype)
        for blk in self.blocks:
            x = blk(x, generator)
        # LayerNorm is per token: norming tokens 0 and 1 alone equals the JAX
        # model's norm over every token followed by taking them
        x = self.norm(x[:, :2])
        return (self.head(x[:, 0]) + self.head_dist(x[:, 1])) / 2


_DEIT = {
    "DeiT_tiny_patch16_224": ("vit", dict(patch_size=16, embed_dim=192, depth=12, num_heads=3)),
    "DeiT_small_patch16_224": ("vit", dict(patch_size=16, embed_dim=384, depth=12, num_heads=6)),
    "DeiT_base_patch16_224": ("vit", dict(patch_size=16, embed_dim=768, depth=12, num_heads=12)),
    "DeiT_base_patch16_384": ("vit", dict(img_size=384, patch_size=16, embed_dim=768, depth=12,
                                          num_heads=12)),
    "DeiT_tiny_distilled_patch16_224": ("dist", dict(patch_size=16, embed_dim=192, depth=12,
                                                     num_heads=3)),
    "DeiT_small_distilled_patch16_224": ("dist", dict(patch_size=16, embed_dim=384, depth=12,
                                                      num_heads=6)),
    "DeiT_base_distilled_patch16_224": ("dist", dict(patch_size=16, embed_dim=768, depth=12,
                                                     num_heads=12)),
}


def _variant(name: str, kind: str, cfg: dict):
    cls = VisionTransformer if kind == "vit" else DistilledVisionTransformer

    def factory(**kw) -> nn.Module:
        return cls(**{**cfg, **kw})

    factory.__name__ = name
    return factory


for _name, (_kind, _cfg) in _DEIT.items():
    MODELS.register(_variant(_name, _kind, _cfg), name=_name)

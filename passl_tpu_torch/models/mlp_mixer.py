"""MLP-Mixer (counterpart of `passl_tpu/models/mlp_mixer.py`).

This is the JAX model, function for function:

- `MixerBlock`: a token-mixing MLP over the transposed `[n, c, L]` tensor and
  a channel-mixing MLP, each pre-normed (eps 1e-6) and added back. The JAX
  token MLP infers its width, the patch count `(img_size // patch_size)²`,
  from its input; here it is given when the block is built.
- `MlpMixer`: the patch embedding (a strided conv), the blocks, the final
  LayerNorm, the mean over the tokens (there is no cls token) and a head
  initialised to zeros.

The three factories `mixer_{s16,b16,l16}_224` are registered under the JAX
names. Images are NHWC at the input. Module names follow the flax model's
(`patch_embed`, `blocks_{i}`, `token_mlp`, `channel_mlp`), so
`utils.convert.flax_to_torch` maps one onto the other.
"""
from __future__ import annotations

from typing import Optional, Union

import torch
from torch import nn

from ..core.amp import resolve_dtype
from ..nn import init as tinit
from ..nn.layers import Dense, LayerNorm, Mlp, PatchEmbed
from .base import MODELS, register_model

DtypeLike = Union[str, torch.dtype]


class MixerBlock(nn.Module):
    def __init__(self, dim: int, num_patches: int, tokens_dim: int, channels_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=1e-6, dtype=dtype)
        self.token_mlp = Mlp(num_patches, tokens_dim, dtype=dtype)
        self.norm2 = LayerNorm(dim, eps=1e-6, dtype=dtype)
        self.channel_mlp = Mlp(dim, channels_dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.token_mlp(self.norm1(x).transpose(1, 2))  # [n, c, L]
        x = x + y.transpose(1, 2)
        return x + self.channel_mlp(self.norm2(x))


@register_model
class MlpMixer(nn.Module):
    """images [N, H, W, 3] (NHWC) -> logits [N, num_classes] at `dtype`; with
    `num_classes=0` the mean of the normed tokens [N, embed_dim]."""

    def __init__(self, img_size: int = 224, patch_size: int = 16, embed_dim: int = 768,
                 depth: int = 12, tokens_mlp_dim: int = 384, channels_mlp_dim: int = 3072,
                 num_classes: int = 1000, dtype: DtypeLike = torch.float32):
        super().__init__()
        dtype = resolve_dtype(dtype)
        self.img_size, self.embed_dim = img_size, embed_dim
        self.num_patches = (img_size // patch_size) ** 2
        self.patch_embed = PatchEmbed(patch_size, embed_dim, dtype=dtype)
        self.blocks = nn.ModuleList(
            MixerBlock(embed_dim, self.num_patches, tokens_mlp_dim, channels_mlp_dim, dtype)
            for _ in range(depth))
        self.norm = LayerNorm(embed_dim, eps=1e-6, dtype=dtype)
        self.head = (Dense(embed_dim, num_classes, dtype, kernel_init=tinit.zeros_)
                     if num_classes > 0 else None)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.patch_embed(x)
        for blk in self.blocks:
            x = blk(x)
        x = self.norm(x).mean(dim=1)
        return self.head(x) if self.head is not None else x


_MIXER = {
    "mixer_s16_224": dict(embed_dim=512, depth=8, tokens_mlp_dim=256, channels_mlp_dim=2048),
    "mixer_b16_224": dict(embed_dim=768, depth=12, tokens_mlp_dim=384, channels_mlp_dim=3072),
    "mixer_l16_224": dict(embed_dim=1024, depth=24, tokens_mlp_dim=512, channels_mlp_dim=4096),
}


def _variant(name: str, cfg: dict):
    def factory(**kw) -> MlpMixer:
        return MlpMixer(**{**cfg, **kw})

    factory.__name__ = name
    return factory


for _name, _cfg in _MIXER.items():
    MODELS.register(_variant(_name, _cfg), name=_name)

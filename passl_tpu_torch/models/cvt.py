"""CvT: the convolutional vision transformer (counterpart of
`passl_tpu/models/cvt.py`).

This is the JAX model, function for function:

- `ConvAttention`: q, k and v each pass through a 3x3 depthwise conv
  (padding 1, no bias; stride 1 for q, `kv_stride` for k and v) over the
  token grid and a LayerNorm; only then is the cls token (stage 2) put in
  front of each, so it bypasses the convs but goes through `proj_q`,
  `proj_k` and `proj_v`. The scores are f32 products with an f32 softmax,
  cast to the compute dtype before they mix v (`ops.attention.einsum_attention`).
- `CvTBlock`: the attention and an MLP, each pre-normed and behind
  stochastic depth.
- `CvT`: three stages, each a conv embedding with bias (padding `p // 2`),
  a LayerNorm and its blocks; the cls token exists in stage 2 only, and the
  head reads it after the final LayerNorm.

Every LayerNorm here uses eps 1e-5. The five factories `CvT_13_224` ...
`CvT_W24_384` are registered under the JAX names. Images are NHWC at the
input; the convs see NCHW views in channels-last memory, and the grids go
between the two by permutes. Module names follow the flax model's
(`stage{s}_embed`, `stage{s}_ln`, `stage{s}_block{b}`, `q_dw`, `q_ln`,
`proj_q`, ...), so `utils.convert.flax_to_torch` maps one onto the other.
In training, `generator` draws the stochastic-depth masks, block by block.
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..core.amp import resolve_dtype
from ..nn import init as tinit
from ..nn.layers import Conv, Dense, DropPath, LayerNorm, Mlp
from ..ops.attention import einsum_attention
from .base import MODELS, register_model

DtypeLike = Union[str, torch.dtype]
_trunc02 = functools.partial(tinit.trunc_normal_, std=0.02)


class ConvAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, kv_stride: int = 2, with_cls: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads, self.with_cls, self.dtype = num_heads, with_cls, dtype
        for name, stride in (("q", 1), ("k", kv_stride), ("v", kv_stride)):
            # flax's default Conv and Dense init (lecun_normal), as the JAX model leaves it
            self.add_module(f"{name}_dw", Conv(dim, dim, 3, stride, 1, groups=dim, dtype=dtype,
                                               use_bias=False))
            self.add_module(f"{name}_ln", LayerNorm(dim, eps=1e-5, dtype=dtype))
        self.proj_q = Dense(dim, dim, dtype)
        self.proj_k = Dense(dim, dim, dtype)
        self.proj_v = Dense(dim, dim, dtype)
        self.proj = Dense(dim, dim, dtype)

    def _conv_proj(self, grid_x: torch.Tensor, name: str) -> torch.Tensor:
        n, c = grid_x.shape[:2]
        y = getattr(self, f"{name}_dw")(grid_x).permute(0, 2, 3, 1)  # NCHW -> NHWC
        return getattr(self, f"{name}_ln")(y).reshape(n, -1, c)

    def forward(self, x: torch.Tensor, grid: Tuple[int, int]) -> torch.Tensor:
        """x [n, (1 +) h w, c] on the token grid `grid` = (h, w)."""
        n, _, c = x.shape
        h, w = grid
        cls, tok = (x[:, :1], x[:, 1:]) if self.with_cls else (None, x)
        grid_x = tok.reshape(n, h, w, c).permute(0, 3, 1, 2)  # NCHW view, channels-last memory
        qkv = [self._conv_proj(grid_x, name) for name in ("q", "k", "v")]
        if cls is not None:
            qkv = [torch.cat([cls, t], dim=1) for t in qkv]
        heads = self.num_heads
        d = c // heads
        q, k, v = (proj(t).reshape(n, -1, heads, d)
                   for proj, t in zip((self.proj_q, self.proj_k, self.proj_v), qkv))
        out = einsum_attention(q, k, v, d**-0.5, torch.float32, self.dtype)
        return self.proj(out)


class CvTBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, kv_stride: int = 2, with_cls: bool = False,
                 mlp_ratio: float = 4.0, drop_path: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=1e-5, dtype=dtype)
        self.attn = ConvAttention(dim, num_heads, kv_stride, with_cls, dtype)
        self.dp1 = DropPath(drop_path)
        self.norm2 = LayerNorm(dim, eps=1e-5, dtype=dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype=dtype)
        self.dp2 = DropPath(drop_path)

    def forward(self, x: torch.Tensor, grid: Tuple[int, int],
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = x + self.dp1(self.attn(self.norm1(x), grid), generator)
        return x + self.dp2(self.mlp(self.norm2(x)), generator)


@register_model
class CvT(nn.Module):
    """images [N, H, W, 3] (NHWC) -> logits [N, num_classes] at `dtype`; with
    `num_classes=0` the normed cls token [N, embed_dims[2]]. The token grids
    follow the input's size: the 384 variants differ from the 224 ones only
    in the data pipeline's resolution, as in JAX."""

    def __init__(self, embed_dims: Sequence[int] = (64, 192, 384), depths: Sequence[int] = (1, 2, 10),
                 num_heads: Sequence[int] = (1, 3, 6), patch_sizes: Sequence[int] = (7, 3, 3),
                 patch_strides: Sequence[int] = (4, 2, 2), num_classes: int = 1000,
                 drop_path_rate: float = 0.0, dtype: DtypeLike = torch.float32,
                 in_chans: int = 3):
        super().__init__()
        dtype = resolve_dtype(dtype)
        self.embed_dims, self.depths = tuple(embed_dims), tuple(depths)
        self.num_heads = tuple(num_heads)
        dpr = np.linspace(0, drop_path_rate, sum(self.depths))
        cur, cin = 0, in_chans
        for s in range(3):
            p, st, dim = patch_sizes[s], patch_strides[s], self.embed_dims[s]
            self.add_module(f"stage{s}_embed", Conv(cin, dim, p, st, p // 2, dtype=dtype))
            self.add_module(f"stage{s}_ln", LayerNorm(dim, eps=1e-5, dtype=dtype))
            for b in range(self.depths[s]):
                self.add_module(f"stage{s}_block{b}", CvTBlock(
                    dim, self.num_heads[s], 2, s == 2, 4.0, float(dpr[cur]), dtype))
                cur += 1
            cin = dim
        self.cls_token = nn.Parameter(torch.empty(1, 1, self.embed_dims[2]))
        self.norm = LayerNorm(self.embed_dims[2], eps=1e-5, dtype=dtype)
        self.head = (Dense(self.embed_dims[2], num_classes, dtype, kernel_init=_trunc02)
                     if num_classes > 0 else None)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        _trunc02(self.cls_token, generator=generator)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        n = x.shape[0]
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW, channels-last memory
        cls = None
        for s in range(3):
            dim = self.embed_dims[s]
            x = getattr(self, f"stage{s}_embed")(x).permute(0, 2, 3, 1)  # NHWC
            h, w = x.shape[1], x.shape[2]
            x = getattr(self, f"stage{s}_ln")(x).reshape(n, h * w, dim)
            if s == 2:
                x = torch.cat([self.cls_token.to(x.dtype).expand(n, -1, -1), x], dim=1)
            for b in range(self.depths[s]):
                x = getattr(self, f"stage{s}_block{b}")(x, (h, w), generator)
            if s == 2:
                cls, x = x[:, 0], x[:, 1:]
            x = x.reshape(n, h, w, dim).permute(0, 3, 1, 2)  # NHWC -> NCHW view
        feats = self.norm(cls)
        return self.head(feats) if self.head is not None else feats


_CVT = {
    "CvT_13_224": dict(depths=(1, 2, 10), embed_dims=(64, 192, 384), num_heads=(1, 3, 6)),
    "CvT_21_224": dict(depths=(1, 4, 16), embed_dims=(64, 192, 384), num_heads=(1, 3, 6)),
    # the 384 finetune variants: the same models, the resolution from the data pipeline
    "CvT_13_384": dict(depths=(1, 2, 10), embed_dims=(64, 192, 384), num_heads=(1, 3, 6)),
    "CvT_21_384": dict(depths=(1, 4, 16), embed_dims=(64, 192, 384), num_heads=(1, 3, 6)),
    "CvT_W24_384": dict(depths=(2, 2, 20), embed_dims=(192, 768, 1024), num_heads=(3, 12, 16)),
}


def _variant(name: str, cfg: dict):
    def factory(**kw) -> CvT:
        return CvT(**{**cfg, **kw})

    factory.__name__ = name
    return factory


for _name, _cfg in _CVT.items():
    MODELS.register(_variant(_name, _cfg), name=_name)

"""XCiT: cross-covariance image transformer (counterpart of
`passl_tpu/models/xcit.py`).

This is the JAX model, function for function:

- `XCA` attends over the channels: q and k are l2-normalized over the
  **tokens** in f32, their (d x d) products per head are scaled by the
  per-head `temperature` (shape (h, 1, 1), f32, ones at init) and go through
  an f32 softmax, which is cast to the compute dtype before it mixes v.
- `LPI` (local patch interaction) reshapes the tokens to their grid and
  runs a 3x3 depthwise conv, GELU, its own BatchNorm (flax's rules,
  `nn.norm.BatchNorm`) and a second 3x3 depthwise conv.
- `XCiTBlock`: XCA, LPI, MLP, each pre-normed (eps 1e-6), scaled by its
  f32 LayerScale (`gamma1`, `gamma3`, `gamma2`, so the residual stream is
  f32 from the first block on, as in JAX) and behind stochastic depth.
- The patch projection is 3 stride-2 3x3 convs for /8 and 4 for /16, with
  biases, GELU between them and no norm.
- The class-attention stage is CaiT's `ClassAttention` (`models/cait.py`,
  as JAX imports CaiT's) over [cls, patches], pre-normed, with no MLP and no
  layer scale; then the cls token's LayerNorm and the head.

The 14 factories `xcit_{nano,tiny,small,medium,large}_{12,24}_p{16,8}` are
registered under the JAX names. Images are NHWC at the input; the convs see
NCHW views in channels-last memory. Module names follow the flax model's
(`patch_proj{i}`, `blocks_{i}`, `ca_norm{i}`, `cls_attn_{i}`), so
`utils.convert.flax_to_torch` maps one onto the other. In training,
`generator` draws the stochastic-depth masks, block by block, in the order
the block runs its branches (XCA, LPI, MLP).
"""
from __future__ import annotations

import functools
from typing import Optional, Union

import numpy as np
import torch
from torch import nn

from ..core.amp import resolve_dtype
from ..nn import init as tinit
from ..nn.layers import Conv, Dense, DropPath, LayerNorm, Mlp, gelu
from ..nn.norm import BatchNorm, l2_normalize
from .base import MODELS, register_model
from .cait import ClassAttention

DtypeLike = Union[str, torch.dtype]
_trunc02 = functools.partial(tinit.trunc_normal_, std=0.02)


class XCA(nn.Module):
    """Cross-covariance attention: a softmax over the (d x d) channel
    similarity of the token-normalized q and k of each head."""

    def __init__(self, dim: int, num_heads: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        # flax's default Dense init (lecun_normal), as the JAX model leaves it
        self.qkv = Dense(dim, 3 * dim, dtype)
        self.temperature = nn.Parameter(torch.empty(num_heads, 1, 1))
        self.proj = Dense(dim, dim, dtype)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        tinit.ones_(self.temperature)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, l, c = x.shape
        h = self.num_heads
        q, k, v = self.qkv(x).reshape(n, l, 3, h, c // h).unbind(2)  # [n, l, h, d]
        acc = torch.promote_types(q.dtype, torch.float32)  # f64 in an f64 model
        q = l2_normalize(q.to(acc), dim=1)  # over the tokens
        k = l2_normalize(k.to(acc), dim=1)
        attn = torch.einsum("nlhd,nlhe->nhde", q, k) * self.temperature.to(acc)
        attn = torch.softmax(attn, dim=-1).to(v.dtype)  # v is at the compute dtype
        out = torch.einsum("nhde,nlhe->nlhd", attn, v).reshape(n, l, c)
        return self.proj(out)


class LPI(nn.Module):
    """Local patch interaction: two 3x3 depthwise convs over the token grid
    with GELU and a BatchNorm between them."""

    def __init__(self, dim: int, grid: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.grid = grid
        self.conv1 = Conv(dim, dim, 3, padding=1, groups=dim, dtype=dtype)
        self.bn = BatchNorm(dim, dtype=dtype)
        self.conv2 = Conv(dim, dim, 3, padding=1, groups=dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, l, c = x.shape
        g = self.grid
        y = x.reshape(n, g, g, c).permute(0, 3, 1, 2)  # NCHW view, channels-last memory
        y = self.conv2(self.bn(gelu(self.conv1(y))))
        return y.permute(0, 2, 3, 1).reshape(n, l, c)


class XCiTBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, grid: int, mlp_ratio: float = 4.0,
                 init_values: float = 1.0, drop_path: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.init_values = init_values
        self.gamma1 = nn.Parameter(torch.empty(dim))
        self.gamma2 = nn.Parameter(torch.empty(dim))
        self.gamma3 = nn.Parameter(torch.empty(dim))
        self.norm1 = LayerNorm(dim, eps=1e-6, dtype=dtype)
        self.attn = XCA(dim, num_heads, dtype)
        self.dp1 = DropPath(drop_path)
        self.norm3 = LayerNorm(dim, eps=1e-6, dtype=dtype)
        self.local_mp = LPI(dim, grid, dtype)
        self.dp3 = DropPath(drop_path)
        self.norm2 = LayerNorm(dim, eps=1e-6, dtype=dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype=dtype)
        self.dp2 = DropPath(drop_path)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for g in (self.gamma1, self.gamma2, self.gamma3):
            tinit.constant_(g, self.init_values)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = x + self.dp1(self.attn(self.norm1(x)) * self.gamma1, generator)
        x = x + self.dp3(self.local_mp(self.norm3(x)) * self.gamma3, generator)
        return x + self.dp2(self.mlp(self.norm2(x)) * self.gamma2, generator)


@register_model
class XCiT(nn.Module):
    """images [N, H, W, 3] (NHWC) -> logits [N, num_classes] at `dtype`; with
    `num_classes=0` the normed cls token [N, embed_dim]."""

    def __init__(self, img_size: int = 224, patch_size: int = 16, embed_dim: int = 384,
                 depth: int = 12, num_heads: int = 8, cls_attn_layers: int = 2,
                 mlp_ratio: float = 4.0, init_values: float = 1.0, drop_path_rate: float = 0.0,
                 num_classes: int = 1000, dtype: DtypeLike = torch.float32, in_chans: int = 3):
        super().__init__()
        dtype = resolve_dtype(dtype)
        self.img_size = img_size
        self.in_chans = in_chans
        self.embed_dim = embed_dim
        self.steps = int(np.log2(patch_size))
        dim = embed_dim // (2 ** (self.steps - 1))
        cin = in_chans
        for i in range(self.steps):
            cout = min(dim * (2**i), embed_dim)
            self.add_module(f"patch_proj{i}", Conv(cin, cout, 3, 2, 1, dtype=dtype))
            cin = cout
        grid = img_size
        for _ in range(self.steps):
            grid = (grid - 1) // 2 + 1  # a 3x3 stride-2 conv padded by 1
        dpr = np.linspace(0, drop_path_rate, depth)
        self.blocks = nn.ModuleList(
            XCiTBlock(embed_dim, num_heads, grid, mlp_ratio, init_values, float(dpr[i]), dtype)
            for i in range(depth))
        self.cls_token = nn.Parameter(torch.empty(1, 1, embed_dim))
        for i in range(cls_attn_layers):
            self.add_module(f"ca_norm{i}", LayerNorm(embed_dim, eps=1e-6, dtype=dtype))
        self.cls_attn = nn.ModuleList(ClassAttention(embed_dim, num_heads, dtype)
                                      for _ in range(cls_attn_layers))
        self.norm = LayerNorm(embed_dim, eps=1e-6, dtype=dtype)
        self.head = (Dense(embed_dim, num_classes, dtype, kernel_init=_trunc02)
                     if num_classes > 0 else None)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        _trunc02(self.cls_token, generator=generator)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        n = x.shape[0]
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW, channels-last memory
        for i in range(self.steps):
            x = getattr(self, f"patch_proj{i}")(x)
            if i < self.steps - 1:
                x = gelu(x)
        x = x.permute(0, 2, 3, 1).reshape(n, -1, self.embed_dim)
        for blk in self.blocks:
            x = blk(x, generator)
        cls = self.cls_token.to(x.dtype).expand(n, -1, -1)
        for i, attn in enumerate(self.cls_attn):
            y = getattr(self, f"ca_norm{i}")(torch.cat([cls, x], dim=1))
            cls = cls + attn(y)
        x = self.norm(cls)[:, 0]
        return self.head(x) if self.head is not None else x


# eta (LayerScale init) 1.0 for the 12-layer models and 1e-5 for the 24-layer ones
_XCIT_SIZES = {
    "xcit_nano_12": dict(embed_dim=128, depth=12, num_heads=4, init_values=1.0),
    "xcit_tiny_12": dict(embed_dim=192, depth=12, num_heads=4, init_values=1.0),
    "xcit_tiny_24": dict(embed_dim=192, depth=24, num_heads=4, init_values=1e-5),
    "xcit_small_12": dict(embed_dim=384, depth=12, num_heads=8, init_values=1.0),
    "xcit_small_24": dict(embed_dim=384, depth=24, num_heads=8, init_values=1e-5),
    "xcit_medium_24": dict(embed_dim=512, depth=24, num_heads=8, init_values=1e-5),
    "xcit_large_24": dict(embed_dim=768, depth=24, num_heads=16, init_values=1e-5),
}
_XCIT = {**{f"{s}_p16": dict(cfg, patch_size=16) for s, cfg in _XCIT_SIZES.items()},
         **{f"{s}_p8": dict(cfg, patch_size=8) for s, cfg in _XCIT_SIZES.items()}}


def _variant(name: str, cfg: dict):
    def factory(**kw) -> XCiT:
        return XCiT(**{**cfg, **kw})

    factory.__name__ = name
    return factory


for _name, _cfg in _XCIT.items():
    MODELS.register(_variant(_name, _cfg), name=_name)

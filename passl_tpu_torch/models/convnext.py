"""ConvNeXt (counterpart of `passl_tpu/models/convnext.py`).

A 4x4 stride-4 stem and three 2x2 stride-2 downsamples, each beside a
channel-last LayerNorm (eps 1e-6), and blocks of a 7x7 depthwise conv (a
grouped conv with one group a channel), LayerNorm, a pointwise MLP of 4x
width with flax's tanh GELU, the LayerScale `gamma` (f32, so the residual
stream turns f32 after the first block, as in JAX) and stochastic depth;
the mean over the grid, a LayerNorm and the head. Every conv and Dense has
a trunc-normal 0.02 kernel and a zero bias; `head_init_scale` scales only
the head's std. The stem and downsample convs take flax's SAME padding
(none where the size divides by the stride). The five factories
`convnext_tiny` to `convnext_xlarge` are registered under the JAX names.

Images are NHWC at the input and the blocks keep NHWC (the LayerNorms and
the MLP act on the last axis); each conv sees the NCHW view of it, which is
channels-last memory. Module names follow the flax model's (`stem_conv`,
`downsample_norm{i}`, `stage{i}_block{j}`), so `utils.convert.flax_to_torch`
maps one onto the other. In training, `generator` draws the
stochastic-depth masks, block by block.
"""
from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.amp import resolve_dtype
from ..nn import init as tinit
from ..nn.layers import Conv, Dense, DropPath, LayerNorm, gelu
from .base import MODELS, register_model

DtypeLike = Union[str, torch.dtype]
_trunc02 = functools.partial(tinit.trunc_normal_, std=0.02)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _same_padded(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """x NCHW padded as flax's SAME pads a k x k conv of stride s."""
    pads = []
    for size in (x.shape[3], x.shape[2]):  # F.pad takes the last axis first
        total = max((-(-size // s) - 1) * s + k - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads) if any(pads) else x


class ConvNeXtBlock(nn.Module):
    def __init__(self, dim: int, drop_path: float = 0.0, layer_scale_init_value: float = 1e-6,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.layer_scale_init_value = layer_scale_init_value
        self.dwconv = Conv(dim, dim, 7, padding=3, groups=dim, dtype=dtype, kernel_init=_trunc02)
        self.norm = LayerNorm(dim, eps=1e-6, dtype=dtype)
        self.pwconv1 = Dense(dim, 4 * dim, dtype, kernel_init=_trunc02)
        self.pwconv2 = Dense(4 * dim, dim, dtype, kernel_init=_trunc02)
        self.gamma = nn.Parameter(torch.empty(dim)) if layer_scale_init_value > 0 else None
        self.drop_path = DropPath(drop_path)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        if self.gamma is not None:
            tinit.constant_(self.gamma, self.layer_scale_init_value)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        y = _nhwc(self.dwconv(_nchw(x)))
        y = self.pwconv2(gelu(self.pwconv1(self.norm(y))))
        if self.gamma is not None:
            y = y * self.gamma
        return x + self.drop_path(y, generator)


@register_model
class ConvNeXt(nn.Module):
    """images [N, H, W, 3] (NHWC) -> logits [N, num_classes] at `dtype`; with
    `num_classes=0` the normed pooled features [N, dims[-1]]."""

    def __init__(self, depths: Sequence[int] = (3, 3, 9, 3),
                 dims: Sequence[int] = (96, 192, 384, 768), num_classes: int = 1000,
                 drop_path_rate: float = 0.0, layer_scale_init_value: float = 1e-6,
                 head_init_scale: float = 1.0, dtype: DtypeLike = torch.float32,
                 in_chans: int = 3):
        super().__init__()
        dtype = resolve_dtype(dtype)
        self.depths, self.dims = tuple(depths), tuple(dims)
        dp_rates = np.linspace(0, drop_path_rate, sum(depths))
        self.stages: List[List[str]] = []
        cur = 0
        for i in range(4):
            if i == 0:
                self.stem_conv = Conv(in_chans, dims[0], 4, 4, dtype=dtype, kernel_init=_trunc02)
                self.stem_norm = LayerNorm(dims[0], eps=1e-6, dtype=dtype)
            else:
                self.add_module(f"downsample_norm{i}", LayerNorm(dims[i - 1], eps=1e-6,
                                                                 dtype=dtype))
                self.add_module(f"downsample_conv{i}", Conv(dims[i - 1], dims[i], 2, 2,
                                                            dtype=dtype, kernel_init=_trunc02))
            names = []
            for j in range(depths[i]):
                names.append(f"stage{i}_block{j}")
                self.add_module(names[-1], ConvNeXtBlock(dims[i], float(dp_rates[cur]),
                                                         layer_scale_init_value, dtype))
                cur += 1
            self.stages.append(names)
        self.norm = LayerNorm(dims[-1], eps=1e-6, dtype=dtype)
        self.head = (Dense(dims[-1], num_classes, dtype,
                           kernel_init=functools.partial(tinit.trunc_normal_,
                                                         std=0.02 * head_init_scale))
                     if num_classes > 0 else None)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for i, names in enumerate(self.stages):
            if i == 0:
                x = _nhwc(self.stem_conv(_same_padded(_nchw(x), 4, 4)))
                x = self.stem_norm(x)
            else:
                x = getattr(self, f"downsample_norm{i}")(x)
                x = _nhwc(getattr(self, f"downsample_conv{i}")(_same_padded(_nchw(x), 2, 2)))
            for name in names:
                x = getattr(self, name)(x, generator)
        x = self.norm(x.mean(dim=(1, 2)))
        return self.head(x) if self.head is not None else x


_CONVNEXT = {
    "convnext_tiny": dict(depths=(3, 3, 9, 3), dims=(96, 192, 384, 768)),
    "convnext_small": dict(depths=(3, 3, 27, 3), dims=(96, 192, 384, 768)),
    "convnext_base": dict(depths=(3, 3, 27, 3), dims=(128, 256, 512, 1024)),
    "convnext_large": dict(depths=(3, 3, 27, 3), dims=(192, 384, 768, 1536)),
    "convnext_xlarge": dict(depths=(3, 3, 27, 3), dims=(256, 512, 1024, 2048)),
}


def _variant(name: str, cfg: dict):
    def factory(**kw) -> ConvNeXt:
        return ConvNeXt(**{**cfg, **kw})

    factory.__name__ = name
    return factory


for _name, _cfg in _CONVNEXT.items():
    MODELS.register(_variant(_name, _cfg), name=_name)

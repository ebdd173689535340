"""RegNet X and Y (counterpart of `passl_tpu/models/regnet.py`).

The stage widths and depths come from the design-space parameters (w_a,
w_0, w_m, depth), quantized to multiples of 8 by `generate_regnet` and
rounded to a multiple of each stage's group width by `adjust_widths_groups`
(numpy copies of the JAX functions: `np.round` and Python's `round` both
round half to even). Each `XBlock` is a 1x1 conv, a grouped 3x3 conv of
`max(1, w_out // group_width)` groups (with the block's stride), the
squeeze-excitation of RegNetY (its width `se_ratio` times the block's
*input* width, as the JAX block takes it) and a 1x1 conv, each conv without
bias and followed by a BatchNorm with flax's rules (`nn.norm.BatchNorm`),
with a strided 1x1 projection where the shape changes. The seven factories
`RegNetX_200MF` to `RegNetY_160` are registered under the JAX names.

Images are NHWC at the input, as in the JAX package; inside, the convs and
BatchNorms run on NCHW tensors in channels-last memory, as the port's ResNet
does. Convs compute at `dtype` with f32 lecun-normal kernels (flax's
default), the head is a Dense. Module names follow the flax model's
(`s{stage}_b{block}`), so `utils.convert.flax_to_torch` maps one onto the
other.
"""
from __future__ import annotations

from typing import List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.amp import resolve_dtype
from ..nn.layers import Conv, Dense
from ..nn.norm import BatchNorm
from .base import MODELS, register_model

DtypeLike = Union[str, torch.dtype]


def generate_regnet(w_a: float, w_0: int, w_m: float, depth: int,
                    q: int = 8) -> Tuple[List[int], List[int]]:
    """Per-stage widths/depths from the RegNet design-space params."""
    ws_cont = np.arange(depth) * w_a + w_0
    ks = np.round(np.log(ws_cont / w_0) / np.log(w_m))
    ws = w_0 * np.power(w_m, ks)
    ws = np.round(ws / q) * q
    ws = ws.astype(int).tolist()
    stage_widths = sorted(set(ws))
    stage_depths = [ws.count(w) for w in stage_widths]
    return stage_widths, stage_depths


def adjust_widths_groups(widths: List[int], group_width: int) -> Tuple[List[int], List[int]]:
    """Round each stage width to a multiple of its (capped) group width."""
    gs = [min(group_width, w) for w in widths]
    ws = [int(round(w / g) * g) for w, g in zip(widths, gs)]
    return ws, gs


def _conv(cin: int, cout: int, k: int, stride: int = 1, groups: int = 1,
          dtype: torch.dtype = torch.float32) -> Conv:
    """flax `Conv(cout, (k, k), strides=stride, padding=k // 2, feature_group_count=groups,
    use_bias=False)`."""
    return Conv(cin, cout, k, stride, k // 2, groups, dtype=dtype, use_bias=False)


class SE(nn.Module):
    """Squeeze-excitation: the spatial mean through two 1x1 convs (with
    biases), relu then sigmoid, scaling the input's channels."""

    def __init__(self, channels: int, reduced: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = Conv(channels, reduced, 1, dtype=dtype)
        self.fc2 = Conv(reduced, channels, 1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(2, 3), keepdim=True)
        s = torch.sigmoid(self.fc2(F.relu(self.fc1(s))))
        return x * s


class XBlock(nn.Module):
    def __init__(self, w_in: int, w_out: int, stride: int, group_width: int,
                 se_ratio: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        groups = max(1, w_out // group_width)
        self.conv1 = _conv(w_in, w_out, 1, dtype=dtype)
        self.bn1 = BatchNorm(w_out, dtype=dtype)
        self.conv2 = _conv(w_out, w_out, 3, stride, groups, dtype=dtype)
        self.bn2 = BatchNorm(w_out, dtype=dtype)
        self.se = SE(w_out, max(1, int(w_in * se_ratio)), dtype) if se_ratio > 0 else None
        self.conv3 = _conv(w_out, w_out, 1, dtype=dtype)
        self.bn3 = BatchNorm(w_out, dtype=dtype)
        self.project = stride != 1 or w_in != w_out
        if self.project:
            self.conv_proj = _conv(w_in, w_out, 1, stride, dtype=dtype)
            self.bn_proj = BatchNorm(w_out, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        if self.se is not None:
            y = self.se(y)
        y = self.bn3(self.conv3(y))
        identity = self.bn_proj(self.conv_proj(x)) if self.project else x
        return F.relu(y + identity)


@register_model
class RegNet(nn.Module):
    """images [N, H, W, 3] (NHWC) -> logits [N, num_classes] at `dtype`; with
    `num_classes=0` the pooled features [N, out_channels]."""

    def __init__(self, w_a: float = 24.48, w_0: int = 24, w_m: float = 2.54, depth: int = 22,
                 group_width: int = 16, se_ratio: float = 0.0, num_classes: int = 1000,
                 dtype: DtypeLike = torch.float32, in_chans: int = 3):
        super().__init__()
        dtype = resolve_dtype(dtype)
        widths, depths = generate_regnet(w_a, w_0, w_m, depth)
        widths, group_ws = adjust_widths_groups(widths, group_width)
        self.widths, self.depths, self.group_widths = widths, depths, group_ws
        self.stem_conv = Conv(in_chans, 32, 3, 2, 1, dtype=dtype, use_bias=False)
        self.stem_bn = BatchNorm(32, dtype=dtype)
        self.block_names: List[str] = []
        w_in = 32
        for si, (w, gw, d) in enumerate(zip(widths, group_ws, depths)):
            for bi in range(d):
                name = f"s{si + 1}_b{bi}"
                self.add_module(name, XBlock(w_in, w, 2 if bi == 0 else 1, gw, se_ratio, dtype))
                self.block_names.append(name)
                w_in = w
        self.out_channels = w_in
        self.head = Dense(w_in, num_classes, dtype=dtype) if num_classes > 0 else None

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        # NHWC -> NCHW in channels-last memory (the layout cuDNN takes fastest)
        x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        x = F.relu(self.stem_bn(self.stem_conv(x)))
        for name in self.block_names:
            x = getattr(self, name)(x)
        x = x.mean(dim=(2, 3))
        return self.head(x) if self.head is not None else x


_REGNET = {
    "RegNetX_200MF": dict(w_a=36.44, w_0=24, w_m=2.49, depth=13, group_width=8),
    "RegNetX_400MF": dict(w_a=24.48, w_0=24, w_m=2.54, depth=22, group_width=16),
    "RegNetX_1600MF": dict(w_a=34.01, w_0=80, w_m=2.25, depth=18, group_width=24),
    "RegNetX_4GF": dict(w_a=38.65, w_0=96, w_m=2.43, depth=23, group_width=40),
    "RegNetY_400MF": dict(w_a=27.89, w_0=48, w_m=2.09, depth=16, group_width=8, se_ratio=0.25),
    "RegNetY_4GF": dict(w_a=31.41, w_0=96, w_m=2.24, depth=22, group_width=64, se_ratio=0.25),
    # the XCiT distillation teacher (its group width 112 is why
    # adjust_widths_groups exists)
    "RegNetY_160": dict(w_a=106.23, w_0=200, w_m=2.48, depth=18, group_width=112,
                        se_ratio=0.25),
}


def _variant(name: str, cfg: dict):
    def factory(**kw) -> RegNet:
        return RegNet(**{**cfg, **kw})

    factory.__name__ = name
    return factory


for _name, _cfg in _REGNET.items():
    MODELS.register(_variant(_name, _cfg), name=_name)

"""CaiT: class-attention in image transformers (counterpart of
`passl_tpu/models/cait.py:25-209`).

Talking-heads self-attention over the patch tokens, then class-attention
blocks where only the cls token queries, LayerScale on every branch.
Module and parameter names follow the flax model's, so
`utils.convert.flax_to_torch` maps one onto the other.

Precision follows the JAX model: Dense/Conv/LayerNorm compute at `dtype`
with f32 parameters, the scores at `softmax_dtype`, and the LayerScale
gammas, `proj_l`/`proj_w`, `pos_embed` and `cls_token` stay f32, so
`y * gamma` promotes the residual stream to f32 from the first block on.
"""
from __future__ import annotations

import functools
from typing import Optional, Union

import numpy as np
import torch
from torch import nn

from ..core.amp import resolve_dtype
from ..nn import init as tinit
from ..nn.layers import Dense, DropPath, Identity, LayerNorm, Mlp, PatchEmbed
from ..ops.talking_heads import talking_heads_softmax, talking_heads_softmax_ref
from .base import MODELS, register_model

TH_IMPLS = ("einsum", "fused", "auto")
DtypeLike = Union[str, torch.dtype]
_trunc02 = functools.partial(tinit.trunc_normal_, std=0.02)


def resolve_th_impl(impl: str, device: Union[str, torch.device]) -> str:
    """`fused` = the CUDA kernel (CUDA tensors only); `einsum` = the plain
    version on any device; `auto` = fused for CUDA tensors, einsum otherwise."""
    if impl not in TH_IMPLS:
        raise ValueError(f"unknown th_impl {impl!r}")
    device = torch.device(device)
    if impl == "auto":
        return "fused" if device.type == "cuda" else "einsum"
    if impl == "fused" and device.type != "cuda":
        raise ValueError(f"th_impl=fused needs CUDA tensors, got {device}; "
                         "use th_impl=einsum or auto")
    return impl


def _scores(q: torch.Tensor, k: torch.Tensor, acc: torch.dtype) -> torch.Tensor:
    """q [n, h, lq, d] . k [n, h, lk, d] -> [n, h, lq, lk] at `acc`, like an
    einsum with preferred_element_type=acc: computed at the wider of the two."""
    ct = torch.promote_types(q.dtype, acc)
    return torch.matmul(q.to(ct), k.to(ct).transpose(-1, -2)).to(acc)


class TalkingHeadAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, dtype: torch.dtype = torch.float32,
                 softmax_dtype: torch.dtype = torch.float32, th_impl: str = "auto"):
        super().__init__()
        if th_impl not in TH_IMPLS:
            raise ValueError(f"unknown th_impl {th_impl!r}")
        self.num_heads = num_heads
        self.dtype = dtype
        self.softmax_dtype = softmax_dtype
        self.th_impl = th_impl
        self.qkv = Dense(dim, 3 * dim, dtype=dtype, kernel_init=_trunc02)
        self.proj_l = nn.Parameter(torch.empty(num_heads, num_heads))
        self.proj_w = nn.Parameter(torch.empty(num_heads, num_heads))
        self.proj = Dense(dim, dim, dtype=dtype, kernel_init=_trunc02)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        _trunc02(self.proj_l, generator=generator)
        _trunc02(self.proj_w, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, l, c = x.shape
        h = self.num_heads
        hd = c // h
        qkv = self.qkv(x).reshape(n, l, 3, h, hd).permute(2, 0, 3, 1, 4)  # [3, n, h, l, hd]
        q, k, v = qkv.unbind(0)
        attn = _scores(q * hd**-0.5, k, self.softmax_dtype)
        if resolve_th_impl(self.th_impl, attn.device) == "fused":
            attn = talking_heads_softmax(attn, self.proj_l, self.proj_w)
        else:
            attn = talking_heads_softmax_ref(attn, self.proj_l, self.proj_w)
        out = torch.matmul(attn.to(self.dtype), v).transpose(1, 2).reshape(n, l, c)
        return self.proj(out)


class ClassAttention(nn.Module):
    """Only the cls token forms queries; softmax in f32."""

    def __init__(self, dim: int, num_heads: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        # flax's default Dense init (lecun_normal), as the JAX model leaves it
        self.q = Dense(dim, dim, dtype=dtype)
        self.k = Dense(dim, dim, dtype=dtype)
        self.v = Dense(dim, dim, dtype=dtype)
        self.proj = Dense(dim, dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, l, c = x.shape
        h = self.num_heads
        hd = c // h
        q = self.q(x[:, :1]).reshape(n, 1, h, hd).transpose(1, 2)
        k = self.k(x).reshape(n, l, h, hd).transpose(1, 2)
        v = self.v(x).reshape(n, l, h, hd).transpose(1, 2)
        # f32 scores (f64 in a model run in f64), cast to v's compute dtype
        acc = torch.promote_types(q.dtype, torch.float32)
        attn = torch.softmax(_scores(q * hd**-0.5, k, acc), dim=-1).to(v.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(n, 1, c)
        return self.proj(out)


class CaiTSABlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0, init_values: float = 1e-4,
                 drop_path: float = 0.0, dtype: torch.dtype = torch.float32,
                 softmax_dtype: torch.dtype = torch.float32, th_impl: str = "auto"):
        super().__init__()
        self.init_values = init_values
        self.gamma_1 = nn.Parameter(torch.empty(dim))
        self.gamma_2 = nn.Parameter(torch.empty(dim))
        self.norm1 = LayerNorm(dim, eps=1e-6, dtype=dtype)
        self.attn = TalkingHeadAttention(dim, num_heads, dtype=dtype,
                                         softmax_dtype=softmax_dtype, th_impl=th_impl)
        self.dp1 = DropPath(drop_path)
        self.norm2 = LayerNorm(dim, eps=1e-6, dtype=dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype=dtype)
        self.dp2 = DropPath(drop_path)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        tinit.constant_(self.gamma_1, self.init_values)
        tinit.constant_(self.gamma_2, self.init_values)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = x + self.dp1(self.attn(self.norm1(x)) * self.gamma_1, generator)
        return x + self.dp2(self.mlp(self.norm2(x)) * self.gamma_2, generator)


class CaiTCABlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0, init_values: float = 1e-4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.init_values = init_values
        self.gamma_1 = nn.Parameter(torch.empty(dim))
        self.gamma_2 = nn.Parameter(torch.empty(dim))
        self.norm1 = LayerNorm(dim, eps=1e-6, dtype=dtype)
        self.attn = ClassAttention(dim, num_heads, dtype=dtype)
        self.norm2 = LayerNorm(dim, eps=1e-6, dtype=dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype=dtype)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        tinit.constant_(self.gamma_1, self.init_values)
        tinit.constant_(self.gamma_2, self.init_values)

    def forward(self, x_cls: torch.Tensor, x_patches: torch.Tensor) -> torch.Tensor:
        u = torch.cat([x_cls, x_patches], dim=1)
        x_cls = x_cls + self.attn(self.norm1(u)) * self.gamma_1
        return x_cls + self.mlp(self.norm2(x_cls)) * self.gamma_2


@register_model
class CaiT(nn.Module):
    """images [n, H, W, 3] (NHWC) -> logits [n, num_classes] at `dtype`.

    In training, `generator` (a torch.Generator on the images' device) draws
    the stochastic-depth masks of every block, in block order.
    """

    def __init__(self, img_size: int = 224, patch_size: int = 16, embed_dim: int = 384,
                 depth: int = 24, num_heads: int = 8, depth_token_only: int = 2,
                 mlp_ratio: float = 4.0, init_values: float = 1e-5, drop_path_rate: float = 0.0,
                 num_classes: int = 1000, softmax_dtype: DtypeLike = "float32",
                 th_impl: str = "auto", dtype: DtypeLike = torch.float32, in_chans: int = 3):
        super().__init__()
        dtype = resolve_dtype(dtype)
        softmax_dtype = resolve_dtype(softmax_dtype)
        self.img_size = img_size
        self.in_chans = in_chans
        self.patch_embed = PatchEmbed(patch_size, embed_dim, in_chans, dtype=dtype)
        num_patches = (img_size // patch_size) ** 2
        self.pos_embed = nn.Parameter(torch.empty(1, num_patches, embed_dim))
        self.cls_token = nn.Parameter(torch.empty(1, 1, embed_dim))
        dpr = np.linspace(0, drop_path_rate, depth)
        self.blocks = nn.ModuleList(
            CaiTSABlock(embed_dim, num_heads, mlp_ratio, init_values, float(dpr[i]), dtype,
                        softmax_dtype, th_impl)
            for i in range(depth))
        self.blocks_token_only = nn.ModuleList(
            CaiTCABlock(embed_dim, num_heads, mlp_ratio, init_values, dtype)
            for _ in range(depth_token_only))
        self.norm = LayerNorm(embed_dim, eps=1e-6, dtype=dtype)
        self.head = (Dense(embed_dim, num_classes, dtype=dtype, kernel_init=_trunc02)
                     if num_classes > 0 else Identity())

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        _trunc02(self.pos_embed, generator=generator)
        _trunc02(self.cls_token, generator=generator)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        n = x.shape[0]
        x = self.patch_embed(x)
        x = x + self.pos_embed.to(x.dtype)
        for blk in self.blocks:
            x = blk(x, generator)
        cls = self.cls_token.to(x.dtype).expand(n, -1, -1)
        for blk in self.blocks_token_only:
            cls = blk(cls, x)
        # LayerNorm is per token, so norming the cls token alone equals the
        # JAX model's norm over [cls, patches] followed by taking token 0
        return self.head(self.norm(cls[:, 0]))


_CAIT = {
    "cait_xxs24_224": dict(embed_dim=192, depth=24, num_heads=4, init_values=1e-5),
    "cait_xs24_384": dict(img_size=384, embed_dim=288, depth=24, num_heads=6, init_values=1e-5),
    "cait_s24_224": dict(embed_dim=384, depth=24, num_heads=8, init_values=1e-5),
    "cait_s24_384": dict(img_size=384, embed_dim=384, depth=24, num_heads=8, init_values=1e-5),
    "cait_s36_384": dict(img_size=384, embed_dim=384, depth=36, num_heads=8, init_values=1e-6),
    "cait_m36_384": dict(img_size=384, embed_dim=768, depth=36, num_heads=16, init_values=1e-6),
    "cait_m48_448": dict(img_size=448, embed_dim=768, depth=48, num_heads=16, init_values=1e-6),
}


def _variant(name: str, cfg: dict):
    def factory(**kw) -> CaiT:
        return CaiT(**{**cfg, **kw})

    factory.__name__ = name
    return factory


for _name, _cfg in _CAIT.items():
    MODELS.register(_variant(_name, _cfg), name=_name)

"""Shared NN building blocks, with flax's precision conventions.

Counterpart of `passl_tpu/nn/layers.py:22-185`, the ViT family's `Attention`
and `Block` included. Parameters are float32; each
layer casts them, and its input, to its compute `dtype` where it uses them,
as flax's `Dense`/`Conv(dtype=...)` do. `LayerNorm` takes its statistics in
float32 and returns the compute dtype, as flax's does. Images are NHWC at
the public functions, as in the JAX package.

Every module here owns `reset_parameters(generator)`, which fills its direct
parameters with the JAX package's initializers; `nn.init.init_module` walks
a model with one generator.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import multi_head_attention, resolve_attn_impl
from . import init as tinit

Identity = nn.Identity  # ignores extra arguments, like the flax module


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax's `nn.gelu`: the tanh approximation (torch's default is exact)."""
    return F.gelu(x, approximate="tanh")


class Dense(nn.Linear):
    """flax `Dense(dtype=..., use_bias=...)`: f32 weight `[out, in]`, computed at `dtype`."""

    def __init__(self, in_features: int, out_features: int, dtype: torch.dtype = torch.float32,
                 kernel_init: Callable = tinit.lecun_normal_, use_bias: bool = True):
        self.compute_dtype = dtype
        self.kernel_init = kernel_init
        super().__init__(in_features, out_features, bias=use_bias)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.kernel_init(self.weight, generator=generator)
        if self.bias is not None:
            tinit.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = self.bias.to(dt) if self.bias is not None else None
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class Conv2d(nn.Conv2d):
    """flax `Conv(padding="VALID", dtype=...)` over NCHW: weight OIHW, f32;
    xavier-uniform kernels unless `kernel_init` says otherwise."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int,
                 dtype: torch.dtype = torch.float32, kernel_init: Callable = tinit.xavier_uniform_):
        self.compute_dtype = dtype
        self.kernel_init = kernel_init
        super().__init__(in_channels, out_channels, kernel_size, stride, padding=0)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.kernel_init(self.weight, generator=generator)
        tinit.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.conv2d(x.to(dt), self.weight.to(dt), self.bias.to(dt), self.stride)


class Conv1x1(nn.Module):
    """flax `Conv(out_channels, (1, 1), dtype=...)` over the last axis of a
    channels-last tensor ([N, H, W, C] or [N, S, C]): weight OIHW
    `[out, in, 1, 1]` in f32 (lecun-normal, as flax's kernel HWIO converts)
    and a zero bias, computed at `dtype` as one product over the channels."""

    def __init__(self, in_channels: int, out_channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, 1, 1))
        self.bias = nn.Parameter(torch.empty(out_channels))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        tinit.lecun_normal_(self.weight, generator=generator)
        tinit.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.flatten(1).to(dt), self.bias.to(dt))


class Conv(nn.Module):
    """flax `Conv(features, (k, k), strides, padding, feature_group_count,
    use_bias, dtype=...)` over NCHW: weight OIHW `[out, in / groups, k, k]` in
    f32 (lecun-normal, flax's default, unless `kernel_init` says otherwise) and
    a zero bias (none with `use_bias=False`), computed at `dtype`. `padding` is
    the pixels added on each side (flax's int padding)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, groups: int = 1, dtype: torch.dtype = torch.float32,
                 kernel_init: Callable = tinit.lecun_normal_, use_bias: bool = True):
        super().__init__()
        self.compute_dtype = dtype
        self.kernel_init = kernel_init
        self.stride, self.padding, self.groups = stride, padding, groups
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels // groups,
                                               kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels)) if use_bias else None

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.kernel_init(self.weight, generator=generator)
        if self.bias is not None:
            tinit.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = self.bias.to(dt) if self.bias is not None else None
        return F.conv2d(x.to(dt), self.weight.to(dt), bias, self.stride, self.padding,
                        groups=self.groups)


class ConvTranspose(nn.Module):
    """flax `ConvTranspose(features, (k, k), strides=(s, s), padding="SAME",
    dtype=...)` over NCHW, for even k = 2 s: weight IOHW `[in, out, k, k]` in
    f32, lecun-normal over flax's fan in (k k in) and a zero bias. flax does
    not flip its kernel (`transpose_kernel=False`): its kernel HWIO is this
    weight flipped in H and W (`utils.convert` maps one to the other)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 4,
                 stride: int = 2, dtype: torch.dtype = torch.float32):
        super().__init__()
        if kernel_size != 2 * stride:
            raise NotImplementedError("ConvTranspose: SAME padding is ported for k = 2 s only")
        self.compute_dtype = dtype
        self.stride, self.padding = stride, (kernel_size - stride) // 2
        self.weight = nn.Parameter(torch.empty(in_channels, out_channels,
                                               kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        fan_in = self.weight.shape[0] * self.weight.shape[2] * self.weight.shape[3]
        std = (1.0 / fan_in) ** 0.5 / tinit._TRUNC_STD_2
        torch.nn.init.trunc_normal_(self.weight, 0.0, std, -2.0 * std, 2.0 * std,
                                    generator=generator)
        tinit.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.conv_transpose2d(x.to(dt), self.weight.to(dt), self.bias.to(dt), self.stride,
                                  self.padding)


class LayerNorm(nn.LayerNorm):
    """flax `LayerNorm(dtype=...)`: statistics and affine in f32 (f64 for a
    model run in f64), output at `dtype`."""

    def __init__(self, dim: int, eps: float = 1e-6, dtype: torch.dtype = torch.float32):
        self.compute_dtype = dtype
        super().__init__(dim, eps=eps)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        tinit.ones_(self.weight)
        tinit.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.promote_types(x.dtype, self.weight.dtype))
        y = F.layer_norm(x, self.normalized_shape, self.weight, self.bias, self.eps)
        return y.to(self.compute_dtype)


class DropPath(nn.Module):
    """Stochastic depth per sample; the identity in eval mode.

    As the JAX `DropPath` draws from the step's `dropout` stream, this one
    draws from an explicit `torch.Generator` on the tensor's device, handed
    down by the caller (the train state owns and checkpoints it), and never
    from the global RNG: in training with `rate > 0` a generator is required.
    """

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def draw(self, x: torch.Tensor, generator: Optional[torch.Generator]) -> Optional[torch.Tensor]:
        """The per-sample uniforms `forward` keeps by, or None where it is the identity."""
        if not self.training or self.rate == 0.0:
            return None
        if generator is None:
            raise ValueError("DropPath: training with rate > 0 needs an explicit torch.Generator")
        shape = (x.shape[0],) + (1,) * (x.dim() - 1)
        return torch.rand(shape, generator=generator, device=x.device)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                draw: Optional[torch.Tensor] = None) -> torch.Tensor:
        """`draw`, where given, stands in for this call's uniforms (a block
        recomputed under activation checkpointing replays its first draws)."""
        if not self.training or self.rate == 0.0:
            return x
        if draw is None:
            draw = self.draw(x, generator)
        keep = 1.0 - self.rate
        return torch.where(draw < keep, x / keep, torch.zeros_like(x))


class Mlp(nn.Module):
    """fc1 -> tanh GELU -> fc2, xavier-uniform kernels (no dropout: serving only)."""

    def __init__(self, in_features: int, hidden_features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = Dense(in_features, hidden_features, dtype, kernel_init=tinit.xavier_uniform_)
        self.fc2 = Dense(hidden_features, in_features, dtype, kernel_init=tinit.xavier_uniform_)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(gelu(self.fc1(x)))


class PatchEmbed(nn.Module):
    """Image NHWC -> patch tokens [n, h*w, c] via a strided conv (NCHW inside)."""

    def __init__(self, patch_size: int = 16, embed_dim: int = 768, in_chans: int = 3,
                 dtype: torch.dtype = torch.float32, kernel_init: Callable = tinit.xavier_uniform_):
        super().__init__()
        self.proj = Conv2d(in_chans, embed_dim, patch_size, patch_size, dtype=dtype,
                           kernel_init=kernel_init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.proj(x.permute(0, 3, 1, 2))  # NHWC -> NCHW
        return x.flatten(2).transpose(1, 2)  # [n, c, h, w] -> [n, h*w, c]


class Attention(nn.Module):
    """Multi-head self-attention with a fused qkv projection (flax names
    `qkv`, `proj`); `attn_impl` einsum, flash or auto, resolved per call by
    `ops.attention.resolve_attn_impl`. Dropout is refused: no config on the
    port's paths sets it."""

    def __init__(self, dim: int, num_heads: int = 8, qkv_bias: bool = False,
                 qk_scale: Optional[float] = None, attn_drop: float = 0.0, proj_drop: float = 0.0,
                 dtype: torch.dtype = torch.float32, softmax_dtype: torch.dtype = torch.float32,
                 attn_impl: str = "einsum"):
        super().__init__()
        if attn_drop or proj_drop:
            raise NotImplementedError("Attention: attention and projection dropout are not "
                                      "ported yet")
        if attn_impl not in ("einsum", "flash", "auto"):
            raise ValueError(f"unknown attn_impl {attn_impl!r}")
        self.num_heads = num_heads
        self.scale = qk_scale or (dim // num_heads) ** -0.5
        self.dtype = dtype
        self.softmax_dtype = softmax_dtype
        self.attn_impl = attn_impl
        self.qkv = Dense(dim, 3 * dim, dtype, kernel_init=tinit.xavier_uniform_, use_bias=qkv_bias)
        self.proj = Dense(dim, dim, dtype, kernel_init=tinit.xavier_uniform_)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, l, c = x.shape
        h = self.num_heads
        qkv = self.qkv(x).reshape(n, l, 3, h, c // h)
        q, k, v = qkv.unbind(2)  # [n, l, h, d] views: the flash kernels read them in place
        impl = resolve_attn_impl(self.attn_impl, l, 0.0, not self.training)
        out = multi_head_attention(q, k, v, self.scale, impl=impl,
                                   softmax_dtype=self.softmax_dtype, out_dtype=self.dtype)
        return self.proj(out)


class Block(nn.Module):
    """Pre-norm transformer block (flax names `norm1`, `attn`, `norm2`, `mlp`,
    and `gamma_1`, `gamma_2` when `init_values` asks for LayerScale, kept in
    f32). In training, `generator` draws the stochastic-depth masks."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0, qkv_bias: bool = False,
                 qk_scale: Optional[float] = None, drop: float = 0.0, attn_drop: float = 0.0,
                 drop_path: float = 0.0, init_values: Optional[float] = None,
                 norm_eps: float = 1e-6, dtype: torch.dtype = torch.float32,
                 softmax_dtype: torch.dtype = torch.float32, attn_impl: str = "einsum"):
        super().__init__()
        if drop:
            raise NotImplementedError("Block: dropout (drop_rate) is not ported yet")
        self.init_values = init_values
        self.norm1 = LayerNorm(dim, eps=norm_eps, dtype=dtype)
        self.attn = Attention(dim, num_heads, qkv_bias, qk_scale, attn_drop, drop, dtype,
                              softmax_dtype, attn_impl)
        self.drop_path1 = DropPath(drop_path)
        self.norm2 = LayerNorm(dim, eps=norm_eps, dtype=dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype=dtype)
        self.drop_path2 = DropPath(drop_path)
        if init_values is not None:
            self.gamma_1 = nn.Parameter(torch.empty(dim))
            self.gamma_2 = nn.Parameter(torch.empty(dim))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        if self.init_values is not None:
            tinit.constant_(self.gamma_1, self.init_values)
            tinit.constant_(self.gamma_2, self.init_values)

    def draw(self, x: torch.Tensor, generator: Optional[torch.Generator]) -> tuple:
        """The stochastic-depth uniforms of one forward on `x`, in the order the
        forward draws them (each None where its DropPath is the identity)."""
        return self.drop_path1.draw(x, generator), self.drop_path2.draw(x, generator)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                draws: Optional[tuple] = None) -> torch.Tensor:
        d1, d2 = draws if draws is not None else (None, None)
        y = self.attn(self.norm1(x))
        if self.init_values is not None:
            y = y * self.gamma_1
        x = x + self.drop_path1(y, generator, d1)
        y = self.mlp(self.norm2(x))
        if self.init_values is not None:
            y = y * self.gamma_2
        return x + self.drop_path2(y, generator, d2)

"""CLIP: contrastive language-image pretraining, two towers (counterpart of
`passl_tpu/models/clip.py`).

`ResidualAttentionBlock` (JAX `:33-58`): LayerNorm `ln_1` (eps 1e-5), one
`attn_qkv` Dense, the scores `q (c / h)^-0.5 k^T` in f32, with the causal
`-inf` upper triangle added in f32 on the text tower, the softmax in f32 and
cast to the compute dtype, times v; `attn_out`; then `ln_2`, `mlp_fc`,
`quick_gelu` and `mlp_proj`. Plain products, as the port's einsum attention:
the JAX model attends with its own einsums, never the flash kernels.

`CLIPVisionTransformer` (JAX `:61-96`): a bias-free patch convolution, the raw
`class_embedding` and `positional_embedding` parameters (normal of std
width^-0.5), `ln_pre`, the blocks, `ln_post` on token 0 and the raw `proj`
matrix `[width, out_dim]`, used as `x @ proj`.

`ModifiedResNet` (JAX `:126-166`): the three-convolution stem and a 2 x 2
average pool; bottlenecks that average-pool where the stride is 2, on the
main and the down branch alike; flax BatchNorm (momentum 0.9, eps 1e-5,
`nn.norm.BatchNorm`); and `AttentionPool2d` (JAX `:99-123`), whose one query
is the mean token, with a learned position embedding of h w + 1 entries.
Images are NHWC at the input; the convolutions run on NCHW in channels-last
memory, as `models/resnet.py`'s do.

`CLIP` (JAX `:169-254`): the token embedding (`token_embedding.embedding`,
normal 0.02), the text `positional_embedding` (normal 0.01), the causal
`transformer_resblocks`, `ln_final`, the feature at each sequence's first
largest token id (the EOT, `jnp.argmax`'s first maximum), `text_projection`;
`logit_scale` starts at ln(1 / 0.07) and is clamped at ln 100 before `exp`
by `torch.minimum`, whose gradient splits at a tie as `jnp.clip`'s (a
`jnp.minimum`) does, where `torch.clamp` would pass all of it. The loss is
the symmetric cross-entropy over the l2-normalised f32 features (f64 for a
model run in f64): `{"loss", "acc1", "logit_scale"}` in training, the
image-to-text logits in eval. `encode_image` and `encode_text` are methods.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..core.amp import at_least_f32, resolve_dtype
from ..nn import init as tinit
from ..nn.layers import Dense, LayerNorm
from ..nn.norm import BatchNorm, l2_normalize
from .base import MODELS, register_model

DtypeLike = Union[str, torch.dtype]


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
            dtype: torch.dtype, causal: bool = False) -> torch.Tensor:
    """[n, lq, h, d] q and [n, lk, h, d] k, v -> [n, lq, h * d] at `dtype`: the
    scores of (q scale) and k in f32 (an einsum with preferred_element_type;
    f64 for a model run in f64), the causal mask added there, the softmax
    there, cast to `dtype` and times v."""
    n, lq, h, d = q.shape
    st = torch.promote_types(dtype, torch.float32)
    qs = (q * scale).transpose(1, 2).to(st)
    attn = torch.matmul(qs, k.transpose(1, 2).to(st).transpose(-1, -2))
    if causal:
        lk = k.shape[1]
        attn = attn + torch.full((lq, lk), float("-inf"), dtype=st, device=attn.device).triu(1)
    attn = torch.softmax(attn, dim=-1).to(dtype)
    out = torch.matmul(attn, v.transpose(1, 2).to(dtype))  # [n, h, lq, d]
    return out.transpose(1, 2).reshape(n, lq, h * d)


class ResidualAttentionBlock(nn.Module):
    """[n, l, c] -> [n, l, c] at `dtype` (flax names `ln_1`, `attn_qkv`,
    `attn_out`, `ln_2`, `mlp_fc`, `mlp_proj`)."""

    def __init__(self, width: int, num_heads: int, causal: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.causal = causal
        self.compute_dtype = dtype
        self.ln_1 = LayerNorm(width, eps=1e-5, dtype=dtype)
        self.attn_qkv = Dense(width, 3 * width, dtype)
        self.attn_out = Dense(width, width, dtype)
        self.ln_2 = LayerNorm(width, eps=1e-5, dtype=dtype)
        self.mlp_fc = Dense(width, 4 * width, dtype)
        self.mlp_proj = Dense(4 * width, width, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, l, c = x.shape
        h = self.num_heads
        q, k, v = self.attn_qkv(self.ln_1(x)).reshape(n, l, 3, h, c // h).unbind(2)
        y = _attend(q, k, v, (c // h) ** -0.5, self.compute_dtype, self.causal)
        x = x + self.attn_out(y)
        return x + self.mlp_proj(quick_gelu(self.mlp_fc(self.ln_2(x))))


class _Conv(nn.Conv2d):
    """flax `Conv(padding=k // 2 or "VALID", use_bias=..., dtype=...)` on NCHW:
    an f32 OIHW kernel at flax's default init (lecun-normal), computed at `dtype`."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, bias: bool = False, dtype: torch.dtype = torch.float32):
        self.compute_dtype = dtype
        super().__init__(in_channels, out_channels, kernel_size, stride, padding, bias=bias)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        tinit.lecun_normal_(self.weight, generator=generator)
        if self.bias is not None:
            tinit.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = self.bias.to(dt) if self.bias is not None else None
        return F.conv2d(x.to(dt), self.weight.to(dt), bias, self.stride, self.padding)


def _normal(std: float):
    def init(t: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return tinit.normal_(t, std=std, generator=generator)

    return init


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC -> NCHW in channels-last memory (a view of a contiguous input)."""
    return x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


class CLIPVisionTransformer(nn.Module):
    """images [n, H, W, 3] NHWC -> [n, out_dim] (or [n, width] without `proj`)."""

    def __init__(self, img_size: int = 224, patch_size: int = 32, width: int = 768,
                 depth: int = 12, num_heads: int = 12, out_dim: int = 512,
                 patch_bias: bool = False, pre_norm: bool = True, proj: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.width = width
        self.conv1 = _Conv(3, width, patch_size, patch_size, bias=patch_bias, dtype=dtype)
        grid = img_size // patch_size
        self.class_embedding = nn.Parameter(torch.empty(width))
        self.positional_embedding = nn.Parameter(torch.empty(grid * grid + 1, width))
        self.ln_pre = LayerNorm(width, eps=1e-5, dtype=dtype) if pre_norm else None
        self.resblocks = nn.ModuleList(ResidualAttentionBlock(width, num_heads, dtype=dtype)
                                       for _ in range(depth))
        self.ln_post = LayerNorm(width, eps=1e-5, dtype=dtype)
        self.proj = nn.Parameter(torch.empty(width, out_dim)) if proj else None

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        init = _normal(self.width ** -0.5)
        for p in (self.class_embedding, self.positional_embedding, self.proj):
            if p is not None:
                init(p, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = x.shape[0]
        x = self.conv1(x.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)  # [n, gh * gw, width]
        cls = self.class_embedding.to(x.dtype).expand(n, 1, -1)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(x.dtype)
        if self.ln_pre is not None:
            x = self.ln_pre(x)
        for blk in self.resblocks:
            x = blk(x)
        x = self.ln_post(x[:, 0])
        return x @ self.proj.to(x.dtype) if self.proj is not None else x


class AttentionPool2d(nn.Module):
    """[n, c, h, w] -> [n, out_dim]: one query, the mean token, over the h w
    tokens and itself, each with a learned position embedding."""

    def __init__(self, grid: int, channels: int, num_heads: int, out_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.compute_dtype = dtype
        self.positional_embedding = nn.Parameter(torch.empty(grid * grid + 1, channels))
        self.q_proj = Dense(channels, channels, dtype)
        self.k_proj = Dense(channels, channels, dtype)
        self.v_proj = Dense(channels, channels, dtype)
        self.c_proj = Dense(channels, out_dim, dtype)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        _normal(self.positional_embedding.shape[1] ** -0.5)(self.positional_embedding, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c = x.shape[:2]
        x = x.flatten(2).transpose(1, 2)  # [n, h * w, c], the tokens in NHWC's order
        x = torch.cat([x.mean(dim=1, keepdim=True), x], dim=1)
        x = x + self.positional_embedding.to(x.dtype)
        hn = self.num_heads
        q = self.q_proj(x[:, :1]).reshape(n, 1, hn, c // hn)
        k = self.k_proj(x).reshape(n, -1, hn, c // hn)
        v = self.v_proj(x).reshape(n, -1, hn, c // hn)
        out = _attend(q, k, v, (c // hn) ** -0.5, self.compute_dtype).reshape(n, c)
        return self.c_proj(out)


class ModifiedResNet(nn.Module):
    """images [n, H, W, 3] NHWC -> [n, out_dim] (flax names `conv1`..`bn3`,
    `layer{i}_{j}_{conv,bn}{1,2,3}`, `layer{i}_{j}_{conv,bn}_down`, `attnpool`)."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3), width: int = 64, out_dim: int = 512,
                 num_heads: int = 32, img_size: int = 224, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.blocks_of = []  # per bottleneck: (name, stride, has a down branch)

        def conv_bn(name: str, cin: int, cout: int, k: int, s: int = 1, bn: str = "") -> None:
            self.add_module(name.format("conv"), _Conv(cin, cout, k, s, k // 2, dtype=dtype))
            self.add_module(name.format("bn"), BatchNorm(cout, momentum=0.9, epsilon=1e-5,
                                                         dtype=dtype))

        conv_bn("{}1", 3, width // 2, 3, 2)
        conv_bn("{}2", width // 2, width // 2, 3)
        conv_bn("{}3", width // 2, width, 3)
        channels, filters = width, width
        for i, nblocks in enumerate(layers):
            for j in range(nblocks):
                name = f"layer{i + 1}_{j}"
                stride = 2 if (i > 0 and j == 0) else 1
                conv_bn(name + "_{}1", channels, filters, 1)
                conv_bn(name + "_{}2", filters, filters, 3)
                conv_bn(name + "_{}3", filters, filters * 4, 1)
                down = stride > 1 or channels != filters * 4
                if down:
                    conv_bn(name + "_{}_down", channels, filters * 4, 1)
                self.blocks_of.append((name, stride, down))
                channels = filters * 4
            filters *= 2
        grid = img_size // 4 // 2 ** (len(layers) - 1)
        self.attnpool = AttentionPool2d(grid, channels, num_heads, out_dim, dtype)

    def _cbr(self, name: str, x: torch.Tensor, relu: bool = True) -> torch.Tensor:
        y = getattr(self, name.format("bn"))(getattr(self, name.format("conv"))(x))
        return F.relu(y) if relu else y

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _nchw(x)
        for i in (1, 2, 3):
            x = self._cbr("{}" + str(i), x)
        x = F.avg_pool2d(x, 2, 2)
        for name, stride, down in self.blocks_of:
            inp = x
            x = self._cbr(name + "_{}1", x)
            x = self._cbr(name + "_{}2", x)
            if stride > 1:
                x = F.avg_pool2d(x, stride, stride)
            x = self._cbr(name + "_{}3", x, relu=False)
            if down:
                if stride > 1:
                    inp = F.avg_pool2d(inp, stride, stride)
                inp = self._cbr(name + "_{}_down", inp, relu=False)
            x = F.relu(x + inp)
        return self.attnpool(x)


class _Embed(nn.Module):
    """flax `nn.Embed(num, features, dtype=...)`: the f32 table `embedding`
    [num, features], rows gathered at `dtype`."""

    def __init__(self, num: int, features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        self.embedding = nn.Parameter(torch.empty(num, features))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        tinit.normal_(self.embedding, std=0.02, generator=generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.embedding).to(self.compute_dtype)


@register_model
class CLIP(nn.Module):
    """batch {"image": [N, H, W, 3], "text": [N, L] int} (or the pair) ->
    {"loss", "acc1", "logit_scale"} in training, logits [N, N] in eval."""

    def __init__(self, embed_dim: int = 512, image_resolution: int = 224,
                 vision_layers: Union[int, Sequence[int]] = 12, vision_width: int = 768,
                 vision_patch_size: int = 32, pre_norm: bool = True, proj: bool = True,
                 patch_bias: bool = False, context_length: int = 77, vocab_size: int = 49408,
                 transformer_width: int = 512, transformer_heads: int = 8,
                 transformer_layers: int = 12, dtype: DtypeLike = torch.float32):
        super().__init__()
        dtype = resolve_dtype(dtype)
        self.transformer_width = transformer_width
        if isinstance(vision_layers, (tuple, list)):
            self.visual = ModifiedResNet(tuple(vision_layers), vision_width, embed_dim,
                                         vision_width * 32 // 64, image_resolution, dtype)
        else:
            self.visual = CLIPVisionTransformer(
                image_resolution, vision_patch_size, vision_width, int(vision_layers),
                max(1, vision_width // 64), embed_dim, patch_bias, pre_norm, proj, dtype)
        self.token_embedding = _Embed(vocab_size, transformer_width, dtype)
        self.positional_embedding = nn.Parameter(torch.empty(context_length, transformer_width))
        self.transformer_resblocks = nn.ModuleList(
            ResidualAttentionBlock(transformer_width, transformer_heads, causal=True, dtype=dtype)
            for _ in range(transformer_layers))
        self.ln_final = LayerNorm(transformer_width, eps=1e-5, dtype=dtype)
        self.text_projection = nn.Parameter(torch.empty(transformer_width, embed_dim))
        self.logit_scale = nn.Parameter(torch.empty(1))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        tinit.normal_(self.positional_embedding, std=0.01, generator=generator)
        tinit.normal_(self.text_projection, std=self.transformer_width ** -0.5,
                      generator=generator)
        tinit.constant_(self.logit_scale, math.log(1 / 0.07))

    def encode_image(self, image: torch.Tensor) -> torch.Tensor:
        return self.visual(image)

    def encode_text(self, text: torch.Tensor) -> torch.Tensor:
        x = self.token_embedding(text)
        x = x + self.positional_embedding.to(x.dtype)
        for blk in self.transformer_resblocks:
            x = blk(x)
        x = self.ln_final(x)
        eot = torch.argmax(text, dim=-1)  # the first maximum, as jnp.argmax
        x = x[torch.arange(x.shape[0], device=x.device), eot]
        return x @ self.text_projection.to(x.dtype)

    def forward(self, batch, generator: Optional[torch.Generator] = None):
        image, text = (batch["image"], batch["text"]) if isinstance(batch, dict) else batch
        img_f = l2_normalize(at_least_f32(self.encode_image(image)), dim=-1)
        txt_f = l2_normalize(at_least_f32(self.encode_text(text)), dim=-1)
        ls = self.logit_scale.to(img_f.dtype)
        scale = torch.exp(torch.minimum(ls, torch.tensor(math.log(100.0), dtype=ls.dtype,
                                                         device=ls.device)))
        logits_i = (scale * img_f) @ txt_f.T
        if not self.training:
            return logits_i
        labels = torch.arange(logits_i.shape[0], device=logits_i.device)
        loss = 0.5 * (F.cross_entropy(logits_i, labels) + F.cross_entropy(logits_i.T, labels))
        acc = (logits_i.argmax(dim=-1) == labels).to(loss.dtype).mean()
        return {"loss": loss, "acc1": acc, "logit_scale": scale[0]}


_CLIP_VARIANTS = {
    "CLIP_vit_base_patch32_224": dict(embed_dim=512, vision_layers=12, vision_width=768,
                                      vision_patch_size=32),
    "CLIP_vit_base_patch16_224": dict(embed_dim=512, vision_layers=12, vision_width=768,
                                      vision_patch_size=16),
    "CLIP_r50": dict(embed_dim=1024, vision_layers=(3, 4, 6, 3), vision_width=64),
}


def _clip_variant(name: str, defaults: dict) -> None:
    def factory(**kw) -> CLIP:
        return CLIP(**{**defaults, **kw})  # the caller's keywords win, as in JAX

    factory.__name__ = name
    MODELS.register(factory, name=name)


for _name, _cfg in _CLIP_VARIANTS.items():
    _clip_variant(_name, _cfg)

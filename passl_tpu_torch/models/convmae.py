"""ConvMAE: the convolution-stem masked autoencoder and its finetune ConvViT
(counterpart of `passl_tpu/models/convmae.py`).

Three stages: two convolution stages of `CBlock`s (JAX `:42-62`: norm1, a
1 x 1 `conv1`, the visibility mask, a 5 x 5 depthwise `attn`, a 1 x 1
`conv2`, then norm2 and the 1 x 1 `CMlp`, each branch through stochastic
depth) over the strided patch embeddings `patch_embed1` (p1) and
`patch_embed2` (p2), and a transformer stage (`patch_embed3`, p3, then the
Dense `patch_embed4`, the fixed sin-cos table, the ViT `Block`s `blocks3`).
Tensors are NHWC as in the JAX package; the spatial convs run NCHW inside.

`MaskedAutoencoderConvViT` (JAX `:65-183`): the mask is decided on the
stage-3 grid from noise as MAE's (`mae.masking_noise`, looked up at call
time: in training from the generator the train step hands over, in eval from
a generator seeded with 0), kept patches first in ascending noise. Its
visibility at the stage-1 and stage-2 grids is the nearest-neighbour repeat
of the stage-3 grid (`vis1`, `vis2`), applied in every `CBlock` after
`conv1` and before the depthwise conv, so a masked patch never mixes into a
visible one. The stage-1 and stage-2 outputs, strided down to the stage-3
grid (`stage1_output_decode`, `stage2_output_decode`), are kept at the
visible patches and added after the transformer stage, which runs over the
visible patches only. Then `norm` and MAE's decoder (no class token): the
`decoder_embed`, `mask_token` (normal 0.02) at the masked patches, the
unshuffle, its own sin-cos table, `decoder_blocks`, `decoder_norm`,
`decoder_pred`; the loss is MAE's norm-pix mean squared error over the
masked patches (`mae.patchify`, f32).

`ConvViT` (JAX `:186-217`): the three stages over the whole image with the
stochastic-depth rates `linspace(0, drop_path_rate, sum(depths))`; the mean
of the tokens and `fc_norm` (or, without `global_pool`, `norm` and the
first token), and a `head` (truncated normal 0.02) only where
`num_classes > 0`. Every attention is the JAX model's einsum: no kernel.
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from ..core.amp import at_least_f32, resolve_dtype
from ..nn import init as tinit
from ..nn.layers import Block, Conv, Conv1x1, Dense, DropPath, LayerNorm, gelu
from . import mae
from .base import MODELS, register_model
from .utils import FixedTable
from .utils.pos_embed import get_2d_sincos_pos_embed

DtypeLike = Union[str, torch.dtype]


def _nchw(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """An NCHW conv over an NHWC tensor, NHWC out."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class CMlp(nn.Module):
    """1 x 1 `fc1`, tanh gelu, 1 x 1 `fc2`, over the channels of NHWC."""

    def __init__(self, dim: int, hidden: int, dtype: torch.dtype):
        super().__init__()
        self.fc1 = Conv1x1(dim, hidden, dtype)
        self.fc2 = Conv1x1(hidden, dim, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(gelu(self.fc1(x)))


class CBlock(nn.Module):
    """x += dp(conv2(dwconv(vis * conv1(ln(x))))); x += dp(cmlp(ln(x))), NHWC."""

    def __init__(self, dim: int, drop_path: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=1e-6, dtype=dtype)
        self.conv1 = Conv1x1(dim, dim, dtype)
        self.attn = Conv(dim, dim, 5, padding=2, groups=dim, dtype=dtype)
        self.conv2 = Conv1x1(dim, dim, dtype)
        self.drop_path1 = DropPath(drop_path)
        self.norm2 = LayerNorm(dim, eps=1e-6, dtype=dtype)
        self.mlp = CMlp(dim, 4 * dim, dtype)
        self.drop_path2 = DropPath(drop_path)

    def forward(self, x: torch.Tensor, vis_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        y = self.conv1(self.norm1(x))
        if vis_mask is not None:
            y = y * vis_mask  # zero the masked patches before the spatial mixing
        y = self.conv2(_nchw(self.attn, y))
        x = x + self.drop_path1(y, generator)
        return x + self.drop_path2(self.mlp(self.norm2(x)), generator)


class _Stages(nn.Module):
    """The three stages' modules (flax names at the model's top level)."""

    def __init__(self, img_size: int, patch_sizes: Sequence[int], embed_dims: Sequence[int],
                 depths: Sequence[int], num_heads: int, mlp_ratio: float, dpr: Sequence[float],
                 dtype: torch.dtype):
        super().__init__()
        p1, p2, p3 = patch_sizes
        e1, e2, e3 = embed_dims
        self.patch_sizes = tuple(patch_sizes)
        self.embed_dims = tuple(embed_dims)
        self.g3 = img_size // (p1 * p2 * p3)
        conv = functools.partial(Conv, dtype=dtype)
        self.patch_embed1 = conv(3, e1, p1, p1)
        self.blocks1 = nn.ModuleList(CBlock(e1, dpr[i], dtype) for i in range(depths[0]))
        self.patch_embed2 = conv(e1, e2, p2, p2)
        self.blocks2 = nn.ModuleList(CBlock(e2, dpr[depths[0] + i], dtype)
                                     for i in range(depths[1]))
        self.patch_embed3 = conv(e2, e3, p3, p3)
        self.patch_embed4 = Dense(e3, e3, dtype)
        self.pos_embed = FixedTable(get_2d_sincos_pos_embed(e3, self.g3)[None])
        self.blocks3 = nn.ModuleList(
            Block(e3, num_heads, mlp_ratio, qkv_bias=True, drop_path=dpr[depths[0] + depths[1] + i],
                  dtype=dtype) for i in range(depths[2]))
        self.out_channels = e3

    def _tokens(self, x: torch.Tensor) -> torch.Tensor:
        """The stage-2 output [N, h, w, e2] -> the stage-3 tokens plus the table."""
        x = _nchw(self.patch_embed3, x)
        x = self.patch_embed4(x.reshape(x.shape[0], -1, x.shape[-1]))
        return x + self.pos_embed.on(x.device).to(x.dtype)


@register_model
class MaskedAutoencoderConvViT(_Stages):
    """images [N, H, W, 3] NHWC (or the loader's (images, labels)) ->
    {"loss": scalar f32}."""

    def __init__(self, img_size: int = 224, patch_sizes: Sequence[int] = (4, 2, 2),
                 embed_dims: Sequence[int] = (256, 384, 768), depths: Sequence[int] = (2, 2, 11),
                 num_heads: int = 12, decoder_embed_dim: int = 512, decoder_depth: int = 8,
                 decoder_num_heads: int = 16, mlp_ratio: float = 4.0, mask_ratio: float = 0.75,
                 norm_pix_loss: bool = True, dtype: DtypeLike = torch.float32):
        dtype = resolve_dtype(dtype)
        super().__init__(img_size, patch_sizes, embed_dims, depths, num_heads, mlp_ratio,
                         [0.0] * sum(depths), dtype)
        p1, p2, p3 = patch_sizes
        e1, e2, e3 = embed_dims
        self.mask_ratio = mask_ratio
        self.norm_pix_loss = norm_pix_loss
        self.stage1_output_decode = Conv(e1, e3, p2 * p3, p2 * p3, dtype=dtype)
        self.stage2_output_decode = Conv(e2, e3, p3, p3, dtype=dtype)
        self.norm = LayerNorm(e3, eps=1e-6, dtype=dtype)
        self.decoder_embed = Dense(e3, decoder_embed_dim, dtype)
        self.mask_token = nn.Parameter(torch.empty(1, 1, decoder_embed_dim))
        self.decoder_pos_embed = FixedTable(
            get_2d_sincos_pos_embed(decoder_embed_dim, self.g3)[None])
        self.decoder_blocks = nn.ModuleList(
            Block(decoder_embed_dim, decoder_num_heads, mlp_ratio, qkv_bias=True, dtype=dtype)
            for _ in range(decoder_depth))
        self.decoder_norm = LayerNorm(decoder_embed_dim, eps=1e-6, dtype=dtype)
        total = p1 * p2 * p3
        self.decoder_pred = Dense(decoder_embed_dim, total * total * 3, dtype)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        tinit.normal_(self.mask_token, std=0.02, generator=generator)

    def forward(self, batch, generator: Optional[torch.Generator] = None) -> dict:
        imgs = batch[0] if isinstance(batch, (tuple, list)) else batch
        if self.training:
            if generator is None:
                raise ValueError("MaskedAutoencoderConvViT: training draws its masks from the "
                                 "train state's generator; none was given")
        else:
            generator = torch.Generator(device=imgs.device).manual_seed(mae.EVAL_SEED)
        n = imgs.shape[0]
        p1, p2, p3 = self.patch_sizes
        g3, l3 = self.g3, self.g3 * self.g3

        # the mask, decided on the stage-3 grid (MAE's argsort of noise)
        len_keep = int(l3 * (1 - self.mask_ratio))
        noise = mae.masking_noise(n, l3, generator, imgs.device)
        ids_shuffle = torch.argsort(noise, dim=1, stable=True)
        ids_restore = torch.argsort(ids_shuffle, dim=1, stable=True)
        ids_keep = ids_shuffle[:, :len_keep]
        mask = torch.ones(n, l3, device=imgs.device)
        mask[:, :len_keep] = 0
        mask = torch.gather(mask, 1, ids_restore)
        vis3 = (1.0 - mask).reshape(n, g3, g3, 1)
        vis1 = vis3.repeat_interleave(p2 * p3, 1).repeat_interleave(p2 * p3, 2)
        vis2 = vis3.repeat_interleave(p3, 1).repeat_interleave(p3, 2)

        def keep(t: torch.Tensor) -> torch.Tensor:
            return torch.gather(t, 1, ids_keep[:, :, None].expand(-1, -1, t.shape[-1]))

        x = _nchw(self.patch_embed1, imgs)
        for blk in self.blocks1:
            x = blk(x, vis1.to(x.dtype), generator)
        s1 = keep(_nchw(self.stage1_output_decode, x).reshape(n, l3, -1))
        x = _nchw(self.patch_embed2, x)
        for blk in self.blocks2:
            x = blk(x, vis2.to(x.dtype), generator)
        s2 = keep(_nchw(self.stage2_output_decode, x).reshape(n, l3, -1))
        x = keep(self._tokens(x))
        for blk in self.blocks3:
            x = blk(x, generator)
        x = self.norm(x + s1 + s2)

        # the decoder, over every patch (no class token)
        x = self.decoder_embed(x)
        c = x.shape[-1]
        x = torch.cat([x, self.mask_token.to(x.dtype).expand(n, l3 - x.shape[1], -1)], dim=1)
        x = torch.gather(x, 1, ids_restore[:, :, None].expand(-1, -1, c))
        x = x + self.decoder_pos_embed.on(x.device).to(x.dtype)
        for blk in self.decoder_blocks:
            x = blk(x, generator)
        pred = at_least_f32(self.decoder_pred(self.decoder_norm(x)))

        target = mae.patchify(imgs.to(pred.dtype), p1 * p2 * p3)
        if self.norm_pix_loss:
            mean = target.mean(dim=-1, keepdim=True)
            var = target.var(dim=-1, keepdim=True, unbiased=False)
            target = (target - mean) / torch.sqrt(var + 1e-6)
        loss = torch.mean(torch.square(pred - target), dim=-1)
        mask = mask.to(loss.dtype)
        return {"loss": torch.sum(loss * mask) / torch.sum(mask)}


@register_model
class ConvViT(_Stages):
    """images [N, H, W, 3] -> logits [N, num_classes], or at num_classes 0 the
    features [N, embed_dims[2]]."""

    def __init__(self, img_size: int = 224, patch_sizes: Sequence[int] = (4, 2, 2),
                 embed_dims: Sequence[int] = (256, 384, 768), depths: Sequence[int] = (2, 2, 11),
                 num_heads: int = 12, mlp_ratio: float = 4.0, drop_path_rate: float = 0.0,
                 num_classes: int = 1000, global_pool: bool = True,
                 dtype: DtypeLike = torch.float32):
        dtype = resolve_dtype(dtype)
        dpr = [float(r) for r in np.linspace(0, drop_path_rate, sum(depths))]
        super().__init__(img_size, patch_sizes, embed_dims, depths, num_heads, mlp_ratio, dpr,
                         dtype)
        e3 = embed_dims[2]
        self.global_pool = global_pool
        if global_pool:
            self.fc_norm = LayerNorm(e3, eps=1e-6, dtype=dtype)
        else:
            self.norm = LayerNorm(e3, eps=1e-6, dtype=dtype)
        self.head = (Dense(e3, num_classes, dtype,
                           kernel_init=functools.partial(tinit.trunc_normal_, std=0.02))
                     if num_classes > 0 else None)
        if num_classes > 0:
            self.out_channels = num_classes

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        x = _nchw(self.patch_embed1, x)
        for blk in self.blocks1:
            x = blk(x, None, generator)
        x = _nchw(self.patch_embed2, x)
        for blk in self.blocks2:
            x = blk(x, None, generator)
        x = self._tokens(x)
        for blk in self.blocks3:
            x = blk(x, generator)
        x = self.fc_norm(x.mean(dim=1)) if self.global_pool else self.norm(x)[:, 0]
        return self.head(x) if self.head is not None else x


def _register(name: str, cls, **defaults):
    def factory(**kw):
        return cls(**{**defaults, **kw})

    factory.__name__ = name
    MODELS.register(factory, name=name)


_register("convmae_convvit_base_patch16", MaskedAutoencoderConvViT,
          embed_dims=(256, 384, 768), depths=(2, 2, 11), num_heads=12,
          decoder_embed_dim=512, decoder_depth=8, decoder_num_heads=16)
_register("convvit_base_patch16", ConvViT,
          embed_dims=(256, 384, 768), depths=(2, 2, 11), num_heads=12)

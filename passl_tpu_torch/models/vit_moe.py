"""Vision Transformer with mixture-of-experts MLPs, V-MoE (counterpart of
`passl_tpu/models/vit_moe.py`).

Every `moe_interval`-th block (block i with i % moe_interval ==
moe_interval - 1) is a `BlockMoE`, whose MLP is a routed expert mixture
(`nn.moe.MoEMlp`); the others are the ViT's `Block`. As in JAX the blocks
take no `attn_impl` from the model, so V-MoE's attention is einsum (MoCo v3
over a V-MoE encoder passes its own, `models/mocov3.py`).

In training the model returns {"logits", "moe_aux_loss", "moe_balance"}: the
sum of the MoE blocks' auxiliary losses (their `moe_aux_loss` and, with
`z_weight > 0`, `moe_z_loss`) and the mean of their balances; the train
step adds every `*loss*` entry to the objective (`engine/steps.py`). In eval
it returns plain logits. In backbone mode (`return_features` or
`num_classes=0`) the features take the logits' place.

`optimizer_overrides` exempts the stacked expert biases (2-D, so the
engine's one-dimensional exemption misses them) from weight decay, with the
JAX package's regex over the flax path.

Not ported yet, and refused: dropout (`drop_rate`, `attn_drop_rate`).
"""
from __future__ import annotations

import functools
from typing import Optional, Union

import numpy as np
import torch
from torch import nn

from ..core.amp import resolve_dtype
from ..nn import init as tinit
from ..nn.layers import Attention, Block, Dense, DropPath, LayerNorm, PatchEmbed
from ..nn.moe import MoEMlp
from .base import MODELS, register_model

DtypeLike = Union[str, torch.dtype]
_trunc02 = functools.partial(tinit.trunc_normal_, std=0.02)


class BlockMoE(nn.Module):
    """Pre-norm transformer block whose MLP is a routed expert mixture (flax
    names `norm1`, `attn`, `norm2`, `moe`): x -> (x, the mixture's aux dict).
    In training, `generator` draws the stochastic-depth masks."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 drop: float = 0.0, attn_drop: float = 0.0, drop_path: float = 0.0,
                 norm_eps: float = 1e-6, num_experts: int = 8, moe_k: int = 2,
                 capacity_factor: float = 1.25, aux_weight: float = 0.01, z_weight: float = 0.0,
                 group_size: int = 256, attn_impl: str = "einsum",
                 dtype: torch.dtype = torch.float32, softmax_dtype: torch.dtype = torch.float32):
        super().__init__()
        if drop:
            raise NotImplementedError("BlockMoE: dropout (drop_rate) is not ported yet")
        self.norm1 = LayerNorm(dim, eps=norm_eps, dtype=dtype)
        self.attn = Attention(dim, num_heads, qkv_bias, None, attn_drop, drop, dtype,
                              softmax_dtype, attn_impl)
        self.drop_path1 = DropPath(drop_path)
        self.norm2 = LayerNorm(dim, eps=norm_eps, dtype=dtype)
        self.moe = MoEMlp(dim, num_experts, moe_k, capacity_factor, int(dim * mlp_ratio),
                          drop, aux_weight, z_weight, group_size)
        self.drop_path2 = DropPath(drop_path)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> tuple:
        x = x + self.drop_path1(self.attn(self.norm1(x)), generator)
        y, aux = self.moe(self.norm2(x))
        return x + self.drop_path2(y, generator), aux


def is_moe_block(i: int, moe_interval: int) -> bool:
    """V-MoE's placement: every `moe_interval`-th block, the last of each run."""
    return i % moe_interval == moe_interval - 1


def run_moe_blocks(blocks, x: torch.Tensor, generator: Optional[torch.Generator]) -> tuple:
    """x through dense and MoE blocks in turn -> (x, {"moe_aux_loss": the sum
    of the MoE blocks' `*loss*` entries, "moe_balance": their mean balance})."""
    aux_losses, balances = [], []
    for blk in blocks:
        if isinstance(blk, BlockMoE):
            x, aux = blk(x, generator)
            aux_losses.append(sum(v for k, v in aux.items() if "loss" in k))
            balances.append(aux["moe_balance"])
        else:
            x = blk(x, generator)
    return x, {"moe_aux_loss": sum(aux_losses), "moe_balance": sum(balances) / max(len(balances), 1)}


@register_model
class VisionTransformerMoE(nn.Module):
    """images [n, H, W, 3] (NHWC) -> in training {"logits", "moe_aux_loss",
    "moe_balance"}, in eval logits [n, num_classes] at `dtype`."""

    def __init__(self, img_size: int = 224, patch_size: int = 16, embed_dim: int = 768,
                 depth: int = 12, num_heads: int = 12, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, drop_rate: float = 0.0, attn_drop_rate: float = 0.0,
                 drop_path_rate: float = 0.0, num_classes: int = 1000, norm_eps: float = 1e-6,
                 softmax_dtype: DtypeLike = "float32", dtype: DtypeLike = torch.float32,
                 num_experts: int = 8, moe_k: int = 2, moe_interval: int = 2,
                 capacity_factor: float = 1.25, aux_weight: float = 0.01, z_weight: float = 0.0,
                 group_size: int = 256):
        super().__init__()
        if drop_rate or attn_drop_rate:
            raise NotImplementedError("V-MoE drop_rate / attn_drop_rate > 0 are not ported yet")
        dtype = resolve_dtype(dtype)
        softmax_dtype = resolve_dtype(softmax_dtype)
        self.img_size = img_size
        self.embed_dim = embed_dim
        self.out_channels = embed_dim
        self.num_classes = num_classes
        self.patch_embed = PatchEmbed(patch_size, embed_dim, dtype=dtype)
        num_patches = (img_size // patch_size) ** 2
        self.cls_token = nn.Parameter(torch.empty(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.empty(1, num_patches + 1, embed_dim))
        dpr = np.linspace(0, drop_path_rate, depth)
        common = dict(mlp_ratio=mlp_ratio, qkv_bias=qkv_bias, norm_eps=norm_eps, dtype=dtype,
                      softmax_dtype=softmax_dtype)
        self.blocks = nn.ModuleList(
            BlockMoE(embed_dim, num_heads, drop_path=float(dpr[i]), num_experts=num_experts,
                     moe_k=moe_k, capacity_factor=capacity_factor, aux_weight=aux_weight,
                     z_weight=z_weight, group_size=group_size, **common)
            if is_moe_block(i, moe_interval) else
            Block(embed_dim, num_heads, drop_path=float(dpr[i]), **common)
            for i in range(depth))
        self.norm = LayerNorm(embed_dim, eps=norm_eps, dtype=dtype)
        if num_classes > 0:
            self.head = Dense(embed_dim, num_classes, dtype=dtype, kernel_init=_trunc02)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        _trunc02(self.cls_token, generator=generator)
        _trunc02(self.pos_embed, generator=generator)

    def optimizer_overrides(self) -> list:
        return [{"name": r"moe/(b1|b2)$", "weight_decay": 0.0}]

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                return_features: bool = False):
        n = x.shape[0]
        x = self.patch_embed(x)
        cls = self.cls_token.to(x.dtype).expand(n, -1, -1)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(x.dtype)
        x, aux = run_moe_blocks(self.blocks, x, generator)
        feats = self.norm(x[:, 0])  # LayerNorm is per token
        if return_features or self.num_classes == 0:
            return {"features": feats, **aux} if self.training else feats
        logits = self.head(feats)
        return {"logits": logits, **aux} if self.training else logits


_VARIANTS = {
    "VMoE_tiny_patch16_224_e8": dict(patch_size=16, embed_dim=192, depth=12, num_heads=3,
                                     num_experts=8),
    "VMoE_small_patch16_224_e8": dict(patch_size=16, embed_dim=384, depth=12, num_heads=6,
                                      num_experts=8),
    "VMoE_base_patch16_224_e8": dict(patch_size=16, embed_dim=768, depth=12, num_heads=12,
                                     num_experts=8),
    "VMoE_base_patch16_224_e16": dict(patch_size=16, embed_dim=768, depth=12, num_heads=12,
                                      num_experts=16),
    "VMoE_large_patch16_224_e16": dict(patch_size=16, embed_dim=1024, depth=24, num_heads=16,
                                       num_experts=16),
}


def _variant(name: str, cfg: dict):
    def factory(**kw) -> VisionTransformerMoE:
        return VisionTransformerMoE(**{**cfg, **kw})

    factory.__name__ = name
    return factory


for _name, _cfg in _VARIANTS.items():
    MODELS.register(_variant(_name, _cfg), name=_name)

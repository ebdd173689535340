"""MoCo v3 (counterpart of `passl_tpu/models/mocov3.py`).

`MoCoV3ViT` (JAX `:43-111`): a ViT whose patch embedding is drawn uniform in
+-sqrt(6 / (3 p^2 + D)) and, with `stop_grad_conv1`, takes no gradient; the
fixed `mocov3_2d_sincos_pos_embed` table (not a parameter); a class token of
std 1e-6; the ViT's blocks with their default init (the JAX file's
`_mocov3_qkv_init` is never called, so the port does what the code does, not
what its docstring says); a LayerNorm, then token 0.

`MoCoV3Pretrain` (JAX `:139-231`): two towers, `base` and `momentum`, each an
encoder, a 3-layer `head` and a 2-layer `predictor` (`_MLPHead`: bias-free
Dense, flax BatchNorm of momentum 0.9 and eps 1e-5 and ReLU, the last
BatchNorm without scale or bias). The queries are the base tower's
predictions of each view, the keys the momentum tower's encoder and head
(without its predictor) under `torch.no_grad()`, in the model's mode: in
training its BatchNorms take the batch statistics and update their own. The
momentum tower's predictor is never run: the JAX engine copies the whole
base tower into the momentum tower before the optimizer is built
(`passl_tpu/engine/engine.py:314-322`) and the EMA then moves that inert
predictor every step, as the port's engine does. The loss is
ctr(q1, k2) + ctr(q2, k1), each 2T times the mean cross-entropy of the
N x N logits of l2-normalised f32 features over T, with `acc1` the share of
q1 whose key k2 leads its row. `ema_map` moves momentum towards base with
the cosine schedule from `base_momentum`; `frozen_patterns` keeps the
optimizer off `momentum`.

`MoCoV3LinearProbe` (JAX `:234-251`): the encoder run in eval under
`torch.no_grad()` and frozen, and a linear head of normal(0.01) weights and
zero bias.

With `num_experts > 0` (JAX `:86-110`) every `moe_interval`-th encoder block
is V-MoE's `BlockMoE` (`models/vit_moe.py`), the encoder's `attn_impl` passed
to every block, dense and MoE alike; in training the encoder returns
{"features", "moe_aux_loss", "moe_balance"}, and the loss takes
0.5 (aux1 + aux2) of the base tower's two forwards (the momentum tower's
routers take no gradient: EMA copies, as its other weights), with
`moe_balance` the two forwards' mean as a metric. `optimizer_overrides`
then exempts the stacked expert biases from weight decay, as V-MoE's.
"""
from __future__ import annotations

import math
from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..core.amp import at_least_f32, resolve_dtype
from ..nn import init as tinit
from ..nn.layers import Block, Dense, LayerNorm, PatchEmbed
from ..nn.norm import BatchNorm, l2_normalize
from .base import register_model, two_views
from .utils import FixedTable
from .vit_moe import BlockMoE, is_moe_block, run_moe_blocks
from .utils.pos_embed import mocov3_2d_sincos_pos_embed

DtypeLike = Union[str, torch.dtype]


class MoCoV3ViT(nn.Module):
    """images [n, H, W, 3] (NHWC) -> features [n, embed_dim] at `dtype`."""

    def __init__(self, img_size: int = 224, patch_size: int = 16, embed_dim: int = 768,
                 depth: int = 12, num_heads: int = 12, mlp_ratio: float = 4.0,
                 stop_grad_conv1: bool = True, softmax_dtype: DtypeLike = "float32",
                 attn_impl: str = "einsum", dtype: DtypeLike = torch.float32,
                 num_experts: int = 0, moe_interval: int = 2, moe_k: int = 2,
                 capacity_factor: float = 1.25, moe_aux_weight: float = 0.01,
                 moe_group_size: int = 256):
        super().__init__()
        dtype = resolve_dtype(dtype)
        softmax_dtype = resolve_dtype(softmax_dtype)
        self.img_size = img_size
        self.embed_dim = embed_dim
        self.out_channels = embed_dim
        self.stop_grad_conv1 = stop_grad_conv1
        val = math.sqrt(6.0 / (3 * patch_size * patch_size + embed_dim))

        def patch_init(t: torch.Tensor, generator: Optional[torch.Generator] = None):
            return tinit.uniform_(t, -val, val, generator=generator)

        self.patch_embed = PatchEmbed(patch_size, embed_dim, dtype=dtype, kernel_init=patch_init)
        grid = img_size // patch_size
        self.pos_embed = FixedTable(mocov3_2d_sincos_pos_embed(embed_dim, grid, grid))
        self.cls_token = nn.Parameter(torch.empty(1, 1, embed_dim))
        self.num_experts = num_experts
        self.blocks = nn.ModuleList(
            BlockMoE(embed_dim, num_heads, mlp_ratio, qkv_bias=True, num_experts=num_experts,
                     moe_k=moe_k, capacity_factor=capacity_factor, aux_weight=moe_aux_weight,
                     group_size=moe_group_size, attn_impl=attn_impl, dtype=dtype,
                     softmax_dtype=softmax_dtype)
            if num_experts and is_moe_block(i, moe_interval) else
            Block(embed_dim, num_heads, mlp_ratio, qkv_bias=True, dtype=dtype,
                  softmax_dtype=softmax_dtype, attn_impl=attn_impl)
            for i in range(depth))
        self.norm = LayerNorm(embed_dim, eps=1e-6, dtype=dtype)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        tinit.normal_(self.cls_token, std=1e-6, generator=generator)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        """Features [n, embed_dim]; with experts, in training, the dict
        {"features", "moe_aux_loss", "moe_balance"}."""
        n = x.shape[0]
        x = self.patch_embed(x)
        if self.stop_grad_conv1:
            x = x.detach()
        cls = self.cls_token.to(x.dtype).expand(n, -1, -1)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.on(x.device).to(x.dtype)
        x, aux = run_moe_blocks(self.blocks, x, None)  # no stochastic depth: nothing to draw
        feats = self.norm(x[:, 0])  # LayerNorm is per token
        if self.num_experts and self.training:
            return {"features": feats, **aux}
        return feats


class _MLPHead(nn.Module):
    """fc{l} (bias-free Dense) -> bn{l} -> ReLU for each layer but the last;
    the last fc, then (with `last_bn`) a BatchNorm without scale or bias."""

    def __init__(self, num_layers: int, in_dim: int, mlp_dim: int, out_dim: int,
                 last_bn: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_layers = num_layers
        self.last_bn = last_bn
        dims = [in_dim] + [mlp_dim] * (num_layers - 1) + [out_dim]
        for l in range(num_layers):
            self.add_module(f"fc{l}", Dense(dims[l], dims[l + 1], dtype=dtype, use_bias=False))
            last = l == num_layers - 1
            if not last or last_bn:
                self.add_module(f"bn{l}", BatchNorm(dims[l + 1], momentum=0.9, epsilon=1e-5,
                                                    use_bias=not last, use_scale=not last,
                                                    dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for l in range(self.num_layers):
            x = getattr(self, f"fc{l}")(x)
            if l < self.num_layers - 1:
                x = F.relu(getattr(self, f"bn{l}")(x))
            elif self.last_bn:
                x = getattr(self, f"bn{l}")(x)
        return x


class _Tower(nn.Module):
    """encoder -> head (3 layers) -> predictor (2 layers; the keys skip it):
    x -> (z, the encoder's router aux dict or None)."""

    def __init__(self, encoder: dict, dim: int, mlp_dim: int, dtype: torch.dtype):
        super().__init__()
        self.encoder = MoCoV3ViT(dtype=dtype, **encoder)
        self.head = _MLPHead(3, self.encoder.embed_dim, mlp_dim, dim, dtype=dtype)
        self.predictor = _MLPHead(2, dim, mlp_dim, dim, dtype=dtype)

    def forward(self, x: torch.Tensor, run_predictor: bool = True) -> tuple:
        feats, aux = self.encoder(x), None
        if isinstance(feats, dict):  # a MoE encoder: the router aux rides along
            aux = {k: v for k, v in feats.items() if k != "features"}
            feats = feats["features"]
        z = self.head(feats)
        return (self.predictor(z) if run_predictor else z), aux


def contrastive_loss(q: torch.Tensor, k: torch.Tensor, T: float) -> torch.Tensor:
    """2T times the mean cross-entropy of q's N x N logits over k (l2-normalised,
    in f32, or f64 for f64 inputs) at temperature T, each query's positive its
    own row's key."""
    q = l2_normalize(at_least_f32(q), dim=1)
    k = l2_normalize(at_least_f32(k), dim=1)
    logits = q @ k.T / T
    labels = torch.arange(logits.shape[0], device=logits.device)
    return F.cross_entropy(logits, labels) * (2 * T)


@register_model
class MoCoV3Pretrain(nn.Module):
    """batch (view1, view2) [N, H, W, C] -> {"loss", "acc1"}, scalars in f32."""

    def __init__(self, encoder: Optional[dict] = None, dim: int = 256, mlp_dim: int = 4096,
                 T: float = 1.0, base_momentum: float = 0.99, dtype: DtypeLike = torch.float32):
        super().__init__()
        dtype = resolve_dtype(dtype)
        encoder = dict(encoder or {})
        self.T = T
        self.base_momentum = base_momentum
        self.num_experts = encoder.get("num_experts", 0)
        self.base = _Tower(encoder, dim, mlp_dim, dtype)
        self.momentum = _Tower(encoder, dim, mlp_dim, dtype)

    def ema_map(self) -> list:
        return [("base", "momentum", {"momentum": self.base_momentum, "schedule": "cosine"})]

    def optimizer_overrides(self) -> list:
        if self.num_experts:  # the stacked expert biases, as V-MoE's
            return [{"name": r"moe/(b1|b2)$", "weight_decay": 0.0}]
        return []

    @staticmethod
    def frozen_patterns() -> list:
        return [r"^momentum\."]

    @staticmethod
    def flax_absent() -> list:
        """What the JAX model's variables never hold (its keys skip the momentum
        predictor): `flax_to_torch` fills it from the base tower's."""
        return ["momentum.predictor."]

    def forward(self, batch, generator: Optional[torch.Generator] = None) -> dict:
        x1, x2 = two_views(batch)
        q1, aux1 = self.base(x1)
        q2, aux2 = self.base(x2)
        with torch.no_grad():
            k1 = self.momentum(x1, run_predictor=False)[0]
            k2 = self.momentum(x2, run_predictor=False)[0]
        loss = contrastive_loss(q1, k2, self.T) + contrastive_loss(q2, k1, self.T)
        with torch.no_grad():
            logits = (l2_normalize(at_least_f32(q1), dim=1)
                      @ l2_normalize(at_least_f32(k2), dim=1).T)
            hits = logits.argmax(dim=1) == torch.arange(q1.shape[0], device=q1.device)
        out = {"loss": loss, "acc1": hits.to(loss.dtype).mean()}
        if aux1 is not None:  # the base tower's router losses join the logged objective
            out["loss"] = loss + 0.5 * (aux1["moe_aux_loss"] + aux2["moe_aux_loss"])
            out["moe_balance"] = 0.5 * (aux1["moe_balance"] + aux2["moe_balance"])
        return out


@register_model
class MoCoV3LinearProbe(nn.Module):
    """images [N, H, W, C] -> logits [N, num_classes] over the frozen encoder."""

    def __init__(self, encoder: Optional[dict] = None, num_classes: int = 1000,
                 dtype: DtypeLike = torch.float32):
        super().__init__()
        dtype = resolve_dtype(dtype)
        self.encoder = MoCoV3ViT(dtype=dtype, **dict(encoder or {}))
        self.img_size = self.encoder.img_size

        def init(t: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
            return tinit.normal_(t, std=0.01, generator=generator)

        self.head = Dense(self.encoder.embed_dim, num_classes, dtype=dtype, kernel_init=init)

    @staticmethod
    def frozen_patterns() -> list:
        return [r"^encoder\."]

    def train(self, mode: bool = True) -> "MoCoV3LinearProbe":
        super().train(mode)
        self.encoder.eval()  # JAX runs it with train=False
        return self

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        with torch.no_grad():
            feats = self.encoder(x)
        return self.head(feats)

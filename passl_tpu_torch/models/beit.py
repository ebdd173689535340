"""BEiT: masked-token pretraining and finetuning of the relative-position ViT
(counterpart of `passl_tpu/models/beit.py`).

`BEiTViT` (JAX `:105-147`): the patch embedding; in the pretrain encoder a
`mask_token` (truncated normal 0.02) takes the place of every masked patch
(`with_mask_token`: JAX creates the parameter only where a mask is passed,
so a finetune encoder has none and an extracted pretrain encoder loads into
it with no stray key); a class token (truncated normal 0.02) in front, an
absolute position embedding only with `use_abs_pos_emb`; `depth`
`BEiTBlock`s with the stochastic-depth rates `linspace(0, drop_path_rate,
depth)`; a final `norm`.

`BEiTBlock` (JAX `:74-102`): pre-norm attention and MLP, each branch scaled
by its LayerScale (`gamma_1`, `gamma_2` at `init_values`, f32) where
`init_values` is set, then stochastic depth. `BEiTAttention` (JAX
`:47-71`): the fused qkv projection and the output projection (truncated
normal 0.02), the scores (q d^-1/2) k in f32 (the JAX einsum's
preferred_element_type) plus the relative position bias, the per-head
`relative_position_bias_table` [(2g - 1)^2 + 3, heads] (zeros at init)
gathered by `_beit_rel_pos_index`, the softmax in f32, then cast to the
compute dtype. The JAX model attends with its own einsums, so the port
launches no kernel here.

`BEiTPretrain` (JAX `:150-194`): batches of (masked view, tokenizer view,
bool mask [N, L]) from `BEiTTwoViewsWithMask`. The encoder reads the masked
view, `head` predicts a visual token at every patch, and the frozen
`tokenizer` (a `DiscreteVAE`, its parameters under `tokenizer.`, kept off
the optimizer by `frozen_patterns`) gives the targets from the tokenizer
view under `torch.no_grad()`; a token grid finer than the patch grid (the
dVAE's 28 x 28 against 14 x 14 patches) is subsampled to its top-left
entry of each cell, as JAX does. The cross-entropy (f32) and `acc1` are
taken over the masked patches only.

`BEiTFinetune` (JAX `:197-218`): the encoder (frozen with `freeze_encoder`,
its dotted pattern `^encoder\\.`), the mean of the patch tokens (or the
class token) and a `head` (truncated normal 0.02). Its `out_channels` is the
head's width, as the probe wrapper reads it.
"""
from __future__ import annotations

import functools
from typing import Any, Optional, Union

import numpy as np
import torch
from torch import nn

from ..core.amp import at_least_f32, resolve_dtype
from ..nn import init as tinit
from ..nn.layers import Dense, DropPath, LayerNorm, Mlp, PatchEmbed
from .base import MODELS, register_model
from .discrete_vae import DiscreteVAE
from .utils import FixedTable

DtypeLike = Union[str, torch.dtype]
_trunc02 = functools.partial(tinit.trunc_normal_, std=0.02)


def _beit_rel_pos_index(grid: int) -> np.ndarray:
    """Relative position index for grid tokens + cls (reference beit.py):
    table rows [(2g-1)^2] for patch pairs + 3 special rows for
    cls↔patch and cls↔cls."""
    ws = grid
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    num_rel = (2 * ws - 1) ** 2
    idx = np.zeros((ws * ws + 1, ws * ws + 1), np.int32)
    idx[1:, 1:] = rel.sum(-1)
    idx[0, 0:] = num_rel
    idx[0:, 0] = num_rel + 1
    idx[0, 0] = num_rel + 2
    return idx


class BEiTAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, grid: int, use_rel_pos_bias: bool = True,
                 qkv_bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.compute_dtype = dtype
        self.qkv = Dense(dim, 3 * dim, dtype, kernel_init=_trunc02, use_bias=qkv_bias)
        self.proj = Dense(dim, dim, dtype, kernel_init=_trunc02)
        self.rel_index = None
        if use_rel_pos_bias:
            self.relative_position_bias_table = nn.Parameter(
                torch.empty((2 * grid - 1) ** 2 + 3, num_heads))
            self.rel_index = FixedTable(_beit_rel_pos_index(grid).reshape(-1), dtype=np.int64)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        if self.rel_index is not None:
            tinit.zeros_(self.relative_position_bias_table)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, l, c = x.shape
        h = self.num_heads
        d = c // h
        q, k, v = self.qkv(x).reshape(n, l, 3, h, d).unbind(2)
        ct = at_least_f32(q).dtype  # an einsum with preferred_element_type f32
        attn = torch.matmul((q * d ** -0.5).transpose(1, 2).to(ct),
                            k.transpose(1, 2).to(ct).transpose(-1, -2))
        if self.rel_index is not None:
            table = self.relative_position_bias_table
            bias = table[self.rel_index.on(x.device)].reshape(l, l, h).permute(2, 0, 1)
            attn = attn + bias[None].to(ct)
        attn = torch.softmax(attn, dim=-1).to(self.compute_dtype)
        out = torch.matmul(attn, v.transpose(1, 2).to(self.compute_dtype))  # [n, h, l, d]
        return self.proj(out.transpose(1, 2).reshape(n, l, c))


class BEiTBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, grid: int, mlp_ratio: float = 4.0,
                 init_values: Optional[float] = 0.1, drop_path: float = 0.0,
                 use_rel_pos_bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.init_values = init_values
        self.norm1 = LayerNorm(dim, eps=1e-6, dtype=dtype)
        self.attn = BEiTAttention(dim, num_heads, grid, use_rel_pos_bias, dtype=dtype)
        self.drop_path1 = DropPath(drop_path)
        self.norm2 = LayerNorm(dim, eps=1e-6, dtype=dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype=dtype)
        self.drop_path2 = DropPath(drop_path)
        if init_values is not None:
            self.gamma_1 = nn.Parameter(torch.empty(dim))
            self.gamma_2 = nn.Parameter(torch.empty(dim))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        if self.init_values is not None:
            tinit.constant_(self.gamma_1, self.init_values)
            tinit.constant_(self.gamma_2, self.init_values)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        y = self.attn(self.norm1(x))
        if self.init_values is not None:
            y = y * self.gamma_1
        x = x + self.drop_path1(y, generator)
        y = self.mlp(self.norm2(x))
        if self.init_values is not None:
            y = y * self.gamma_2
        return x + self.drop_path2(y, generator)


class BEiTViT(nn.Module):
    """images [N, H, W, 3] (and a bool mask [N, L] where `with_mask_token`)
    -> the normed tokens [N, 1 + L, D], the class token first."""

    def __init__(self, img_size: int = 224, patch_size: int = 16, embed_dim: int = 768,
                 depth: int = 12, num_heads: int = 12, mlp_ratio: float = 4.0,
                 init_values: Optional[float] = 0.1, drop_path_rate: float = 0.0,
                 use_rel_pos_bias: bool = True, use_abs_pos_emb: bool = False,
                 with_mask_token: bool = False, dtype: DtypeLike = torch.float32):
        super().__init__()
        dtype = resolve_dtype(dtype)
        grid = img_size // patch_size
        self.embed_dim = embed_dim
        self.use_abs_pos_emb = use_abs_pos_emb
        self.patch_embed = PatchEmbed(patch_size, embed_dim, dtype=dtype)
        self.mask_token = nn.Parameter(torch.empty(1, 1, embed_dim)) if with_mask_token else None
        self.cls_token = nn.Parameter(torch.empty(1, 1, embed_dim))
        if use_abs_pos_emb:
            self.pos_embed = nn.Parameter(torch.empty(1, grid * grid + 1, embed_dim))
        dpr = np.linspace(0, drop_path_rate, depth)
        self.blocks = nn.ModuleList(
            BEiTBlock(embed_dim, num_heads, grid, mlp_ratio, init_values, float(dpr[i]),
                      use_rel_pos_bias, dtype) for i in range(depth))
        self.norm = LayerNorm(embed_dim, eps=1e-6, dtype=dtype)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for p in (self.mask_token, self.cls_token,
                  self.pos_embed if self.use_abs_pos_emb else None):
            if p is not None:
                _trunc02(p, generator=generator)

    def forward(self, x: torch.Tensor, bool_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.patch_embed(x)
        n = x.shape[0]
        if bool_mask is not None:
            if self.mask_token is None:
                raise ValueError("BEiTViT: a mask was given to an encoder built without "
                                 "with_mask_token")
            m = bool_mask.to(x.dtype)[:, :, None]
            x = x * (1 - m) + self.mask_token.to(x.dtype) * m
        cls = self.cls_token.to(x.dtype).expand(n, -1, -1)
        x = torch.cat([cls, x], dim=1)
        if self.use_abs_pos_emb:
            x = x + self.pos_embed.to(x.dtype)
        for blk in self.blocks:
            x = blk(x, generator)
        return self.norm(x)


def _pool_targets(target: torch.Tensor, l: int) -> torch.Tensor:
    """Token ids [N, g_t^2] -> [N, l]: the top-left id of each cell where the
    token grid is finer than the patch grid (JAX `beit.py:177-181`)."""
    if target.shape[1] == l:
        return target
    g_t, g_l = int(target.shape[1] ** 0.5), int(l ** 0.5)
    s = g_t // g_l
    return target.reshape(-1, g_l, s, g_l, s)[:, :, 0, :, 0].reshape(-1, l)


@register_model
class BEiTPretrain(nn.Module):
    """(masked view, tokenizer view, bool mask [N, L]) -> {"loss", "acc1"}."""

    def __init__(self, encoder: Any = None, tokenizer: Any = None, vocab_size: int = 8192,
                 dtype: DtypeLike = torch.float32):
        super().__init__()
        dtype = resolve_dtype(dtype)
        self.encoder = BEiTViT(dtype=dtype, with_mask_token=True, **dict(encoder or {}))
        self.head = Dense(self.encoder.embed_dim, vocab_size, dtype, kernel_init=_trunc02)
        self.tokenizer = DiscreteVAE(dtype=dtype, with_decoder=False,
                                     **dict(tokenizer or {"vocab_size": vocab_size}))

    @staticmethod
    def frozen_patterns() -> list:
        return [r"^tokenizer\."]

    def forward(self, batch, generator: Optional[torch.Generator] = None) -> dict:
        view, tok_view, bool_mask = batch[0], batch[1], batch[2]
        x = self.encoder(view, bool_mask=bool_mask, generator=generator)
        logits = self.head(x[:, 1:])
        with torch.no_grad():
            target = _pool_targets(self.tokenizer.tokenize(tok_view), logits.shape[1])
        logp = torch.log_softmax(at_least_f32(logits), dim=-1)
        nll = -torch.gather(logp, -1, target[:, :, None])[:, :, 0]
        m = bool_mask.to(nll.dtype)
        count = torch.clamp(m.sum(), min=1.0)
        acc = torch.sum((torch.argmax(logits, dim=-1) == target).to(m.dtype) * m) / count
        return {"loss": torch.sum(nll * m) / count, "acc1": acc}


@register_model
class BEiTFinetune(nn.Module):
    """images [N, H, W, 3] -> logits [N, num_classes]."""

    def __init__(self, encoder: Any = None, num_classes: int = 1000, global_pool: bool = True,
                 freeze_encoder: bool = False, dtype: DtypeLike = torch.float32):
        super().__init__()
        dtype = resolve_dtype(dtype)
        self.global_pool = global_pool
        self.freeze_encoder = freeze_encoder
        self.encoder = BEiTViT(dtype=dtype, **dict(encoder or {}))
        self.head = Dense(self.encoder.embed_dim, num_classes, dtype, kernel_init=_trunc02)
        self.out_channels = num_classes

    def frozen_patterns(self) -> list:
        return [r"^encoder\."] if self.freeze_encoder else []

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        x = self.encoder(x, generator=generator)
        feats = x[:, 1:].mean(dim=1) if self.global_pool else x[:, 0]
        return self.head(feats)


def _register(name: str, **defaults):
    def factory(**kw) -> BEiTPretrain:
        return BEiTPretrain(**{**defaults, **kw})

    factory.__name__ = name
    MODELS.register(factory, name=name)


_register("beit_base_patch16_224_pretrain", encoder=dict(embed_dim=768, depth=12, num_heads=12))
_register("beit_large_patch16_224_pretrain",
          encoder=dict(embed_dim=1024, depth=24, num_heads=16))

"""T2T-ViT and LV-ViT, with LV-ViT's token-labeling trainer (counterpart of
`passl_tpu/models/t2t_vit.py`).

This is the JAX model, function for function:

- `soft_split` unfolds an NHWC grid into `[n, L, C k k]` patches, the
  features ordered (C, kh, kw): `F.unfold` on the NCHW view.
- `TokenAttention`: one head of f32 scores and softmax, cast to the compute
  dtype before they mix v, then `out + mlp(norm2(out))`; no skip from its
  input, whose width differs.
- `TokenPerformer`: the projection `kqv` in the order k, q, v; the positive
  random features `exp(w t - |t|² / 2) / sqrt(m)` in f32 with a trainable
  f32 `w` of shape (m = dim / 2, dim); `y = v + proj(qp (kpᵀ v) / (qp · Σ kp
  + 1e-8))`, then `y + mlp(norm2(y))`. At a random init the features are
  about e⁻³² and the denominator sits far under the epsilon, so the stage
  passes `v + proj.bias` on: the JAX model's behaviour, kept.
- `T2TViT`: a 7x7/4 soft split, LayerNorm and token stage, a 3x3/2 split,
  LayerNorm and token stage, a 3x3/2 split and `t2t_project`; the cls token
  and the fixed 1-D sin-cos code over L + 1 positions (not a parameter);
  `Block`s without qkv bias; the final LayerNorm and the head on the cls
  token.
- `LVViT`: a stem of three conv-BatchNorm-ReLU layers (7x7/2 then two 3x3,
  64 channels, no bias, flax's BatchNorm) and `patch_proj` (kernel and
  stride `patch_size // 2`, with bias); a learned `pos_embed`; the output is
  `head(cls) + aux_weight max_tokens(aux_head(patches))` in training and at
  eval alike.
- `LVViTTokenLabel`: the same parameters (its state dict loads strictly into
  `LVViT`), trained on `{image, label, token_value, token_idx}` batches with
  MixToken (one box a batch on the patch grid, the partner the batch
  reversed, `mixtoken_draws` / `mixtoken_box`), the box-mixed smoothed class
  target and the soft cross-entropy of the aux logits gathered at the top-K
  token labels; at eval, or on images alone, it returns the logits as
  `LVViT` does with `dense_weight`.

The factories `t2t_vit{,_t}_{14,19,24}`, `lvvit_s` and `lvvit_m` are
registered under the JAX names. Images are NHWC at the input. Module names
follow the flax model's (`t2t_norm0`, `t2t_attn1`, `kqv`, `w`,
`t2t_project`, `stem_conv{i}`, `stem_bn{i}`, `patch_proj`, `aux_head`,
`blocks_{i}`), so `utils.convert.flax_to_torch` maps one onto the other. In
training, `generator` draws MixToken's box (before the blocks) and the
stochastic-depth masks.
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.amp import at_least_f32, resolve_dtype
from ..nn import init as tinit
from ..nn.layers import Block, Conv, Dense, LayerNorm, gelu
from ..nn.norm import BatchNorm
from ..ops.attention import einsum_attention
from .base import MODELS, register_model
from .utils import FixedTable
from .utils.pos_embed import get_1d_sincos_pos_embed_from_grid

DtypeLike = Union[str, torch.dtype]
_trunc02 = functools.partial(tinit.trunc_normal_, std=0.02)


def soft_split(x: torch.Tensor, kernel: int, stride: int, pad: int) -> Tuple[torch.Tensor, int, int]:
    """NHWC [n, h, w, c] -> patches [n, oh ow, c k k] (torch `nn.Unfold`'s
    order), oh, ow."""
    _, h, w, _ = x.shape
    oh = (h + 2 * pad - kernel) // stride + 1
    ow = (w + 2 * pad - kernel) // stride + 1
    patches = F.unfold(x.permute(0, 3, 1, 2), kernel, padding=pad, stride=stride)
    return patches.transpose(1, 2), oh, ow


class TokenAttention(nn.Module):
    """The single-head attention of a T2T stage, `in_dim` -> `dim`."""

    def __init__(self, in_dim: int, dim: int, num_heads: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        # flax's default Dense init (lecun_normal), as the JAX model leaves it
        self.qkv = Dense(in_dim, 3 * dim, dtype)
        self.norm2 = LayerNorm(dim, eps=1e-6, dtype=dtype)
        self.mlp_fc1 = Dense(dim, dim, dtype)
        self.mlp_fc2 = Dense(dim, dim, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, l, _ = x.shape
        h = self.num_heads
        q, k, v = self.qkv(x).reshape(n, l, 3, h, self.dim // h).unbind(2)
        # f32 scores (f64 in an f64 model), the probabilities at v's dtype
        out = einsum_attention(q, k, v, (self.dim // h) ** -0.5,
                               torch.promote_types(q.dtype, torch.float32), v.dtype)
        return out + self.mlp_fc2(gelu(self.mlp_fc1(self.norm2(out))))


class TokenPerformer(nn.Module):
    """The linear-attention T2T stage, `in_dim` -> `dim`, with the trainable
    random-feature matrix `w` (m = dim kernel_ratio, dim) in f32."""

    def __init__(self, in_dim: int, dim: int, kernel_ratio: float = 0.5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim = dim
        self.m = int(dim * kernel_ratio)
        self.kqv = Dense(in_dim, 3 * dim, dtype)
        self.w = nn.Parameter(torch.empty(self.m, dim))
        self.proj = Dense(dim, dim, dtype)
        self.norm2 = LayerNorm(dim, eps=1e-6, dtype=dtype)
        self.mlp_fc1 = Dense(dim, dim, dtype)
        self.mlp_fc2 = Dense(dim, dim, dtype)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        _trunc02(self.w, generator=generator)

    def prm_exp(self, t: torch.Tensor) -> torch.Tensor:
        """exp(w t - |t|² / 2) / sqrt(m) in f32 (f64 in an f64 model), [n, l, m]."""
        t = at_least_f32(t)
        xd = (t * t).sum(dim=-1, keepdim=True) / 2.0
        wtx = torch.einsum("nld,md->nlm", t, self.w.to(t.dtype))
        return torch.exp(wtx - xd) / math.sqrt(self.m)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, l, _ = x.shape
        k, q, v = self.kqv(x).reshape(n, l, 3, self.dim).unbind(2)
        kp, qp = self.prm_exp(k), self.prm_exp(q)
        denom = torch.einsum("nlm,nm->nl", qp, kp.sum(dim=1))[..., None]
        kptv = torch.einsum("nld,nlm->nmd", v.to(kp.dtype), kp)
        y = torch.einsum("nlm,nmd->nld", qp, kptv) / (denom + 1e-8)
        y = v + self.proj(y.to(v.dtype))
        return y + self.mlp_fc2(gelu(self.mlp_fc1(self.norm2(y))))


def _sincos_table(dim: int, length: int) -> FixedTable:
    """The fixed 1-D sin-cos code over `length` positions, kept in f64 and cast
    to the tokens' dtype at use, as JAX casts the numpy table."""
    return FixedTable(get_1d_sincos_pos_embed_from_grid(dim, np.arange(length))[None],
                      dtype=np.float64)


def _blocks(embed_dim: int, depth: int, num_heads: int, mlp_ratio: float, drop_path_rate: float,
            dtype: torch.dtype) -> nn.ModuleList:
    dpr = np.linspace(0, drop_path_rate, depth)
    return nn.ModuleList(Block(embed_dim, num_heads, mlp_ratio, qkv_bias=False,
                               drop_path=float(dpr[i]), dtype=dtype) for i in range(depth))


@register_model
class T2TViT(nn.Module):
    """images [N, H, W, 3] (NHWC) -> logits [N, num_classes] at `dtype`; with
    `num_classes=0` the normed cls token [N, embed_dim]. `tokens_type`
    "performer" (the `t2t_vit_*` factories) or "transformer" (`t2t_vit_t_*`)."""

    def __init__(self, img_size: int = 224, token_dim: int = 64, embed_dim: int = 384,
                 depth: int = 14, num_heads: int = 6, mlp_ratio: float = 3.0,
                 drop_path_rate: float = 0.0, num_classes: int = 1000,
                 tokens_type: str = "performer", dtype: DtypeLike = torch.float32,
                 in_chans: int = 3):
        super().__init__()
        dtype = resolve_dtype(dtype)
        if tokens_type == "performer":
            tok = functools.partial(TokenPerformer, dtype=dtype)
        else:
            tok = functools.partial(TokenAttention, dtype=dtype)
        self.img_size, self.token_dim, self.embed_dim = img_size, token_dim, embed_dim
        self.tokens_type = tokens_type
        self.t2t_norm0 = LayerNorm(in_chans * 7 * 7, eps=1e-6, dtype=dtype)
        self.t2t_attn1 = tok(in_chans * 7 * 7, token_dim)
        self.t2t_norm1 = LayerNorm(token_dim * 3 * 3, eps=1e-6, dtype=dtype)
        self.t2t_attn2 = tok(token_dim * 3 * 3, token_dim)
        self.t2t_project = Dense(token_dim * 3 * 3, embed_dim, dtype)
        self.cls_token = nn.Parameter(torch.empty(1, 1, embed_dim))
        self._pos_tables: dict = {}
        self.blocks = _blocks(embed_dim, depth, num_heads, mlp_ratio, drop_path_rate, dtype)
        self.norm = LayerNorm(embed_dim, eps=1e-6, dtype=dtype)
        self.head = (Dense(embed_dim, num_classes, dtype, kernel_init=_trunc02)
                     if num_classes > 0 else None)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        _trunc02(self.cls_token, generator=generator)

    def _pos(self, length: int, device: torch.device) -> torch.Tensor:
        if length not in self._pos_tables:
            self._pos_tables[length] = _sincos_table(self.embed_dim, length)
        return self._pos_tables[length].on(device)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        n = x.shape[0]
        t, h, w = soft_split(x, 7, 4, 2)  # stage 0: 7x7/4
        t = self.t2t_attn1(self.t2t_norm0(t))
        t, h, w = soft_split(t.reshape(n, h, w, self.token_dim), 3, 2, 1)  # restructure, 3x3/2
        t = self.t2t_attn2(self.t2t_norm1(t))
        t, h, w = soft_split(t.reshape(n, h, w, self.token_dim), 3, 2, 1)
        x = self.t2t_project(t)
        x = torch.cat([self.cls_token.to(x.dtype).expand(n, -1, -1), x], dim=1)
        x = x + self._pos(x.shape[1], x.device).to(x.dtype)
        for blk in self.blocks:
            x = blk(x, generator)
        x = self.norm(x)[:, 0]
        return self.head(x) if self.head is not None else x


class _LVViTBody(nn.Module):
    """LV-ViT's parameters and its forward up to the two heads' logits,
    shared by `LVViT` and `LVViTTokenLabel` (one state dict for both)."""

    def __init__(self, img_size: int, patch_size: int, embed_dim: int, depth: int,
                 num_heads: int, mlp_ratio: float, drop_path_rate: float, num_classes: int,
                 dtype: torch.dtype, in_chans: int = 3):
        super().__init__()
        self.img_size, self.in_chans, self.embed_dim = img_size, in_chans, embed_dim
        cin = in_chans
        for i, (dch, s) in enumerate(zip((64, 64, 64), (2, 1, 1))):
            k = 7 if i == 0 else 3
            # flax's default Conv init (lecun_normal), as the JAX model leaves it
            self.add_module(f"stem_conv{i}", Conv(cin, dch, k, s, k // 2, dtype=dtype,
                                                  use_bias=False))
            self.add_module(f"stem_bn{i}", BatchNorm(dch, momentum=0.9, epsilon=1e-5, dtype=dtype))
            cin = dch
        p = patch_size // 2  # the stem already halved the image
        self.patch_proj = Conv(cin, embed_dim, p, p, dtype=dtype)
        self.grid = ((img_size - 1) // 2 + 1) // p
        self.cls_token = nn.Parameter(torch.empty(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.empty(1, self.grid * self.grid + 1, embed_dim))
        self.blocks = _blocks(embed_dim, depth, num_heads, mlp_ratio, drop_path_rate, dtype)
        self.norm = LayerNorm(embed_dim, eps=1e-6, dtype=dtype)
        self.head = Dense(embed_dim, num_classes, dtype, kernel_init=_trunc02)
        self.aux_head = Dense(embed_dim, num_classes, dtype, kernel_init=_trunc02)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        _trunc02(self.cls_token, generator=generator)
        _trunc02(self.pos_embed, generator=generator)

    def patches(self, x: torch.Tensor) -> torch.Tensor:
        """images NHWC -> the patch grid NHWC [n, gh, gw, embed_dim]."""
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW, channels-last memory
        for i in range(3):
            x = F.relu(getattr(self, f"stem_bn{i}")(getattr(self, f"stem_conv{i}")(x)))
        return self.patch_proj(x).permute(0, 2, 3, 1)

    def logits(self, grid: torch.Tensor,
               generator: Optional[torch.Generator]) -> Tuple[torch.Tensor, torch.Tensor]:
        """The patch grid -> the head's logits [n, C] and the aux head's [n, L, C]."""
        n, gh, gw, c = grid.shape
        x = grid.reshape(n, gh * gw, c)
        x = torch.cat([self.cls_token.to(x.dtype).expand(n, -1, -1), x], dim=1)
        x = x + self.pos_embed.to(x.dtype)
        for blk in self.blocks:
            x = blk(x, generator)
        x = self.norm(x)
        return self.head(x[:, 0]), self.aux_head(x[:, 1:])


@register_model
class LVViT(_LVViTBody):
    """images [N, H, W, 3] (NHWC) -> `head(cls) + aux_weight max(aux_head(patches))`
    [N, num_classes] at `dtype`, in training and at eval alike."""

    def __init__(self, img_size: int = 224, patch_size: int = 16, embed_dim: int = 384,
                 depth: int = 16, num_heads: int = 6, mlp_ratio: float = 3.0,
                 drop_path_rate: float = 0.1, num_classes: int = 1000, aux_weight: float = 0.5,
                 dtype: DtypeLike = torch.float32):
        super().__init__(img_size, patch_size, embed_dim, depth, num_heads, mlp_ratio,
                         drop_path_rate, num_classes, resolve_dtype(dtype))
        self.aux_weight = aux_weight

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        cls_logits, aux_logits = self.logits(self.patches(x), generator)
        return cls_logits + self.aux_weight * aux_logits.max(dim=1).values


def mixtoken_draws(gh: int, gw: int, generator: Optional[torch.Generator],
                   device: torch.device) -> Tuple[torch.Tensor, ...]:
    """MixToken's four draws, in JAX's order: lam ~ U(0, 1) (JAX's Beta(1, 1)),
    cx ~ randint(0, gw), cy ~ randint(0, gh), and the coin u ~ U(0, 1), each a
    0-d tensor on `device`. Looked up at call time: the tests hand JAX's draws in."""
    lam = torch.rand((), generator=generator, device=device)
    cx = torch.randint(0, gw, (), generator=generator, device=device)
    cy = torch.randint(0, gh, (), generator=generator, device=device)
    u = torch.rand((), generator=generator, device=device)
    return lam, cx, cy, u


def mixtoken_box(draws: Tuple[torch.Tensor, ...], gh: int, gw: int,
                 mix_prob: float) -> torch.Tensor:
    """The box [gh, gw] (bool) of the draws: sides `int(sqrt(1 - lam) g)`
    (truncated, in f32), centred at (cx, cy) and clipped to the grid; all
    False unless u < mix_prob. Computed on the draws' device, without a sync."""
    lam, cx, cy, u = draws
    cut = torch.sqrt(1.0 - lam.float())
    cw, ch = (cut * gw).long(), (cut * gh).long()
    x1, x2 = (cx - cw // 2).clamp(0, gw), (cx + cw // 2).clamp(0, gw)
    y1, y2 = (cy - ch // 2).clamp(0, gh), (cy + ch // 2).clamp(0, gh)
    col = torch.arange(gw, device=lam.device)
    row = torch.arange(gh, device=lam.device)
    box = ((col >= x1) & (col < x2))[None, :] & ((row >= y1) & (row < y2))[:, None]
    return box & (u < mix_prob)


@register_model
class LVViTTokenLabel(_LVViTBody):
    """LV-ViT's token-labeling trainer. In training on a dict batch `{image,
    label, token_value [n, g, g, K], token_idx [n, g, g, K]}` it returns
    `{loss = cls_weight loss_cls + dense_weight loss_aux, loss_cls, loss_aux,
    acc1}` (f32, f64 in an f64 model); at eval, or on images alone, the
    logits `head(cls) + dense_weight max(aux_head(patches))` in f32. `mix`,
    where given, stands in for `mixtoken_draws`."""

    def __init__(self, img_size: int = 224, patch_size: int = 16, embed_dim: int = 384,
                 depth: int = 16, num_heads: int = 6, mlp_ratio: float = 3.0,
                 drop_path_rate: float = 0.1, num_classes: int = 1000, cls_weight: float = 1.0,
                 dense_weight: float = 0.5, mix_prob: float = 0.5, label_smoothing: float = 0.1,
                 dtype: DtypeLike = torch.float32):
        super().__init__(img_size, patch_size, embed_dim, depth, num_heads, mlp_ratio,
                         drop_path_rate, num_classes, resolve_dtype(dtype))
        self.num_classes = num_classes
        self.cls_weight, self.dense_weight = cls_weight, dense_weight
        self.mix_prob, self.label_smoothing = mix_prob, label_smoothing

    def forward(self, batch, generator: Optional[torch.Generator] = None,
                mix: Optional[Tuple[torch.Tensor, ...]] = None):
        x = batch["image"] if isinstance(batch, dict) else batch
        grid = self.patches(x)
        _, gh, gw, _ = grid.shape
        mixed = self.training and isinstance(batch, dict)
        if mixed:
            box = mixtoken_box(mix if mix is not None else
                               mixtoken_draws(gh, gw, generator, grid.device), gh, gw, self.mix_prob)
            grid = torch.where(box[None, :, :, None], grid.flip(0), grid)
        cls_logits, aux_logits = (at_least_f32(t) for t in self.logits(grid, generator))
        if not mixed:
            return cls_logits + self.dense_weight * aux_logits.max(dim=1).values

        n = grid.shape[0]
        labels = batch["label"].long()
        tv = batch["token_value"].to(cls_logits.dtype)
        ti = batch["token_idx"]
        tv = torch.where(box[None, :, :, None], tv.flip(0), tv).reshape(n, gh * gw, -1)
        ti = torch.where(box[None, :, :, None], ti.flip(0), ti).reshape(n, gh * gw, -1)
        lam_real = 1.0 - box.to(cls_logits.dtype).mean()

        # the class loss: the smoothed one-hot mixed with its reverse by the box's area
        ls = self.label_smoothing
        onehot = F.one_hot(labels, self.num_classes).to(cls_logits.dtype) * (1.0 - ls) + (
            ls / self.num_classes)
        target_cls = lam_real * onehot + (1.0 - lam_real) * onehot.flip(0)
        loss_cls = -(target_cls * F.log_softmax(cls_logits, dim=-1)).sum(-1).mean()
        # the aux loss: the soft cross-entropy at the top-K token labels
        picked = torch.gather(F.log_softmax(aux_logits, dim=-1), -1, ti.long())
        loss_aux = -(tv * picked).sum(-1).mean()
        loss = self.cls_weight * loss_cls + self.dense_weight * loss_aux
        acc1 = (cls_logits.argmax(-1) == labels).to(cls_logits.dtype).mean()
        return {"loss": loss, "loss_cls": loss_cls, "loss_aux": loss_aux, "acc1": acc1}


_T2T = {
    # t2t_vit_* take performer T2T stages, t2t_vit_t_* transformer ones
    "t2t_vit_14": dict(embed_dim=384, depth=14, num_heads=6),
    "t2t_vit_19": dict(embed_dim=448, depth=19, num_heads=7),
    "t2t_vit_24": dict(embed_dim=512, depth=24, num_heads=8),
    "t2t_vit_t_14": dict(embed_dim=384, depth=14, num_heads=6, tokens_type="transformer"),
    "t2t_vit_t_19": dict(embed_dim=448, depth=19, num_heads=7, tokens_type="transformer"),
    "t2t_vit_t_24": dict(embed_dim=512, depth=24, num_heads=8, tokens_type="transformer"),
}
_LVVIT = {
    "lvvit_s": dict(embed_dim=384, depth=16, num_heads=6),
    "lvvit_m": dict(embed_dim=512, depth=20, num_heads=8),
}


def _variant(name: str, cls: type, cfg: dict):
    def factory(**kw):
        return cls(**{**cfg, **kw})

    factory.__name__ = name
    return factory


for _name, _cfg in _T2T.items():
    MODELS.register(_variant(_name, T2TViT, _cfg), name=_name)
for _name, _cfg in _LVVIT.items():
    MODELS.register(_variant(_name, LVViT, _cfg), name=_name)

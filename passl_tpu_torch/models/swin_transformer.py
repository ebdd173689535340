"""Swin Transformer (counterpart of `passl_tpu/models/swin_transformer.py`).

Windowed attention with a relative-position bias, shifted windows with the
attention mask, patch merging and stochastic depth, with `win_pack` windows
packed into one attention call under a block-diagonal -100 mask (the JAX
model's default, 2). Module and parameter names follow the flax model's, so
`utils.convert.flax_to_torch` maps one onto the other: the blocks of stage
i are the ModuleList `layers_{i}_blocks` (flax `layers_{i}_blocks_{j}`) and
the patch conv is the bare `patch_embed`.

Precision follows the JAX model: Dense/Conv/LayerNorm compute at `dtype`
with f32 parameters; the einsum path takes q * scale at `dtype`, the scores,
bias, mask and softmax at `softmax_dtype`; the fused path
(`attn_impl: fused`, the CUDA kernels of `ops/window_attention.py`) runs the
softmax in f32 whatever `softmax_dtype` says.

The relative-position index and the shift/pack masks are numpy constants,
as in the JAX model, uploaded once per device: they are neither parameters
nor buffers, so the state_dict holds exactly the flax leaves, and building a
model on the meta device (export, serving) leaves them intact.

Not ported, and refused: `lane_pad` and `win_pack > 2` (TPU lane-layout
tricks), `remat`, and dropout (`drop_rate`, `attn_drop_rate`; no Swin
config sets them).
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..core.amp import resolve_dtype
from ..nn import init as tinit
from ..nn.layers import Conv2d, Dense, DropPath, Identity, LayerNorm, Mlp
from ..ops.window_attention import fused_window_attention
from .base import MODELS, register_model

WINDOW_IMPLS = ("einsum", "fused", "auto")
DtypeLike = Union[str, torch.dtype]
_trunc02 = functools.partial(tinit.trunc_normal_, std=0.02)


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    n, h, w, c = x.shape
    x = x.reshape(n, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)


def window_reverse(windows: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    n = windows.shape[0] // ((h // ws) * (w // ws))
    x = windows.reshape(n, h // ws, w // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(n, h, w, -1)


def _relative_position_index(ws: int) -> np.ndarray:
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))  # [2, ws, ws]
    coords = coords.reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]  # [2, ws^2, ws^2]
    rel = rel.transpose(1, 2, 0)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)  # [ws^2, ws^2]


def _shift_attn_mask(h: int, w: int, ws: int, shift: int) -> Optional[np.ndarray]:
    if shift == 0:
        return None
    img_mask = np.zeros((1, h, w, 1))
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img_mask[:, hs, wsl, :] = cnt
            cnt += 1
    mask_windows = img_mask.reshape(1, h // ws, ws, w // ws, ws, 1)
    mask_windows = mask_windows.transpose(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws)
    attn_mask = mask_windows[:, None, :] - mask_windows[:, :, None]
    return np.where(attn_mask != 0, -100.0, 0.0).astype(np.float32)  # [nW, ws^2, ws^2]


def _packed_attn_mask(h: int, w: int, ws: int, shift: int, g: int) -> Optional[np.ndarray]:
    """[nW/g, g*ws^2, g*ws^2]: the shift mask of each window on the diagonal
    blocks, -100 off them; None when g == 1 and there is no shift."""
    mask = _shift_attn_mask(h, w, ws, shift)
    if g == 1:
        return mask
    nw = (h // ws) * (w // ws)
    l = ws * ws
    packed = np.full((nw // g, g * l, g * l), -100.0, np.float32)
    for i in range(g):
        sl = slice(i * l, (i + 1) * l)
        packed[:, sl, sl] = 0.0 if mask is None else mask.reshape(nw // g, g, l, l)[:, i]
    return packed


def resolve_window_impl(impl: str, device: Union[str, torch.device], interpret: bool = False) -> str:
    """`fused` = the CUDA kernels (CUDA tensors only); `einsum` = the plain
    path on any device; `auto` = einsum, as the JAX package resolves it.
    `interpret` (the JAX model's `attn_interpret`) takes the fused path's
    autograd Function on any device: on CPU tensors it runs the kernels'
    plain versions."""
    if impl not in WINDOW_IMPLS:
        raise ValueError(f"unknown Swin attn_impl {impl!r}")
    if interpret:
        return "fused"
    if impl == "auto":
        return "einsum"
    if impl == "fused" and torch.device(device).type != "cuda":
        raise ValueError(f"attn_impl=fused needs CUDA tensors, got {device}; use attn_impl=einsum "
                         "or auto, or attn_interpret=True for the kernels' plain versions")
    return impl


class _DeviceConstant:
    """A numpy constant, made a tensor once per device it is asked on."""

    def __init__(self, array: np.ndarray, dtype: torch.dtype):
        self.array = array
        self.dtype = dtype
        self._on: dict = {}

    def on(self, device: torch.device) -> torch.Tensor:
        if device not in self._on:
            with torch.inference_mode(False):  # usable by autograd, whatever mode asks first
                self._on[device] = torch.as_tensor(self.array, dtype=self.dtype, device=device)
        return self._on[device]


class WindowAttention(nn.Module):
    """Attention over `pack` windows of ws^2 tokens per call (block-diagonal
    masked); the relative-position bias of each head is kron(I_pack, table[idx])."""

    def __init__(self, dim: int, window_size: int, num_heads: int, qkv_bias: bool = True,
                 pack: int = 1, dtype: torch.dtype = torch.float32,
                 softmax_dtype: torch.dtype = torch.float32, attn_impl: str = "einsum",
                 attn_interpret: bool = False):
        super().__init__()
        if attn_impl not in WINDOW_IMPLS:
            raise ValueError(f"unknown Swin attn_impl {attn_impl!r}")
        self.num_heads = num_heads
        self.window_size = window_size
        self.pack = pack
        self.dtype = dtype
        self.softmax_dtype = softmax_dtype
        self.attn_impl = attn_impl
        self.attn_interpret = attn_interpret
        self.qkv = Dense(dim, 3 * dim, dtype=dtype, kernel_init=_trunc02, use_bias=qkv_bias)
        self.relative_position_bias_table = nn.Parameter(
            torch.empty((2 * window_size - 1) ** 2, num_heads))
        self._index = _DeviceConstant(_relative_position_index(window_size).reshape(-1), torch.long)
        self.proj = Dense(dim, dim, dtype=dtype, kernel_init=_trunc02)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        _trunc02(self.relative_position_bias_table, generator=generator)

    def _bias(self) -> torch.Tensor:
        """[h, pack*ws^2, pack*ws^2] f32, differentiable in the table."""
        table = self.relative_position_bias_table
        l = self.window_size ** 2
        h = self.num_heads
        bias = table[self._index.on(table.device)].reshape(l, l, h).permute(2, 0, 1)
        if self.pack > 1:
            eye = torch.eye(self.pack, dtype=bias.dtype, device=bias.device)
            g = self.pack
            bias = torch.einsum("ab,hij->haibj", eye, bias).reshape(h, g * l, g * l)
        return bias

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, lg, c = x.shape  # b = batch * window groups, lg = pack * ws^2
        h = self.num_heads
        hd = c // h
        scale = hd**-0.5
        qkv = self.qkv(x).reshape(b, lg, 3, h, hd).permute(2, 0, 3, 1, 4)  # [3, b, h, lg, hd]
        q, k, v = qkv.unbind(0)
        bias = self._bias()
        if resolve_window_impl(self.attn_impl, x.device, self.attn_interpret) == "fused":
            out = fused_window_attention(q.contiguous(), k.contiguous(), v.contiguous(), bias,
                                         mask, scale=scale)
        else:
            acc = self.softmax_dtype
            ct = torch.promote_types(q.dtype, acc)  # an einsum with preferred_element_type=acc
            attn = torch.matmul((q * scale).to(ct), k.to(ct).transpose(-1, -2)).to(acc)
            attn = attn + bias[None].to(acc)
            if mask is not None:
                nw = mask.shape[0]
                attn = attn.view(b // nw, nw, h, lg, lg) + mask[None, :, None].to(acc)
                attn = attn.view(b, h, lg, lg)
            attn = torch.softmax(attn, dim=-1).to(self.dtype)
            out = torch.matmul(attn, v)
        return self.proj(out.transpose(1, 2).reshape(b, lg, c))


class SwinBlock(nn.Module):
    def __init__(self, dim: int, input_resolution: Tuple[int, int], num_heads: int,
                 window_size: int = 7, shift_size: int = 0, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, drop_path: float = 0.0, win_pack: int = 2,
                 dtype: torch.dtype = torch.float32, softmax_dtype: torch.dtype = torch.float32,
                 attn_impl: str = "einsum", attn_interpret: bool = False):
        super().__init__()
        hres, wres = input_resolution
        ws, shift = window_size, shift_size
        if min(hres, wres) <= ws:  # the window covers the map: no shift
            ws, shift = min(hres, wres), 0
        nwin = (hres // ws) * (wres // ws)
        g = max(1, min(win_pack, nwin))
        while nwin % g:
            g -= 1
        self.resolution, self.ws, self.shift, self.nwin, self.g = (hres, wres), ws, shift, nwin, g
        mask = _packed_attn_mask(hres, wres, ws, shift, g)
        self._mask = None if mask is None else _DeviceConstant(mask, torch.float32)
        self.norm1 = LayerNorm(dim, eps=1e-5, dtype=dtype)
        self.attn = WindowAttention(dim, ws, num_heads, qkv_bias, pack=g, dtype=dtype,
                                    softmax_dtype=softmax_dtype, attn_impl=attn_impl,
                                    attn_interpret=attn_interpret)
        self.dp1 = DropPath(drop_path)
        self.norm2 = LayerNorm(dim, eps=1e-5, dtype=dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype=dtype)
        self.dp2 = DropPath(drop_path)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        (hres, wres), ws, shift, g = self.resolution, self.ws, self.shift, self.g
        n, l, c = x.shape
        shortcut = x
        x = self.norm1(x).reshape(n, hres, wres, c)
        if shift > 0:
            x = torch.roll(x, shifts=(-shift, -shift), dims=(1, 2))
        windows = window_partition(x, ws)
        if g > 1:
            windows = windows.reshape(n * self.nwin // g, g * ws * ws, c)
        mask = self._mask.on(x.device) if self._mask is not None else None
        out = self.attn(windows, mask)
        if g > 1:
            out = out.reshape(n * self.nwin, ws * ws, c)
        x = window_reverse(out, ws, hres, wres)
        if shift > 0:
            x = torch.roll(x, shifts=(shift, shift), dims=(1, 2))
        x = shortcut + self.dp1(x.reshape(n, l, c), generator)
        return x + self.dp2(self.mlp(self.norm2(x)), generator)


class PatchMerging(nn.Module):
    def __init__(self, input_resolution: Tuple[int, int], dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.resolution = input_resolution
        self.norm = LayerNorm(4 * dim, eps=1e-5, dtype=dtype)
        self.reduction = Dense(4 * dim, 2 * dim, dtype=dtype, kernel_init=_trunc02, use_bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = self.resolution
        n, _, c = x.shape
        x = x.reshape(n, h // 2, 2, w // 2, 2, c)
        # the JAX model's concat order (`passl_tpu/models/swin_transformer.py:302-304`)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(n, (h // 2) * (w // 2), 4 * c)
        return self.reduction(self.norm(x))


@register_model
class SwinTransformer(nn.Module):
    """images [n, H, W, 3] (NHWC) -> logits [n, num_classes] at `dtype`.

    In training, `generator` (a torch.Generator on the images' device) draws
    the stochastic-depth masks of every block, in block order.
    """

    def __init__(self, img_size: int = 224, patch_size: int = 4, embed_dim: int = 96,
                 depths: Sequence[int] = (2, 2, 6, 2), num_heads: Sequence[int] = (3, 6, 12, 24),
                 window_size: int = 7, mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 drop_rate: float = 0.0, attn_drop_rate: float = 0.0,
                 drop_path_rate: float = 0.1, ape: bool = False, patch_norm: bool = True,
                 num_classes: int = 1000, win_pack: int = 2, lane_pad: int = 0,
                 softmax_dtype: DtypeLike = "float32", attn_impl: str = "einsum",
                 attn_interpret: bool = False, remat: bool = False,
                 dtype: DtypeLike = torch.float32, in_chans: int = 3):
        super().__init__()
        if lane_pad:
            raise NotImplementedError("Swin lane_pad is a TPU lane-layout trick the port does not "
                                      "carry (ROADMAP: do not port)")
        if win_pack > 2:
            raise NotImplementedError(f"Swin win_pack={win_pack}: the port packs at most 2 "
                                      "windows (win_pack=4 is a measured TPU negative)")
        if remat:
            raise NotImplementedError("Swin remat (activation recompute) is not ported yet")
        if drop_rate or attn_drop_rate:
            raise NotImplementedError("Swin drop_rate / attn_drop_rate > 0 are not ported yet")
        dtype = resolve_dtype(dtype)
        softmax_dtype = resolve_dtype(softmax_dtype)
        self.img_size = img_size
        self.in_chans = in_chans
        self.depths = tuple(depths)
        self.patch_embed = Conv2d(in_chans, embed_dim, patch_size, patch_size, dtype=dtype,
                                  kernel_init=_trunc02)
        gh = gw = img_size // patch_size
        self.patch_norm = LayerNorm(embed_dim, eps=1e-5, dtype=dtype) if patch_norm else None
        self.absolute_pos_embed = nn.Parameter(torch.empty(1, gh * gw, embed_dim)) if ape else None

        dpr = np.linspace(0, drop_path_rate, sum(depths))
        cur = 0
        res, dim = (gh, gw), embed_dim
        for i, depth in enumerate(depths):
            setattr(self, f"layers_{i}_blocks", nn.ModuleList(
                SwinBlock(dim, res, num_heads[i], window_size,
                          shift_size=0 if j % 2 == 0 else window_size // 2,
                          mlp_ratio=mlp_ratio, qkv_bias=qkv_bias, drop_path=float(dpr[cur + j]),
                          win_pack=win_pack, dtype=dtype, softmax_dtype=softmax_dtype,
                          attn_impl=attn_impl, attn_interpret=attn_interpret)
                for j in range(depth)))
            cur += depth
            if i < len(depths) - 1:
                setattr(self, f"layers_{i}_downsample", PatchMerging(res, dim, dtype))
                res, dim = (res[0] // 2, res[1] // 2), dim * 2
        self.norm = LayerNorm(dim, eps=1e-5, dtype=dtype)
        self.head = (Dense(dim, num_classes, dtype=dtype, kernel_init=_trunc02)
                     if num_classes > 0 else Identity())

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        if self.absolute_pos_embed is not None:
            _trunc02(self.absolute_pos_embed, generator=generator)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.patch_embed(x.permute(0, 3, 1, 2))  # NHWC -> NCHW
        x = x.flatten(2).transpose(1, 2)  # [n, h*w, c], rows in the flax order
        if self.patch_norm is not None:
            x = self.patch_norm(x)
        if self.absolute_pos_embed is not None:
            x = x + self.absolute_pos_embed.to(x.dtype)
        for i in range(len(self.depths)):
            for blk in getattr(self, f"layers_{i}_blocks"):
                x = blk(x, generator)
            if i < len(self.depths) - 1:
                x = getattr(self, f"layers_{i}_downsample")(x)
        x = self.norm(x).mean(dim=1)  # at the compute dtype, as jnp.mean
        return self.head(x)


_SWIN = {
    "swin_tiny_patch4_window7_224": dict(embed_dim=96, depths=(2, 2, 6, 2), num_heads=(3, 6, 12, 24)),
    "swin_small_patch4_window7_224": dict(embed_dim=96, depths=(2, 2, 18, 2), num_heads=(3, 6, 12, 24)),
    "swin_base_patch4_window7_224": dict(embed_dim=128, depths=(2, 2, 18, 2), num_heads=(4, 8, 16, 32)),
    "swin_base_patch4_window12_384": dict(img_size=384, window_size=12, embed_dim=128,
                                          depths=(2, 2, 18, 2), num_heads=(4, 8, 16, 32)),
    "swin_large_patch4_window7_224": dict(embed_dim=192, depths=(2, 2, 18, 2), num_heads=(6, 12, 24, 48)),
    "swin_huge_patch4_window7_224": dict(embed_dim=354, depths=(2, 2, 18, 2), num_heads=(6, 12, 24, 48)),
    "swin_giant_patch4_window7_224": dict(embed_dim=512, depths=(2, 2, 42, 2), num_heads=(8, 16, 32, 64)),
}


def _variant(name: str, cfg: dict):
    def factory(**kw) -> SwinTransformer:
        return SwinTransformer(**{**cfg, **kw})

    factory.__name__ = name
    return factory


for _name, _cfg in _SWIN.items():
    MODELS.register(_variant(_name, _cfg), name=_name)

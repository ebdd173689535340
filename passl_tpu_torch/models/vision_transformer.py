"""Vision Transformer (counterpart of `passl_tpu/models/vision_transformer.py:42-161`).

Patch embedding (NHWC in), a class token and a learned position embedding
(f32, trunc-normal 0.02), pre-norm blocks with optional LayerScale and
stochastic depth, then the class token through `norm` (or the mean of the
patch tokens through `fc_norm` with `global_pool`) and the head. Module and
parameter names follow the flax model's, so `utils.convert.flax_to_torch`
maps one onto the other: flax `blocks_{i}` is item i of the ModuleList
`blocks`.

Precision follows the JAX model: Dense/Conv/LayerNorm compute at `dtype`
with f32 parameters; the einsum path takes q * scale at `dtype` and the
scores and softmax at `softmax_dtype`; the flash path (`attn_impl: flash`,
the CUDA kernels of `ops/attention.py`) keeps its scores and softmax in f32
whatever `softmax_dtype` says, as the JAX library kernel does.

`interpolate_pos_embed` resizes a position embedding to another grid for
finetuning at a new resolution, as `jax.image.resize(method="bicubic")`
does in the JAX package; the pretrained loader (`utils/io.py`) calls it.

`remat` recomputes each block's activations in the backward (the JAX
model's `nn.remat(Block)`, `passl_tpu/models/vision_transformer.py:121-143`):
each block runs under non-reentrant `torch.utils.checkpoint`, and
`remat_policy` says what it saves (`ops/attention.py:87
resolve_remat_policy` of the JAX package): `nothing` the block's input
alone; `dots_no_batch` the products without a batch dimension (the Dense
layers' `mm` / `addmm`) through selective checkpointing, so that the
attention, flash kernel included, is recomputed; `dots` every product
(`bmm` too). A block's stochastic-depth uniforms are drawn before it and
handed in, so the recompute replays them as flax's remat replays its key.

Not ported yet, and refused: dropout (`drop_rate`, `attn_drop_rate`) and
`pipeline`.
"""
from __future__ import annotations

import functools
from typing import Optional, Union

import numpy as np
import torch
from torch import nn
from torch.utils import checkpoint as torch_checkpoint

from ..core.amp import resolve_dtype
from ..nn import init as tinit
from ..nn.layers import Block, Dense, LayerNorm, PatchEmbed
from .base import MODELS, register_model

DtypeLike = Union[str, torch.dtype]
_trunc02 = functools.partial(tinit.trunc_normal_, std=0.02)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic kernel with a = -0.5 at distances x >= 0 (`jax.image`'s
    bicubic; torch's `F.interpolate(mode="bicubic")` takes a = -0.75)."""
    near = ((1.5 * x - 2.5) * x) * x + 1.0
    far = ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0
    return torch.where(x >= 2.0, 0.0, torch.where(x >= 1.0, far, near))


def _resize_weights(n_in: int, n_out: int) -> torch.Tensor:
    """[n_in, n_out] f32 weights of `jax.image.resize(method="bicubic")` along
    one axis, computed as `jax/_src/image/scale.py` `compute_weight_mat` does
    with scale n_out / n_in, no translation and antialias on: half-pixel
    centres; when shrinking the kernel widens by n_in / n_out; each output's
    weights sum to 1."""
    inv = 1.0 / torch.tensor(n_out / n_in, dtype=torch.float32)
    sample = (torch.arange(n_out, dtype=torch.float32) + 0.5) * inv - 0.5
    dist = (sample[None, :] - torch.arange(n_in, dtype=torch.float32)[:, None]).abs()
    w = _keys_cubic(dist / torch.clamp(inv, min=1.0))
    total = w.sum(0, keepdim=True)
    eps = 1000.0 * float(torch.finfo(torch.float32).eps)
    w = torch.where(total.abs() > eps, w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def interpolate_pos_embed(pos_embed: torch.Tensor, new_grid: int,
                          num_prefix: int = 1) -> torch.Tensor:
    """Bicubic-resize the grid part of a [1, P + prefix, C] position embedding
    to new_grid x new_grid, the prefix (class token) kept: the counterpart of
    `passl_tpu/models/vision_transformer.py:28-38`, with `jax.image.resize`'s
    weights (summed in float64, returned at the input's type), differentiable,
    on the input's device."""
    prefix, grid = pos_embed[:, :num_prefix], pos_embed[:, num_prefix:]
    old = int(round(grid.shape[1] ** 0.5))
    c = grid.shape[-1]
    w = _resize_weights(old, new_grid).to(device=grid.device, dtype=torch.float64)
    out = torch.einsum("iy,jx,ijc->yxc", w, w, grid.reshape(old, old, c).double())
    out = out.reshape(1, new_grid * new_grid, c).to(pos_embed.dtype)
    return torch.cat([prefix, out], dim=1)


_aten = torch.ops.aten
# the products each remat policy saves (by overload packet); None: the block's input only
REMAT_POLICIES = {
    "nothing": None,
    "dots_no_batch": (_aten.mm, _aten.addmm),
    "dots": (_aten.mm, _aten.addmm, _aten.bmm, _aten.baddbmm),
}


def remat_context(policy: str):
    """The `context_fn` of `torch.utils.checkpoint.checkpoint` for a remat
    policy (None for `nothing`); ValueError naming the three on another name,
    as the JAX package's `resolve_remat_policy`."""
    if policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {policy!r}; expected one of "
                         f"{sorted(REMAT_POLICIES)}")
    saved = REMAT_POLICIES[policy]
    if saved is None:
        return None

    def keep(ctx, func, *args, **kwargs):
        return (torch_checkpoint.CheckpointPolicy.MUST_SAVE if func.overloadpacket in saved
                else torch_checkpoint.CheckpointPolicy.PREFER_RECOMPUTE)

    return functools.partial(torch_checkpoint.create_selective_checkpoint_contexts, keep)


def run_blocks(blocks, x: torch.Tensor, generator: Optional[torch.Generator],
               remat_policy: Optional[str] = None) -> torch.Tensor:
    """x through each block in turn; with a `remat_policy`, where gradients
    are taken, each block runs under non-reentrant checkpointing with its
    stochastic-depth uniforms drawn before it (the draws are the same, in the
    same order, as without remat)."""
    if remat_policy is None or not torch.is_grad_enabled():
        for blk in blocks:
            x = blk(x, generator)
        return x
    context = remat_context(remat_policy)
    kw = {"context_fn": context} if context is not None else {}
    for blk in blocks:
        draws = blk.draw(x, generator)
        # the block draws nothing from the global RNGs: there is no state to keep
        x = torch_checkpoint.checkpoint(blk, x, None, draws, use_reentrant=False,
                                        preserve_rng_state=False, **kw)
    return x


HEAD_INITS = {
    "trunc_normal": _trunc02,
    "zeros": tinit.zeros_,
    "small": lambda t, generator=None: torch.nn.init.normal_(t, 0.0, 0.01, generator=generator),
}


@register_model
class VisionTransformer(nn.Module):
    """images [n, H, W, 3] (NHWC) -> logits [n, num_classes] at `dtype`, or the
    features [n, embed_dim] with `return_features` or `num_classes=0`.

    In training, `generator` (a torch.Generator on the images' device) draws
    the stochastic-depth masks of every block, in block order.
    """

    def __init__(self, img_size: int = 224, patch_size: int = 16, embed_dim: int = 768,
                 depth: int = 12, num_heads: int = 12, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, qk_scale: Optional[float] = None, drop_rate: float = 0.0,
                 attn_drop_rate: float = 0.0, drop_path_rate: float = 0.0,
                 init_values: Optional[float] = None, num_classes: int = 1000,
                 global_pool: bool = False, norm_eps: float = 1e-6,
                 softmax_dtype: DtypeLike = "float32", attn_impl: str = "einsum",
                 dtype: DtypeLike = torch.float32, head_init: str = "trunc_normal",
                 stop_grad_patch_embed: bool = False, remat: bool = False,
                 remat_policy: str = "nothing", pipeline: bool = False, num_microbatches: int = 4,
                 in_chans: int = 3):
        super().__init__()
        if drop_rate or attn_drop_rate:
            raise NotImplementedError("ViT drop_rate / attn_drop_rate > 0 are not ported yet")
        if remat:
            remat_context(remat_policy)  # an unknown policy raises here, as JAX's at trace
        if pipeline:
            raise NotImplementedError("ViT pipeline (pipeline parallelism) is not ported yet")
        if head_init not in HEAD_INITS:
            raise ValueError(f"unknown head_init {head_init!r}; expected one of {sorted(HEAD_INITS)}")
        dtype = resolve_dtype(dtype)
        softmax_dtype = resolve_dtype(softmax_dtype)
        self.img_size = img_size
        self.in_chans = in_chans
        self.embed_dim = embed_dim
        self.out_channels = embed_dim  # the features' width (a probe's head takes it)
        self.remat_policy = remat_policy if remat else None
        self.global_pool = global_pool
        self.num_classes = num_classes
        self.stop_grad_patch_embed = stop_grad_patch_embed
        self.patch_embed = PatchEmbed(patch_size, embed_dim, in_chans, dtype=dtype)
        num_patches = (img_size // patch_size) ** 2
        self.cls_token = nn.Parameter(torch.empty(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.empty(1, num_patches + 1, embed_dim))
        dpr = np.linspace(0, drop_path_rate, depth)
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio, qkv_bias, qk_scale, drop_path=float(dpr[i]),
                  init_values=init_values, norm_eps=norm_eps, dtype=dtype,
                  softmax_dtype=softmax_dtype, attn_impl=attn_impl)
            for i in range(depth))
        norm = LayerNorm(embed_dim, eps=norm_eps, dtype=dtype)
        if global_pool:
            self.fc_norm = norm
        else:
            self.norm = norm
        if num_classes > 0:
            self.head = Dense(embed_dim, num_classes, dtype=dtype, kernel_init=HEAD_INITS[head_init])

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        _trunc02(self.cls_token, generator=generator)
        _trunc02(self.pos_embed, generator=generator)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                return_features: bool = False) -> torch.Tensor:
        n = x.shape[0]
        x = self.patch_embed(x)
        if self.stop_grad_patch_embed:
            x = x.detach()
        cls = self.cls_token.to(x.dtype).expand(n, -1, -1)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(x.dtype)
        x = run_blocks(self.blocks, x, generator, self.remat_policy)
        if self.global_pool:
            feats = self.fc_norm(x[:, 1:].mean(dim=1))
        else:
            # LayerNorm is per token: norming the class token alone equals the
            # JAX model's norm over every token followed by taking token 0
            feats = self.norm(x[:, 0])
        if return_features or self.num_classes == 0:
            return feats
        return self.head(feats)


_VARIANTS = {
    "ViT_tiny_patch16_224": dict(patch_size=16, embed_dim=192, depth=12, num_heads=3),
    "ViT_small_patch16_224": dict(patch_size=16, embed_dim=384, depth=12, num_heads=6),
    "ViT_base_patch16_224": dict(patch_size=16, embed_dim=768, depth=12, num_heads=12),
    "ViT_base_patch16_384": dict(img_size=384, patch_size=16, embed_dim=768, depth=12, num_heads=12),
    "ViT_base_patch32_224": dict(patch_size=32, embed_dim=768, depth=12, num_heads=12),
    "ViT_base_patch32_384": dict(img_size=384, patch_size=32, embed_dim=768, depth=12, num_heads=12),
    "ViT_large_patch16_224": dict(patch_size=16, embed_dim=1024, depth=24, num_heads=16),
    "ViT_large_patch16_384": dict(img_size=384, patch_size=16, embed_dim=1024, depth=24, num_heads=16),
    "ViT_large_patch32_384": dict(img_size=384, patch_size=32, embed_dim=1024, depth=24, num_heads=16),
    "ViT_huge_patch14_224": dict(patch_size=14, embed_dim=1280, depth=32, num_heads=16),
    "ViT_g_patch14_224": dict(patch_size=14, embed_dim=1664, depth=48, num_heads=16,
                              mlp_ratio=4.9231),
    "mocov3_vit_small": dict(patch_size=16, embed_dim=384, depth=12, num_heads=12),
    "mocov3_vit_base": dict(patch_size=16, embed_dim=768, depth=12, num_heads=12),
    # the tensor-parallel aliases of the JAX package: the same module (tensor
    # parallelism is not ported, so they run on one card)
    "ViT_hybrid_base_patch16_224": dict(patch_size=16, embed_dim=768, depth=12, num_heads=12),
    "ViT_hybrid_large_patch16_224": dict(patch_size=16, embed_dim=1024, depth=24, num_heads=16),
}


def _variant(name: str, cfg: dict):
    def factory(**kw) -> VisionTransformer:
        return VisionTransformer(**{**cfg, **kw})

    factory.__name__ = name
    return factory


for _name, _cfg in _VARIANTS.items():
    MODELS.register(_variant(_name, _cfg), name=_name)

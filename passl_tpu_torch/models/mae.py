"""MAE: masked-autoencoder pretraining and the global-pool ViT that finetunes
or probes its encoder (counterpart of `passl_tpu/models/mae.py`).

`MaskedAutoencoderViT` (JAX `:69-140`): the patch embedding plus the fixed
2-D sin-cos table (`models/utils/pos_embed.py`, not a parameter), then
`random_masking` keeps `int(L (1 - mask_ratio))` patches of each image, the
class token (normal 0.02) plus its table entry goes in front, and the
encoder's blocks and `norm` run over the visible tokens alone. The decoder
embeds them to `decoder_embed_dim`, appends `mask_token` (normal 0.02) for
the masked patches, puts every token back in its place (`ids_restore`), adds
its own sin-cos table and runs `decoder_blocks`, `decoder_norm` and
`decoder_pred`. The loss is the mean squared error over the masked patches
alone, in f32, against each patch's pixels normalised by their own mean and
variance (`norm_pix_loss`).

The masking noise comes from one module-level function, `masking_noise(n,
l, generator, device)`, looked up at call time: in training it draws from
the `generator` the train step hands the model (the train state's), and
tests hand it the JAX package's draws. In eval it draws from a generator
seeded with 0. A deliberate difference: the JAX model's eval key is
`PRNGKey(0)`, whose draws the torch generator does not reproduce.

`MAEVisionTransformer` (JAX `:143-147`) is the ViT with `global_pool` on.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
from torch import nn

from ..core.amp import at_least_f32, resolve_dtype
from ..nn import init as tinit
from ..nn.layers import Block, Dense, LayerNorm, PatchEmbed
from .base import MODELS, register_model
from .utils import FixedTable
from .utils.pos_embed import get_2d_sincos_pos_embed
from .vision_transformer import VisionTransformer

DtypeLike = Union[str, torch.dtype]
EVAL_SEED = 0  # the eval masks' generator (JAX: PRNGKey(0))


def patchify(imgs: torch.Tensor, p: int) -> torch.Tensor:
    """NHWC [N, H, W, C] -> [N, L, p * p * C], each patch laid out (p, p, C)."""
    n, h, w, c = imgs.shape
    gh, gw = h // p, w // p
    x = imgs.reshape(n, gh, p, gw, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, gh * gw, p * p * c)


def unpatchify(x: torch.Tensor, p: int) -> torch.Tensor:
    """[N, L, p * p * C] -> NHWC [N, sqrt(L) p, sqrt(L) p, C]."""
    n, l, d = x.shape
    g = int(l ** 0.5)
    c = d // (p * p)
    x = x.reshape(n, g, g, p, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, g * p, g * p, c)


def masking_noise(n: int, l: int, generator: torch.Generator,
                  device: torch.device) -> torch.Tensor:
    """The [n, l] f32 uniforms whose argsort orders each image's patches."""
    return torch.rand(n, l, generator=generator, device=device)


def random_masking(x: torch.Tensor, mask_ratio: float, noise: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x [N, L, D] -> (the kept tokens [N, len_keep, D], the mask [N, L] at x's
    type, 1 where a patch is masked, ids_restore [N, L]): the patches in
    ascending order of `noise` (a stable argsort, as `jnp.argsort`), the
    first `int(L (1 - mask_ratio))` kept."""
    n, l, d = x.shape
    len_keep = int(l * (1 - mask_ratio))
    ids_shuffle = torch.argsort(noise, dim=1, stable=True)
    ids_restore = torch.argsort(ids_shuffle, dim=1, stable=True)
    ids_keep = ids_shuffle[:, :len_keep]
    x_masked = torch.gather(x, 1, ids_keep[:, :, None].expand(-1, -1, d))
    mask = torch.ones(n, l, dtype=x.dtype, device=x.device)
    mask[:, :len_keep] = 0
    return x_masked, torch.gather(mask, 1, ids_restore), ids_restore


def _normal02(t: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    return tinit.normal_(t, std=0.02, generator=generator)


@register_model
class MaskedAutoencoderViT(nn.Module):
    """images [N, H, W, 3] NHWC (or the loader's (images, labels)) ->
    {"loss": scalar f32}."""

    def __init__(self, img_size: int = 224, patch_size: int = 16, embed_dim: int = 1024,
                 depth: int = 24, num_heads: int = 16, decoder_embed_dim: int = 512,
                 decoder_depth: int = 8, decoder_num_heads: int = 16, mlp_ratio: float = 4.0,
                 norm_pix_loss: bool = True, mask_ratio: float = 0.75,
                 softmax_dtype: DtypeLike = "float32", attn_impl: str = "einsum",
                 dtype: DtypeLike = torch.float32):
        super().__init__()
        dtype = resolve_dtype(dtype)
        softmax_dtype = resolve_dtype(softmax_dtype)
        self.img_size = img_size
        self.patch_size = patch_size
        self.norm_pix_loss = norm_pix_loss
        self.mask_ratio = mask_ratio
        grid = img_size // patch_size
        self.num_patches = grid * grid
        self.patch_embed = PatchEmbed(patch_size, embed_dim, dtype=dtype)
        self.pos_embed = FixedTable(get_2d_sincos_pos_embed(embed_dim, grid, cls_token=True)[None])
        self.cls_token = nn.Parameter(torch.empty(1, 1, embed_dim))

        def blocks(dim, heads, n):
            return nn.ModuleList(
                Block(dim, heads, mlp_ratio, qkv_bias=True, dtype=dtype,
                      softmax_dtype=softmax_dtype, attn_impl=attn_impl) for _ in range(n))

        self.blocks = blocks(embed_dim, num_heads, depth)
        self.norm = LayerNorm(embed_dim, eps=1e-6, dtype=dtype)
        self.decoder_embed = Dense(embed_dim, decoder_embed_dim, dtype=dtype)
        self.mask_token = nn.Parameter(torch.empty(1, 1, decoder_embed_dim))
        self.decoder_pos_embed = FixedTable(
            get_2d_sincos_pos_embed(decoder_embed_dim, grid, cls_token=True)[None])
        self.decoder_blocks = blocks(decoder_embed_dim, decoder_num_heads, decoder_depth)
        self.decoder_norm = LayerNorm(decoder_embed_dim, eps=1e-6, dtype=dtype)
        self.decoder_pred = Dense(decoder_embed_dim, patch_size * patch_size * 3, dtype=dtype)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        _normal02(self.cls_token, generator=generator)
        _normal02(self.mask_token, generator=generator)

    def forward(self, batch, generator: Optional[torch.Generator] = None) -> dict:
        imgs = batch[0] if isinstance(batch, (tuple, list)) else batch
        if self.training:
            if generator is None:
                raise ValueError("MaskedAutoencoderViT: training draws its masks from the train "
                                 "state's generator; none was given")
        else:
            generator = torch.Generator(device=imgs.device).manual_seed(EVAL_SEED)

        # encoder, over the visible patches
        x = self.patch_embed(imgs)
        pos = self.pos_embed.on(x.device)
        x = x + pos[:, 1:].to(x.dtype)
        noise = masking_noise(x.shape[0], x.shape[1], generator, x.device)
        x, mask, ids_restore = random_masking(x, self.mask_ratio, noise)
        cls = (self.cls_token + pos[:, :1]).to(x.dtype).expand(x.shape[0], -1, -1)
        x = torch.cat([cls, x], dim=1)
        for blk in self.blocks:  # no stochastic depth: nothing to draw
            x = blk(x)
        x = self.norm(x)

        # decoder, over every patch
        x = self.decoder_embed(x)
        n, kept, c = x.shape
        mask_tokens = self.mask_token.to(x.dtype).expand(n, self.num_patches + 1 - kept, -1)
        x_ = torch.cat([x[:, 1:], mask_tokens], dim=1)
        x_ = torch.gather(x_, 1, ids_restore[:, :, None].expand(-1, -1, c))  # unshuffle
        x = torch.cat([x[:, :1], x_], dim=1) + self.decoder_pos_embed.on(x.device).to(x.dtype)
        for blk in self.decoder_blocks:
            x = blk(x)
        x = self.decoder_norm(x)
        pred = self.decoder_pred(x)[:, 1:]

        # the norm-pix MSE over the masked patches, in f32 (f64 for a model run in f64)
        pred = at_least_f32(pred)
        target = patchify(imgs.to(pred.dtype), self.patch_size)
        if self.norm_pix_loss:
            mean = target.mean(dim=-1, keepdim=True)
            var = target.var(dim=-1, keepdim=True, unbiased=False)
            target = (target - mean) / torch.sqrt(var + 1e-6)
        loss = torch.mean(torch.square(pred - target), dim=-1)
        return {"loss": torch.sum(loss * mask) / torch.sum(mask)}


@register_model
class MAEVisionTransformer(VisionTransformer):
    """The finetune and probe model: the ViT with `global_pool` on by default."""

    def __init__(self, *args, global_pool: bool = True, **kw):
        super().__init__(*args, global_pool=global_pool, **kw)


def _mae_variant(name: str, **defaults):
    def factory(**kw) -> MaskedAutoencoderViT:
        return MaskedAutoencoderViT(**{**defaults, **kw})

    factory.__name__ = name
    MODELS.register(factory, name=name)


_mae_variant("mae_vit_base_patch16", embed_dim=768, depth=12, num_heads=12,
             decoder_embed_dim=512, decoder_depth=8, decoder_num_heads=16)
_mae_variant("mae_vit_large_patch16", embed_dim=1024, depth=24, num_heads=16,
             decoder_embed_dim=512, decoder_depth=8, decoder_num_heads=16)
_mae_variant("mae_vit_huge_patch14", patch_size=14, embed_dim=1280, depth=32, num_heads=16,
             decoder_embed_dim=512, decoder_depth=8, decoder_num_heads=16)

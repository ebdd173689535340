"""DINO and DINOv2: the ViTs, their linear probes and their pretraining
(counterpart of `passl_tpu/models/dino.py`).

`DINOVisionTransformer` (JAX `:25-69`): the ViT's patch embedding, a class
token and a position embedding (truncated normal 0.02) for `img_size`'s grid,
the ViT's `Block`s with a qkv bias (LayerScale where `init_values` is set;
no stochastic depth) and one `norm`; it returns the normed class tokens of
the last `n_last_blocks` blocks, concatenated, and with `return_patch_avg`
the mean of the last block's normed patch tokens after them. A crop whose
grid differs from `img_size`'s takes the position embedding through
`interpolate_pos_embed` inside the forward, so its gradient reaches
`pos_embed` through the resize, as JAX differentiates `jax.image.resize`.

`DINOLinearProbe` and `DINOv2LinearProbe` (JAX `:72-104`): the encoder in
eval under `torch.no_grad()` and frozen, and a linear head of normal(0.01)
weights and zero bias. The probe passes its `encoder` keywords through as
they are, as the JAX code does: a DINOv2 probe config without
`init_values` builds its encoder without LayerScale, whatever the JAX
docstring says. The eight `_DINO_VARIANTS` factories return the encoder.

`DINOHead` (JAX `:132-155`): fc1, gelu, fc2, gelu, fc3 (flax's tanh gelu),
the output l2-normalised in f32, times the raw `prototypes` matrix
`[bottleneck, out_dim]`, each column l2-normalised at use.

`DINOPretrain` (JAX `:158-247`): `student` and `teacher` towers (backbone and
head). The student runs once per crop resolution, its crops grouped in the
order of their first appearance (images NHWC: grouped on H); the teacher on
the global crops under `torch.no_grad()`. The loss is the mean over every
teacher global crop and every other student crop of the cross-entropy of
the student's softmax at `student_temp` against the teacher's at
`teacher_temp` around the `center` buffer (the JAX `ssl` collection), which
then, in training only, moves to `center_momentum` of itself plus the rest
of the mean of the teacher's raw outputs. `ema_map` moves the teacher
towards the student with the cosine schedule from `base_momentum`;
`frozen_patterns` keeps the optimizer off the teacher.

`DINOv2Pretrain` and `DINOv2Backbone` (JAX `:250-421`): the towers' backbone
returns every normed token and takes LayerScale (`init_values` 1.0 unless
the config sets it). On the global crops the student sees `mask_token` at
the masked patches, each patch masked where a uniform draw is below
`mask_ratio`. The head runs on every token of the global crops. The loss is
the image-level DINO loss over the class tokens (the local crops, unmasked,
one student forward each), the iBOT loss (the student's masked patch tokens
against the teacher's around `patch_center`) and the KoLeo spread of the
student's global class features, weighted `1`, `ibot_weight` and
`koleo_weight`; both centers move after it. The draws come from one
module-level function, `masking_noise(n, l, generator, device)`, looked up
at call time: in training from the generator the train step hands over,
in eval from a generator seeded with 0. A deliberate difference: the JAX
model's eval key is `PRNGKey(0)`, whose draws the torch generator does not
reproduce. The teacher never takes a mask, so flax never creates
`teacher/backbone/mask_token`; the JAX engine copies the student into the
teacher before training and the EMA then moves that inert token, as the
port's engine does (`flax_absent` lets the converter fill it).
"""
from __future__ import annotations

import functools
from typing import Optional, Union

import torch
from torch import nn

from ..core.amp import at_least_f32, resolve_dtype
from ..nn import init as tinit
from ..nn.layers import Block, Dense, LayerNorm, PatchEmbed, gelu
from ..nn.norm import l2_normalize
from .base import MODELS, register_model
from .vision_transformer import interpolate_pos_embed

DtypeLike = Union[str, torch.dtype]
EVAL_SEED = 0  # DINOv2's eval masks' generator (JAX: PRNGKey(0))
_trunc02 = functools.partial(tinit.trunc_normal_, std=0.02)


class _ViT(nn.Module):
    """The patch embedding, class token, position embedding (resized to the
    input's grid) and blocks shared by the DINO and DINOv2 encoders."""

    def __init__(self, img_size: int = 224, patch_size: int = 16, embed_dim: int = 384,
                 depth: int = 12, num_heads: int = 6, mlp_ratio: float = 4.0,
                 init_values: Optional[float] = None, norm_eps: float = 1e-6,
                 dtype: DtypeLike = torch.float32):
        super().__init__()
        dtype = resolve_dtype(dtype)
        self.img_size = img_size
        self.patch_size = patch_size
        self.embed_dim = embed_dim
        self.patch_embed = PatchEmbed(patch_size, embed_dim, dtype=dtype)
        base = (img_size // patch_size) ** 2
        self.cls_token = nn.Parameter(torch.empty(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.empty(1, base + 1, embed_dim))
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio, qkv_bias=True, init_values=init_values,
                  norm_eps=norm_eps, dtype=dtype) for _ in range(depth))
        self.norm = LayerNorm(embed_dim, eps=norm_eps, dtype=dtype)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        _trunc02(self.cls_token, generator=generator)
        _trunc02(self.pos_embed, generator=generator)

    def _tokens(self, x: torch.Tensor) -> torch.Tensor:
        """Patch tokens [n, L, D] -> the class token in front, the position
        embedding added (resized where L is not `img_size`'s grid)."""
        n, num_patches = x.shape[:2]
        pos = self.pos_embed
        if num_patches != pos.shape[1] - 1:  # multi-crop: this resolution's grid
            pos = interpolate_pos_embed(pos, int(num_patches ** 0.5), num_prefix=1)
        cls = self.cls_token.to(x.dtype).expand(n, -1, -1)
        return torch.cat([cls, x], dim=1) + pos.to(x.dtype)


class DINOVisionTransformer(_ViT):
    """images [n, H, W, 3] NHWC -> [n, D (n_last_blocks + return_patch_avg)]."""

    def forward(self, x: torch.Tensor, n_last_blocks: int = 1,
                return_patch_avg: bool = False) -> torch.Tensor:
        x = self._tokens(self.patch_embed(x))
        depth = len(self.blocks)
        outs = []
        for i, blk in enumerate(self.blocks):  # no stochastic depth: nothing to draw
            x = blk(x)
            if i >= depth - n_last_blocks:
                outs.append(self.norm(x))
        feats = torch.cat([o[:, 0] for o in outs], dim=-1)
        if return_patch_avg:
            feats = torch.cat([feats, outs[-1][:, 1:].mean(dim=1)], dim=-1)
        return feats


class DINOv2Backbone(_ViT):
    """images [n, H, W, 3] NHWC -> every normed token [n, 1 + L, D]; where
    `bool_mask` [n, L] is given, `mask_token` takes the masked patches."""

    def __init__(self, *args, init_values: Optional[float] = 1.0, **kw):
        super().__init__(*args, init_values=init_values, **kw)
        self.mask_token = nn.Parameter(torch.empty(1, 1, self.embed_dim))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        _trunc02(self.mask_token, generator=generator)
        super().reset_parameters(generator)

    def forward(self, x: torch.Tensor, bool_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.patch_embed(x)
        if bool_mask is not None:
            m = bool_mask.to(x.dtype)[:, :, None]
            x = x * (1 - m) + self.mask_token.to(x.dtype) * m
        x = self._tokens(x)
        for blk in self.blocks:
            x = blk(x)
        return self.norm(x)


def _normal01(t: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    return tinit.normal_(t, std=0.01, generator=generator)


@register_model
class DINOLinearProbe(nn.Module):
    """images [N, H, W, C] -> logits [N, num_classes] over the frozen encoder's
    last `n_last_blocks` class tokens (and, with `avgpool_patchtokens`, its
    patch-token mean)."""

    def __init__(self, encoder: Optional[dict] = None, num_classes: int = 1000,
                 n_last_blocks: int = 4, avgpool_patchtokens: bool = False,
                 dtype: DtypeLike = torch.float32):
        super().__init__()
        dtype = resolve_dtype(dtype)
        self.n_last_blocks = n_last_blocks
        self.avgpool_patchtokens = avgpool_patchtokens
        self.encoder = DINOVisionTransformer(dtype=dtype, **dict(encoder or {}))
        self.img_size = self.encoder.img_size
        tokens = min(n_last_blocks, len(self.encoder.blocks)) + int(avgpool_patchtokens)
        feats = self.encoder.embed_dim * tokens
        self.head = Dense(feats, num_classes, dtype=dtype, kernel_init=_normal01)

    @staticmethod
    def frozen_patterns() -> list:
        return [r"^encoder\."]

    def train(self, mode: bool = True) -> "DINOLinearProbe":
        super().train(mode)
        self.encoder.eval()  # JAX runs it with train=False
        return self

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        with torch.no_grad():
            feats = self.encoder(x, self.n_last_blocks, self.avgpool_patchtokens)
        return self.head(feats)


@register_model
class DINOv2LinearProbe(DINOLinearProbe):
    """The class token and the patch-token mean of the last block."""

    def __init__(self, encoder: Optional[dict] = None, num_classes: int = 1000,
                 n_last_blocks: int = 1, avgpool_patchtokens: bool = True,
                 dtype: DtypeLike = torch.float32):
        super().__init__(encoder, num_classes, n_last_blocks, avgpool_patchtokens, dtype)


_DINO_VARIANTS = {
    "dino_vit_small_patch16": dict(embed_dim=384, depth=12, num_heads=6),
    "dino_vit_small_patch8": dict(patch_size=8, embed_dim=384, depth=12, num_heads=6),
    "dino_vit_base_patch16": dict(embed_dim=768, depth=12, num_heads=12),
    "dino_vit_base_patch8": dict(patch_size=8, embed_dim=768, depth=12, num_heads=12),
    "dinov2_vit_small_patch14": dict(patch_size=14, embed_dim=384, depth=12, num_heads=6,
                                     init_values=1.0),
    "dinov2_vit_base_patch14": dict(patch_size=14, embed_dim=768, depth=12, num_heads=12,
                                    init_values=1.0),
    "dinov2_vit_large_patch14": dict(patch_size=14, embed_dim=1024, depth=24, num_heads=16,
                                     init_values=1.0),
    "dinov2_vit_giant2_patch14": dict(patch_size=14, embed_dim=1536, depth=40, num_heads=24,
                                      init_values=1.0),
}


def _dino_variant(name: str, defaults: dict) -> None:
    def factory(**kw) -> DINOVisionTransformer:
        return DINOVisionTransformer(**{**defaults, **kw})

    factory.__name__ = name
    MODELS.register(factory, name=name)


for _name, _cfg in _DINO_VARIANTS.items():
    _dino_variant(_name, _cfg)


class DINOHead(nn.Module):
    """[n, in_dim] -> [n, out_dim] in f32 (f64 for a model run in f64)."""

    def __init__(self, in_dim: int, out_dim: int = 65536, hidden_dim: int = 2048,
                 bottleneck_dim: int = 256, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = Dense(in_dim, hidden_dim, dtype)
        self.fc2 = Dense(hidden_dim, hidden_dim, dtype)
        self.fc3 = Dense(hidden_dim, bottleneck_dim, dtype)
        self.prototypes = nn.Parameter(torch.empty(bottleneck_dim, out_dim))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        _trunc02(self.prototypes, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.fc3(gelu(self.fc2(gelu(self.fc1(x)))))
        x = l2_normalize(at_least_f32(x), dim=-1)
        return x @ l2_normalize(self.prototypes.to(x.dtype), dim=0)


def _cross_entropies(t_probs: list, s_out: dict, student_temp: float) -> torch.Tensor:
    """The mean over every teacher crop ti and every student crop si != ti of
    the mean cross-entropy of softmax(s / student_temp) against t."""
    total, terms = 0.0, 0
    for ti, tp in enumerate(t_probs):
        for si in range(len(s_out)):
            if si == ti:
                continue
            logp = torch.log_softmax(s_out[si] / student_temp, dim=-1)
            total = total - torch.mean(torch.sum(tp * logp, dim=-1))
            terms += 1
    return total / max(terms, 1)


@torch.no_grad()
def _move_center(center: torch.Tensor, outputs: torch.Tensor, momentum: float) -> None:
    """center <- momentum center + (1 - momentum) mean of the outputs' rows."""
    batch_center = outputs.reshape(-1, outputs.shape[-1]).mean(dim=0, keepdim=True)
    center.copy_(momentum * center + (1 - momentum) * batch_center)


class _Tower(nn.Module):
    """backbone -> DINOHead on its features."""

    def __init__(self, backbone: nn.Module, out_dim: int, hidden_dim: int, bottleneck_dim: int,
                 dtype: torch.dtype):
        super().__init__()
        self.backbone = backbone
        self.head = DINOHead(backbone.embed_dim, out_dim, hidden_dim, bottleneck_dim, dtype)


class _DINOTower(_Tower):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.backbone(x))


class _DINOv2Tower(_Tower):
    def forward(self, x: torch.Tensor, bool_mask: Optional[torch.Tensor] = None,
                all_tokens: bool = False) -> torch.Tensor:
        tokens = self.backbone(x, bool_mask)  # [n, 1 + L, D]
        if all_tokens:
            n, l1, c = tokens.shape
            return self.head(tokens.reshape(n * l1, c)).reshape(n, l1, -1)
        return self.head(tokens[:, 0])


class _Pretrain(nn.Module):
    """What DINOPretrain and DINOv2Pretrain share: the settings, the EMA pair
    and the frozen teacher."""

    def __init__(self, out_dim: int, global_crops: int, student_temp: float,
                 teacher_temp: float, center_momentum: float, base_momentum: float):
        super().__init__()
        self.out_dim = out_dim
        self.global_crops = global_crops
        self.student_temp = student_temp
        self.teacher_temp = teacher_temp
        self.center_momentum = center_momentum
        self.base_momentum = base_momentum

    def ema_map(self) -> list:
        return [("student", "teacher", {"momentum": self.base_momentum, "schedule": "cosine"})]

    @staticmethod
    def frozen_patterns() -> list:
        return [r"^teacher\."]

    def _teacher_probs(self, t: torch.Tensor, center: torch.Tensor) -> torch.Tensor:
        return torch.softmax((t - center) / self.teacher_temp, dim=-1)


@register_model
class DINOPretrain(_Pretrain):
    """batch: the crops [N, H, W, 3], the `global_crops` full-size ones first
    -> {"loss"} in f32."""

    def __init__(self, backbone: Optional[dict] = None, out_dim: int = 65536,
                 hidden_dim: int = 2048, bottleneck_dim: int = 256, global_crops: int = 2,
                 student_temp: float = 0.1, teacher_temp: float = 0.04,
                 center_momentum: float = 0.9, base_momentum: float = 0.996,
                 dtype: DtypeLike = torch.float32):
        super().__init__(out_dim, global_crops, student_temp, teacher_temp, center_momentum,
                         base_momentum)
        dtype = resolve_dtype(dtype)
        backbone = dict(backbone or {})
        self.student, self.teacher = (
            _DINOTower(DINOVisionTransformer(dtype=dtype, **backbone), out_dim, hidden_dim,
                       bottleneck_dim, dtype) for _ in range(2))
        self.register_buffer("center", torch.zeros(1, out_dim))

    def forward(self, batch, generator: Optional[torch.Generator] = None) -> dict:
        crops = list(batch) if isinstance(batch, (list, tuple)) else [batch]
        groups: dict = {}  # one student forward per resolution, in order of first appearance
        for i, c in enumerate(crops):
            groups.setdefault(c.shape[1], []).append(i)
        s_out = {}
        for idxs in groups.values():
            z = self.student(torch.cat([crops[i] for i in idxs], dim=0))
            for j, i in enumerate(idxs):
                s_out[i] = z.chunk(len(idxs))[j]
        with torch.no_grad():
            t_global = self.teacher(torch.cat(crops[:self.global_crops], dim=0))
        t_out = t_global.chunk(self.global_crops)
        center = self.center.to(t_global.dtype)
        t_probs = [self._teacher_probs(t, center) for t in t_out]
        loss = _cross_entropies(t_probs, dict(sorted(s_out.items())), self.student_temp)
        if self.training:
            _move_center(self.center, t_global, self.center_momentum)
        return {"loss": loss}


def masking_noise(n: int, l: int, generator: torch.Generator,
                  device: torch.device) -> torch.Tensor:
    """The [n, l] f32 uniforms whose entries below `mask_ratio` mask a patch."""
    return torch.rand(n, l, generator=generator, device=device)


@register_model
class DINOv2Pretrain(_Pretrain):
    """batch: the crops [N, H, W, 3], the `global_crops` full-size ones first
    -> {"loss", "dino_loss", "ibot_loss", "koleo_loss"} in f32."""

    def __init__(self, backbone: Optional[dict] = None, out_dim: int = 65536,
                 hidden_dim: int = 2048, bottleneck_dim: int = 256, global_crops: int = 2,
                 student_temp: float = 0.1, teacher_temp: float = 0.04,
                 center_momentum: float = 0.9, base_momentum: float = 0.994,
                 mask_ratio: float = 0.3, ibot_weight: float = 1.0, koleo_weight: float = 0.1,
                 dtype: DtypeLike = torch.float32):
        super().__init__(out_dim, global_crops, student_temp, teacher_temp, center_momentum,
                         base_momentum)
        dtype = resolve_dtype(dtype)
        backbone = dict(backbone or {})
        backbone.setdefault("init_values", 1.0)  # DINOv2's LayerScale (JAX :293-294)
        self.mask_ratio = mask_ratio
        self.ibot_weight = ibot_weight
        self.koleo_weight = koleo_weight
        self.student, self.teacher = (
            _DINOv2Tower(DINOv2Backbone(dtype=dtype, **backbone), out_dim, hidden_dim,
                         bottleneck_dim, dtype) for _ in range(2))
        self.register_buffer("cls_center", torch.zeros(1, out_dim))
        self.register_buffer("patch_center", torch.zeros(1, out_dim))

    @staticmethod
    def flax_absent() -> list:
        """What the JAX model's variables never hold (the teacher takes no
        mask): `flax_to_torch` fills it from the student's."""
        return ["teacher.backbone.mask_token"]

    def forward(self, batch, generator: Optional[torch.Generator] = None) -> dict:
        crops = list(batch) if isinstance(batch, (list, tuple)) else [batch]
        n = crops[0].shape[0]
        g = torch.cat(crops[:self.global_crops], dim=0)
        p = self.student.backbone.patch_size
        l = (g.shape[1] // p) ** 2
        if not self.training:
            generator = torch.Generator(device=g.device).manual_seed(EVAL_SEED)
        elif generator is None:
            raise ValueError("DINOv2Pretrain: training draws its masks from the train "
                             "state's generator; none was given")
        bool_mask = (masking_noise(g.shape[0], l, generator, g.device)
                     < self.mask_ratio).to(torch.int32)

        s_global = self.student(g, bool_mask, all_tokens=True)  # [G N, 1 + L, K]
        with torch.no_grad():
            t_global = self.teacher(g, all_tokens=True)
        cls_center = self.cls_center.to(t_global.dtype)
        patch_center = self.patch_center.to(t_global.dtype)

        # the image-level DINO loss over the class tokens (locals unmasked)
        t_cls = [self._teacher_probs(t[:, 0], cls_center)
                 for t in t_global.chunk(self.global_crops)]
        s_cls = dict(enumerate(s_global[:, 0].chunk(self.global_crops)))
        for i in range(self.global_crops, len(crops)):
            s_cls[i] = self.student(crops[i])
        dino_loss = _cross_entropies(t_cls, s_cls, self.student_temp)

        # iBOT: the student's masked patch tokens against the teacher's
        t_patch = self._teacher_probs(t_global[:, 1:], patch_center)
        s_patch_logp = torch.log_softmax(s_global[:, 1:] / self.student_temp, dim=-1)
        per_tok = -torch.sum(t_patch * s_patch_logp, dim=-1)  # [G N, L]
        m = bool_mask.to(per_tok.dtype)
        ibot_loss = torch.sum(per_tok * m) / torch.clamp(torch.sum(m), min=1.0)

        # KoLeo on the student's global class features
        f = l2_normalize(at_least_f32(s_global[:, 0]), dim=-1)
        d2 = 2.0 - 2.0 * (f @ f.T) + 1e6 * torch.eye(f.shape[0], dtype=f.dtype, device=f.device)
        koleo = -torch.mean(torch.log(torch.sqrt(torch.min(d2, dim=-1).values) + 1e-8))

        if self.training:
            _move_center(self.cls_center, t_global[:, 0], self.center_momentum)
            _move_center(self.patch_center, t_global[:, 1:], self.center_momentum)
        loss = dino_loss + self.ibot_weight * ibot_loss + self.koleo_weight * koleo
        return {"loss": loss, "dino_loss": dino_loss, "ibot_loss": ibot_loss,
                "koleo_loss": koleo}

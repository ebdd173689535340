"""On-device batched augmentation, plain PyTorch (counterpart of
`passl_tpu/ops/augment.py:32-179`).

BYOL's and SimCLR's device recipes: uint8 NHWC views to f32 in [0, 1],
SimCLR's color jitter (brightness, contrast, saturation, hue in that fixed
order, hue as a rotation in YIQ space) and grayscale, a per-sample gaussian
blur (separable, edge-renormalized, as two batched banded matrix products),
BYOL's per-sample solarize, and the per-channel normalize. Every `random_*`
op is split into its draws, which come from an explicit `torch.Generator`
(the train state's), and a deterministic core that takes the factors,
sigmas and masks, so that a test can feed the core the draws the JAX
package made. A jitter strength of 0 skips its op and draws nothing for it,
as in JAX. The JAX package runs these paths as plain `jnp`, not through its
Pallas kernel, and so does the port: `ops/augment_kernel.py` is that
kernel's counterpart, an op of its own.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def to_float(x: torch.Tensor) -> torch.Tensor:
    if x.dtype == torch.uint8:
        return x.to(torch.float32) / 255.0
    return x.to(torch.float32)


def normalize(x: torch.Tensor, mean: Sequence[float] = IMAGENET_MEAN,
              std: Sequence[float] = IMAGENET_STD) -> torch.Tensor:
    mean_t = torch.tensor(mean, dtype=torch.float32, device=x.device)
    std_t = torch.tensor(std, dtype=torch.float32, device=x.device)
    return (x - mean_t) / std_t


def solarize(x: torch.Tensor, threshold: float = 0.5) -> torch.Tensor:
    return torch.where(x >= threshold, 1.0 - x, x)


def _coins(n: int, prob: float, generator: Optional[torch.Generator],
           device: torch.device) -> torch.Tensor:
    """[n] bools, each True with probability `prob`."""
    return torch.rand(n, generator=generator, device=device) < prob


def _uniform(n: int, lo: float, hi: float, generator: Optional[torch.Generator],
             device: torch.device) -> torch.Tensor:
    """[n] f32, each uniform in [lo, hi)."""
    return lo + (hi - lo) * torch.rand(n, generator=generator, device=device)


def _per_image(t: torch.Tensor) -> torch.Tensor:
    """[N] -> [N, 1, 1, 1], to broadcast over an NHWC batch."""
    return t[:, None, None, None]


def solarize_where(x: torch.Tensor, mask: torch.Tensor, threshold: float = 0.5) -> torch.Tensor:
    """The deterministic core of `random_solarize`: mask [N] bool."""
    return torch.where(_per_image(mask), solarize(x, threshold), x)


def random_solarize(x: torch.Tensor, generator: Optional[torch.Generator], prob: float = 0.2,
                    threshold: float = 0.5) -> torch.Tensor:
    return solarize_where(x, _coins(x.shape[0], prob, generator, x.device), threshold)


def _banded_blur_matrix(sigmas: torch.Tensor, size: int, taps: int) -> torch.Tensor:
    """[N, size, size] row-normalized banded gaussian operators."""
    r = taps // 2
    idx = torch.arange(size, device=sigmas.device)
    d = (idx[:, None] - idx[None, :]).to(torch.float32)
    band = d.abs() <= r
    k = torch.exp(-0.5 * (d[None] / torch.clamp(sigmas.float(), min=1e-3)[:, None, None]) ** 2)
    k = torch.where(band[None], k, torch.zeros((), device=k.device))
    return k / k.sum(dim=2, keepdim=True)


def gaussian_blur(x: torch.Tensor, sigmas: torch.Tensor, taps: int = 23) -> torch.Tensor:
    """Separable per-sample blur as two batched banded products
    (edge-renormalized). x: [N, H, W, C] float, sigmas: [N]."""
    n, h, w, c = x.shape
    kh = _banded_blur_matrix(sigmas, h, taps)  # [N, H, H]
    x = torch.einsum("nij,njwc->niwc", kh, x.to(torch.float32))
    kw = kh if w == h else _banded_blur_matrix(sigmas, w, taps)
    return torch.einsum("nwj,nhjc->nhwc", kw, x)


def blur_where(x: torch.Tensor, sigmas: torch.Tensor, mask: torch.Tensor,
               taps: int = 23) -> torch.Tensor:
    """The deterministic core of `random_gaussian_blur`: sigmas [N], mask [N] bool."""
    return torch.where(_per_image(mask), gaussian_blur(x, sigmas, taps), x)


def random_gaussian_blur(x: torch.Tensor, generator: Optional[torch.Generator], prob: float = 0.5,
                         sigma_range: Tuple[float, float] = (0.1, 2.0),
                         taps: int = 23) -> torch.Tensor:
    n = x.shape[0]
    sig = _uniform(n, *sigma_range, generator, x.device)
    return blur_where(x, sig, _coins(n, prob, generator, x.device), taps)


def rgb_to_grayscale(x: torch.Tensor) -> torch.Tensor:
    """Luma 0.299 R + 0.587 G + 0.114 B, broadcast back to the C channels."""
    wts = torch.tensor([0.299, 0.587, 0.114], dtype=torch.float32, device=x.device)
    return torch.sum(x * wts, dim=-1, keepdim=True).expand(x.shape)


def grayscale_where(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The deterministic core of `random_grayscale`: mask [N] bool."""
    return torch.where(_per_image(mask), rgb_to_grayscale(x), x)


def random_grayscale(x: torch.Tensor, generator: Optional[torch.Generator],
                     prob: float = 0.2) -> torch.Tensor:
    return grayscale_where(x, _coins(x.shape[0], prob, generator, x.device))


# the JAX package's YIQ pair (`passl_tpu/ops/augment.py:135-140`), rows the input channel
_RGB_TO_YIQ = ((0.299, 0.596, 0.211), (0.587, -0.274, -0.523), (0.114, -0.322, 0.312))
_YIQ_TO_RGB = ((1.0, 1.0, 1.0), (0.956, -0.272, -1.106), (0.621, -0.647, 1.703))


def color_jitter_draws(n: int, generator: Optional[torch.Generator], device: torch.device,
                       brightness: float = 0.4, contrast: float = 0.4, saturation: float = 0.4,
                       hue: float = 0.1, prob: float = 0.8) -> dict:
    """The draws of the color jitter (JAX's `color_jitter`) for n images: a
    factor [n] for each op whose strength is above 0 (brightness, contrast
    and saturation uniform in [max(0, 1 - s), 1 + s], hue an angle in
    [-hue pi, hue pi]) and the coins `apply` [n] of probability `prob`."""
    out = {}
    for name, s in (("brightness", brightness), ("contrast", contrast),
                    ("saturation", saturation)):
        if s > 0:
            out[name] = _uniform(n, max(0.0, 1.0 - s), 1.0 + s, generator, device)
    if hue > 0:
        out["hue"] = _uniform(n, -hue * math.pi, hue * math.pi, generator, device)
    out["apply"] = _coins(n, prob, generator, device)
    return out


def color_jitter_core(x: torch.Tensor, draws: dict) -> torch.Tensor:
    """The deterministic core of the color jitter on f32 [N, H, W, 3] in [0, 1]:
    brightness, contrast, saturation and hue in that order, each where its
    factor is drawn; an image whose `apply` coin is set comes out clipped to
    [0, 1], any other as it went in."""
    orig = x
    if "brightness" in draws:
        x = x * _per_image(draws["brightness"])
    if "contrast" in draws:
        mean = torch.mean(rgb_to_grayscale(x), dim=(1, 2, 3), keepdim=True)
        x = (x - mean) * _per_image(draws["contrast"]) + mean
    if "saturation" in draws:
        g = rgb_to_grayscale(x)
        x = (x - g) * _per_image(draws["saturation"]) + g
    if "hue" in draws:
        to_yiq = torch.tensor(_RGB_TO_YIQ, dtype=torch.float32, device=x.device)
        to_rgb = torch.tensor(_YIQ_TO_RGB, dtype=torch.float32, device=x.device)
        yiq = torch.einsum("nhwc,cd->nhwd", x, to_yiq)
        theta = draws["hue"][:, None, None]
        cos, sin = torch.cos(theta), torch.sin(theta)
        i, q = yiq[..., 1], yiq[..., 2]
        yiq = torch.stack([yiq[..., 0], i * cos - q * sin, i * sin + q * cos], dim=-1)
        x = torch.einsum("nhwd,dc->nhwc", yiq, to_rgb)
    return torch.where(_per_image(draws["apply"]), torch.clamp(x, 0.0, 1.0), orig)


# SimCLR's recipe (reference basic_transforms.py:770, 909): jitter at strengths
# (0.8 s, 0.8 s, 0.8 s, 0.2 s) with p 0.8, grayscale p 0.2, blur p 0.5
SIMCLR_JITTER_PROB = 0.8
SIMCLR_GRAY_PROB = 0.2
SIMCLR_BLUR_PROB = 0.5


def simclr_draws(n: int, generator: Optional[torch.Generator], device: torch.device,
                 jitter_strength: float = 0.5) -> list:
    """The draws of `simclr_device_augment` for two views of n images, one
    dict a view, each view's own numbers: its jitter draws, grayscale coins,
    blur sigmas and blur coins."""
    s = jitter_strength
    views = []
    for _ in range(2):
        views.append({
            "jitter": color_jitter_draws(n, generator, device, brightness=0.8 * s,
                                         contrast=0.8 * s, saturation=0.8 * s, hue=0.2 * s,
                                         prob=SIMCLR_JITTER_PROB),
            "gray": _coins(n, SIMCLR_GRAY_PROB, generator, device),
            "sigma": _uniform(n, 0.1, 2.0, generator, device),
            "blur": _coins(n, SIMCLR_BLUR_PROB, generator, device),
        })
    return views


def simclr_device_augment_core(v1: torch.Tensor, v2: torch.Tensor, draws: Sequence[dict],
                               mean: Sequence[float] = IMAGENET_MEAN,
                               std: Sequence[float] = IMAGENET_STD
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The deterministic core of `simclr_device_augment`, on given draws."""
    outs = []
    for v, d in zip((v1, v2), draws):
        x = color_jitter_core(to_float(v), d["jitter"])
        x = grayscale_where(x, d["gray"])
        x = blur_where(x, d["sigma"], d["blur"])
        outs.append(normalize(x, mean, std))
    return outs[0], outs[1]


def simclr_device_augment(v1: torch.Tensor, v2: torch.Tensor,
                          generator: Optional[torch.Generator], jitter_strength: float = 0.5,
                          mean: Sequence[float] = IMAGENET_MEAN,
                          std: Sequence[float] = IMAGENET_STD) -> tuple[torch.Tensor, torch.Tensor]:
    """uint8 views [N, H, W, 3] -> f32 augmented and normalized views."""
    draws = simclr_draws(v1.shape[0], generator, v1.device, jitter_strength)
    return simclr_device_augment_core(v1, v2, draws, mean, std)


# BYOL's recipe (reference BYOL.py:239): view 1 blur p=1.0, solarize p=0.0;
# view 2 blur p=0.1, solarize p=0.2
BYOL_BLUR_PROBS = (1.0, 0.1)
BYOL_SOLARIZE_PROB = 0.2


def byol_draws(n: int, generator: Optional[torch.Generator],
               device: torch.device) -> dict:
    """The draws of `byol_device_augment` for views of n images: the blur
    sigmas and coins of each view and view 2's solarize coins."""
    out = {}
    for i, prob in enumerate(BYOL_BLUR_PROBS, start=1):
        out[f"sigma{i}"] = _uniform(n, 0.1, 2.0, generator, device)
        out[f"blur{i}"] = _coins(n, prob, generator, device)
    out["solarize2"] = _coins(n, BYOL_SOLARIZE_PROB, generator, device)
    return out


def byol_device_augment_core(v1: torch.Tensor, v2: torch.Tensor, draws: dict,
                             mean: Sequence[float] = IMAGENET_MEAN,
                             std: Sequence[float] = IMAGENET_STD
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The deterministic core of `byol_device_augment`, on given draws."""
    v1 = blur_where(to_float(v1), draws["sigma1"], draws["blur1"])
    v2 = blur_where(to_float(v2), draws["sigma2"], draws["blur2"])
    v2 = solarize_where(v2, draws["solarize2"])
    return normalize(v1, mean, std), normalize(v2, mean, std)


def byol_device_augment(v1: torch.Tensor, v2: torch.Tensor, generator: Optional[torch.Generator],
                        mean: Sequence[float] = IMAGENET_MEAN,
                        std: Sequence[float] = IMAGENET_STD) -> tuple[torch.Tensor, torch.Tensor]:
    """uint8 views [N, H, W, C] -> f32 augmented and normalized views."""
    return byol_device_augment_core(v1, v2, byol_draws(v1.shape[0], generator, v1.device),
                                    mean, std)

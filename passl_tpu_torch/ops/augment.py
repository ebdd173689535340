"""On-device batched augmentation, plain PyTorch (counterpart of
`passl_tpu/ops/augment.py:32-95, 169-179`).

BYOL's device recipe: uint8 NHWC views to f32 in [0, 1], a per-sample
gaussian blur (separable, edge-renormalized, as two batched banded matrix
products), a per-sample solarize, and the per-channel normalize. Every
`random_*` op is split into its draws, which come from an explicit
`torch.Generator` (the train state's), and a deterministic core that takes
the sigmas and masks, so that a test can feed the core the draws the JAX
package made. The JAX package runs this path as plain `jnp`, not through
its Pallas kernel, and so does the port: `ops/augment_kernel.py` is that
kernel's counterpart, an op of its own.

The SimCLR ops (`color_jitter`, `random_grayscale`, `simclr_device_augment`)
wait for SimCLR.
"""
from __future__ import annotations

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


def _sigmas(n: int, sigma_range: Tuple[float, float], generator: Optional[torch.Generator],
            device: torch.device) -> torch.Tensor:
    lo, hi = sigma_range
    return lo + (hi - lo) * torch.rand(n, generator=generator, device=device)


def solarize_where(x: torch.Tensor, mask: torch.Tensor, threshold: float = 0.5) -> torch.Tensor:
    """The deterministic core of `random_solarize`: mask [N] bool."""
    return torch.where(mask[:, None, None, None], solarize(x, threshold), x)


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
    return torch.where(mask[:, None, None, None], gaussian_blur(x, sigmas, taps), x)


def random_gaussian_blur(x: torch.Tensor, generator: Optional[torch.Generator], prob: float = 0.5,
                         sigma_range: Tuple[float, float] = (0.1, 2.0),
                         taps: int = 23) -> torch.Tensor:
    n = x.shape[0]
    sig = _sigmas(n, sigma_range, generator, x.device)
    return blur_where(x, sig, _coins(n, prob, generator, x.device), taps)


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
        out[f"sigma{i}"] = _sigmas(n, (0.1, 2.0), generator, device)
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

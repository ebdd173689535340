"""Fused augmentation: the CUDA kernel's wrapper and its plain version.

Counterpart of `passl_tpu/ops/pallas/augment_kernel.py:114` (`fused_augment`,
kernel body `_augment_kernel` `:36`): BYOL's on-device recipe as one pass
per image, uint8 [N, H, W, C] -> bf16 [N, H, W, C]:

    x = u8 * (1/255); per image: sigma = smin + (smax - smin) u0,
    blur = u1 < blur_prob, sol = u2 < solarize_prob;
    blur: separable gaussian over |d| <= taps // 2, edge-renormalized
          (each output position divided by the sum of its in-bounds taps);
    sol:  x >= threshold ? 1 - x : x;
    out = (x - mean[c]) * (1 / std[c]), rounded once to bf16.

The draws. The TPU kernel draws (u0, u1, u2) on the core's PRNG seeded with
`seed + program_id`. Here `fused_augment` draws u = [N, 3] f32 uniforms from
`torch.Generator(device=images.device).manual_seed(seed)`, and both the
kernel and its plain twin `fused_augment_ref` take u. Each image's draw is
still a function of the seed, as on the TPU, but not the same numbers; and
the plain version now reproduces the kernel, so per-sample randomness is
testable on the CPU, which it is not in the JAX package's interpret mode.

On a CUDA tensor `fused_augment_with_draws` launches `csrc/augment.cu` once
(or raises); on a CPU tensor it runs `fused_augment_ref`. Forward only, as
in JAX. The JAX package calls this op from no model (BYOL runs the plain
`ops/augment.py`), and so does the port.

`csrc/augment.cu` has two kernels, and its C entry point picks one by shape
(`fused_augment_kernel_for`): the fast kernel, compiled for taps // 2 in
{0, 1, 2, 4, 11, 12} and C in {1, 3} where a band of 16 rows fits in shared
memory, and the generic kernel (the first design, runtime tap loops) for
every other shape. The per-channel constants live on the card once per
(device, mean, std), so a launch makes no host-to-device copy and the op can
be captured in a CUDA graph once it has run eagerly for those constants.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch

from . import _build
from .augment import IMAGENET_MEAN, IMAGENET_STD, blur_where, solarize_where

_KW_DEFAULTS = dict(blur_prob=1.0, solarize_prob=0.0, taps=23, sigma_range=(0.1, 2.0),
                    solarize_threshold=0.5, mean=IMAGENET_MEAN, std=IMAGENET_STD)


def _check_channels(images: torch.Tensor, mean: Sequence[float], std: Sequence[float]) -> None:
    if images.dim() != 4:
        raise ValueError(f"fused_augment: images must be [N, H, W, C], got {tuple(images.shape)}")
    c = images.shape[-1]
    if len(mean) != c or len(std) != c:
        raise ValueError(f"fused_augment: mean and std need {c} entries (one per channel), got "
                         f"{len(mean)} and {len(std)}")


def fused_augment_ref(images: torch.Tensor, draws: torch.Tensor, *, blur_prob: float = 1.0,
                      solarize_prob: float = 0.0, taps: int = 23,
                      sigma_range: Tuple[float, float] = (0.1, 2.0),
                      solarize_threshold: float = 0.5, mean: Sequence[float] = IMAGENET_MEAN,
                      std: Sequence[float] = IMAGENET_STD) -> torch.Tensor:
    """Plain version on the draws u [N, 3]: the f32 formulas of `_augment_kernel`
    (`augment_kernel.py:36-106`), rounded once to bf16."""
    _check_channels(images, mean, std)
    x = images.to(torch.float32) * (1.0 / 255.0)
    u = draws.to(torch.float32)
    lo, hi = sigma_range
    x = blur_where(x, lo + (hi - lo) * u[:, 0], u[:, 1] < blur_prob, taps)
    x = solarize_where(x, u[:, 2] < solarize_prob, solarize_threshold)
    mean_t = torch.tensor(mean, dtype=torch.float32, device=x.device)
    inv_std = torch.tensor([1.0 / s for s in std], dtype=torch.float32, device=x.device)
    return ((x - mean_t) * inv_std).to(torch.bfloat16)


@functools.lru_cache(maxsize=None)
def _chan(device: torch.device, mean: Tuple[float, ...], std: Tuple[float, ...]) -> torch.Tensor:
    """[2, C] f32 on `device`: mean, 1 / std; made once per (device, mean, std)."""
    return torch.tensor([*mean, *(1.0 / s for s in std)], dtype=torch.float32, device=device)


def fused_augment_kernel_for(h: int, w: int, c: int, taps: int) -> str:
    """Which kernel of `csrc/augment.cu` takes [*, h, w, c] at `taps` taps:
    "fast", "generic", or "none" (a row too wide for shared memory)."""
    return ("none", "generic", "fast")[_build.load().passl_fused_augment_path(h, w, c, taps)]


def fused_augment_resources(h: int, w: int, c: int, taps: int, device: int = 0) -> dict:
    """Registers a thread, dynamic shared memory a block, blocks an SM,
    spilled bytes a thread and threads a block of the kernel that takes the
    shape (`fused_augment_kernel_for`)."""
    out = (ctypes.c_int * 5)()
    rc = _build.load().passl_fused_augment_resources(h, w, c, taps, device, ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"fused_augment_resources: cudaError {rc} for [{h}, {w}, {c}] at "
                           f"{taps} taps")
    return {"kernel": fused_augment_kernel_for(h, w, c, taps), "registers": out[0],
            "shared_bytes": out[1], "blocks_per_sm": out[2], "spill_bytes": out[3],
            "threads": out[4]}


def _launch(images: torch.Tensor, draws: torch.Tensor, blur_prob: float, solarize_prob: float,
            taps: int, sigma_range: Tuple[float, float], solarize_threshold: float,
            mean: Sequence[float], std: Sequence[float]) -> torch.Tensor:
    """One launch of the kernel (CUDA tensors only)."""
    name = "fused_augment"
    if images.dtype != torch.uint8:
        raise TypeError(f"{name}: the kernel takes uint8 images, got {images.dtype}")
    if not images.is_contiguous():
        raise ValueError(f"{name}: images must be contiguous")
    n, h, w, c = images.shape
    if tuple(draws.shape) != (n, 3) or draws.device != images.device:
        raise ValueError(f"{name}: draws must be [{n}, 3] on {images.device}, got "
                         f"{tuple(draws.shape)} on {draws.device}")
    if taps < 1:
        raise ValueError(f"{name}: taps must be >= 1, got {taps}")
    lib = _build.load()
    if lib.passl_fused_augment_path(h, w, c, taps) == 0:
        raise ValueError(f"{name}: a row of {w} x {c} with a {taps}-tap halo does not fit in "
                         "shared memory")
    u = draws.detach().to(torch.float32).contiguous()
    chan = _chan(images.device, tuple(mean), tuple(std))
    out = torch.empty(images.shape, dtype=torch.bfloat16, device=images.device)
    lo, hi = sigma_range
    rc = lib.passl_fused_augment(images.data_ptr(), u.data_ptr(), chan.data_ptr(), out.data_ptr(),
                                 n, h, w, c, taps, blur_prob, solarize_prob, lo, hi - lo,
                                 solarize_threshold, images.device.index,
                                 torch.cuda.current_stream(images.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: launch failed with cudaError {rc} for images "
                           f"{tuple(images.shape)}")
    fused_augment.launches += 1
    return out


def fused_augment_with_draws(images: torch.Tensor, draws: torch.Tensor, **kw) -> torch.Tensor:
    """The op on given draws u [N, 3]: the kernel on a CUDA tensor, the plain
    version on a CPU tensor. Keywords as `fused_augment`."""
    kw = {**_KW_DEFAULTS, **kw}
    if images.device.type == "cpu":
        return fused_augment_ref(images, draws, **kw)
    _check_channels(images, kw["mean"], kw["std"])
    return _launch(images, draws, **kw)


def fused_augment_draws(n: int, seed: int, device: torch.device) -> torch.Tensor:
    """The per-image uniforms (u0, u1, u2) that `fused_augment` draws from `seed`."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    return torch.rand(n, 3, generator=gen, device=device)


def fused_augment(images: torch.Tensor, seed: int, *, blur_prob: float = 1.0,
                  solarize_prob: float = 0.0, taps: int = 23,
                  sigma_range: Tuple[float, float] = (0.1, 2.0), solarize_threshold: float = 0.5,
                  mean: Sequence[float] = IMAGENET_MEAN,
                  std: Sequence[float] = IMAGENET_STD) -> torch.Tensor:
    """uint8 images [N, H, W, C] -> bf16 [N, H, W, C], with each image's blur
    and solarize coins and sigma drawn from `seed` (see the module docstring).
    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises."""
    draws = fused_augment_draws(images.shape[0], seed, images.device)
    return fused_augment_with_draws(images, draws, blur_prob=blur_prob,
                                    solarize_prob=solarize_prob, taps=taps,
                                    sigma_range=sigma_range,
                                    solarize_threshold=solarize_threshold, mean=mean, std=std)


fused_augment.launches = 0  # kernel launches since the last reset

# Copied from passl_tpu/data/autoaugment.py; the port keeps its own copy and imports nothing of passl_tpu.
"""AutoAugment / RandAugment / AugMix (PIL, host side).

Capability parity with reference `passl/data/preprocess/
timm_autoaugment.py:338-893` (the timm port: AA policies v0/original,
RandAugment with magnitude std, AugMix width/depth mixing). Fresh
implementation of the published algorithms over the standard PIL op
set; magnitude semantics follow timm's 0–10 scale.
"""
from __future__ import annotations

import random
import re
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
from PIL import Image, ImageEnhance, ImageOps

_MAX_LEVEL = 10.0
_FILL = (128, 128, 128)


def _affine(img, matrix):
    return img.transform(img.size, Image.AFFINE, matrix, resample=Image.BILINEAR, fillcolor=_FILL)


def shear_x(img, v):
    return _affine(img, (1, v, 0, 0, 1, 0))


def shear_y(img, v):
    return _affine(img, (1, 0, 0, v, 1, 0))


def translate_x_rel(img, v):
    return _affine(img, (1, 0, v * img.size[0], 0, 1, 0))


def translate_y_rel(img, v):
    return _affine(img, (1, 0, 0, 0, 1, v * img.size[1]))


def rotate(img, v):
    return img.rotate(v, resample=Image.BILINEAR, fillcolor=_FILL)


def auto_contrast(img, _):
    return ImageOps.autocontrast(img)


def invert(img, _):
    return ImageOps.invert(img)


def equalize(img, _):
    return ImageOps.equalize(img)


def solarize(img, v):
    return ImageOps.solarize(img, int(v))


def solarize_add(img, v, threshold=128):
    arr = np.asarray(img, np.int64)
    arr = np.where(arr < threshold, np.clip(arr + int(v), 0, 255), arr)
    return Image.fromarray(arr.astype(np.uint8))


def posterize(img, v):
    return ImageOps.posterize(img, max(1, int(v)))


def contrast(img, v):
    return ImageEnhance.Contrast(img).enhance(v)


def color(img, v):
    return ImageEnhance.Color(img).enhance(v)


def brightness(img, v):
    return ImageEnhance.Brightness(img).enhance(v)


def sharpness(img, v):
    return ImageEnhance.Sharpness(img).enhance(v)


def _enhance_level(level):
    return 1.0 + 0.9 * ((level / _MAX_LEVEL) * 2.0 - 1.0)  # 0.1..1.9


def _shear_level(level):
    v = (level / _MAX_LEVEL) * 0.3
    return -v if random.random() > 0.5 else v


def _translate_level(level):
    v = (level / _MAX_LEVEL) * 0.45
    return -v if random.random() > 0.5 else v


def _rotate_level(level):
    v = (level / _MAX_LEVEL) * 30.0
    return -v if random.random() > 0.5 else v


NAME_TO_OP: Dict[str, Tuple[Callable, Callable]] = {
    "AutoContrast": (auto_contrast, lambda l: 0),
    "Equalize": (equalize, lambda l: 0),
    "Invert": (invert, lambda l: 0),
    "Rotate": (rotate, _rotate_level),
    "Posterize": (posterize, lambda l: 8 - int((l / _MAX_LEVEL) * 4)),
    "PosterizeIncreasing": (posterize, lambda l: 4 + int((l / _MAX_LEVEL) * 4)),
    "Solarize": (solarize, lambda l: 256 - int((l / _MAX_LEVEL) * 256)),
    "SolarizeIncreasing": (solarize, lambda l: int((l / _MAX_LEVEL) * 256)),
    "SolarizeAdd": (solarize_add, lambda l: int((l / _MAX_LEVEL) * 110)),
    "Color": (color, _enhance_level),
    "Contrast": (contrast, _enhance_level),
    "Brightness": (brightness, _enhance_level),
    "Sharpness": (sharpness, _enhance_level),
    "ShearX": (shear_x, _shear_level),
    "ShearY": (shear_y, _shear_level),
    "TranslateXRel": (translate_x_rel, _translate_level),
    "TranslateYRel": (translate_y_rel, _translate_level),
}

_RAND_OPS = [
    "AutoContrast", "Equalize", "Invert", "Rotate", "Posterize", "Solarize",
    "SolarizeAdd", "Color", "Contrast", "Brightness", "Sharpness",
    "ShearX", "ShearY", "TranslateXRel", "TranslateYRel",
]

# AutoAugment ImageNet policy v0 (the published 25 sub-policies)
_AA_POLICY_V0 = [
    [("Equalize", 0.8, 1), ("ShearY", 0.8, 4)],
    [("Color", 0.4, 9), ("Equalize", 0.6, 3)],
    [("Color", 0.4, 1), ("Rotate", 0.6, 8)],
    [("Solarize", 0.8, 3), ("Equalize", 0.4, 7)],
    [("Solarize", 0.4, 2), ("Solarize", 0.6, 2)],
    [("Color", 0.2, 0), ("Equalize", 0.8, 8)],
    [("Equalize", 0.4, 8), ("SolarizeAdd", 0.8, 3)],
    [("ShearX", 0.2, 9), ("Rotate", 0.6, 8)],
    [("Color", 0.6, 1), ("Equalize", 1.0, 2)],
    [("Invert", 0.4, 9), ("Rotate", 0.6, 0)],
    [("Equalize", 1.0, 9), ("ShearY", 0.6, 3)],
    [("Color", 0.4, 7), ("Equalize", 0.6, 0)],
    [("Posterize", 0.4, 6), ("AutoContrast", 0.4, 7)],
    [("Solarize", 0.6, 8), ("Color", 0.6, 9)],
    [("Solarize", 0.2, 4), ("Rotate", 0.8, 9)],
    [("Rotate", 1.0, 7), ("TranslateYRel", 0.8, 9)],
    [("ShearX", 0.0, 0), ("Solarize", 0.8, 4)],
    [("ShearY", 0.8, 0), ("Color", 0.6, 4)],
    [("Color", 1.0, 0), ("Rotate", 0.6, 2)],
    [("Equalize", 0.8, 4), ("Equalize", 0.0, 8)],
    [("Equalize", 1.0, 4), ("AutoContrast", 0.6, 2)],
    [("ShearY", 0.4, 7), ("SolarizeAdd", 0.6, 7)],
    [("Posterize", 0.8, 2), ("Solarize", 0.6, 10)],
    [("Solarize", 0.6, 8), ("Equalize", 0.6, 1)],
    [("Color", 0.8, 6), ("Rotate", 0.4, 5)],
]


def _apply_op(img, name: str, prob: float, level: float, magnitude_std: float = 0.0):
    if random.random() > prob:
        return img
    if magnitude_std > 0:
        level = max(0.0, min(_MAX_LEVEL, random.gauss(level, magnitude_std)))
    op, level_fn = NAME_TO_OP[name]
    return op(img, level_fn(level))


class AutoAugment:
    """Policy-based AA (config: `RandAugment`-style timm string or the
    policy name 'v0'/'original')."""

    def __init__(self, policy: str = "v0"):
        self.policy = _AA_POLICY_V0  # v0 == ImageNet policy

    def __call__(self, img):
        sub = random.choice(self.policy)
        for name, prob, level in sub:
            img = _apply_op(img, name, prob, level)
        return img


class RandAugment:
    """N random ops at magnitude M (timm semantics, incl. mstd)."""

    def __init__(self, num_layers: int = 2, magnitude: float = 9, magnitude_std: float = 0.5,
                 prob: float = 0.5, ops: Optional[Sequence[str]] = None):
        self.num_layers = num_layers
        self.magnitude = magnitude
        self.magnitude_std = magnitude_std
        self.prob = prob
        self.ops = list(ops or _RAND_OPS)

    def __call__(self, img):
        for _ in range(self.num_layers):
            name = random.choice(self.ops)
            img = _apply_op(img, name, self.prob, self.magnitude, self.magnitude_std)
        return img


class AugMix:
    """Mixture of augmentation chains (width/depth/alpha)."""

    def __init__(self, severity: int = 3, width: int = 3, depth: int = -1, alpha: float = 1.0):
        self.severity = severity
        self.width = width
        self.depth = depth
        self.alpha = alpha
        self.ops = [o for o in _RAND_OPS if o not in ("Invert", "SolarizeAdd")]

    def __call__(self, img):
        ws = np.random.dirichlet([self.alpha] * self.width).astype(np.float32)
        m = np.float32(np.random.beta(self.alpha, self.alpha))
        mix = np.zeros(np.asarray(img, np.float32).shape, np.float32)
        for i in range(self.width):
            img_aug = img
            depth = self.depth if self.depth > 0 else random.randint(1, 3)
            for _ in range(depth):
                name = random.choice(self.ops)
                img_aug = _apply_op(img_aug, name, 1.0, self.severity)
            mix += ws[i] * np.asarray(img_aug, np.float32)
        out = (1 - m) * np.asarray(img, np.float32) + m * mix
        return Image.fromarray(np.clip(out, 0, 255).astype(np.uint8))


def rand_augment_transform(config_str: str = "rand-m9-mstd0.5", **kwargs) -> RandAugment:
    """Parse timm config strings like 'rand-m9-n2-mstd0.5'."""
    magnitude, num_layers, mstd = 9.0, 2, 0.0
    for part in config_str.split("-")[1:]:
        m = re.match(r"([a-z]+)([0-9.]+)", part)
        if not m:
            continue
        key, val = m.group(1), float(m.group(2))
        if key == "m":
            magnitude = val
        elif key == "n":
            num_layers = int(val)
        elif key == "mstd":
            mstd = val
    return RandAugment(num_layers=num_layers, magnitude=magnitude, magnitude_std=mstd, **kwargs)


class TimmAutoAugment:
    """Config-string front door matching the reference transform name:
    'rand-...' → RandAugment, 'augmix-...' → AugMix, else AA policy."""

    def __init__(self, config_str: str = "rand-m9-mstd0.5", img_size: int = 224, **_):
        if config_str.startswith("rand"):
            self.t = rand_augment_transform(config_str)
        elif config_str.startswith("augmix"):
            self.t = AugMix()
        else:
            self.t = AutoAugment(config_str)

    def __call__(self, img):
        return self.t(img)


from .transforms import TRANSFORMS  # noqa: E402

TRANSFORMS["AutoAugment"] = AutoAugment
TRANSFORMS["RandAugment"] = RandAugment
TRANSFORMS["RandAugmentation"] = RandAugment
TRANSFORMS["AugMix"] = AugMix
TRANSFORMS["TimmAutoAugment"] = TimmAutoAugment

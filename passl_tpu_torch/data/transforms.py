# Copied from passl_tpu/data/transforms.py; the port keeps its own copy and imports nothing of passl_tpu.
# Left out: the native JPEG path (`NativeJpegRRC`), which needs the JAX package's C++ decoder.
"""Host-side image transforms (PIL/numpy), NHWC float32 output.

Capability parity with reference `passl/data/preprocess/basic_transforms.py`:
DecodeImage(:101), ResizeImage(:200)/Resize(:235), CenterCrop(:326),
RandCropImage(:373), RandomResizedCrop(:473), RandFlipImage(:665),
NormalizeImage(:707), ToCHWImage(:756 — here NHWC is the native layout,
so ToCHW becomes a no-op marker kept for config compat), ColorJitter
(:770 with prob), RandomErasing(:808), RandomApply(:859),
RandomGrayscale(:872), SimCLRGaussianBlur(:909), BYOLSolarize(:929),
TwoViewsTransform(:88), Compose(:70), MAERandCropImage(:635).

Aug parity notes (SURVEY §7 hard part 3): RandomResizedCrop uses the
torchvision scale/ratio log-uniform sampling; resize defaults to PIL
bilinear/bicubic to match; ColorJitter applies brightness/contrast/
saturation/hue in random order like torchvision.

These run on CPU workers. The TPU-native fused path (uint8 batch →
device, aug on device) lives in `passl_tpu/ops/augment.py`.
"""
from __future__ import annotations

import math
import random
from typing import Any, Callable, List, Optional, Sequence, Tuple, Union

import numpy as np

try:
    from PIL import Image, ImageFilter, ImageOps
    _HAS_PIL = True
except ImportError:  # pragma: no cover
    _HAS_PIL = False

try:
    import cv2
    _HAS_CV2 = True
except ImportError:  # pragma: no cover
    _HAS_CV2 = False

_PIL_INTERP = {}
if _HAS_PIL:
    _PIL_INTERP = {
        "nearest": Image.NEAREST,
        "bilinear": Image.BILINEAR,
        "bicubic": Image.BICUBIC,
        "lanczos": Image.LANCZOS,
        "random": None,  # chosen per call
    }
_CV2_INTERP = {}
if _HAS_CV2:
    _CV2_INTERP = {
        "nearest": cv2.INTER_NEAREST,
        "bilinear": cv2.INTER_LINEAR,
        "bicubic": cv2.INTER_CUBIC,
        "lanczos": cv2.INTER_LANCZOS4,
        "area": cv2.INTER_AREA,
        "random": None,
    }


def _img_size(img) -> Tuple[int, int]:
    """(w, h) for PIL images and HWC ndarrays alike."""
    if isinstance(img, np.ndarray):
        return img.shape[1], img.shape[0]
    return img.size


def _crop(img, x: int, y: int, w: int, h: int):
    if isinstance(img, np.ndarray):
        return img[y : y + h, x : x + w]
    return img.crop((x, y, x + w, y + h))


class UnifiedResize:
    """Backend-dispatched resize (reference `basic_transforms.py:186-198`
    UnifiedResize): `pil` → PIL.Image.resize, `cv2` → cv2.resize on the
    ndarray. Several published recipes' aug parity depends on cv2's
    resize kernel, which differs measurably from PIL's."""

    def __init__(self, interpolation: str = "bilinear", backend: str = "pil"):
        if backend == "cv2" and not _HAS_CV2:  # pragma: no cover
            backend = "pil"
        self.interpolation = interpolation
        self.backend = backend

    def __call__(self, img, size_wh: Tuple[int, int]):
        if self.backend == "cv2":
            arr = np.asarray(img)
            interp = _CV2_INTERP.get(self.interpolation)
            if interp is None:  # "random" or unknown
                interp = random.choice([cv2.INTER_LINEAR, cv2.INTER_CUBIC]) \
                    if self.interpolation == "random" else cv2.INTER_LINEAR
            return cv2.resize(arr, size_wh, interpolation=interp)
        if isinstance(img, np.ndarray):
            img = Image.fromarray(img.astype(np.uint8))
        return img.resize(size_wh, _interp(self.interpolation))


class Compose:
    def __init__(self, transforms: Sequence[Callable]):
        self.transforms = list(transforms)

    def __call__(self, x):
        for t in self.transforms:
            x = t(x)
        return x


class TwoViewsTransform:
    """Apply two (possibly different) pipelines → (view1, view2)."""

    def __init__(self, base_transform1: Callable, base_transform2: Optional[Callable] = None):
        self.t1 = base_transform1
        self.t2 = base_transform2 or base_transform1

    def __call__(self, x):
        return self.t1(x), self.t2(x)


class DecodeImage:
    """bytes/ndarray/PIL → RGB image (reference DecodeImage:101).
    backend 'pil' yields a PIL image; 'cv2' yields an RGB HWC uint8
    ndarray decoded by cv2 — downstream ops accept either."""

    def __init__(self, to_rgb: bool = True, channel_first: bool = False, backend: str = "pil"):
        self.to_rgb = to_rgb
        self.backend = backend if _HAS_CV2 or backend != "cv2" else "pil"

    def __call__(self, img):
        if self.backend == "cv2":
            if isinstance(img, bytes):
                arr = cv2.imdecode(np.frombuffer(img, np.uint8), cv2.IMREAD_COLOR)
                if arr is None:
                    raise ValueError("cv2.imdecode failed (corrupt/unsupported image bytes)")
                if self.to_rgb:
                    arr = cv2.cvtColor(arr, cv2.COLOR_BGR2RGB)
            elif isinstance(img, np.ndarray):
                arr = img.astype(np.uint8)
            else:
                if self.to_rgb and img.mode != "RGB":
                    img = img.convert("RGB")
                arr = np.asarray(img, np.uint8)
            if self.to_rgb and arr.ndim == 2:
                arr = np.repeat(arr[..., None], 3, -1)
            return arr
        if isinstance(img, bytes):
            import io as _io

            img = Image.open(_io.BytesIO(img))
        if isinstance(img, np.ndarray):
            img = Image.fromarray(img.astype(np.uint8))
        if self.to_rgb and img.mode != "RGB":
            img = img.convert("RGB")
        return img


def _interp(interpolation: str):
    if interpolation == "random":
        return random.choice([Image.BILINEAR, Image.BICUBIC])
    return _PIL_INTERP.get(interpolation, Image.BILINEAR)


class Resize:
    def __init__(self, size: Union[int, Sequence[int]], interpolation: str = "bilinear",
                 backend: str = "pil"):
        self.size = size
        self._resize = UnifiedResize(interpolation, backend)

    def __call__(self, img):
        if isinstance(self.size, int):
            w, h = _img_size(img)
            if w < h:
                ow, oh = self.size, int(self.size * h / w)
            else:
                ow, oh = int(self.size * w / h), self.size
            return self._resize(img, (ow, oh))
        return self._resize(img, (self.size[1], self.size[0]))


ResizeImage = Resize


class CenterCrop:
    def __init__(self, size: Union[int, Sequence[int]]):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def __call__(self, img):
        w, h = _img_size(img)
        th, tw = self.size
        x1 = int(round((w - tw) / 2.0))
        y1 = int(round((h - th) / 2.0))
        return _crop(img, x1, y1, tw, th)


class RandomResizedCrop:
    """torchvision-semantics RRC (reference RandomResizedCrop:473)."""

    def __init__(
        self,
        size: Union[int, Sequence[int]],
        scale: Tuple[float, float] = (0.08, 1.0),
        ratio: Tuple[float, float] = (3.0 / 4, 4.0 / 3),
        interpolation: str = "bilinear",
        backend: str = "pil",
    ):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.scale = scale
        self.ratio = ratio
        self.interpolation = interpolation
        self._resize = UnifiedResize(interpolation, backend)

    def get_params(self, img):
        w, h = _img_size(img)
        area = w * h
        log_ratio = (math.log(self.ratio[0]), math.log(self.ratio[1]))
        for _ in range(10):
            target_area = area * random.uniform(*self.scale)
            aspect = math.exp(random.uniform(*log_ratio))
            cw = int(round(math.sqrt(target_area * aspect)))
            ch = int(round(math.sqrt(target_area / aspect)))
            if 0 < cw <= w and 0 < ch <= h:
                x = random.randint(0, w - cw)
                y = random.randint(0, h - ch)
                return x, y, cw, ch
        # fallback: center crop at in-range aspect
        in_ratio = w / h
        if in_ratio < self.ratio[0]:
            cw, ch = w, int(round(w / self.ratio[0]))
        elif in_ratio > self.ratio[1]:
            ch, cw = h, int(round(h * self.ratio[1]))
        else:
            cw, ch = w, h
        return (w - cw) // 2, (h - ch) // 2, cw, ch

    def __call__(self, img):
        x, y, cw, ch = self.get_params(img)
        img = _crop(img, x, y, cw, ch)
        return self._resize(img, (self.size[1], self.size[0]))


class RandCropImage(RandomResizedCrop):
    """Alias with reference naming (RandCropImage:373)."""


class MAERandCropImage(RandomResizedCrop):
    """MAE variant: scale (0.2, 1.0) default, bicubic."""

    def __init__(self, size, scale=(0.2, 1.0), ratio=(3.0 / 4, 4.0 / 3), interpolation="bicubic",
                 backend="pil"):
        super().__init__(size, scale, ratio, interpolation, backend)


class RandFlipImage:
    def __init__(self, flip_code: int = 1, prob: float = 0.5):
        self.flip_code = flip_code  # 1: horizontal (cv2 convention)
        self.prob = prob

    def __call__(self, img):
        if random.random() < self.prob:
            if isinstance(img, np.ndarray):
                return img[:, ::-1] if self.flip_code == 1 else img[::-1]
            if self.flip_code == 1:
                return img.transpose(Image.FLIP_LEFT_RIGHT)
            return img.transpose(Image.FLIP_TOP_BOTTOM)
        return img


RandomHorizontalFlip = RandFlipImage


class ColorJitter:
    """brightness/contrast/saturation/hue in random order, with
    an apply-probability (reference ColorJitter:770)."""

    def __init__(self, brightness=0.0, contrast=0.0, saturation=0.0, hue=0.0, prob: float = 1.0):
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.hue = hue
        self.prob = prob

    def _jitter(self, img):
        from PIL import ImageEnhance

        ops = []
        if self.brightness > 0:
            f = random.uniform(max(0, 1 - self.brightness), 1 + self.brightness)
            ops.append(lambda im: ImageEnhance.Brightness(im).enhance(f))
        if self.contrast > 0:
            f = random.uniform(max(0, 1 - self.contrast), 1 + self.contrast)
            ops.append(lambda im: ImageEnhance.Contrast(im).enhance(f))
        if self.saturation > 0:
            f = random.uniform(max(0, 1 - self.saturation), 1 + self.saturation)
            ops.append(lambda im: ImageEnhance.Color(im).enhance(f))
        if self.hue > 0:
            h = random.uniform(-self.hue, self.hue)

            def hue_op(im, h=h):
                hsv = np.array(im.convert("HSV"), dtype=np.uint8)
                hsv[..., 0] = (hsv[..., 0].astype(np.int16) + int(h * 255)) % 256
                return Image.fromarray(hsv, "HSV").convert("RGB")

            ops.append(hue_op)
        random.shuffle(ops)
        for op in ops:
            img = op(img)
        return img

    def _jitter_array(self, arr):
        """cv2-backend jitter on uint8 HWC arrays (reference
        preprocess/cv2_trans.py mirrors): same random order and factor
        ranges, array arithmetic instead of ImageEnhance."""
        arr = arr.astype(np.float32)
        ops = []
        if self.brightness > 0:
            f = random.uniform(max(0, 1 - self.brightness), 1 + self.brightness)
            ops.append(lambda a: a * f)
        if self.contrast > 0:
            f = random.uniform(max(0, 1 - self.contrast), 1 + self.contrast)

            def contrast_op(a, f=f):
                # ImageEnhance.Contrast pivots on the mean of the L
                # (luma) channel, not the raw RGB mean
                pivot = (a @ np.asarray([0.299, 0.587, 0.114], np.float32)).mean()
                return (a - pivot) * f + pivot

            ops.append(contrast_op)
        if self.saturation > 0:
            f = random.uniform(max(0, 1 - self.saturation), 1 + self.saturation)

            def sat(a, f=f):
                gray = a @ np.asarray([0.299, 0.587, 0.114], np.float32)
                return a * f + gray[..., None] * (1 - f)

            ops.append(sat)
        if self.hue > 0:
            h = random.uniform(-self.hue, self.hue)

            def hue_op(a, h=h):
                hsv = cv2.cvtColor(np.clip(a, 0, 255).astype(np.uint8), cv2.COLOR_RGB2HSV)
                hsv[..., 0] = (hsv[..., 0].astype(np.int16) + int(h * 180)) % 180
                return cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB).astype(np.float32)

            ops.append(hue_op)
        random.shuffle(ops)
        for op in ops:
            arr = op(arr)
        return np.clip(arr, 0, 255).astype(np.uint8)

    def __call__(self, img):
        if random.random() < self.prob:
            if isinstance(img, np.ndarray):
                return self._jitter_array(img)
            return self._jitter(img)
        return img


class RandomApply:
    def __init__(self, transforms: Sequence[Callable], p: float = 0.5):
        self.transforms = list(transforms)
        self.p = p

    def __call__(self, img):
        if random.random() < self.p:
            for t in self.transforms:
                img = t(img)
        return img


class RandomGrayscale:
    def __init__(self, p: float = 0.2, prob: Optional[float] = None):
        self.p = p if prob is None else prob

    def __call__(self, img):
        if random.random() < self.p:
            if isinstance(img, np.ndarray):
                gray = (img.astype(np.float32)
                        @ np.asarray([0.299, 0.587, 0.114], np.float32))
                return np.repeat(gray[..., None], 3, -1).astype(img.dtype)
            return ImageOps.grayscale(img).convert("RGB")
        return img


class SimCLRGaussianBlur:
    """Gaussian blur with sigma ~ U(sigma_min, sigma_max) applied with
    probability p (reference SimCLRGaussianBlur:909)."""

    def __init__(self, sigma: Sequence[float] = (0.1, 2.0), p: float = 0.5, _PIL: bool = True):
        self.sigma = tuple(sigma)
        self.p = p

    def __call__(self, img):
        if random.random() < self.p:
            s = random.uniform(*self.sigma)
            if isinstance(img, np.ndarray):
                return cv2.GaussianBlur(img, (0, 0), sigmaX=s)
            return img.filter(ImageFilter.GaussianBlur(radius=s))
        return img


GaussianBlur = SimCLRGaussianBlur


class BYOLSolarize:
    def __init__(self, threshold: int = 128, p: float = 0.2):
        self.threshold = threshold
        self.p = p

    def __call__(self, img):
        if random.random() < self.p:
            if isinstance(img, np.ndarray):
                return np.where(img >= self.threshold, 255 - img.astype(np.int16), img).astype(img.dtype)
            return ImageOps.solarize(img, self.threshold)
        return img


Solarize = BYOLSolarize


class RandomErasing:
    """timm-style random erasing on the float array (reference :808).
    Operates post-normalization on HWC float arrays."""

    def __init__(self, prob: float = 0.25, scale=(0.02, 1 / 3), ratio=(0.3, 3.3), mode: str = "pixel", **_):
        self.prob = prob
        self.scale = scale
        self.ratio = ratio
        self.mode = mode

    def __call__(self, arr):
        if not isinstance(arr, np.ndarray) or random.random() > self.prob:
            return arr
        h, w, c = arr.shape
        area = h * w
        for _ in range(10):
            target = area * random.uniform(*self.scale)
            aspect = math.exp(random.uniform(math.log(self.ratio[0]), math.log(self.ratio[1])))
            eh = int(round(math.sqrt(target * aspect)))
            ew = int(round(math.sqrt(target / aspect)))
            if eh < h and ew < w:
                y = random.randint(0, h - eh)
                x = random.randint(0, w - ew)
                if self.mode == "pixel":
                    arr[y : y + eh, x : x + ew, :] = np.random.randn(eh, ew, c).astype(arr.dtype)
                else:
                    arr[y : y + eh, x : x + ew, :] = 0
                return arr
        return arr


class NormalizeImage:
    """PIL/uint8 → float32 HWC normalized (reference NormalizeImage:707)."""

    def __init__(
        self,
        scale: Union[str, float] = 1.0 / 255.0,
        mean: Sequence[float] = (0.485, 0.456, 0.406),
        std: Sequence[float] = (0.229, 0.224, 0.225),
        order: str = "hwc",
        output_fp16: bool = False,
    ):
        if isinstance(scale, str):
            scale = eval(scale)
        self.scale = float(scale)
        self.mean = np.asarray(mean, np.float32).reshape(1, 1, -1)
        self.std = np.asarray(std, np.float32).reshape(1, 1, -1)
        self.dtype = np.float16 if output_fp16 else np.float32

    def __call__(self, img):
        arr = np.asarray(img, np.float32)
        if arr.ndim == 2:
            arr = arr[..., None].repeat(3, -1)
        arr = (arr * self.scale - self.mean) / self.std
        return arr.astype(self.dtype)


class ToCHWImage:
    """Kept for config compatibility; the framework is NHWC-native, so
    this marks the end of the PIL stage without transposing."""

    def __call__(self, img):
        if not isinstance(img, np.ndarray):
            img = np.asarray(img, np.float32)
        return img


class ToRGB:
    def __call__(self, img):
        return img.convert("RGB") if img.mode != "RGB" else img


TRANSFORMS = {
    k: v
    for k, v in globals().items()
    if isinstance(v, type) and callable(getattr(v, "__call__", None)) and not k.startswith("_")
}


def build_transform(cfg) -> Callable:
    """cfg: list of {OpName: {kwargs}} dicts (reference YAML surface)."""
    if cfg is None:
        return lambda x: x
    if callable(cfg):
        return cfg
    ops: List[Callable] = []
    for item in cfg:
        if isinstance(item, str):
            ops.append(TRANSFORMS[item]())
            continue
        for opname, kwargs in item.items():
            kwargs = dict(kwargs or {})
            if opname in ("TwoViewsTransform",):
                t1 = build_transform(kwargs.pop("base_transform1", kwargs.pop("transforms", None)))
                t2 = kwargs.pop("base_transform2", None)
                ops.append(TwoViewsTransform(t1, build_transform(t2) if t2 else None))
            elif opname in ("RandomApply",):
                inner = build_transform(kwargs.pop("transforms"))
                ops.append(RandomApply([inner], **kwargs))
            else:
                ops.append(TRANSFORMS[opname](**kwargs))
    return Compose(ops)


class RandomResizedCropWithCoords(RandomResizedCrop):
    """RRC returning (img, coord) where coord = (x1, y1, x2, y2) of the
    crop box in source-image space (reference PixPro transforms,
    img_pil_pixpro_transforms.py)."""

    def __call__(self, img):
        x, y, cw, ch = self.get_params(img)
        coord = np.asarray([x, y, x + cw, y + ch], np.float32)
        img = _crop(img, x, y, cw, ch)
        img = self._resize(img, (self.size[1], self.size[0]))
        return img, coord


class PixProTwoViewsTransform:
    """Two coordinate-tracked crops, each through its own post pipeline.
    Yields {'view1','view2','coord1','coord2'} for PixPro.

    Horizontal flips must be coordinate-tracked too (an untracked flip
    breaks the per-cell correspondence the loss is built on), so they
    happen HERE, not in the post pipeline: a flip mirrors the image and
    swaps coord x1<->x2, giving a negative box width that mirrors the
    cell-center grid in pixpro_regression_loss — reference
    img_pil_pixpro_transforms.py flip semantics."""

    def __init__(self, crop, post_transform1, post_transform2=None,
                 flip_prob: float = 0.5):
        self.crop = crop if callable(crop) else RandomResizedCropWithCoords(**crop)
        self.post1 = build_transform(post_transform1)
        self.post2 = build_transform(post_transform2) if post_transform2 else self.post1
        self.flip_prob = flip_prob

    def _crop_flip(self, img):
        v, c = self.crop(img)
        if random.random() < self.flip_prob:
            if isinstance(v, np.ndarray):
                v = np.ascontiguousarray(v[:, ::-1])
            else:
                from PIL import Image

                v = v.transpose(Image.FLIP_LEFT_RIGHT)
            c = np.asarray([c[2], c[1], c[0], c[3]], np.float32)
        return v, c

    def __call__(self, img):
        v1, c1 = self._crop_flip(img)
        v2, c2 = self._crop_flip(img)
        return {"view1": self.post1(v1), "view2": self.post2(v2),
                "coord1": c1, "coord2": c2}


TRANSFORMS["RandomResizedCropWithCoords"] = RandomResizedCropWithCoords
TRANSFORMS["PixProTwoViewsTransform"] = PixProTwoViewsTransform


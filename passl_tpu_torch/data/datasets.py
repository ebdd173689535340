# Copied from passl_tpu/data/datasets.py; the port keeps its own copy and imports nothing of passl_tpu.
"""Datasets.

Capability parity with reference `passl/data/dataset/`:
`ImageFolder` (imagefolder_dataset.py:26-199), `ImageNetDataset`
(imagenet_dataset.py:23-55, anno-list file), `CommonDataset`
(common_dataset.py), `FewShotDataset` (fewshot_dataset.py:24, 1%/10%
semi-sup lists), `SwAVMultiCropDataset` (swavmulticrop_datatset.py:
32-76), plus CIFAR-10 (configs/simclr_r18_cifar10) and a synthetic
dataset (the TPU-world replacement for mounting /passl_data in CI —
deterministic fake ImageNet for perf/golden tests).
"""
from __future__ import annotations

import os
import pickle
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np

from .transforms import build_transform

_IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp", ".ppm", ".tif", ".tiff")


class Dataset:
    def __len__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise NotImplementedError


class ImageFolder(Dataset):
    """class-per-subdir layout (reference imagefolder_dataset.py)."""

    def __init__(self, root: str, transform=None, with_label: bool = True,
                 raw_bytes: bool = False):
        self.root = root
        self.transform = build_transform(transform)
        self.with_label = with_label
        self.raw_bytes = raw_bytes
        classes = sorted(
            d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d))
        )
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples: List[Tuple[str, int]] = []
        for c in classes:
            cdir = os.path.join(root, c)
            for fn in sorted(os.listdir(cdir)):
                if fn.lower().endswith(_IMG_EXTS):
                    self.samples.append((os.path.join(cdir, fn), self.class_to_idx[c]))

    def __len__(self):
        return len(self.samples)

    def _load(self, path):
        if getattr(self, "raw_bytes", False):
            # undecoded JPEG bytes for the native C++ decode path
            # (transforms like NativeJpegRRC / DecodeImage consume them)
            with open(path, "rb") as f:
                return f.read()
        from PIL import Image

        with open(path, "rb") as f:
            img = Image.open(f)
            return img.convert("RGB")

    def __getitem__(self, idx):
        path, label = self.samples[idx]
        img = self.transform(self._load(path))
        return (img, label) if self.with_label else img


class ImageNetDataset(ImageFolder):
    """Annotation-list dataset: `<rel_path> <label>` per line
    (reference imagenet_dataset.py:23-55)."""

    def __init__(self, image_root: str, cls_label_path: str, transform=None,
                 with_label: bool = True, raw_bytes: bool = False):
        self.root = image_root
        self.transform = build_transform(transform)
        self.with_label = with_label
        self.raw_bytes = raw_bytes
        self.samples = []
        with open(cls_label_path) as f:
            for line in f:
                parts = line.strip().split(" ")
                if not parts or not parts[0]:
                    continue
                label = int(parts[1]) if len(parts) > 1 else -1
                self.samples.append((os.path.join(image_root, parts[0]), label))


class FewShotDataset(ImageNetDataset):
    """1%/10% semi-supervised split lists (reference fewshot_dataset.py)."""


class CIFAR10(Dataset):
    """CIFAR-10 from the standard python pickle batches (no download;
    the reference's smallest config is simclr_r18_cifar10)."""

    def __init__(self, root: str, mode: str = "train", transform=None, with_label: bool = True):
        self.transform = build_transform(transform)
        self.with_label = with_label
        files = [f"data_batch_{i}" for i in range(1, 6)] if mode == "train" else ["test_batch"]
        base = root
        sub = os.path.join(root, "cifar-10-batches-py")
        if os.path.isdir(sub):
            base = sub
        data, labels = [], []
        for fn in files:
            with open(os.path.join(base, fn), "rb") as f:
                d = pickle.load(f, encoding="bytes")
            data.append(d[b"data"])
            labels.extend(d[b"labels"])
        self.data = np.concatenate(data).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        self.labels = np.asarray(labels, np.int64)

    def __len__(self):
        return len(self.data)

    def __getitem__(self, idx):
        from PIL import Image

        img = Image.fromarray(self.data[idx])
        img = self.transform(img)
        return (img, int(self.labels[idx])) if self.with_label else img


class SyntheticDataset(Dataset):
    """Deterministic fake data for CI/perf (replaces /passl_data mounts).
    Generates fixed-seed uint8 images; `two_views`/`multi_crop` mirror
    the SSL dataset wrappers so any pipeline can run synthetically."""

    def __init__(
        self,
        size: int = 1024,
        image_size: int = 224,
        num_classes: int = 1000,
        transform=None,
        with_label: bool = True,
        channels: int = 3,
    ):
        self.size = size
        self.image_size = image_size
        self.num_classes = num_classes
        self.transform = build_transform(transform)
        self.with_label = with_label
        self.channels = channels

    def __len__(self):
        return self.size

    def __getitem__(self, idx):
        from PIL import Image

        rs = np.random.RandomState(idx % 4096)
        arr = rs.randint(0, 256, (self.image_size, self.image_size, self.channels), np.uint8)
        img = Image.fromarray(arr)
        img = self.transform(img)
        label = idx % self.num_classes
        return (img, label) if self.with_label else img


class SwAVMultiCropDataset(Dataset):
    """Multi-crop wrapper: per-resolution transform stacks (reference
    swavmulticrop_datatset.py:32-76). Returns a list of crops grouped
    by resolution: [crops_res1(n1), crops_res2(n2), ...]."""

    def __init__(self, dataset: Dataset, num_crops: Sequence[int], transforms: Sequence[Any]):
        assert len(num_crops) == len(transforms)
        self.dataset = dataset
        self.num_crops = list(num_crops)
        self.transforms = [build_transform(t) for t in transforms]

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, idx):
        item = self.dataset[idx]
        img = item[0] if isinstance(item, tuple) else item
        crops = []
        for n, t in zip(self.num_crops, self.transforms):
            for _ in range(n):
                crops.append(t(img))
        return crops


DATASETS = {
    "ImageFolder": ImageFolder,
    "ImageNetDataset": ImageNetDataset,
    "FewShotDataset": FewShotDataset,
    "CIFAR10": CIFAR10,
    "Cifar10": CIFAR10,
    "SyntheticDataset": SyntheticDataset,
    "SwAVMultiCropDataset": SwAVMultiCropDataset,
}


def _register_token_label():
    # late import: token_label imports transforms helpers from here's
    # sibling; registered lazily to avoid a cycle at module import
    from .token_label import LVViTImageNetDataset, SyntheticTokenLabelDataset

    DATASETS["LVViTImageNetDataset"] = LVViTImageNetDataset
    DATASETS["LVViT_ImageNet"] = LVViTImageNetDataset  # reference name
    DATASETS["SyntheticTokenLabelDataset"] = SyntheticTokenLabelDataset


class TextImageDataset(Dataset):
    """Image-caption pairs for CLIP (reference
    passl_v110/datasets/textimagedataset.py): an annotation file with
    `<image_path>\t<caption>` lines; tokenized to fixed context length."""

    def __init__(
        self,
        data_root: str = "",
        anno_path: Optional[str] = None,
        transform=None,
        context_length: int = 77,
        bpe_path: Optional[str] = None,
    ):
        from .tokenizer import SimpleTokenizer

        self.transform = build_transform(transform)
        self.tokenizer = SimpleTokenizer(bpe_path=bpe_path, context_length=context_length)
        self.samples: List[Tuple[str, str]] = []
        if anno_path:
            with open(anno_path) as f:
                for line in f:
                    parts = line.rstrip("\n").split("\t")
                    if len(parts) >= 2:
                        self.samples.append((os.path.join(data_root, parts[0]), parts[1]))

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx):
        from PIL import Image

        path, caption = self.samples[idx]
        with open(path, "rb") as f:
            img = Image.open(f).convert("RGB")
        img = self.transform(img)
        tokens = self.tokenizer.tokenize(caption)[0]
        return {"image": img, "text": tokens}


class SyntheticTextImageDataset(Dataset):
    """Deterministic fake image-caption pairs (CLIP smoke/perf runs)."""

    def __init__(self, size: int = 256, image_size: int = 224, context_length: int = 77,
                 vocab_size: int = 49408, transform=None):
        self.size = size
        self.image_size = image_size
        self.context_length = context_length
        self.vocab_size = vocab_size
        self.transform = build_transform(transform)

    def __len__(self):
        return self.size

    def __getitem__(self, idx):
        from PIL import Image

        rs = np.random.RandomState(idx % 4096)
        img = Image.fromarray(rs.randint(0, 256, (self.image_size, self.image_size, 3), np.uint8))
        img = self.transform(img)
        max_ln = max(2, self.context_length - 2)
        ln = rs.randint(1, min(20, max_ln))
        toks = np.zeros((self.context_length,), np.int32)
        toks[0] = self.vocab_size - 2  # sot
        toks[1 : 1 + ln] = rs.randint(1, self.vocab_size - 2, ln)
        toks[1 + ln] = self.vocab_size - 1  # eot
        return {"image": img, "text": toks}


DATASETS["TextImageDataset"] = TextImageDataset
DATASETS["SyntheticTextImageDataset"] = SyntheticTextImageDataset


class StructuredSyntheticDataset(Dataset):
    """Synthetic images with class-dependent structure (not pure noise):
    each class has a characteristic 2-D sinusoid pattern (frequency +
    orientation + color) composited with per-sample phase/noise. SSL
    methods can learn class-separating features from it, so a linear
    probe scoring far above chance validates the whole pretrain→probe
    pipeline end-to-end without real data."""

    def __init__(self, size: int = 2048, image_size: int = 32, num_classes: int = 10,
                 noise: float = 0.35, transform=None, with_label: bool = True,
                 index_offset: int = 0):
        self.size = size
        self.image_size = image_size
        self.num_classes = num_classes
        self.noise = noise
        self.transform = build_transform(transform)
        self.with_label = with_label
        self.index_offset = index_offset  # disjoint splits (eval holdout)

    def _pattern(self, cls: int, rs: np.random.RandomState) -> np.ndarray:
        h = w = self.image_size
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32) / h
        angle = np.pi * cls / self.num_classes
        freq = 2.0 + 1.5 * (cls % 5)
        phase = rs.uniform(0, 2 * np.pi)
        wave = np.sin(2 * np.pi * freq * (xx * np.cos(angle) + yy * np.sin(angle)) + phase)
        base = np.zeros((h, w, 3), np.float32)
        crs = np.random.RandomState(cls)  # fixed per-class color
        color = crs.uniform(0.3, 1.0, 3)
        for c in range(3):
            base[..., c] = 0.5 + 0.5 * wave * color[c]
        base += self.noise * rs.randn(h, w, 3)
        return np.clip(base * 255, 0, 255).astype(np.uint8)

    def __len__(self):
        return self.size

    def __getitem__(self, idx):
        from PIL import Image

        idx = idx + self.index_offset
        label = idx % self.num_classes
        rs = np.random.RandomState(idx)
        img = Image.fromarray(self._pattern(label, rs))
        img = self.transform(img)
        return (img, label) if self.with_label else img


DATASETS["StructuredSyntheticDataset"] = StructuredSyntheticDataset


class StructuredTextImageDataset(StructuredSyntheticDataset):
    """Structured images paired with class-describing captions — the
    CLIP learning check set. Captions are natural-language templates
    over a per-class keyword, tokenized with the real (vendored) BPE
    vocabulary, so contrastive image-text training must align the
    visual sinusoid pattern with the caption's class word to solve
    retrieval on held-out pairs."""

    CLASS_WORDS = ["river", "mountain", "forest", "desert", "ocean",
                   "glacier", "meadow", "canyon", "volcano", "island"]
    TEMPLATES = ["a photo of a {}", "an image showing a {}",
                 "this is a picture of a {}", "a {} scene"]

    def __init__(self, size: int = 2048, image_size: int = 32, num_classes: int = 10,
                 noise: float = 0.35, transform=None, index_offset: int = 0,
                 context_length: int = 32, bpe_path=None):
        super().__init__(size=size, image_size=image_size, num_classes=num_classes,
                         noise=noise, transform=transform, with_label=False,
                         index_offset=index_offset)
        from .tokenizer import SimpleTokenizer

        assert num_classes <= len(self.CLASS_WORDS)
        self.tokenizer = SimpleTokenizer(bpe_path=bpe_path, context_length=context_length)

    def caption(self, label: int, idx: int) -> str:
        tpl = self.TEMPLATES[idx % len(self.TEMPLATES)]
        return tpl.format(self.CLASS_WORDS[label])

    def __getitem__(self, idx):
        from PIL import Image

        gidx = idx + self.index_offset
        label = gidx % self.num_classes
        rs = np.random.RandomState(gidx)
        img = self.transform(Image.fromarray(self._pattern(label, rs)))
        text = self.tokenizer.tokenize(self.caption(label, gidx))[0]
        return {"image": img, "text": text}


DATASETS["StructuredTextImageDataset"] = StructuredTextImageDataset


class SklearnDigits(Dataset):
    """UCI optical handwritten digits via `sklearn.datasets.load_digits`
    (1797 real 8x8 scans, 10 classes) — the only REAL image dataset
    shipped inside this rig's installed packages (no egress, no
    mounts), so it serves as the framework's first real-data accuracy
    point (reference counterpart in spirit:
    configs/simclr/simclr_r18_cifar10.yaml — the reference's own
    smallest real-data recipe). Deterministic class-stratified
    train/test split via a fixed permutation seed; 0..16 ints are
    rescaled to 0..255 uint8 grayscale replicated to RGB so the
    standard transform stack applies unchanged."""

    def __init__(self, mode: str = "train", holdout: int = 297, split_seed: int = 0,
                 transform=None, with_label: bool = True):
        from sklearn.datasets import load_digits

        d = load_digits()
        imgs = np.clip(d.images * (255.0 / 16.0), 0, 255).astype(np.uint8)
        perm = np.random.RandomState(split_seed).permutation(len(imgs))
        sel = perm[holdout:] if mode == "train" else perm[:holdout]
        self.data = imgs[sel]
        self.labels = d.target[sel].astype(np.int64)
        self.transform = build_transform(transform)
        self.with_label = with_label

    def __len__(self):
        return len(self.data)

    def __getitem__(self, idx):
        from PIL import Image

        img = Image.fromarray(self.data[idx]).convert("RGB")
        img = self.transform(img)
        return (img, int(self.labels[idx])) if self.with_label else img


DATASETS["SklearnDigits"] = SklearnDigits

"""Data pipeline factory (twin of `passl_tpu/data/__init__.py:38-77`).

`build_dataloader` builds the port's own copies of the JAX package's host
pieces (`datasets`, `transforms` with `autoaugment`, `loader`'s
`DistributedBatchSampler` / `RepeatedAugSampler` and `DataLoader`, and the
Mixup/Cutmix `batch_transforms`), which give the JAX package's batches bit
for bit from the same config and seed. This process's rank and the world
size come from `torch.distributed` when it is initialised, else 0 and 1.
Batches are numpy; `to_device` makes them tensors on an explicit device.
The mask transforms (`masking`: BEiT's and CAE's `MaskingGenerator`,
`RandomMaskingGenerator`, `BEiTTwoViewsWithMask`) register with the
transforms on import, as in the JAX package; the token-label datasets
(`token_label`: `LVViTImageNetDataset`, `SyntheticTokenLabelDataset`)
register on their first use by name, as there.
"""
from __future__ import annotations

import copy
from typing import Any, Dict

import numpy as np
import torch
import torch.distributed as dist

from . import autoaugment  # noqa: F401  (registers AutoAugment/RandAugment/AugMix/TimmAutoAugment)
from . import batch_transforms as _bt
from . import masking  # noqa: F401  (registers mask transforms)
from .datasets import DATASETS
from .loader import DataLoader, DistributedBatchSampler, RepeatedAugSampler

SAMPLERS = {
    "DistributedBatchSampler": DistributedBatchSampler,
    "BatchSampler": DistributedBatchSampler,
    "RepeatedAugSampler": RepeatedAugSampler,
    "DistributedRepeatedAugSampler": RepeatedAugSampler,
}


def build_dataset(cfg: Dict[str, Any]):
    cfg = copy.deepcopy(dict(cfg))
    name = cfg.pop("name")
    if name not in DATASETS and ("TokenLabel" in name or name.startswith("LVViT")):
        from .datasets import _register_token_label

        _register_token_label()
    if name == "SwAVMultiCropDataset" and isinstance(cfg.get("dataset"), dict):
        cfg["dataset"] = build_dataset(cfg["dataset"])
    return DATASETS[name](**cfg)


def _rank_and_world() -> tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def build_dataloader(config: Dict[str, Any], mode: str = "Train", seed: int = 0) -> DataLoader:
    """config: the DataLoader.<mode> block (dataset, sampler, loader,
    batch_transform). `sampler.batch_size` is the global batch size; this
    process loads its share, global / world size."""
    cfg = copy.deepcopy(dict(config))
    dataset = build_dataset(cfg["dataset"])
    sampler_cfg = dict(cfg.get("sampler", {}))
    sampler_name = sampler_cfg.pop("name", "DistributedBatchSampler")
    global_bs = int(sampler_cfg.pop("batch_size", 128))
    rank, world = _rank_and_world()
    if global_bs % world:
        raise ValueError(f"global batch {global_bs} does not divide over {world} processes")
    sampler = SAMPLERS[sampler_name](
        dataset_len=len(dataset),
        batch_size=global_bs // world,
        shuffle=sampler_cfg.pop("shuffle", mode.lower() == "train"),
        drop_last=sampler_cfg.pop("drop_last", mode.lower() == "train"),
        seed=seed,
        num_replicas=world,
        rank=rank,
        **sampler_cfg,
    )
    loader_cfg = dict(cfg.get("loader", {}))
    batch_transform = None
    if cfg.get("batch_transform"):
        batch_transform = _bt.build_batch_transform(cfg["batch_transform"])
    return DataLoader(dataset, sampler, num_workers=int(loader_cfg.get("num_workers", 0)),
                      prefetch=int(loader_cfg.get("prefetch", 2)),
                      batch_transform=batch_transform, seed=seed)


def to_device(batch, device: torch.device):
    """numpy arrays (in tuples, lists or dicts) -> tensors on `device`."""
    if isinstance(batch, dict):
        return {k: to_device(v, device) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(to_device(v, device) for v in batch)
    return torch.from_numpy(np.ascontiguousarray(batch)).to(device)

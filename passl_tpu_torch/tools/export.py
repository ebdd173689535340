"""Export CLI: config -> the port's serving artifact.

Counterpart of `passl_tpu/tools/export.py` and `Engine.export`
(`passl_tpu/engine/engine.py:544-579`), with the same `-c`/`-o` surface. It
builds the model from the config's `Model` and `FP16` blocks alone (no
optimizer, no data), fills it from `Global.checkpoint` (a checkpoint the
port's trainer wrote; a JAX `.ckpt` is refused), else from `Global.seed`
with `Global.pretrained_model` (a torch `state_dict` file, e.g. from
`utils.convert.flax_to_torch`) loaded over it as the JAX loader loads it
(`utils.io.load_pretrained`), and writes
`<Model.name>.pt` + `.json` under `Global.output_dir`. The artifact's input
spec takes its height, width and channels from one sample of the config's
Eval (else Train) dataset through its transforms, as the JAX engine takes
one loader sample (`engine.py:501,564`), whatever `Global.eval_during_train`
says; where that dataset cannot be read (an absent ImageNet list), from
the model's `img_size` and `in_chans`.

Usage:
  python -m passl_tpu_torch.tools.export \
      -c configs/classification/cait_s24_224_in1k.yaml [-o Global.output_dir=./output/x]
"""
from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np
import torch

from passl_tpu_torch.core.amp import Policy, resolve_dtype
from passl_tpu_torch.data import build_dataset
from passl_tpu_torch.models import build_model
from passl_tpu_torch.nn.init import init_module
from passl_tpu_torch.utils import cfg_util, io, logger


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser("passl_tpu_torch export")
    ap.add_argument("-c", "--config", required=True, help="config file path")
    ap.add_argument("-o", "--override", action="append", default=[],
                    help="config options to override, e.g. -o Global.output_dir=./out")
    return ap.parse_args(argv)


def input_spec(config: dict, model: torch.nn.Module) -> dict:
    """The served input `[None, H, W, C]`: one sample of the Eval (else Train)
    dataset, or the model's `img_size` where no dataset can be read."""
    blocks = config.get("DataLoader", {}) or {}
    block = blocks.get("Eval") or blocks.get("Train")
    shape = None
    if block:
        try:
            sample = build_dataset(block["dataset"])[0]
        except (OSError, IndexError) as exc:  # a dataset list or folder that is absent, or empty
            logger.warning(f"export: no sample of the dataset ({exc!r}); the model's img_size "
                           "gives the input shape")
        else:
            image = np.asarray(sample[0] if isinstance(sample, tuple) else sample)
            shape = list(image.shape) if image.ndim == 3 else list(image.shape) + [1]
    if shape is None:
        if not hasattr(model, "img_size"):
            raise ValueError(f"export: {type(model).__name__} has no img_size and the config "
                             "names no readable dataset: the input shape is unknown")
        shape = [model.img_size, model.img_size, getattr(model, "in_chans", 3)]
    return {"shape": [None, *shape], "dtype": "float32", "layout": "NHWC"}


def main(argv: Optional[Sequence[str]] = None) -> str:
    """Run the export; return the path of the written `.pt`."""
    args = parse_args(argv)
    config = cfg_util.get_config(args.config, overrides=args.override, show=True)
    g = config.get("Global", {})
    if not config.get("Loss") and "Train" in config.get("DataLoader", {}):
        # the JAX engine's refusal (passl_tpu/engine/engine.py:553-559)
        raise ValueError(
            "export targets inference models (logits/features). For an SSL pretrain config, "
            "first extract the backbone (passl_tpu_torch.tools.extract_weights) and export a "
            "Classification/LinearProbe config over it.")
    output_dir = g.get("output_dir", "./output")
    logger.init_logger(log_file=os.path.join(output_dir, "export.log"))
    checkpoint = io.resolve_checkpoint(g["checkpoint"]) if g.get("checkpoint") else None

    policy = Policy.from_config(config.get("FP16"))
    model_cfg = dict(config.get("Model", {}))
    if "dtype" not in model_cfg and policy.compute_dtype != torch.float32:
        model_cfg["dtype"] = policy.compute_dtype
    compute_dtype = resolve_dtype(model_cfg.get("dtype"))
    with torch.device("meta"):
        model = build_model(model_cfg)
    model.to_empty(device="cpu")

    weights = g.get("pretrained_model")
    if checkpoint:
        state = torch.load(checkpoint, map_location="cpu", weights_only=True)
        model.load_state_dict(state["model"])
        logger.info(f"export: loaded the trained weights of {checkpoint} (step {state['step']})")
    else:
        # the seed's init, then the pretrained file over it with the JAX
        # loader's tolerance: what the file lacks or cannot fill keeps the init
        init_module(model, torch.Generator().manual_seed(int(g.get("seed", 42))))
        if weights:
            io.load_pretrained(model, weights)
        else:
            logger.warning("export: neither Global.checkpoint nor Global.pretrained_model "
                           "set — exporting fresh-init weights")

    n_params = sum(p.numel() for p in model.parameters())
    logger.info(f"model {model_cfg.get('name')}: {n_params / 1e6:.2f}M params, "
                f"compute dtype {compute_dtype}")
    return io.export(model, output_dir, model_cfg.get("name", "inference"), model_cfg,
                     compute_dtype, input_spec(config, model))


if __name__ == "__main__":
    main()

"""CLIP learning check of the PyTorch port: held-out zero-shot-style retrieval
(the twin of tests/e2e/clip_retrieval_check.py).

Loads the tiny CLIP the port pretrained on structured image-caption pairs
(or, with `none` for the checkpoint, the untrained model initialised from the
config's seed as the trainer initialises it: the floor), embeds 512 HELD-OUT
structured images (a disjoint index range) and the 10 class captions, and
scores text->class R@1: each image must rank its own class's caption first.
Chance = 0.10; the pass bar (> 0.5) matches the other learning checks.

  python tests/e2e/clip_retrieval_check_torch.py <config> <checkpoint | none> [--device cuda]
"""
import argparse
import sys

import numpy as np
import torch

from passl_tpu_torch.data.datasets import StructuredTextImageDataset
from passl_tpu_torch.data.tokenizer import SimpleTokenizer
from passl_tpu_torch.models import build_model
from passl_tpu_torch.nn.init import init_module
from passl_tpu_torch.utils import cfg_util, io


def main(cfg_path: str, ckpt: str, device: str) -> int:
    cfg = cfg_util.get_config(cfg_path, show=False)
    model = build_model(dict(cfg["Model"]))  # f32, as the JAX check builds it
    if ckpt == "none":
        init_module(model, torch.Generator().manual_seed(int(cfg["Global"]["seed"])))
    else:
        state = torch.load(io.resolve_checkpoint(ckpt), map_location="cpu", weights_only=True)
        model.load_state_dict(state["model"])
    model = model.to(device).eval()

    # held-out images: disjoint index range, eval-style transform
    ds = StructuredTextImageDataset(
        size=512, image_size=32, num_classes=10, noise=0.2,
        context_length=32, index_offset=100000,
        transform=[{"NormalizeImage": {"scale": 0.00392157,
                                       "mean": [0.5, 0.5, 0.5],
                                       "std": [0.25, 0.25, 0.25]}}])
    images = np.stack([ds[i]["image"] for i in range(len(ds))])
    labels = np.arange(512) % 10  # gidx % num_classes with offset 100000 % 10 == 0

    tok = SimpleTokenizer(context_length=32)
    texts = tok.tokenize([f"a photo of a {w}" for w in ds.CLASS_WORDS[:10]])

    with torch.no_grad():
        im = model.encode_image(torch.from_numpy(images.astype(np.float32)).to(device))
        tx = model.encode_text(torch.from_numpy(texts).to(device))
        im = im / im.norm(dim=-1, keepdim=True)
        tx = tx / tx.norm(dim=-1, keepdim=True)
        sim = (im @ tx.T).cpu().numpy()  # [512, 10]
    r1 = float((sim.argmax(axis=1) == labels).mean())
    print(f"FINAL retrieval R@1: {r1:.4f} (chance = 0.10)")
    return 0 if r1 > 0.5 else 1


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("config")
    ap.add_argument("checkpoint", help="the pretrain's latest.pt, or none for the untrained model")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    sys.exit(main(args.config, args.checkpoint, args.device))

"""Classification CLI over the port's exported artifact.

Counterpart of `passl_tpu/tools/predict.py`, with the same arguments plus
`--device`: prints the top-k class ids and scores of each image.

Usage:
  python -m passl_tpu_torch.tools.predict \
      --model-dir ./output/cait_s24_224_in1k --model-name cait_s24_224 \
      --image path/to/img.jpg [more.jpg ...] [--resize 256 --crop 224] \
      [--topk 5] [--batch-size 32] [--label-file labels.txt] [--device cuda]
"""
from __future__ import annotations

import argparse
import glob
import os
from typing import Optional, Sequence

from passl_tpu_torch.engine.inference import Predictor


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser("passl_tpu_torch predict")
    ap.add_argument("--model-dir", required=True, help="directory with <name>.pt + <name>.json")
    ap.add_argument("--model-name", default="inference")
    ap.add_argument("--image", nargs="+", required=True,
                    help="image file(s), glob(s), or a directory")
    ap.add_argument("--resize", type=int, default=256)
    ap.add_argument("--crop", type=int, default=224)
    ap.add_argument("--interpolation", default="bicubic")
    ap.add_argument("--mean", type=float, nargs=3, default=[0.485, 0.456, 0.406])
    ap.add_argument("--std", type=float, nargs=3, default=[0.229, 0.224, 0.225])
    ap.add_argument("--scale", type=float, default=1.0 / 255)
    ap.add_argument("--no-crop", action="store_true",
                    help="resize directly to --crop x --crop (no center crop)")
    ap.add_argument("--topk", type=int, default=5)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--label-file", default=None,
                    help="one class name per line; maps ids to names")
    ap.add_argument("--device", default="cuda", help="torch device to serve on")
    return ap.parse_args(argv)


def expand_images(specs):
    paths = []
    for s in specs:
        if os.path.isdir(s):
            for ext in ("*.jpg", "*.jpeg", "*.png", "*.bmp", "*.JPEG"):
                paths.extend(sorted(glob.glob(os.path.join(s, ext))))
        elif any(c in s for c in "*?["):
            paths.extend(sorted(glob.glob(s)))
        else:
            paths.append(s)
    if not paths:
        raise SystemExit(f"no images matched {specs}")
    return paths


def main(argv: Optional[Sequence[str]] = None):
    args = parse_args(argv)
    if args.no_crop:
        transform = [{"Resize": {"size": [args.crop, args.crop],
                                 "interpolation": args.interpolation}}]
    else:
        transform = [{"Resize": {"size": args.resize, "interpolation": args.interpolation}},
                     {"CenterCrop": {"size": args.crop}}]
    transform += [{"NormalizeImage": {"scale": args.scale, "mean": args.mean,
                                      "std": args.std}}]
    predictor = Predictor(args.model_dir, name=args.model_name, transform=transform,
                          device=args.device)

    labels = None
    if args.label_file:
        with open(args.label_file) as f:
            labels = [line.strip() for line in f]

    from PIL import Image

    paths = expand_images(args.image)
    for i in range(0, len(paths), args.batch_size):
        chunk = paths[i : i + args.batch_size]
        imgs = [Image.open(p).convert("RGB") for p in chunk]
        for path, res in zip(chunk, predictor(imgs, topk=args.topk)):
            names = [labels[c] if labels and c < len(labels) else str(c)
                     for c in res["class_ids"]]
            pretty = ", ".join(f"{n}:{s:.4f}" for n, s in zip(names, res["scores"]))
            print(f"{path}\ttop{args.topk}: {pretty}")


if __name__ == "__main__":
    main()

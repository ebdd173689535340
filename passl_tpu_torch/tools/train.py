"""Training CLI (counterpart of `passl_tpu/tools/train.py`).

Usage:
  python -m passl_tpu_torch.tools.train \
      -c configs/classification/cait_s24_224_in1k.yaml [-o Global.epochs=10] [--device cuda]
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

from passl_tpu_torch.engine.engine import Engine
from passl_tpu_torch.utils import cfg_util


def parse_args(description: str, argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description)
    ap.add_argument("-c", "--config", required=True, help="config file path")
    ap.add_argument("-o", "--override", action="append", default=[],
                    help="config options to override, e.g. -o Global.epochs=10")
    ap.add_argument("--device", default="cuda", help="torch device to run on (default cuda)")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Engine:
    args = parse_args("passl_tpu_torch train", argv)
    config = cfg_util.get_config(args.config, overrides=args.override, show=True)
    engine = Engine(config, mode="train", device=args.device)
    engine.train()
    return engine


if __name__ == "__main__":
    main()

"""Evaluation CLI (counterpart of `passl_tpu/tools/eval.py`): top-k of the
config's `DataLoader.Eval` set, with the weights of `Global.checkpoint` (a
port checkpoint) or `Global.pretrained_model`.

Usage:
  python -m passl_tpu_torch.tools.eval -c <config> -o Global.checkpoint=<dir>/latest.pt
"""
from __future__ import annotations

from typing import Optional, Sequence

from passl_tpu_torch.engine.engine import Engine
from passl_tpu_torch.tools.train import parse_args
from passl_tpu_torch.utils import cfg_util


def main(argv: Optional[Sequence[str]] = None) -> Optional[float]:
    args = parse_args("passl_tpu_torch eval", argv)
    config = cfg_util.get_config(args.config, overrides=args.override, show=True)
    return Engine(config, mode="eval", device=args.device).eval()


if __name__ == "__main__":
    main()

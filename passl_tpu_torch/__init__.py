"""PASSL on PyTorch and CUDA: the port of `passl_tpu` to NVIDIA Hopper.

Mirrors `passl_tpu`'s layout (`core/`, `nn/`, `ops/`, `models/`, `engine/`,
`tools/`, `utils/`), with the hand-written CUDA kernels under `csrc/`. It
imports torch and never jax; host code of `passl_tpu` that is free of jax
(config parsing, the registry, image transforms) is imported from there.
"""

__version__ = "0.1.0"

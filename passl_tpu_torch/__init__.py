"""PASSL on PyTorch and CUDA: the port of `passl_tpu` to NVIDIA Hopper.

Mirrors `passl_tpu`'s layout (`core/`, `nn/`, `ops/`, `models/`, `engine/`,
`tools/`, `utils/`), with the hand-written CUDA kernels under `csrc/`. It
imports torch and never jax, and nothing of `passl_tpu`: the host code it
shares with the JAX package (config parsing, the registry, datasets, image
transforms, samplers and the loader) is its own copy, under `utils/` and `data/`.
"""

__version__ = "0.1.0"

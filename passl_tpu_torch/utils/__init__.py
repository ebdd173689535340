# jax-free host code of the JAX package, imported rather than copied
from passl_tpu.utils import config as cfg_util  # noqa: F401
from passl_tpu.utils.registry import Registry  # noqa: F401

from . import logger  # noqa: F401

from . import config as cfg_util  # noqa: F401
from . import logger  # noqa: F401
from .registry import Registry  # noqa: F401

from .base import MODELS, build_model, register_model  # noqa: F401
from . import byol  # noqa: F401
from . import cait  # noqa: F401
from . import classification  # noqa: F401
from . import deit  # noqa: F401
from . import densecl  # noqa: F401
from . import fastmoco  # noqa: F401
from . import mae  # noqa: F401
from . import moco  # noqa: F401
from . import mocov3  # noqa: F401
from . import necks  # noqa: F401
from . import pixpro  # noqa: F401
from . import resnet  # noqa: F401
from . import simclr  # noqa: F401
from . import swav  # noqa: F401
from . import swin_transformer  # noqa: F401
from . import vision_transformer  # noqa: F401

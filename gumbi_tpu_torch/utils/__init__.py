from .torch_utils import *  # noqa: F401,F403

from .torch_utils import *  # noqa: F401,F403
from .misc import *  # noqa: F401,F403
from .generic_utils import *  # noqa: F401,F403

from .vggishish import VGGishish  # noqa: F401
from .lpaps import LPAPS  # noqa: F401

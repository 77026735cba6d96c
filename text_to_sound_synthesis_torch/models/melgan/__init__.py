from .generator import MelGANGenerator  # noqa: F401
from .interface import Vocoder  # noqa: F401

from .generator import MelGANGenerator  # noqa: F401
from .interface import Vocoder, load_vocoder  # noqa: F401

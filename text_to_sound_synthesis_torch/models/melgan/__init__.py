from .generator import MelGANGenerator  # noqa: F401
from .discriminator import MelGANDiscriminator, NLayerDiscriminator1d  # noqa: F401
from .interface import Vocoder, load_vocoder  # noqa: F401

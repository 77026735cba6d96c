from .modules import AttnBlock, Decoder, Downsample, Encoder, ResnetBlock, Upsample  # noqa: F401
from .quantize import VectorQuantizer, nearest_codebook_indices  # noqa: F401
from .model import VQModel  # noqa: F401

from .modules import AttnBlock, Decoder, Downsample, Encoder, ResnetBlock, Upsample  # noqa: F401
from .quantize import VectorQuantizer, VQResult, nearest_codebook_indices  # noqa: F401
from .model import VQModel, VQNoDiscModel, VQSegmentationModel, init_codec_  # noqa: F401
from .modules1d import Decoder1d, Encoder1d, VQModel1d  # noqa: F401

from .tokenizer import ClipBPETokenizer, find_default_bpe  # noqa: F401
from .text_model import ClipTextEncoder, CLIPTextEmbedding  # noqa: F401
from .tokenize import Tokenize  # noqa: F401
from .vision_model import ClipVisionEncoder  # noqa: F401

from .embeddings import ContentEmbedding  # noqa: F401
from .backbone import (Condition2SpecTransformer, Text2SpecTransformer,  # noqa: F401
                       UnCondition2SpecTransformer)
from .process import DiscreteDiffusion, OneHotDraws, sample_tokens, sample_tokens_fused  # noqa: F401

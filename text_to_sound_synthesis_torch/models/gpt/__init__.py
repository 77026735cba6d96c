from .model import GPT, GPTClass, GPTFeats, GPTFeatsClass, RNNEmbedder, ar_sample  # noqa: F401
from .net2net import Net2NetTransformer  # noqa: F401

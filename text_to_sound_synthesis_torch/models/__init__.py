"""Model zoo of the port. Importing this package registers every config target."""

from . import captioner, clip, diffusion, discriminator, gpt, lpaps, melception, melgan, vqgan  # noqa: F401,E501
from .diffsound import Diffsound, build_model, parse_sample_type  # noqa: F401

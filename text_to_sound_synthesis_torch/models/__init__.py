"""Model zoo of the port. Importing this package registers every config target."""

from . import clip, diffusion, discriminator, lpaps, melgan, vqgan  # noqa: F401
from .diffsound import Diffsound, build_model, parse_sample_type  # noqa: F401

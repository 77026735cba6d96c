from .model import Melception, load_melception_checkpoint  # noqa: F401

from . import checkpoint, from_jax  # noqa: F401

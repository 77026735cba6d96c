from . import from_jax  # noqa: F401

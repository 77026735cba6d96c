from . import diffusion, fused_sampler, permuter  # noqa: F401

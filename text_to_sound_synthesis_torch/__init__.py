"""text_to_sound_synthesis_torch — the PyTorch / CUDA port of the Diffsound
text-to-sound system, for an NVIDIA H100 (Hopper, sm_90a).

It sits beside ``text_to_sound_synthesis_tpu`` (JAX on a TPU), which stays the
reference: the port mirrors its layout and public names, and its tests check
each ported module against the JAX one on the same inputs and weights. The
port imports ``torch`` and never ``jax`` or ``flax``.

* ``models/``  CLIP text tower, the discrete-diffusion denoiser and sampler,
  the VQGAN codec, the MelGAN vocoder, and the ``Diffsound`` composite;
* ``ops/``     the diffusion algebra, permuters, and the fused sampler step
  (plain PyTorch + the hand-written kernel ``csrc/fused_sampler.cu``);
* ``convert/`` ``from_jax``: the JAX package's parameter trees (as numpy)
  into the port's modules;
* ``engine/``  Stage-2 training: the train step, AdamW, the schedulers, the
  EMA, the grad clip, checkpoints, the logger and the ``Solver``;
* ``data/``    the mel datasets and the sharded loader (``native/``: the
  batched .npy reader, C++ on the host);
* ``parallel/`` DDP and the sharded samplers' runner on ``torch.distributed``;
* ``tools/``   the training CLI and the kernels' A/B tools;
* ``utils/``   the config registry, seeded init, and the nvcc build helper.
"""

__version__ = "0.1.0"

# importing the package registers every config target, so the repo's YAML
# configs resolve to the port's classes
from . import convert, data, engine, models, ops, parallel, utils  # noqa: E402,F401

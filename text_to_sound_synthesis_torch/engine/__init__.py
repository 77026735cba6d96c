"""Training engine of the port (the JAX package's ``engine/``): Stage 2, Stage 1, the
vocoder."""

from .clip_grad import ClipGradNorm, clip_by_global_norm  # noqa: F401
from .ema import ema_copy, ema_update  # noqa: F401
from .optimizers import build_optimizer, decay_mask, param_groups, set_learning_rate  # noqa: F401
from .schedulers import CosineAnnealingLRWithWarmup, ReduceLROnPlateauWithWarmup  # noqa: F401
from .solver import Solver  # noqa: F401
from .train_state import DiffusionTrainState, TrainDraws, TrainMetrics, make_train_step  # noqa: F401
from .vocoder_solver import (VocoderTrainState, make_vocoder_train_step,  # noqa: F401
                             mel_for_vocoder)
from .vqgan_solver import (VQGANLossConfig, VQGANTrainState, build_gan_optimizer,  # noqa: F401
                           make_vqgan_nodisc_train_step, make_vqgan_segmentation_train_step,
                           make_vqgan_train_step)

"""Stage-2 training engine of the port (the JAX package's ``engine/``)."""

from .clip_grad import ClipGradNorm, clip_by_global_norm  # noqa: F401
from .ema import ema_copy, ema_update  # noqa: F401
from .optimizers import build_optimizer, decay_mask, param_groups, set_learning_rate  # noqa: F401
from .schedulers import CosineAnnealingLRWithWarmup, ReduceLROnPlateauWithWarmup  # noqa: F401
from .solver import Solver  # noqa: F401
from .train_state import DiffusionTrainState, TrainDraws, TrainMetrics, make_train_step  # noqa: F401

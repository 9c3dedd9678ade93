"""Big-RoMa and Tiny RoMa training on one device (counterpart of
roma_tpu/train)."""
from .checkpoint import CheckPoint
from .gt_warp import get_gt_warp, warp_kpts
from .losses import RobustLosses
from .losses_tiny import TinyRobustLosses, bce_with_logits_masked, mutual_nearest_mask
from .optim import ema_params, in_encoder, make_optimizer, multistep_lr
from .train import (
    TrainState,
    ema_decay_schedule,
    grad_statistics,
    init_train_state,
    make_ema_update,
    make_train_step,
    nonfinite_grad_names,
    train_epoch,
    train_k_epochs,
    train_k_steps,
)

__all__ = [
    "CheckPoint",
    "get_gt_warp",
    "warp_kpts",
    "RobustLosses",
    "TinyRobustLosses",
    "bce_with_logits_masked",
    "mutual_nearest_mask",
    "in_encoder",
    "ema_params",
    "make_optimizer",
    "multistep_lr",
    "TrainState",
    "ema_decay_schedule",
    "grad_statistics",
    "make_ema_update",
    "nonfinite_grad_names",
    "init_train_state",
    "make_train_step",
    "train_epoch",
    "train_k_epochs",
    "train_k_steps",
]

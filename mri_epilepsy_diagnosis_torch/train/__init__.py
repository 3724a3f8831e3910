from .accum import packed_seg_train_step_accum
from .checkpoint import (load_checkpoint, load_checkpoint_extra,
                         load_jax_checkpoint, load_scheduler_state,
                         save_checkpoint)
from .optim import ReduceLROnPlateau, StepLR, torch_adam, torch_adamw
from .resilience import CheckpointManager, train_segmentation_resilient
from .seg import (Action, get_model_and_optimizer, mask_forward,
                  packed_seg_eval_step, packed_seg_train_step, run_epoch,
                  seg_eval_step, seg_train_step, sweep_checkpoints,
                  train_segmentation, validate_dsc_asd)
from .state import TrainState, create_train_state

__all__ = [
    "Action", "CheckpointManager", "ReduceLROnPlateau", "StepLR",
    "TrainState", "create_train_state", "get_model_and_optimizer",
    "load_checkpoint", "load_checkpoint_extra", "load_jax_checkpoint",
    "load_scheduler_state", "mask_forward", "packed_seg_eval_step",
    "packed_seg_train_step", "packed_seg_train_step_accum", "run_epoch",
    "save_checkpoint", "seg_eval_step", "seg_train_step",
    "sweep_checkpoints", "torch_adam", "torch_adamw", "train_segmentation",
    "train_segmentation_resilient", "validate_dsc_asd",
]

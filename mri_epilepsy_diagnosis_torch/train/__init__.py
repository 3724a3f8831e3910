from .checkpoint import load_checkpoint, load_checkpoint_extra, save_checkpoint
from .optim import ReduceLROnPlateau, StepLR, torch_adam, torch_adamw
from .seg import (Action, get_model_and_optimizer, packed_seg_eval_step,
                  packed_seg_train_step, run_epoch, seg_eval_step,
                  seg_train_step, train_segmentation)
from .state import TrainState, create_train_state

__all__ = [
    "Action", "ReduceLROnPlateau", "StepLR", "TrainState",
    "create_train_state", "get_model_and_optimizer", "load_checkpoint",
    "load_checkpoint_extra", "packed_seg_eval_step", "packed_seg_train_step",
    "run_epoch", "save_checkpoint", "seg_eval_step", "seg_train_step",
    "torch_adam", "torch_adamw", "train_segmentation",
]

from .accum import class_train_step_accum, packed_seg_train_step_accum
from .classification import (create_model_opt, cross_entropy,
                             cross_val_score, run_one_epoch,
                             stratified_batch_indices)
from .classification import train as train_classifier
from .fader import (FaderState, adv_loss, ae_step, disc_step, enc_clf_step,
                    fader_main_loss, train_fader)
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
    "Action", "CheckpointManager", "FaderState", "ReduceLROnPlateau",
    "StepLR", "TrainState", "adv_loss", "ae_step", "class_train_step_accum",
    "create_model_opt", "create_train_state", "cross_entropy",
    "cross_val_score", "disc_step", "enc_clf_step", "fader_main_loss",
    "get_model_and_optimizer", "run_one_epoch", "stratified_batch_indices",
    "train_classifier", "train_fader",
    "load_checkpoint", "load_checkpoint_extra", "load_jax_checkpoint",
    "load_scheduler_state", "mask_forward", "packed_seg_eval_step",
    "packed_seg_train_step", "packed_seg_train_step_accum", "run_epoch",
    "save_checkpoint", "seg_eval_step", "seg_train_step",
    "sweep_checkpoints", "torch_adam", "torch_adamw", "train_segmentation",
    "train_segmentation_resilient", "validate_dsc_asd",
]

"""Typed experiment configs (counterpart of the JAX package's
`core/config.py`; the port keeps its own copy).

The reference has no formal config system — experiments are kwargs dicts
assembled in notebooks and splatted into factories (`data_params`,
`training_params`, `ae_kwargs`, `cv_params`, ... — SURVEY.md §5).  These
dataclasses preserve those exact schemas as typed, serializable configs.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional, Sequence, Tuple


@dataclasses.dataclass
class DataConfig:
    """`data_params` (pretraining_3d_unet.ipynb cell 4) +
    MriSegmentation/MriClassification constructor schema."""
    sample: str = "all"
    prefix: Any = False
    mask_path: Any = False
    image_path: str = "/gpfs/gpfs0/sbi/data/fcd_classification_bank"
    targets_path: str = "../targets/targets_fcd_bank.csv"
    ignore_missing: bool = True
    coord_min: Tuple[int, int, int] = (30, 30, 30)
    img_shape: Tuple[int, int, int] = (192, 192, 192)
    mask: str = "seg"          # MriSegmentation: seg | bb | combined
    data_type: str = "img"     # MriClassification: img | seg


@dataclasses.dataclass
class SegTrainingConfig:
    """`training_params` (pretraining_3d_unet.ipynb cell 12) + factory args."""
    num_epochs: int = 12
    num_encoding_blocks: int = 3
    out_channels_first_layer: int = 16
    patience: int = 3
    save_epoch: int = 1
    weights_stem: str = "whole_im_train"
    training_batch_size: int = 1
    validation_batch_size: int = 1
    patches: bool = False
    patch_size: int = 64
    samples_per_volume: int = 6
    max_queue_length: int = 180
    seed: int = 0


@dataclasses.dataclass
class CVConfig:
    """`cv_params` (baseline_sample_classification.ipynb cell 28)."""
    folds: int = 5
    batch_size: int = 10
    max_epoch: int = 30
    lr: float = 1e-5
    weight_decay: float = 0.01
    transfer: bool = False
    finetune: bool = False
    model_load_path: Optional[str] = None


@dataclasses.dataclass
class FaderConfig:
    """ae/discriminator/classificator kwargs + loop settings
    (train_ENC_CLF.ipynb cells 17-18)."""
    ae_kwargs: Dict[str, Any] = dataclasses.field(default_factory=lambda: dict(
        c_in=1, is_skip=False, deapth=3, c_base=8, inc_size=2,
        reduce_size=False,
        down_block_kwargs=dict(conv_k=6, conv_pad=2, conv_s=2, maxpool_k=2,
                               maxpool_s=2, batch_norm=True, act="l_relu"),
        up_block_kwargs=dict(up="upsample", scale=4, scale_mode="nearest",
                             conv_k=3, conv_pad=1, conv_s=1,
                             batch_norm=False, act="l_relu")))
    discriminator_kwargs: Dict[str, Any] = dataclasses.field(
        default_factory=lambda: dict(c_in=32, c_out=64, conv_k=3, conv_s=1,
                                     conv_pad=0, l_in=64, l_out=32,
                                     batch_norm=True, act="relu",
                                     n_domains=18, p_drop=0.5))
    classificator_kwargs: Dict[str, Any] = dataclasses.field(
        default_factory=lambda: dict(c_in=32, c_out=64, conv_k=3, conv_s=1,
                                     conv_pad=0, l_in=64, l_out=32,
                                     batch_norm=True, act="relu",
                                     n_class=2, p_drop=0.5))
    epochs: int = 17
    disc_loop: int = 3
    lambda_initial: float = 1e-4
    lambda_final: float = 1e-1
    max_step: int = 300
    learning_rate_enc: float = 7e-4
    learning_rate_disc: float = 5e-4
    weight_decay: float = 1e-4
    class_weight: Sequence[float] = (1.0, 2.0)


def to_json(cfg) -> str:
    return json.dumps(dataclasses.asdict(cfg), indent=2)


def from_json(cls, payload: str):
    return cls(**json.loads(payload))

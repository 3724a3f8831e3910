from .intensity import (znormalization, rescale_intensity, minmax_norm,
                        histogram_standardization, train_histogram_landmarks,
                        DEFAULT_CUTOFF, STANDARD_RANGE)
from .spatial import affine_resample, crop_or_pad, flip, warp_dense
from .labels import LIST_FCD, binarize_segmentation
from .augment import (random_flip, random_noise, random_bias_field,
                      random_affine, random_elastic_deformation, random_motion,
                      Compose, OneOf)
from .preprocessing import (preprocess_volume, register_img,
                            register_img_and_mask)
from .registration import (apply_transform, bias_field_correction,
                           coarse_search, params_to_affine, register_affine)

__all__ = [
    "znormalization", "rescale_intensity", "minmax_norm",
    "histogram_standardization", "train_histogram_landmarks",
    "DEFAULT_CUTOFF", "STANDARD_RANGE",
    "affine_resample", "crop_or_pad", "flip", "warp_dense",
    "LIST_FCD", "binarize_segmentation",
    "random_flip", "random_noise", "random_bias_field", "random_affine",
    "random_elastic_deformation", "random_motion", "Compose", "OneOf",
    "preprocess_volume", "register_img", "register_img_and_mask",
    "apply_transform", "bias_field_correction", "coarse_search",
    "params_to_affine", "register_affine",
]

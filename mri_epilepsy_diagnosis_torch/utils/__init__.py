from .data import (LIST_FCD, MriClassification, MriSegmentation,
                   SyntheticVolumes, load_nii_to_array, reshape_image,
                   targets_complete)
from .nifti import NiftiImage, load_nifti, save_nifti

__all__ = ["LIST_FCD", "MriClassification", "MriSegmentation", "NiftiImage",
           "SyntheticVolumes", "load_nifti", "load_nii_to_array",
           "reshape_image", "save_nifti", "targets_complete"]

from .nifti import NiftiImage, load_nifti, save_nifti

__all__ = ["NiftiImage", "load_nifti", "save_nifti"]

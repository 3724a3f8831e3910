from .intensity import znormalization
from .labels import LIST_FCD, binarize_segmentation

__all__ = ["LIST_FCD", "binarize_segmentation", "znormalization"]

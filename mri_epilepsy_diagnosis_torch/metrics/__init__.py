from .classification import accuracy_score, roc_auc_score
from .dice import (compute_dice_coefficient, get_dice_loss, get_dice_score,
                   get_iou_score)
from .surface import (compute_average_surface_distance,
                      compute_robust_hausdorff,
                      compute_surface_dice_at_tolerance,
                      compute_surface_distances,
                      compute_surface_overlap_at_tolerance,
                      neighbour_code_to_surface_area)

__all__ = [
    "accuracy_score", "roc_auc_score",
    "compute_average_surface_distance", "compute_dice_coefficient",
    "compute_robust_hausdorff", "compute_surface_dice_at_tolerance",
    "compute_surface_distances", "compute_surface_overlap_at_tolerance",
    "get_dice_loss", "get_dice_score", "get_iou_score",
    "neighbour_code_to_surface_area",
]

from .dice import (compute_dice_coefficient, get_dice_loss, get_dice_score,
                   get_iou_score)

__all__ = ["compute_dice_coefficient", "get_dice_loss", "get_dice_score",
           "get_iou_score"]

from .detection import FCDMaskGenerator
from .serving import segment_volumes
from .sliding_window import (GridAggregator, GridSampler, extract_patches,
                             grid_locations, sliding_window_predict)

__all__ = ["FCDMaskGenerator", "GridAggregator", "GridSampler",
           "extract_patches", "grid_locations", "segment_volumes",
           "sliding_window_predict"]

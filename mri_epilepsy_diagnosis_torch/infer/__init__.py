from .detection import FCDMaskGenerator
from .serving import segment_volumes
from .sliding_window import (GridAggregator, GridSampler, extract_patches,
                             grid_locations, make_sharded_apply,
                             sliding_window_predict)

__all__ = ["FCDMaskGenerator", "GridAggregator", "GridSampler",
           "extract_patches", "grid_locations", "make_sharded_apply",
           "segment_volumes",
           "sliding_window_predict"]

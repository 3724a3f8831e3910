"""mfu: model FLOPs of a training step (the plain reference's
forward and backward at the cell's shapes, counted by FlopCounterMode on
the meta device) times the steps of the stack-less profiled stretch, over
the stretch's wall time and the chip's peak for the configuration's dtype
(989 TFLOP/s in bf16), in %.  The stretch's own clock, not the traced
window's: the window of a `--trace 1` run holds the profilers' stalls."""
from portbench.metrics._common import mfu


def read(view):
    return mfu(view, "train")

"""b1_roofline_pct: the bound of UNet3D's fine 3x3x3 convs in a
training step (forward, and the input gradient of every conv but the
first: 2*27*Ci*Co operations a voxel, each input, weight and output read
or written once; `lib/work.py::unet_conv_sites`) over the device time per
step of kernel B1's launches, forward and dx alike, in %."""
from portbench.metrics._common import roofline_pct

NAMES = ("conv2_packed_tc_kernel", "conv2_packed_kernel")


def read(view):
    return roofline_pct(view, "b1_sites", NAMES)

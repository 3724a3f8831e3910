"""bn_tail_roofline_pct: the byte bound of the train-mode BatchNorm
tail's four passes at every BatchNorm of a training step (8 reads or
writes of each site's fine tensor at 3.35 TB/s; the driver's `bn_sites`,
`lib/work_voxresnet.py::bn_sites`) over the device time per step of the
tail's kernels (`mri::bn_train_*`: statistics, apply, backward reduction,
dx, and the second launch of the two reductions), in %."""
from portbench.metrics._common import roofline_pct

NAMES = ("bn_train_stats_kernel", "bn_train_apply_kernel",
         "bn_train_reduce_kernel", "bn_train_dx_kernel",
         "bn_train_fold_kernel")


def read(view):
    return roofline_pct(view, "bn_sites", NAMES)

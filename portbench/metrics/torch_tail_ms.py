"""torch_tail_ms: device ms per training step in kernels that are
neither the port's own (`mri::` names) nor cuBLAS's or cuDNN's: the
generic elementwise, reduction and copy kernels of plain PyTorch (the
BatchNorm and activation tail, the layout changes)."""
from portbench.lib import trace as T

# substrings of cuBLAS and cuDNN kernel names on Hopper
LIBRARY = ("cublas", "cudnn", "gemm", "xmma", "cutlass", "nvjet",
           "implicit_convolve", "wgrad", "dgrad", "fprop", "winograd",
           "sm90_", "sm80_", "ampere_", "hopper_")


def read(view):
    if view.work["kind"] != "train" or not view.devs:
        return None
    us = 0.0
    for e in view.devs:
        if e.get("cat") != "kernel":
            continue
        kind = T.op_kind(e.get("name", ""))
        if kind.startswith("mri::") or any(s in kind.lower()
                                           for s in LIBRARY):
            continue
        us += float(e.get("dur", 0.0))
    return us / 1e3 / view.steps

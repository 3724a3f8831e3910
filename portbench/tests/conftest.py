"""Shared settings of the benchmark's own tests (CPU, tiny sizes)."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# per cell: (traffic overrides, config overrides) of a CPU dry run
TINY = {
    "unet3d_train_192_b2": ({"size": 16, "pool": 4}, {}),
    "unet3d_train_patch64_b16": ({"size": 32, "patch": 16, "batch": 4,
                                  "pool": 2, "patch_batches": 6}, {}),
}


def dry_run(cell, seed=2 ** 31 + 7, seconds=2.5, trace=False,
            dtype="float32", calibrate=False, root=None):
    """One run of `cell` on the CPU at its tiny size."""
    from portbench.lib import harness

    mix, cfg = TINY[cell]
    return harness.run_cell(cell, seed, seconds, trace, device="cpu",
                            mix_overrides=mix,
                            cfg_overrides={**cfg, "dtype": dtype},
                            calibrate=calibrate, root=root or harness.ROOT)


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)

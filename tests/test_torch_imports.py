"""The PyTorch port stands alone: no module of `mri_epilepsy_diagnosis_torch`
and not `chip_smoke.py` imports JAX, flax, optax, msgpack (the port reads
flax checkpoints with its own decoder), pandas, sklearn or nibabel (the
card's machine has none of them: the port reads CSVs with `csv` and NIfTI
with its own codec) or the JAX package.

Checked statically with `ast`: a `sys.modules` check cannot work in a
process whose start-up may already have imported jax."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "msgpack", "pandas",
             "sklearn", "nibabel", "mri_epilepsy_diagnosis_tpu")
SOURCES = sorted((ROOT / "mri_epilepsy_diagnosis_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_sources_found():
    names = {p.name for p in SOURCES}
    assert {"chip_smoke.py", "cuda_kernels.py", "serving.py",
            "unet_packed.py", "jax_bridge.py", "fader.py", "labels.py",
            "dice.py", "state.py", "optim.py", "checkpoint.py",
            "seg.py", "accum.py", "resilience.py", "flax_msgpack.py",
            "surface.py", "nifti.py", "spatial.py", "intensity.py",
            "preprocessing.py", "augment.py", "data.py", "pipeline.py",
            "collate.py", "sliding_window.py", "cnn.py",
            "classification.py", "registration.py", "patches.py",
            "detection.py", "patch_model.py", "unet_packed_q.py",
            "bayes.py", "brats_unet.py", "modified_unet.py",
            "residual_unet.py", "voxresnet_packed.py",
            "fader_packed.py"} <= names
    port = ROOT / "mri_epilepsy_diagnosis_torch"
    for path in ("native/__init__.py", "train/fader.py",
                 "train/classification.py", "metrics/classification.py",
                 "models/cnn.py", "transforms/registration.py",
                 "data/patches.py", "infer/detection.py",
                 "models/patch_model.py", "models/unet_packed_q.py",
                 "models/bayes.py", "models/brats_unet.py",
                 "models/modified_unet.py", "models/residual_unet.py",
                 "models/voxresnet_packed.py", "models/fader_packed.py"):
        assert port / path in SOURCES


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_jax_imports(path):
    bad = [m for m in imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_check_catches_a_jax_import(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import numpy\nfrom jax import numpy as jnp\n"
                     "def f():\n    import mri_epilepsy_diagnosis_tpu.ops\n"
                     "    import pandas as pd\n"
                     "    from sklearn.preprocessing import LabelEncoder\n")
    assert [m for m in imported_modules(probe)
            if m.split(".")[0] in FORBIDDEN] == [
        "jax", "mri_epilepsy_diagnosis_tpu.ops", "pandas",
        "sklearn.preprocessing"]

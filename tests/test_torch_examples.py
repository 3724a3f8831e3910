"""The port's example drivers (`examples/torch_*.py`), each run in a clean
CPU subprocess with `--device cpu` on synthetic data at 12-16^3, as
`tests/test_examples.py` runs the JAX package's; the whole-brain inference
and the checkpoint sweep run on a `.pth` that the test writes with
`torch.save`.  `torch_infer_whole_brain.py`'s mask is held to the JAX
package's `examples/infer_whole_brain.py` logic on the same `.pth` and
NIfTI (float32: agreement >= 0.999, ties only), and the port's
`StratifiedKFold` (which `torch_classification_cv.py` uses) to sklearn's,
fold for fold."""
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
from sklearn.model_selection import StratifiedKFold as SkStratifiedKFold

import jax
import jax.numpy as jnp

from mri_epilepsy_diagnosis_torch.models import UNet3D as TUNet3D
from mri_epilepsy_diagnosis_torch.train.classification import (
    StratifiedKFold)
from mri_epilepsy_diagnosis_torch.utils.nifti import load_nifti, save_nifti
from mri_epilepsy_diagnosis_tpu.interop import import_torch_state_dict
from mri_epilepsy_diagnosis_tpu.models import UNet3D as JUNet3D
from mri_epilepsy_diagnosis_tpu.models.unet_packed import (
    fold_bn_inference, packed_unet_mask_v2)
from mri_epilepsy_diagnosis_tpu.transforms import znormalization
from mri_epilepsy_diagnosis_tpu.utils.data import reshape_image

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples")
MASK_AGREEMENT = 0.999
OCFL = 4
SIZE = 16
COORD_MIN = (4, 4, 4)


def _run(tmp_path, script, *args, timeout=300):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    env["OMP_NUM_THREADS"] = "2"
    proc = subprocess.run(
        [sys.executable, os.path.join(EXAMPLES, script), *map(str, args),
         "--device", "cpu"],
        cwd=tmp_path, env=env, capture_output=True, text=True,
        timeout=timeout)
    assert proc.returncode == 0, (
        f"{script} failed\nstdout:\n{proc.stdout[-2000:]}\n"
        f"stderr:\n{proc.stderr[-2000:]}")
    return proc.stdout


@pytest.mark.parametrize("mode", ["whole", "packed_resilient", "packed_bf16",
                                  "patches"])
def test_train_segmentation(tmp_path, mode):
    flags = {"whole": ["--batch-size", 4],
             "packed_resilient": ["--packed", "--resilient", "--batch-size",
                                  4],
             "packed_bf16": ["--packed", "--bf16", "--batch-size", 4],
             "patches": ["--patches"]}[mode]
    out = _run(tmp_path, "torch_train_segmentation.py", "--synthetic",
               "--epochs", 1, "--img-size", SIZE, "--ocfl", OCFL,
               "--weights-stem", "smoke", *flags)
    assert "Epoch 1" in out and "mean DSC" in out
    assert (tmp_path / "weights" / "smoke_epoch_1.ckpt").exists()
    (log,) = (tmp_path / "logs").iterdir()
    losses = [line for line in log.read_text().splitlines()
              if '"train_dice_loss"' in line]
    assert losses and log.name.startswith("segmentation-")


def test_train_ae(tmp_path):
    out = _run(tmp_path, "torch_train_ae.py", "--synthetic", "--epochs", 1)
    assert "rec+adv loss" in out and "nan" not in out


def test_train_fader(tmp_path):
    out = _run(tmp_path, "torch_train_fader.py", "--synthetic", "--epochs",
               1, "--img-size", 12, "--batch-size", 4, "--disc-loop", 1)
    assert "final val accuracy" in out


def test_classification_cv(tmp_path):
    out = _run(tmp_path, "torch_classification_cv.py", "--synthetic",
               "--model", "voxresnet", "--batch-size", 4)
    assert "CV ROC-AUC" in out


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A `.pth` of a port UNet3D (seeded, its foreground bias shifted so
    that about 30% of the volume is foreground) and a T1-like NIfTI."""
    d = tmp_path_factory.mktemp("pth")
    rng = np.random.default_rng(1)
    t1 = rng.random((24, 24, 24)).astype(np.float32) * 100
    t1[6:16, 8:18, 5:15] += 60.0
    save_nifti(str(d / "t1.nii.gz"), t1, np.eye(4))
    torch.manual_seed(3)
    model = TUNet3D(out_channels_first_layer=OCFL, device="cpu").eval()
    x = torch.from_numpy(t1[4:20, 4:20, 4:20].copy())
    x = ((x - x.mean()) / x.std())[None, ..., None]
    with torch.no_grad():
        logits = model(x)[0]
        margin = (logits[..., 1] - logits[..., 0]).flatten()
        model.classifier.conv_layer.bias[1] -= torch.quantile(margin, 0.7)
    torch.save(model.state_dict(), str(d / "unet.pth"))
    return d


def _jax_mask(pth, image):
    """`examples/infer_whole_brain.py`'s packed path, in float32."""
    model = JUNet3D(out_channels_first_layer=OCFL)
    variables = model.init(jax.random.key(0), jnp.zeros((1, 8, 8, 8, 1)))
    variables = fold_bn_inference(import_torch_state_dict(variables, pth))
    vol = reshape_image(np.asarray(load_nifti(image).data), COORD_MIN,
                        (SIZE,) * 3)
    x = znormalization(jnp.asarray(vol[0], jnp.float32))[..., None]
    with jax.default_matmul_precision("highest"):
        return np.asarray(jax.jit(packed_unet_mask_v2)(variables, x[None])[0])


def test_infer_whole_brain_matches_jax(tmp_path, checkpoint):
    out = _run(tmp_path, "torch_infer_whole_brain.py",
               "--pth", checkpoint / "unet.pth",
               "--image", checkpoint / "t1.nii.gz",
               "--seg", checkpoint / "t1.nii.gz", "--ocfl", OCFL,
               "--img-size", SIZE, "--coord-min", *COORD_MIN,
               "--out", tmp_path / "pred.nii.gz")
    assert "foreground voxels" in out and "DSC" in out
    got = np.asarray(load_nifti(str(tmp_path / "pred.nii.gz")).data)
    ref = _jax_mask(str(checkpoint / "unet.pth"),
                    str(checkpoint / "t1.nii.gz"))
    assert got.shape == ref.shape == (SIZE,) * 3
    assert 0.05 < ref.mean() < 0.95                 # not a one-class mask
    assert np.mean(got == ref) >= MASK_AGREEMENT


@pytest.mark.parametrize("mode", ["--fine", "--sliding-window"])
def test_infer_whole_brain_modes(tmp_path, checkpoint, mode):
    _run(tmp_path, "torch_infer_whole_brain.py",
         "--pth", checkpoint / "unet.pth", "--image", checkpoint / "t1.nii.gz",
         "--ocfl", OCFL, "--img-size", SIZE, "--coord-min", *COORD_MIN,
         "--out", tmp_path / "pred.nii.gz", mode)
    got = np.asarray(load_nifti(str(tmp_path / "pred.nii.gz")).data)
    assert got.shape == (SIZE,) * 3 and 0 < got.mean() < 1


def test_validate_checkpoints(tmp_path, checkpoint):
    torch.save({"w": torch.zeros(2)}, str(tmp_path / "wrong_net.pth"))
    shutil.copy(checkpoint / "unet.pth", tmp_path / "unet_epoch_7.pth")
    out = _run(tmp_path, "torch_validate_checkpoints.py", "--pth-dir",
               tmp_path, "--pattern", "*_*.pth", "--synthetic", "--img-size",
               SIZE, "--ocfl", OCFL, "--n-synthetic", 2)
    assert "unet_epoch_7.pth" in out and "best: unet_epoch_7.pth" in out
    assert "wrong_net.pth" in out and "skipped" in out
    # the sweep reports all three reference metrics per checkpoint
    assert "DSC" in out and "ASD" in out and "IoU" in out


@pytest.mark.parametrize("seed", range(8))
def test_stratified_kfold_matches_sklearn(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(8, 40))
    k = int(rng.integers(2, 5))
    y = rng.choice([3, 1, 7], n)
    y[:k] = 3                             # every fold can hold a 3
    ref = list(SkStratifiedKFold(k).split(np.zeros(n), y))
    got = list(StratifiedKFold(k).split(np.zeros(n), y))
    assert len(got) == len(ref) == k
    for (tr, te), (rtr, rte) in zip(got, ref):
        np.testing.assert_array_equal(tr, rtr)
        np.testing.assert_array_equal(te, rte)
    assert StratifiedKFold(k).get_n_splits() == k
    with pytest.raises(ValueError):
        list(StratifiedKFold(n + 1).split(np.zeros(n), y))

"""Port parity: per-subject DSC / average surface distance / IoU
validation (`train/seg.py::validate_dsc_asd`) and the checkpoint sweep
(`sweep_checkpoints`) against the JAX package's, on the CPU.

JAX-initialised UNet3D weights (out_channels_first_layer 4, random
BatchNorm statistics), two batches of two 16^3 subjects with blob labels.
The classifier's bias is shifted so that about 30% of the voxels are
foreground, at the middle of the widest gap between neighbouring logit
margins there, so that no voxel sits within f32 rounding of the decision
boundary: both packages then predict the same masks, and the metrics,
float64 numpy over the same masks, agree to 1e-12."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mri_epilepsy_diagnosis_torch.train import checkpoint as TC
from mri_epilepsy_diagnosis_torch.train import optim as TO
from mri_epilepsy_diagnosis_torch.train import seg as TS
from mri_epilepsy_diagnosis_torch.train.state import TrainState
from mri_epilepsy_diagnosis_tpu.train import checkpoint as JC
from mri_epilepsy_diagnosis_tpu.train import optim as JO
from mri_epilepsy_diagnosis_tpu.train import seg as JS
from mri_epilepsy_diagnosis_tpu.train.state import create_train_state
from test_torch_bridge import jax_unet_variables, torch_unet

torch.set_num_threads(2)

SIZE = 16
OCFL = 4
TOL = 1e-12


def _loader(seed):
    rng = np.random.default_rng(seed)
    grid = np.stack(np.meshgrid(*[np.arange(SIZE)] * 3, indexing="ij"), -1)
    out = []
    for _ in range(2):
        x = rng.normal(size=(2, SIZE, SIZE, SIZE, 1)).astype(np.float32)
        labels = np.full(x.shape, 41, np.int16)
        for i in range(2):
            c = rng.uniform(4, SIZE - 4, 3)
            inside = ((grid - c) ** 2).sum(-1) <= rng.uniform(3, 5) ** 2
            labels[i, inside] = 1002
            x[i, inside] += 1.0
        out.append((x, labels))
    return out


def _with_foreground(jmodel, variables, loader, share):
    """`variables` with the classifier's class-1 bias shifted so that about
    `share` of the voxels are foreground, the boundary in the middle of
    the widest gap between neighbouring margins near that quantile."""
    fwd = jax.jit(jmodel.apply)
    margins = np.sort(np.concatenate([
        np.ravel(np.diff(np.asarray(fwd(variables, jnp.asarray(x))), axis=-1))
        for x, _ in loader]))
    k = int(len(margins) * (1 - share))
    lo, hi = k - len(margins) // 10, k + len(margins) // 10
    j = lo + int(np.argmax(np.diff(margins[lo:hi])))
    shift = (margins[j] + margins[j + 1]) / 2
    out = jax.tree_util.tree_map(np.copy, variables)
    out["params"]["classifier"]["conv_layer"]["bias"][1] -= shift
    return out


@pytest.fixture(scope="module")
def case():
    jmodel, variables = jax_unet_variables(ocfl=OCFL, nb=3, seed=41)
    loader = _loader(42)
    variables = _with_foreground(jmodel, variables, loader, 0.3)
    return jmodel, variables, loader


def _jax_state(jmodel, variables):
    """A JAX train state whose `apply_fn` is jitted: JAX's unpacked
    validation calls it eagerly, which compiles every op anew in each
    process."""
    state = create_train_state(jmodel, JO.torch_adamw(1e-3),
                               jnp.zeros((1, 8, 8, 8, 1)),
                               variables=jax.tree_util.tree_map(jnp.asarray,
                                                                variables))
    return state.replace(apply_fn=jax.jit(jmodel.apply,
                                          static_argnames="train"))


def _port_state(variables):
    model = torch_unet(variables, ocfl=OCFL)
    return TrainState(model, TO.torch_adamw(1e-3)(model.parameters()))


@pytest.fixture(scope="module")
def jax_metrics(case):
    jmodel, variables, loader = case
    state = _jax_state(jmodel, variables)
    return {packed: JS.validate_dsc_asd(state, loader, packed=packed)
            for packed in (False, True)}


def _assert_metrics_equal(got, ref):
    assert len(got) == len(ref) == 4
    for g, r in zip(got, ref):
        assert len(g) == len(r) == 4           # one entry per subject
        np.testing.assert_allclose(np.asarray(g, np.float64),
                                   np.asarray(r, np.float64), rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("packed", [False, True])
def test_validate_dsc_asd_matches_jax(case, jax_metrics, packed):
    """Per-subject DSC, both directed average surface distances and IoU,
    through the fine UNet3D (packed=False) or the served packed forward
    with BatchNorm folded (packed=True, B1 with B2 fused on the card)."""
    _, variables, loader = case
    got = TS.validate_dsc_asd(_port_state(variables), loader, packed=packed)
    _assert_metrics_equal(got, jax_metrics[packed])
    dsc, asd_gt, asd_pred, iou = map(np.asarray, got)
    assert ((dsc > 0.05) & (dsc < 0.95)).all()   # no degenerate masks
    assert np.isfinite(asd_gt).all() and np.isfinite(asd_pred).all()
    assert (iou < dsc).all()


def test_packed_and_fine_masks_agree(case):
    _, variables, loader = case
    state = _port_state(variables)
    x = torch.from_numpy(loader[0][0])
    fine = TS.mask_forward(state, packed=False)(x)
    packed = TS.mask_forward(state, packed=True)(x)
    assert fine.dtype == packed.dtype == torch.uint8
    assert fine.shape == (2, SIZE, SIZE, SIZE)
    assert torch.equal(fine, packed)
    assert 0.1 < fine.float().mean().item() < 0.5


def test_sweep_checkpoints_reads_both_formats(case, jax_metrics, tmp_path,
                                              capsys):
    """Two port checkpoints (after one and two train steps) and one that
    the JAX package wrote (the initial weights), in one directory: each
    gets the (mean DSC, mean IoU) of validating its own weights, the JAX
    one as the JAX package's `validate_dsc_asd` scores it; the caller's
    state stays as it was."""
    jmodel, variables, loader = case
    JC.save_checkpoint(str(tmp_path / "jax_epoch_3.ckpt"),
                       _jax_state(jmodel, variables))
    ref_j = jax_metrics[False]
    state = _port_state(variables)
    refs = []
    for epoch in (1, 2):
        state, _ = TS.seg_train_step(state, torch.from_numpy(loader[0][0]),
                                     torch.from_numpy(loader[0][1]))
        TC.save_checkpoint(str(tmp_path / f"a_epoch_{epoch}.ckpt"), state)
        refs.append(TS.validate_dsc_asd(state, loader))
    ref_a, ref_b = refs
    (tmp_path / "broken_epoch_4.ckpt").write_bytes(b"PK not a checkpoint")

    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    results = TS.sweep_checkpoints(str(tmp_path), state, loader)
    assert list(results) == [str(tmp_path / n) for n in (
        "a_epoch_1.ckpt", "a_epoch_2.ckpt", "jax_epoch_3.ckpt")]
    assert "broken_epoch_4.ckpt: skipped" in capsys.readouterr().out
    for path, ref in zip(results, (ref_a, ref_b, ref_j)):
        np.testing.assert_allclose(
            results[path], (np.nanmean(ref[0]), np.mean(ref[3])), rtol=TOL,
            atol=TOL)
    assert results[str(tmp_path / "a_epoch_1.ckpt")] != results[
        str(tmp_path / "jax_epoch_3.ckpt")]
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, before[k]), k

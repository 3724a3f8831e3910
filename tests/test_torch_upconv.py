"""Port parity: the composed decoder up branch (`ops/packed.py`:
`pack_upconv_weights`, `edge_pad_cells`, `upconv_packed`,
`upconv_fix_faces`, `upconv_core_hybrid`) and packed training with
`dec_up="composed"` and `"hybrid"`, against the JAX package on the CPU.

The same numpy inputs and weights go through both packages.  f32, JAX at
"highest" precision (this JAX build contracts float32 at bf16-level
precision by default, and `pack_upconv_weights`' einsum names none).
Tolerances: the composed ops 1e-5 x max|ref| (float32 summation order);
the train forms at the explicit form's tolerances
(`tests/test_torch_train.py`).  JAX's gradients of the composed forms
compile slowly on the CPU: 16^3, out_channels_first_layer 4, batch 2, in
module fixtures."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mri_epilepsy_diagnosis_torch.ops import packed as TP
from mri_epilepsy_diagnosis_torch.models import unet_packed as TU
from mri_epilepsy_diagnosis_torch.train import optim as TO
from mri_epilepsy_diagnosis_torch.train import seg as TS
from mri_epilepsy_diagnosis_torch.train.state import TrainState
from mri_epilepsy_diagnosis_tpu.models import unet_packed as JU
from mri_epilepsy_diagnosis_tpu.ops import packed as JP
from mri_epilepsy_diagnosis_tpu.train import optim as JO
from mri_epilepsy_diagnosis_tpu.train import seg as JS
from mri_epilepsy_diagnosis_tpu.train.state import create_train_state
from test_torch_bridge import jax_unet_variables
from test_torch_train import (OCFL, SIZE, _assert_grads_close, _pre_bn_bias,
                              _sd, _stats_sd, _torch_model)

torch.set_num_threads(2)

TOL = 1e-5                       # x max|ref|


def _close(got, ref, tol=TOL):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= tol * np.abs(ref).max(), err


def _fine_kernel(rng, ci, co):
    """A fine kernel in JAX's (3, 3, 3, Ci, Co) layout and the port's
    (Co, Ci, 3, 3, 3)."""
    wj = rng.normal(size=(3, 3, 3, ci, co)).astype(np.float32)
    return wj, torch.from_numpy(np.ascontiguousarray(wj.transpose(4, 3, 0,
                                                                  1, 2)))


@pytest.fixture(scope="module")
def branch():
    """An up branch at 3 x 4 x 3 coarse cells (non-cubic), Ci 4, Co 3,
    with JAX's composed kernel, output and face-fixed output."""
    rng = np.random.default_rng(0)
    wj, wt = _fine_kernel(rng, 4, 3)
    x = rng.normal(size=(2, 3, 4, 3, 32)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        wk = np.asarray(JP.pack_upconv_weights(jnp.asarray(wj)))
        y = np.asarray(JP.upconv_packed(jnp.asarray(x), jnp.asarray(wk)))
        fixed = np.asarray(JP.upconv_fix_faces(jnp.asarray(y), jnp.asarray(x),
                                               jnp.asarray(wj)))
    return wj, wt, x, wk, y, fixed


@pytest.mark.parametrize("ci,co", [(1, 2), (4, 3), (8, 16)])
def test_pack_upconv_weights_matches_jax(ci, co):
    wj, wt = _fine_kernel(np.random.default_rng(ci), ci, co)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(JP.pack_upconv_weights(jnp.asarray(wj)))
    got = TP.pack_upconv_weights(wt)
    assert tuple(got.shape) == (5, 5, 5, 8 * ci, 8 * co)
    _close(got.numpy(), ref)


@pytest.mark.parametrize("dtype", [np.float32, np.int8])
@pytest.mark.parametrize("shape", [(2, 3, 4, 2, 16), (1, 2, 2, 2, 8)])
def test_edge_pad_cells_matches_jax(dtype, shape):
    """Any dtype, exactly: int8 goes through the pad and the plane writes
    unchanged (the int8 path edge-pads in int8)."""
    rng = np.random.default_rng(1)
    x = (rng.integers(-127, 128, size=shape) if dtype == np.int8
         else rng.normal(size=shape)).astype(dtype)
    got = TP.edge_pad_cells(torch.from_numpy(x))
    ref = np.asarray(JP.edge_pad_cells(jnp.asarray(x)))
    assert got.dtype == torch.from_numpy(x).dtype
    np.testing.assert_array_equal(got.numpy(), ref)


def test_upconv_packed_matches_jax(branch):
    """The lhs-dilated conv as one transposed convolution == JAX's
    `lax.conv_general_dilated` form."""
    _, _, x, wk, y, _ = branch
    got = TP.upconv_packed(torch.from_numpy(x), torch.from_numpy(wk))
    _close(got.numpy(), y)


def test_upconv_fix_faces_matches_jax(branch):
    _, wt, x, _, y, fixed = branch
    got = TP.upconv_fix_faces(torch.from_numpy(y.copy()), torch.from_numpy(x),
                              wt)
    _close(got.numpy(), fixed)


def test_upconv_fix_faces_dequantizes_int8_planes(branch):
    """The int8 form: the boundary planes of int8 x are dequantized after
    slicing (`dequant_scale`), as JAX's int8 path runs it."""
    wj, wt, x, _, y, _ = branch
    x8 = np.random.default_rng(2).integers(-127, 128, size=x.shape).astype(
        np.int8)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(JP.upconv_fix_faces(
            jnp.asarray(y), jnp.asarray(x8), jnp.asarray(wj),
            dequant_scale=jnp.float32(1.0)))
    got = TP.upconv_fix_faces(torch.from_numpy(y.copy()),
                              torch.from_numpy(x8), wt, dequant_scale=1.0)
    _close(got.numpy(), ref)


def test_composed_branch_equals_explicit_beneath_the_pads(branch):
    """Composed + face fixes == `upsample2_packed` + the aligned->shifted
    conv on every voxel that the decoder keeps (the shifted pads are
    zeroed after the block's activation either way)."""
    _, wt, x, wk, _, _ = branch
    xt = torch.from_numpy(x)
    composed = TP.upconv_fix_faces(TP.upconv_packed(xt, torch.from_numpy(wk)),
                                   xt, wt)
    explicit = TP.conv3_packed_as(TP.upsample2_packed(xt),
                                  TP.pack_weights2_as(wt))
    _close(TP.zero_shifted_pads(composed).numpy(),
           TP.zero_shifted_pads(explicit).numpy())


@pytest.mark.parametrize("form", ["composed", "hybrid"])
def test_up_branch_gradients_match_jax(branch, form):
    """dx and dw of `upconv_fix_faces(core(x, w), x, w)`: autograd through
    the composed ops, or `UpconvCoreHybrid`'s hand-rolled rule, against
    `jax.grad` of the same JAX form."""
    wj, wt, x, _, y, _ = branch
    g = np.random.default_rng(3).normal(size=y.shape).astype(np.float32)

    def jcore(xx, ww):
        if form == "hybrid":
            return JP.upconv_core_hybrid(xx, ww)
        return JP.upconv_packed(xx, JP.pack_upconv_weights(ww))

    def jloss(xx, ww):
        return jnp.sum(JP.upconv_fix_faces(jcore(xx, ww), xx, ww) * g)

    with jax.default_matmul_precision("highest"):
        gx, gw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x),
                                                 jnp.asarray(wj))
    xt = torch.from_numpy(x).requires_grad_()
    wtt = wt.clone().requires_grad_()
    core = (TP.upconv_core_hybrid(xt, wtt) if form == "hybrid"
            else TP.upconv_packed(xt, TP.pack_upconv_weights(wtt)))
    (TP.upconv_fix_faces(core, xt, wtt) * torch.from_numpy(g)).sum().backward()
    _close(xt.grad.numpy(), gx)
    _close(wtt.grad.numpy(), np.asarray(gw).transpose(4, 3, 0, 1, 2))


# ---------------------------------------------------------------------------
# packed training with the composed up branch
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def case():
    jmodel, variables = jax_unet_variables(ocfl=OCFL, nb=3, seed=21)
    rng = np.random.default_rng(22)
    x = rng.normal(size=(2, SIZE, SIZE, SIZE, 1)).astype(np.float32)
    y = (rng.random((2, SIZE, SIZE, SIZE, 1)) > 0.6).astype(np.float32)
    return jmodel, variables, x, y


_JAX_FORMS = {}


def _jax_form(case, dec_up):
    """JAX's packed train forward with `dec_up`, its loss and `jax.grad`
    in every parameter (f32 HIGHEST), once per form."""
    if dec_up not in _JAX_FORMS:
        _, variables, x, y = case

        def loss_fn(params):
            yp, bs = JU.packed_unet_train_apply(
                {"params": params, "batch_stats": variables["batch_stats"]},
                jnp.asarray(x), dec_up=dec_up)
            return JU.packed_dice_loss(yp, jnp.asarray(y)), (yp, bs)

        with jax.default_matmul_precision("highest"):
            (loss, (yp, bs)), grads = jax.jit(jax.value_and_grad(
                loss_fn, has_aux=True))(variables["params"])
        _JAX_FORMS[dec_up] = (
            float(loss), np.asarray(yp), _stats_sd(bs),
            _sd({"params": jax.tree_util.tree_map(np.asarray, grads)}))
    return _JAX_FORMS[dec_up]


@pytest.mark.parametrize("dec_up", ["composed", "hybrid"])
def test_train_apply_forms_match_jax(case, dec_up):
    """Logits (2e-4), running statistics (rtol 1e-4, atol 1e-5), the dice
    loss (1e-5) and every parameter's gradient (the explicit form's
    per-leaf tolerance) against JAX's same `dec_up`."""
    _, variables, x, y = case
    loss_ref, yp_ref, stats_ref, grads_ref = _jax_form(case, dec_up)
    model = _torch_model(variables)
    yp, stats = TU.packed_unet_train_apply(
        model.state_dict(keep_vars=True), torch.from_numpy(x), dec_up=dec_up)
    np.testing.assert_allclose(yp.detach().numpy(), yp_ref, rtol=2e-4,
                               atol=2e-4)
    assert stats.keys() == stats_ref.keys()
    for k in stats_ref:
        np.testing.assert_allclose(stats[k].numpy(), stats_ref[k].numpy(),
                                   rtol=1e-4, atol=1e-5)
    loss = TU.packed_dice_loss(yp, torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(loss.item(), loss_ref, rtol=1e-5)
    _assert_grads_close({k: p.grad for k, p in model.named_parameters()},
                        grads_ref)


@pytest.mark.parametrize("dec_up", ["composed", "hybrid"])
def test_packed_seg_train_step_forms_match_jax(case, dec_up):
    """One AdamW step (lr 1e-3) with `dec_up` on both sides, at the
    explicit step test's tolerances (rtol 5e-3, atol 5e-4; pre-BN conv
    biases 2 lr)."""
    jmodel, variables, x, y = case
    labels = np.where(y > 0, 1002, 41).astype(np.float32)
    jstate = create_train_state(jmodel, JO.torch_adamw(1e-3),
                                jnp.zeros((1, 8, 8, 8, 1)),
                                variables=jax.tree_util.tree_map(
                                    jnp.asarray, variables))
    with jax.default_matmul_precision("highest"):
        jstate, jloss = JS.packed_seg_train_step(
            jstate, jnp.asarray(x), jnp.asarray(labels), dec_up=dec_up)
    model = _torch_model(variables)
    state = TrainState(model, TO.torch_adamw(1e-3)(model.parameters()))
    state, loss = TS.packed_seg_train_step(state, torch.from_numpy(x),
                                           torch.from_numpy(labels),
                                           dec_up=dec_up)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    ref = _sd({"params": jax.tree_util.tree_map(np.asarray, jstate.params),
               "batch_stats": jax.tree_util.tree_map(np.asarray,
                                                     jstate.batch_stats)})
    got = model.state_dict()
    for k, r in ref.items():
        if k.endswith("num_batches_tracked"):
            assert int(got[k]) == 1
        elif _pre_bn_bias(k, ref):
            np.testing.assert_allclose(got[k].numpy(), r.numpy(), rtol=0,
                                       atol=2e-3)
        else:
            np.testing.assert_allclose(got[k].numpy(), r.numpy(), rtol=5e-3,
                                       atol=5e-4)


def test_train_apply_refuses_unknown_forms(case):
    _, variables, x, _ = case
    with pytest.raises(ValueError, match="dec_up"):
        TU.packed_unet_train_apply(_torch_model(variables).state_dict(),
                                   torch.from_numpy(x), dec_up="dilated")

"""Port parity: the segmentation model zoo (`models/brats_unet.py`,
`modified_unet.py`, `residual_unet.py`) against the JAX package's, on
the CPU, on weights bridged from JAX (`interop.variables_to_state_dict`).

At JAX's own test sizes (BraTSUnet n=4 at 32^3, ResidualUNet3D (1, 2, 4,
8, 16) at 16^3 with and without `shorten`, Modified3DUNet base 2 at
16^3), float32, JAX at `Precision.HIGHEST`.  Noise and Dropout masks are
JAX's own draws replayed in the port (`test_torch_bayes.py::jax_draws`,
`port_replay`), but for the masks of BraTSUnet's dead Dropout
(`live_draws`).  Logits are held to 1e-4 x max|ref|, BatchNorm running
statistics to 1e-5."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mri_epilepsy_diagnosis_torch import models as TM
from mri_epilepsy_diagnosis_torch.interop import variables_to_state_dict
from mri_epilepsy_diagnosis_tpu import models as JM
from test_torch_bayes import jax_draws, port_replay

torch.set_num_threads(2)

LOGIT_TOL = 1e-4          # x max|ref|
STATS_TOL = 1e-5

RESIDUAL = dict(n_classes=2, n_channels=(1, 2, 4, 8, 16))
# name -> (class name, constructor kwargs, spatial size); the forwards
# also cover JAX's 3-class BraTSUnet (`tests/test_models.py:97`)
ZOO = {
    "residual_short": ("ResidualUNet3D", dict(RESIDUAL, shorten=True), 16),
    "residual": ("ResidualUNet3D", RESIDUAL, 16),
    "residual_bayes": ("ResidualUNet3D", dict(RESIDUAL, shorten=True,
                                              bayes=True), 16),
    "residual_bayes_long": ("ResidualUNet3D", dict(RESIDUAL, bayes=True),
                            16),
    "modified": ("Modified3DUNet", dict(in_channels=1, n_classes=2,
                                        base_n_filter=2), 16),
    "brats_gn": ("BraTSUnet", dict(c=1, n=4, norm="gn", num_classes=2), 32),
    "brats_bn": ("BraTSUnet", dict(c=1, n=4, norm="bn", num_classes=2), 32),
    "brats_in": ("BraTSUnet", dict(c=1, n=4, norm="in", num_classes=2), 32),
    "brats_gn3": ("BraTSUnet", dict(c=1, n=4, norm="gn", num_classes=3),
                  32),
}


def _randomize_norms(tree, rng, in_norm=False):
    """Non-trivial norm parameters and running statistics (gammas in
    [0.5, 1.5), betas and means N(0, 0.2), variances in [0.5, 1.5)), so
    that the bridge's placement of every norm leaf matters."""
    out = {}
    for k, leaf in tree.items():
        if hasattr(leaf, "items"):
            out[k] = _randomize_norms(dict(leaf), rng, in_norm or k.startswith(
                ("GroupNorm_", "BatchNorm_")))
            continue
        leaf = np.asarray(leaf, np.float32)
        if in_norm and k in ("weight", "running_var"):
            leaf = rng.uniform(0.5, 1.5, leaf.shape)
        elif in_norm and k in ("bias", "running_mean"):
            leaf = rng.normal(0.0, 0.2, leaf.shape)
        out[k] = np.asarray(leaf, np.float32)
    return out


def jax_zoo(name, seed=0):
    """(JAX model, numpy variables with randomized norms, spatial size)."""
    cls, kw, size = ZOO[name]
    model = getattr(JM, cls)(**kw)
    v = jax.jit(model.init)({"params": jax.random.key(seed),
                             "sample": jax.random.key(seed + 1),
                             "dropout": jax.random.key(seed + 2)},
                            jnp.zeros((1, size, size, size, 1)))
    v = jax.tree_util.tree_map(np.asarray, v)
    return model, _randomize_norms(dict(v), np.random.default_rng(seed)), size


def live_draws(name, rec):
    """JAX's draws `rec` of the zoo model `name` that the port replays.
    BraTSUnet's only Dropout is ConvD's, on the branch whose result is
    overwritten: eager JAX draws its mask in each of the five ConvDs in
    train mode, and the port, like XLA's compiled step, does not."""
    if not name.startswith("brats"):
        return rec
    assert len(rec["bernoulli"]) in (0, 5)
    return dict(rec, bernoulli=[])


def torch_zoo(name, variables, device="cpu"):
    """The port's model of `name` with the bridged `variables` loaded
    strictly."""
    cls, kw, _ = ZOO[name]
    model = getattr(TM, cls)(**kw, device=device)
    model.load_state_dict(variables_to_state_dict(variables, device=device),
                          strict=True)
    return model


def buffers_close(model, batch_stats):
    """The model's running statistics against JAX's `batch_stats`."""
    ref = {k: v for k, v in variables_to_state_dict(
        {"batch_stats": batch_stats}, device="cpu").items()
        if not k.endswith("num_batches_tracked")}
    got = dict(model.named_buffers())
    assert ref and ref.keys() <= got.keys()
    for k, r in ref.items():
        np.testing.assert_allclose(got[k].numpy(), r.numpy(), rtol=STATS_TOL,
                                   atol=STATS_TOL, err_msg=k)


def logits_close(got: torch.Tensor, ref):
    ref = np.asarray(ref)
    assert tuple(got.shape) == ref.shape
    err = np.abs(got.detach().numpy().astype(np.float64) - ref).max()
    assert err <= LOGIT_TOL * np.abs(ref).max(), err


@pytest.fixture(scope="module", params=list(ZOO))
def zoo_case(request):
    name = request.param
    model, v, size = jax_zoo(name)
    x = np.random.default_rng(1).normal(
        size=(2, size, size, size, 1)).astype(np.float32)
    return name, model, v, x


@pytest.mark.parametrize("train", [False, True])
def test_zoo_forward_matches_jax(zoo_case, train):
    """Eval mode (running statistics; the Bayesian layers sample with the
    pruning mask) and train mode (batch statistics and their running
    update, Dropout, unpruned sampling)."""
    name, jm, v, x = zoo_case
    with jax_draws() as rec:
        ref = jm.apply(v, jnp.asarray(x), train,
                       rngs={"dropout": jax.random.key(3),
                             "sample": jax.random.key(4)},
                       mutable=["batch_stats"] if train else False)
    if train:
        ref, new_vars = ref
    assert bool(rec["normal"]) == name.startswith("residual_bayes")
    assert bool(rec["bernoulli"]) == (train and not name.startswith(
        "residual"))
    pm = torch_zoo(name, v).train(train)
    with port_replay(live_draws(name, rec)), torch.no_grad():
        got = pm(torch.from_numpy(x))
    logits_close(got, ref)
    if train and "batch_stats" in v:
        buffers_close(pm, new_vars["batch_stats"])


def test_bridged_zoo_loads_strictly_with_the_reference_keys(zoo_case):
    """`variables_to_state_dict` gives exactly the port's keys (the
    reference's torch names), every tensor at the port's shape."""
    name, _, v, _ = zoo_case
    sd = variables_to_state_dict(v, device="cpu")
    cls, kw, _ = ZOO[name]
    want = getattr(TM, cls)(**kw, device="cpu").state_dict()
    assert sd.keys() == want.keys()
    for k, t in want.items():
        assert sd[k].shape == t.shape, k
    expected = {
        "residual_bayes": ["down1.conv_1.conv.2.mu_weight",
                           "down1.conv_1.conv.2.logsigma_weight",
                           "init_conv.mu_weight", "up1.upsample.0.conv.2.weight",
                           "down1.down.conv.2.weight", "out.weight"],
        "residual": ["down9.conv_2.conv.2.weight", "init_conv.weight"],
        "modified": ["norm_lrelu_conv_c2.2.weight",
                     "conv_norm_lrelu_l1.0.weight", "lrelu_conv_c1.1.weight",
                     "norm_lrelu_upscale_conv_norm_lrelu_l0.3.weight",
                     "ds2_1x1_conv3d.weight"],
        "brats_gn": ["convd1.bn1.weight", "convd1.bn1.bias",
                     "convd5.conv3.weight", "convu4.bn2.weight",
                     "seg1.bias"],
        "brats_bn": ["convd1.bn1.running_mean", "convd2.bn2.running_var",
                     "convu1.bn3.num_batches_tracked"],
    }.get(name, [])
    assert set(expected) <= sd.keys()
    if name == "brats_in":
        assert not any(".bn" in k for k in sd)


def test_brats_rejects_an_unknown_norm():
    with pytest.raises(ValueError, match="not supported"):
        TM.BraTSUnet(c=1, n=4, norm="ln", device="cpu")


def test_zoo_entry_points_need_a_device_without_a_card():
    """No fallback that hides the device: without a card the zoo's
    constructors raise unless told `device="cpu"`."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for cls, kw, _ in ZOO.values():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            getattr(TM, cls)(**kw)

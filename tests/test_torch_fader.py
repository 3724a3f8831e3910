"""Port parity: the fader family's eval forward (`models/fader.py`: Encoder,
Classificator, Discriminator, AE) against the JAX package's `models/
fader.py`, with JAX-initialised variables (random BN statistics and
biases) carried across by `interop.variables_to_state_dict`.

float32 on both sides; JAX contracts float32 at HIGHEST precision in its
layers.  Tolerance: 1e-5 x max|ref|, for the float32 summation-order
differences over a stack of up to 9 convs and the BN and Linear layers
(measured: under 1e-6 x max|ref|)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mri_epilepsy_diagnosis_torch.interop import variables_to_state_dict
from mri_epilepsy_diagnosis_torch.models import fader as TFd
from mri_epilepsy_diagnosis_torch.ops import functional as TFn
from mri_epilepsy_diagnosis_tpu.models import fader as JFd
from mri_epilepsy_diagnosis_tpu.ops import functional as JF

torch.set_num_threads(2)

# the reference's kwargs (train_ENC_CLF.ipynb cell 17, train_AE.ipynb cell 8)
DOWN = dict(conv_k=6, conv_pad=2, conv_s=2, maxpool_k=2, maxpool_s=2,
            batch_norm=True, act="l_relu")
UP = dict(up="upsample", scale=4, scale_mode="nearest", conv_k=5,
          conv_pad=2, conv_s=1, batch_norm=True, act="l_relu")
# the reference geometry at 48^3 with two blocks: 48 -> 24 -> 12 -> 6 -> 3
ENC_KW = dict(c_in=1, deapth=2, c_base=8, inc_size=2, reduce_size=False,
              down_block_kwargs=DOWN)
# the head's widths narrowed; its geometry (3^3 -> 1^3) is the reference's
HEAD_KW = dict(c_in=16, c_out=8, conv_k=3, conv_s=1, conv_pad=0, l_in=8,
               l_out=6, batch_norm=True, act="relu", p_drop=0.5)
REL_TOL = 1e-5


def randomized(variables, seed):
    """numpy copy of `variables` with random BN statistics, BN affine
    parameters and biases (the JAX init zeroes the biases)."""
    rng = np.random.default_rng(seed)

    def walk(tree, path=()):
        out = {}
        for k, leaf in tree.items():
            if hasattr(leaf, "items"):
                out[k] = walk(leaf, path + (k,))
                continue
            leaf = np.asarray(leaf, np.float32)
            in_bn = "batch_norm" in path[-1]
            if k == "running_var" or (in_bn and k == "weight"):
                leaf = rng.uniform(0.5, 1.5, leaf.shape)
            elif k in ("running_mean", "bias"):
                leaf = rng.normal(0.0, 0.2, leaf.shape)
            out[k] = np.asarray(leaf, np.float32)
        return out

    return walk(dict(variables))


def jax_model(name):
    """(JAX module, torch module (CPU, eval), example input shape)."""
    if name == "encoder":
        return (JFd.make_encoder(ENC_KW),
                TFd.make_encoder(ENC_KW, device="cpu"), (2, 48, 48, 48, 1))
    if name == "clf":
        return (JFd.Classificator(n_class=2, **HEAD_KW),
                TFd.Classificator(n_class=2, device="cpu", **HEAD_KW),
                (3, 3, 3, 3, 16))
    if name == "disc":
        return (JFd.Discriminator(n_domains=5, **HEAD_KW),
                TFd.Discriminator(n_domains=5, device="cpu", **HEAD_KW),
                (3, 3, 3, 3, 16))
    if name == "ae":
        kw = dict(c_in=1, deapth=2, c_base=4, inc_size=2,
                  down_block_kwargs=DOWN, up_block_kwargs=UP)
        return JFd.AE(**kw), TFd.AE(device="cpu", **kw), (1, 32, 32, 32, 1)
    if name == "ae_reduce":
        # the dense paths the reference never runs: the 4^3/s4 stem, the
        # transpose-conv UpBlock and the decoder's 4^3/s4 transpose conv
        kw = dict(c_in=1, deapth=1, c_base=4, inc_size=2, reduce_size=True,
                  down_block_kwargs=dict(conv_k=3, conv_pad=1, conv_s=1),
                  up_block_kwargs=dict(up="transpose_conv", scale=2,
                                       conv_k=3, conv_pad=1))
        return JFd.AE(**kw), TFd.AE(device="cpu", **kw), (1, 32, 32, 32, 1)
    # scale-2 UpBlocks after a stride-1 encoder: odd pre-pool sizes take
    # UpBlock's nearest-resize fixup; plain relu and no decoder BN
    kw = dict(c_in=1, deapth=2, c_base=4, inc_size=2,
              down_block_kwargs=dict(conv_k=3, conv_pad=1, conv_s=1,
                                     batch_norm=True, act="relu"),
              up_block_kwargs=dict(up="upsample", scale=2, conv_k=3,
                                   conv_pad=1, batch_norm=False, act="relu"))
    return JFd.AE(**kw), TFd.AE(device="cpu", **kw), (1, 10, 12, 14, 1)


def bridged(name, seed=0):
    jmodel, tmodel, shape = jax_model(name)
    x = np.random.default_rng(seed + 1).normal(size=shape).astype(np.float32)
    variables = randomized(jax.jit(jmodel.init)(jax.random.key(seed),
                                                jnp.asarray(x)), seed)
    tmodel.load_state_dict(variables_to_state_dict(variables, device="cpu"),
                           strict=True)
    return jmodel, tmodel.eval(), variables, x


def _assert_close(got: torch.Tensor, ref):
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    err = np.abs(got.detach().numpy() - ref).max()
    assert err <= REL_TOL * np.abs(ref).max(), err


@pytest.mark.parametrize("name", ["encoder", "clf", "disc", "ae",
                                  "ae_reduce"])
def test_bridged_keys_are_the_modules_keys(name):
    """The bridge covers the fader trees (rank-5 (k,1,1,I,O) convs, rank-2
    Linear, BatchNorm1d/3d statistics): the key sets agree and
    `load_state_dict(strict=True)` takes them (in `bridged`)."""
    jmodel, tmodel, variables, _ = bridged(name)
    sd = variables_to_state_dict(variables, device="cpu")
    assert set(sd) == set(tmodel.state_dict())
    for k, v in tmodel.state_dict().items():
        assert v.shape == sd[k].shape, k


def test_reference_checkpoint_names():
    """Submodule names of `classification/{encoder,clf}_93_6_4.pth`."""
    enc = TFd.make_encoder(dict(ENC_KW, deapth=3), device="cpu")
    clf = TFd.Classificator(n_class=2, device="cpu", **HEAD_KW)
    keys = set(enc.state_dict()) | set(clf.state_dict())
    assert {"encode.0.block.1_convx.weight", "encode.2.block.3_convz.bias",
            "encode.1.block.5_batch_norm.running_mean",
            "clf.5_l1.weight", "clf.6_batch_norm.running_mean",
            "clf.9_l_f.bias"} <= keys
    assert enc.state_dict()["encode.0.block.2_convy.weight"].shape == (
        8, 8, 1, 6, 1)


def test_encoder_matches_jax():
    jmodel, tmodel, variables, x = bridged("encoder", seed=3)
    ref, ref_sizes = jmodel.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got, sizes = tmodel(torch.from_numpy(x))
    assert got.shape == (2, 3, 3, 3, 16)
    assert sizes == [tuple(s) for s in ref_sizes] == [(24,) * 3, (6,) * 3]
    _assert_close(got, ref)


@pytest.mark.parametrize("name", ["clf", "disc"])
def test_heads_match_jax(name):
    jmodel, tmodel, variables, x = bridged(name, seed=4)
    ref, ref_hidden = jmodel.apply(variables, jnp.asarray(x),
                                   return_hidden=True)
    with torch.no_grad():
        got, hidden = tmodel(torch.from_numpy(x), return_hidden=True)
        assert torch.equal(tmodel(torch.from_numpy(x)), got)
    _assert_close(got, ref)
    _assert_close(hidden, ref_hidden)


@pytest.mark.parametrize("name", ["ae", "ae_fixup", "ae_reduce"])
def test_ae_matches_jax(name):
    jmodel, tmodel, variables, x = bridged(name, seed=5)
    ref = jmodel.apply(variables, jnp.asarray(x))
    ref_z, _ = jmodel.apply(variables, jnp.asarray(x), method="encode")
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x))
        z, _ = tmodel.encode(torch.from_numpy(x))
    assert got.shape == x.shape
    _assert_close(got, ref)
    _assert_close(z, ref_z)


@pytest.mark.parametrize("out", [(8, 12, 5), (3, 7, 11), (6, 6, 10)])
def test_resize_nearest_matches_jax(out):
    x = np.random.default_rng(6).normal(size=(2, 6, 4, 10, 3)).astype(
        np.float32)
    np.testing.assert_array_equal(
        TFn.resize_nearest(torch.from_numpy(x), out).numpy(),
        np.asarray(JF.resize_nearest(jnp.asarray(x), out)))


@pytest.mark.parametrize("kernel,stride", [(2, None), (2, 2), (3, 3),
                                           (3, 2)])
def test_maxpool3d_floor_mode_matches_jax(kernel, stride):
    """Spatial dims not divisible by the kernel drop their ragged edge."""
    x = np.random.default_rng(7).normal(size=(2, 7, 8, 9, 3)).astype(
        np.float32)
    np.testing.assert_array_equal(
        TFn.maxpool3d(torch.from_numpy(x), kernel, stride).numpy(),
        np.asarray(JF.maxpool3d(jnp.asarray(x), kernel, stride)))


def test_activations_match_jax():
    x = np.random.default_rng(8).normal(size=(4, 5)).astype(np.float32)
    for name in ("l_relu", "relu"):
        np.testing.assert_array_equal(
            TFn.activation(name)(torch.from_numpy(x)).numpy(),
            np.asarray(JFd._act(name)(jnp.asarray(x))))


@pytest.mark.parametrize("name", ["encoder", "clf", "ae"])
def test_train_mode_raises(name):
    _, tmodel, shape = jax_model(name)
    with pytest.raises(RuntimeError, match="eval mode"):
        tmodel.train()(torch.zeros(shape))

"""Port parity: the JAX -> torch weight bridge and the fine UNet3D.

The JAX package is the reference: the same numpy inputs and weights go
through `mri_epilepsy_diagnosis_tpu` and `mri_epilepsy_diagnosis_torch`
(on the CPU), and the outputs must agree."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mri_epilepsy_diagnosis_torch.interop import (load_torch_checkpoint,
                                                  variables_to_state_dict)
from mri_epilepsy_diagnosis_torch.models import UNet3D as TorchUNet3D
from mri_epilepsy_diagnosis_tpu.interop import torch_import as jax_import
from mri_epilepsy_diagnosis_tpu.models import UNet3D as JaxUNet3D

torch.set_num_threads(2)


def jax_unet_variables(ocfl=8, nb=3, seed=0):
    """JAX-initialised UNet3D variables (numpy leaves) with random,
    non-trivial BN statistics, gammas and betas."""
    model = JaxUNet3D(out_channels_first_layer=ocfl, num_encoding_blocks=nb)
    v = model.init(jax.random.key(seed), jnp.zeros((1, 8, 8, 8, 1)))
    v = jax.tree_util.tree_map(np.asarray, v)
    rng = np.random.default_rng(seed)

    def randomize(tree, path=()):
        out = {}
        for k, leaf in tree.items():
            if isinstance(leaf, dict) or hasattr(leaf, "items"):
                out[k] = randomize(dict(leaf), path + (k,))
                continue
            inside_norm = "norm_layer" in path
            if k == "running_var":
                leaf = rng.uniform(0.5, 1.5, leaf.shape)
            elif k == "running_mean" or (inside_norm and k == "bias"):
                leaf = rng.normal(0.0, 0.2, leaf.shape)
            elif inside_norm and k == "weight":
                leaf = rng.uniform(0.5, 1.5, leaf.shape)
            out[k] = np.asarray(leaf, np.float32)
        return out

    return model, randomize(dict(v))


def torch_unet(variables, ocfl=8, nb=3):
    model = TorchUNet3D(out_channels_first_layer=ocfl,
                        num_encoding_blocks=nb, device="cpu").eval()
    model.load_state_dict(variables_to_state_dict(variables, device="cpu"),
                          strict=True)
    return model


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_bridge_inverts_jax_importer():
    """Every bridged tensor, put back through the JAX importer's
    `_convert` under the importer's own key rule, is the flax leaf."""
    _, variables = jax_unet_variables(ocfl=4, nb=2)
    sd = variables_to_state_dict(variables, device="cpu")
    n = 0
    for collection in ("params", "batch_stats"):
        for path, leaf in _flat(variables[collection]):
            key = jax_import._flax_path_to_torch_key(path)
            back = jax_import._convert(sd[key].numpy(), leaf.shape)
            np.testing.assert_array_equal(back, leaf)
            n += 1
    # plus one num_batches_tracked per BatchNorm, as torch keeps
    assert len(sd) == n + sum(k.endswith("num_batches_tracked") for k in sd)


@pytest.mark.parametrize("shape", [(3, 3, 3, 2, 5), (3, 3, 2, 5), (4, 6),
                                   (7,)])
def test_bridge_layout_by_rank(shape):
    """rank 5 (kD,kH,kW,I,O) -> (O,I,kD,kH,kW), rank 4 (kH,kW,I,O) ->
    (O,I,kH,kW), rank 2 transposed, rank 1 as is; `__` -> `.`."""
    arr = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    sd = variables_to_state_dict(
        {"params": {"blocks__0": {"conv": {"weight": arr}}}}, device="cpu")
    got = sd["blocks.0.conv.weight"].numpy()
    np.testing.assert_array_equal(jax_import._convert(got, shape), arr)


def test_bridged_state_dict_loads_into_torch_unet():
    _, variables = jax_unet_variables(ocfl=8, nb=3)
    model = torch_unet(variables)
    nl = model.encoder.encoding_blocks[1].conv1.norm_layer
    np.testing.assert_array_equal(
        nl.running_var.numpy(),
        variables["batch_stats"]["encoder"]["encoding_blocks__1"]["conv1"]
        ["norm_layer"]["running_var"])
    # the first encoder conv has no norm, as in the fepegar checkpoints
    assert model.encoder.encoding_blocks[0].conv1.norm_layer is None


def test_load_torch_checkpoint_matches_jax_reader(tmp_path):
    _, variables = jax_unet_variables(ocfl=4, nb=2)
    sd = variables_to_state_dict(variables, device="cpu")
    path = str(tmp_path / "unet.pth")
    torch.save(sd, path)
    ours = load_torch_checkpoint(path)
    ref = jax_import.load_torch_checkpoint(path)
    assert ours.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k])


@pytest.mark.parametrize("ocfl,nb,size", [(8, 3, 16), (4, 2, 12)])
def test_fine_unet_matches_jax(ocfl, nb, size):
    """The port's fine UNet3D logits == `UNet3D.apply` on JAX-initialised
    weights with random BN stats (f32; JAX contracts f32 at HIGHEST)."""
    jmodel, variables = jax_unet_variables(ocfl=ocfl, nb=nb, seed=2)
    x = np.random.default_rng(3).normal(
        size=(2, size, size, size, 1)).astype(np.float32)
    ref = np.asarray(jax.jit(jmodel.apply)(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = torch_unet(variables, ocfl, nb)(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


def test_fine_unet_refuses_train_mode():
    model = TorchUNet3D(out_channels_first_layer=4, num_encoding_blocks=2,
                        device="cpu")
    with pytest.raises(RuntimeError, match="eval"):
        model(torch.zeros(1, 8, 8, 8, 1))

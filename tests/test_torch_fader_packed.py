"""Port parity: the packed and the fused fader encoders
(`models/fader_packed.py::encoder_apply_packed`, `models/fader.py::
encoder_apply_fused`) against the JAX package's, float32 on the CPU, with
JAX-initialised variables (random BN statistics and biases) carried
across by `interop.variables_to_state_dict`: the reference geometry (k 6,
s 2, p 2, pool 2, LeakyReLU) at 64^3 with depth 3 (every block packed)
and at 40^3 with depth 2 (the second block, 10^3, takes the fine
fallback), rtol and atol 1e-4 and the same size_list; the packing pieces
exactly; and the geometry the packed block refuses."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mri_epilepsy_diagnosis_torch.interop import variables_to_state_dict
from mri_epilepsy_diagnosis_torch.models import fader as TFd
from mri_epilepsy_diagnosis_torch.models import fader_packed as TFP
from mri_epilepsy_diagnosis_tpu.models import fader as JFd
from mri_epilepsy_diagnosis_tpu.models import fader_packed as JFP
from test_torch_fader import DOWN, randomized

torch.set_num_threads(2)

# (size, depth): every block packed; the second block on the fine path
CASES = {"s64_d3": (64, 3), "s40_d2": (40, 2)}


def _kwargs(depth):
    return dict(c_in=1, is_skip=False, deapth=depth, c_base=8, inc_size=2,
                reduce_size=False, down_block_kwargs=DOWN)


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    """(port encoder (eval), kwargs, input, JAX packed and fused latents
    and size lists)."""
    size, depth = CASES[request.param]
    kw = _kwargs(depth)
    jenc = JFd.make_encoder(kw)
    x = np.random.default_rng(size).normal(
        size=(2, size, size, size, 1)).astype(np.float32)
    variables = randomized(jax.jit(jenc.init)(
        jax.random.key(depth), jnp.asarray(x)), seed=size)
    xj = jnp.asarray(x)
    with jax.default_matmul_precision("highest"):
        packed = JFP.encoder_apply_packed(variables, xj, kw)
        fused = JFd.encoder_apply_fused(variables, xj, kw)
    tenc = TFd.make_encoder(kw, device="cpu")
    tenc.load_state_dict(variables_to_state_dict(variables, device="cpu"),
                         strict=True)
    return tenc.eval(), kw, x, {"packed": packed, "fused": fused}


@pytest.mark.parametrize("path", ["packed", "fused"])
def test_encoder_matches_jax(case, path):
    tenc, kw, x, refs = case
    fn = (TFP.encoder_apply_packed if path == "packed"
          else TFd.encoder_apply_fused)
    with torch.no_grad():
        got, sizes = fn(tenc, torch.from_numpy(x), kw)
        fine, fine_sizes = tenc(torch.from_numpy(x))
    ref, ref_sizes = refs[path]
    assert sizes == [tuple(s) for s in ref_sizes] == fine_sizes
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got.numpy(), fine.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_fine_fallback_block_is_taken(case, monkeypatch):
    """At 40^3 the 10^3 block is not divisible by 4: it runs
    `downblock_apply_fine`; at 64^3 every block is packed."""
    tenc, kw, x, _ = case
    taken = []
    for name in ("downblock_apply_fine", "downblock_apply_packed"):
        fn = getattr(TFP, name)
        monkeypatch.setattr(TFP, name, lambda *a, _fn=fn, _n=name, **k: (
            taken.append(_n), _fn(*a, **k))[1])
    with torch.no_grad():
        TFP.encoder_apply_packed(tenc, torch.from_numpy(x), kw)
    want = (["downblock_apply_packed"] * 3 if x.shape[1] == 64 else
            ["downblock_apply_packed", "downblock_apply_fine"])
    assert taken == want


@pytest.mark.parametrize("k,p", [(6, 2), (4, 1), (2, 0)])
def test_axis_table_strided_matches_jax(k, p):
    a, lo = TFP._axis_table_strided(k, p)
    ja, jlo = JFP._axis_table_strided(k, p)
    assert lo == jlo and np.array_equal(a, ja)


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_packed_axis_conv_matches_jax(axis):
    """`pack_sepconv_weight` equals JAX's kernel (exactly: one tap or zero
    an entry) and `conv_axis_packed`, one B3 launch on the card, JAX's
    conv within 1e-5 x max|ref|."""
    rng = np.random.default_rng(axis)
    w = rng.normal(size=(6, 3, 4)).astype(np.float32)
    b = rng.normal(size=(4,)).astype(np.float32)
    xp = rng.normal(size=(2, 4, 6, 8, 24)).astype(np.float32)
    jw, jlo = JFP.pack_sepconv_weight(jnp.asarray(w), axis, 2)
    tw, tlo = TFP.pack_sepconv_weight(torch.from_numpy(w), axis, 2)
    assert tlo == jlo
    assert np.array_equal(tw.numpy(), np.asarray(jw).reshape(tw.shape))
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(JFP.conv_axis_packed(jnp.asarray(xp), jw,
                                              jnp.asarray(b), axis, jlo))
    got = TFP.conv_axis_packed(torch.from_numpy(xp), tw, torch.from_numpy(b),
                               axis, tlo).numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("args", [(12, 6, 6, 2, 2), (9, 4, 3, 2, 1),
                                  (5, 5, 3, 1, 1)])
def test_axis_valid_mask_matches_jax(args):
    assert np.array_equal(TFd._axis_valid_mask(*args),
                          JFd._axis_valid_mask(*args))


def test_packed_block_is_the_pack_of_the_fine_block():
    """The packed stack's output, unpacked, is the fine stack's output
    before the pool (the shape_before_pool it reports), to float32
    rounding: the geometry's identity, without JAX."""
    torch.manual_seed(1)
    blk = TFd.DownBlock(3, 5, device="cpu", **DOWN).eval()
    x = torch.randn(2, 16, 12, 8, 3)
    with torch.no_grad():
        ref, ref_shape = blk(x)
        got, shape = TFP.downblock_apply_packed(blk, x, **DOWN)
    assert shape == ref_shape
    assert (got - ref).abs().max() <= 1e-5 * ref.abs().max()


@pytest.mark.parametrize("bad", [dict(conv_s=1), dict(conv_k=5, conv_pad=2),
                                 dict(conv_pad=1), dict(maxpool_k=3)])
def test_packed_block_refuses_other_geometry(bad):
    blk = TFd.DownBlock(1, 2, device="cpu", **DOWN).eval()
    with pytest.raises(ValueError):
        TFP.downblock_apply_packed(blk, torch.zeros(1, 8, 8, 8, 1),
                                   **{**DOWN, **bad})
    with pytest.raises(ValueError, match="divisible by 4"):
        TFP.downblock_apply_packed(blk, torch.zeros(1, 8, 8, 6, 1), **DOWN)


def test_b3_symmetric_pad_is_asserted():
    """B3 pads both ends of an axis alike; cell padding (pad_lo, Q - 2 -
    pad_lo) that is not symmetric raises rather than computing another
    conv."""
    assert TFP._symmetric_pad(4, 1) == 1
    with pytest.raises(ValueError, match="symmetric"):
        TFP._symmetric_pad(5, 1)
    wp, lo = TFP.pack_sepconv_weight(torch.ones(4, 1, 1), 0, 2)
    with pytest.raises(ValueError, match="symmetric"):
        TFP.conv_axis_packed(torch.zeros(1, 4, 2, 2, 8), wp, None, 0, lo)


def test_fused_bias_field_matches_jax_at_the_boundary():
    """A DownBlock with zero weights but nonzero biases: its output is the
    boundary-truncated bias field alone, the same in both packages."""
    kw = _kwargs(1)
    jenc = JFd.make_encoder(kw)
    x = np.zeros((1, 16, 16, 16, 1), np.float32)
    variables = randomized(jax.jit(jenc.init)(jax.random.key(0),
                                              jnp.asarray(x)), seed=7)
    p = variables["params"]["encode__0"]["block__1_convx"]
    p["weight"] = p["weight"] * 0
    ref, _ = JFd.encoder_apply_fused(variables, jnp.asarray(x), kw)
    tenc = TFd.make_encoder(kw, device="cpu")
    tenc.load_state_dict(variables_to_state_dict(variables, device="cpu"))
    with torch.no_grad():
        got, _ = TFd.encoder_apply_fused(tenc.eval(), torch.from_numpy(x),
                                         kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)
    assert np.ptp(np.asarray(ref)) > 0     # the field varies at the faces

"""Port parity: the stride-2 and stem section of `ops/packed.py` and its
leftover helpers against the JAX package's `ops/packed.py`, in float32 on
the CPU: the weight packings exactly, the convs within 1e-5 x max|ref|
(`conv3s2_packed_aa` at S2 = 8 and 6, the stride-1, k5 and pack4 stems).
Then the index math of the kernels these functions launch on the card,
walked with torch as the kernels walk it: B1's tile plan over
`conv3s2_packed_aa`'s low-padded input and over the pack4 stem, at 8Ci up
to 1024; B3's row plan for the packed fader encoder's stride-2, Q = 4
axis convs (integer-valued inputs: exact, tolerance 0)."""
import numpy as np
import pytest
import torch
import torch.nn.functional as TF

import jax
import jax.numpy as jnp

from mri_epilepsy_diagnosis_torch.ops import cuda_kernels as K
from mri_epilepsy_diagnosis_torch.ops import packed as TP
from mri_epilepsy_diagnosis_tpu.ops import packed as JP
from test_torch_axis_fwd_tc import _check_walk, _ints, _plan
from test_torch_conv2_tc import _int_tensor, _walk_plan

torch.set_num_threads(2)

REL_TOL = 1e-5
CI, CO = 3, 5


def _torch_w(w):
    """JAX (3, 3, 3, Ci, Co) -> torch (Co, Ci, 3, 3, 3)."""
    return torch.from_numpy(np.ascontiguousarray(w.transpose(4, 3, 0, 1, 2)))


def _close(got, ref):
    got = got.detach().numpy()
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= REL_TOL * np.abs(ref).max(), err


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(15)
    w = rng.normal(size=(3, 3, 3, CI, CO)).astype(np.float32)
    b = rng.normal(size=(CO,)).astype(np.float32)
    x16 = rng.normal(size=(2, 16, 16, 16, CI)).astype(np.float32)
    x12 = rng.normal(size=(2, 12, 12, 12, CI)).astype(np.float32)
    return w, b, x16, x12


@pytest.fixture(scope="module")
def jax_refs(data):
    """The JAX package's packings and convs on the same inputs."""
    w, b, x16, x12 = data
    wj, bj = jnp.asarray(w), jnp.asarray(b)
    out = {"wk_s2": JP.pack_weights2_s2(wj),
           "w_in": JP.pack_input_weights(wj),
           "w_in_s2": JP.pack_input_weights_s2(wj),
           "w_p4": JP.pack_input_weights_s2_p4(wj)}
    with jax.default_matmul_precision("highest"):
        for name, x in (("16", x16), ("12", x12)):
            xj = jnp.asarray(x)
            # S2 = 8 and 6 cells: the aligned packing of a 16^3 / 12^3 input
            out[f"s2_{name}"] = JP.conv3s2_packed_aa(JP.pack2(xj),
                                                     out["wk_s2"], bj)
        x16j = jnp.asarray(x16)
        out["in"] = JP.conv_input_packed(x16j, out["w_in"], bj)
        out["in_s2"] = JP.conv_input_packed_s2(x16j, out["w_in_s2"], bj)
        out["p4"] = JP.conv_input_packed_s2_p4(x16j, out["w_p4"], bj)
        xp = JP.pack2(x16j)
        out["pack2_conv"] = JP.pack2_conv(x16j)
        out["pack2_shifted"] = JP.pack2_shifted(x16j)
        out["repack_shifted"] = JP.repack_shifted(xp)
        out["conv1"] = JP.conv1_packed(xp, wj[1, 1, 1], bj)
        out["cascade"] = JP.maxpool2_packed_cascade(xp)
        out["pack4"] = jax.lax.conv_general_dilated(
            x16j, jnp.asarray(JP._pack4_identity_kernel(CI)), (4, 4, 4),
            "VALID", dimension_numbers=("NDHWC", "DHWIO", "NDHWC"))
    return {k: np.asarray(v) for k, v in out.items()}


def test_axis_tables_match_jax():
    assert np.array_equal(TP._axis_table_s2(), JP._axis_table_s2())
    assert np.array_equal(TP._axis_table_s2_p4(), JP._axis_table_s2_p4())


@pytest.mark.parametrize("name,fn", [
    ("wk_s2", TP.pack_weights2_s2), ("w_in", TP.pack_input_weights),
    ("w_in_s2", TP.pack_input_weights_s2),
    ("w_p4", TP.pack_input_weights_s2_p4)])
def test_weight_packings_equal_jax(data, jax_refs, name, fn):
    """Each packed kernel holds one fine tap or zero per entry: equal."""
    got = fn(_torch_w(data[0])).numpy()
    assert np.array_equal(got, jax_refs[name])


@pytest.mark.parametrize("size", ["16", "12"])
def test_conv3s2_packed_aa_matches_jax(data, jax_refs, size):
    w, b, x16, x12 = data
    x = torch.from_numpy(x16 if size == "16" else x12)
    got = TP.conv3s2_packed_aa(TP.pack2(x), TP.pack_weights2_s2(_torch_w(w)),
                               torch.from_numpy(b))
    _close(got, jax_refs[f"s2_{size}"])


@pytest.mark.parametrize("name", ["in", "in_s2", "p4"])
def test_stems_match_jax(data, jax_refs, name):
    w, b, x16, _ = data
    wt, bt, x = _torch_w(w), torch.from_numpy(b), torch.from_numpy(x16)
    fn, pack = {"in": (TP.conv_input_packed, TP.pack_input_weights),
                "in_s2": (TP.conv_input_packed_s2, TP.pack_input_weights_s2),
                "p4": (TP.conv_input_packed_s2_p4,
                       TP.pack_input_weights_s2_p4)}[name]
    _close(fn(x, pack(wt), bt), jax_refs[name])


def test_stems_are_the_fine_conv_shifted(data):
    """After `zero_shifted_pads`, each stem is the shifted packing of the
    fine stem conv (torch's own conv3d)."""
    w, b, x16, _ = data
    wt, bt, x = _torch_w(w), torch.from_numpy(b), torch.from_numpy(x16)
    for stride, got in (
            (1, TP.conv_input_packed(x, TP.pack_input_weights(wt), bt)),
            (2, TP.conv_input_packed_s2(x, TP.pack_input_weights_s2(wt), bt)),
            (2, TP.conv_input_packed_s2_p4(
                x, TP.pack_input_weights_s2_p4(wt), bt))):
        fine = TF.conv3d(x.permute(0, 4, 1, 2, 3), wt, bt, stride=stride,
                         padding=1).permute(0, 2, 3, 4, 1)
        ref = TP.pack2_shifted(fine)
        err = (TP.zero_shifted_pads(got) - ref).abs().max()
        assert err <= REL_TOL * ref.abs().max()


@pytest.mark.parametrize("name", ["pack2_conv", "pack2_shifted",
                                  "repack_shifted", "conv1", "cascade",
                                  "pack4"])
def test_leftover_helpers_match_jax(data, jax_refs, name):
    w, b, x16, _ = data
    x = torch.from_numpy(x16)
    xp = TP.pack2(x)
    got = {"pack2_conv": lambda: TP.pack2_conv(x),
           "pack2_shifted": lambda: TP.pack2_shifted(x),
           "repack_shifted": lambda: TP.repack_shifted(xp),
           "conv1": lambda: TP.conv1_packed(
               xp, _torch_w(w)[:, :, 1, 1, 1], torch.from_numpy(b)),
           "cascade": lambda: TP.maxpool2_packed_cascade(xp),
           "pack4": lambda: TP.pack4(x)}[name]()
    if name == "conv1":
        _close(got, jax_refs[name])
    else:       # data movement and max: exact
        assert np.array_equal(got.numpy(), jax_refs[name])


def test_conv3s2_packed_aa_gradients_match_the_fine_conv(data):
    """dx (a B1 dx launch on the card, through the low pad) and dw (the
    qgroup GEMMs, through the tap gather) and the bias gradient equal
    autograd through the fine stride-2 conv."""
    w, b, x16, _ = data
    x = torch.from_numpy(x16).requires_grad_()
    wt = _torch_w(w).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    g = torch.randn(2, 8, 8, 8, CO, generator=torch.Generator().manual_seed(3))
    out = TP.unpack2(TP.conv3s2_packed_aa(TP.pack2(x),
                                          TP.pack_weights2_s2(wt), bt))
    got = torch.autograd.grad(out, (x, wt, bt), g)
    fine = TF.conv3d(x.permute(0, 4, 1, 2, 3), wt, bt, stride=2,
                     padding=1).permute(0, 2, 3, 4, 1)
    ref = torch.autograd.grad(fine, (x, wt, bt), g)
    for a, r in zip(got, ref):
        assert (a - r).abs().max() <= REL_TOL * r.abs().max()


# ---------------------------------------------------------------------------
# the kernels' index math at the new plans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cells,c8i,c8o", [(4, 256, 64), (6, 64, 128),
                                           (2, 1024, 256)])
def test_b1_plan_walk_over_the_low_padded_downsample(cells, c8i, c8o):
    """`conv3s2_packed_aa`'s launch: B1 (pad 0) over the input padded by
    one cell on the low side.  Walking the tensor-core tile plan stores
    every output once and equals the plain version, and pack2 of it is
    JAX's 8-phase form, exactly (integer-valued)."""
    rng = np.random.default_rng(cells + c8i + c8o)
    xp = _int_tensor(rng, (1, cells, cells, cells, c8i))
    wk = _int_tensor(rng, (2, 2, 2, c8i, c8o), -2, 3)
    xpad = TF.pad(xp, (0, 0, 1, 0, 1, 0, 1, 0))
    got, stores = _walk_plan(xpad, K.kmajor_weights(wk), None, 0)
    assert torch.equal(stores, torch.ones_like(stores))
    assert torch.equal(got, K.conv2_packed_plain(xpad, wk, pad=0))
    ref = JP.conv3s2_packed_aa(jnp.asarray(xp.numpy()),
                               jnp.asarray(wk.numpy()))
    assert np.array_equal(TP.pack2(got).numpy(), np.asarray(ref))


def test_b1_plan_walk_over_the_pack4_stem():
    """The pack4 stem's launch (8Ci = 64 from one channel, 8Co = 8 x 32,
    pad 1): the tile plan's walk equals the plain version exactly."""
    rng = np.random.default_rng(4)
    x = _int_tensor(rng, (1, 12, 12, 12, 1))
    wk = _int_tensor(rng, (2, 2, 2, 64, 256), -2, 3)
    x4 = TP.pack4(x)
    got, stores = _walk_plan(x4, K.kmajor_weights(wk), None, 1)
    assert torch.equal(stores, torch.ones_like(stores))
    assert torch.equal(got, K.conv2_packed_plain(x4, wk, pad=1))


# (8Ci, 8Co) of VoxResNet's B1 sites at n_filters 32 (stem, conv3d_2,
# the four downsamples, the block convs of each stage) and the tensor-core
# plan at 192^3 batch 10: every site's cells and the grid it launches
VOX_SITES = [("stem", 64, 256, 48, 1), ("conv3d_2", 256, 256, 49, 0),
             ("conv3d_3", 256, 64, 49, 0), ("stage1", 512, 512, 24, 1),
             ("conv3d_4", 512, 64, 25, 0), ("stage2", 512, 512, 12, 1),
             ("conv3d_5", 512, 128, 13, 0), ("stage3", 1024, 1024, 6, 1),
             ("conv3d_6", 1024, 128, 7, 0), ("stage4", 1024, 1024, 3, 1)]


@pytest.mark.parametrize("site", VOX_SITES, ids=lambda s: s[0])
def test_voxresnet_sites_take_the_tensor_cores(site):
    _, c8i, c8o, cells, pad = site
    assert K._conv2_route(torch.bfloat16, c8i, c8o) == "tc"
    assert K._conv2_route(torch.bfloat16, c8o, c8i) == "tc"   # its dx
    out = cells + (1 if pad else -1)
    plan = K.conv2_tc_plan(10, out, out, out, c8o, pad)
    assert plan.grid >= 132 or out ** 3 * 10 <= 128 * 132


@pytest.mark.parametrize("axis", [1, 2, 3])
@pytest.mark.parametrize("ci,co", [(8, 16), (16, 8)])
def test_b3_row_plan_walk_at_stride2_q4(axis, ci, co):
    """The packed encoder's axis convs are B3 with k = Q = 4 cells, stride
    2, pad 1: the tensor-core row plan's walk equals the plain version
    exactly, each output once."""
    rng = np.random.default_rng(axis + ci)
    x = _ints(rng, (1, 6, 4, 8, ci))
    w = _ints(rng, (4, ci, co))
    _check_walk(x, w, _ints(rng, (co,)), 4, 2, 1, axis)


# the packed encoder's B3 sites at 192^3 batch 8 in bf16: the three stacks
# (cells, 8Ci, 8Co) and each route: e0 fused, e1 and e2 per axis
PACKED_STACKS = [("e0", 96, (8, 64, 64, 64), "fused"),
                 ("e1", 24, (64, 128, 128, 128), "per_axis"),
                 ("e2", 6, (128, 256, 256, 256), "per_axis")]


@pytest.mark.parametrize("stack", PACKED_STACKS, ids=lambda s: s[0])
def test_packed_encoder_routes_and_row_plans(stack):
    _, cells, chans, route = stack
    plan = K.separable_plan(8, (cells,) * 3, chans, (4,) * 3, (2,) * 3,
                            (1,) * 3, torch.bfloat16)
    assert K._separable_route(torch.bfloat16, plan) == route
    if route == "fused":
        return
    shape = [8, cells, cells, cells, chans[0]]
    for axis in (1, 2, 3):
        p = _plan(tuple(shape), chans[axis], 4, 2, 1, axis)
        assert p.lo == shape[axis] // 2 and p.smem <= 232448
        assert p.ntiles * p.cot >= chans[axis] and p.kst * p.cik >= shape[4]
        shape[axis] //= 2
        shape[4] = chans[axis]

"""Port parity: int8 inference of the packed UNet3D
(`models/unet_packed_q.py`), its kernels' plain versions and plans (K1
`conv2_packed_s8`, K2 `upconv_packed_s8` in `ops/cuda_kernels.py`) and the
bridge of JAX's quantized pytree, against the JAX package on the CPU.

The same numpy inputs and weights go through both packages.  Integer sums
are exact on both sides (int32 equal).  Scales and calibration maxima
agree to float32 rounding (1e-5 relative); a rounding difference in a
calibrated scale can move a weight across a rounding tie, so the int8
weights are equal except for entries that differ by 1, at most 1e-4 of
them.  Float parts (the epilogues' dequantization, the face fixes) round
differently at a few entries, which flips a few int8 activations by one
step: logits on bridged JAX weights within 1e-2 x max, masks agreeing
>= 0.999.  JAX at "highest" precision; its int8 forward is slow on the
CPU, so its references run at 16^3 in module fixtures."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mri_epilepsy_diagnosis_torch.infer.serving import segment_volumes
from mri_epilepsy_diagnosis_torch.interop import (quantized_to_torch,
                                                  variables_to_state_dict)
from mri_epilepsy_diagnosis_torch.models import unet_packed as TU
from mri_epilepsy_diagnosis_torch.models import unet_packed_q as TQ
from mri_epilepsy_diagnosis_torch.ops import cuda_kernels as K
from mri_epilepsy_diagnosis_torch.ops import packed as TP
from mri_epilepsy_diagnosis_tpu.models import UNet3D as JaxUNet3D
from mri_epilepsy_diagnosis_tpu.models import unet_packed as JU
from mri_epilepsy_diagnosis_tpu.models import unet_packed_q as JQ
from mri_epilepsy_diagnosis_tpu.ops import packed as JP
from test_torch_bridge import jax_unet_variables

torch.set_num_threads(2)

SIZE = 16
CONV_SITES = ("e0c1", "e0c2", "e1c1", "e1c2", "bc1", "bc2", "d0c1", "d0c2",
              "d1c1", "d1c2")
UP_SITES = ("d0", "d1")
SCALE_RTOL = 1e-5
W8_FLIP_SHARE = 1e-4
LOGIT_TOL = 1e-2               # x max|logit|
MASK_AGREEMENT = 0.999


@pytest.fixture(scope="module")
def jax_q():
    """JAX's quantized UNet3D (ocfl 8, random BN statistics) at 16^3,
    batch 2: calibration maxima, the int8 pytree, every int8 conv's and
    up-conv's inputs and int32 outputs, the logits and the mask."""
    _, variables = jax_unet_variables(ocfl=8, nb=3, seed=31)
    x = np.random.default_rng(32).normal(
        size=(2, SIZE, SIZE, SIZE, 1)).astype(np.float32)
    convs, ups = [], []
    conv, upconv = JQ.conv_int8, JQ.upconv_int8

    def rec_conv(x8, w8, padding):
        y = conv(x8, w8, padding)
        convs.append((np.asarray(x8), np.asarray(w8), padding,
                      np.asarray(y)))
        return y

    def rec_up(x8, wk8):
        y = upconv(x8, wk8)
        ups.append((np.asarray(x8), np.asarray(wk8), np.asarray(y)))
        return y

    with jax.default_matmul_precision("highest"):
        calib = JQ.calibrate(JU.fold_bn_inference(variables), jnp.asarray(x))
        q = JQ.quantize_inference(variables, jnp.asarray(x))
        JQ.conv_int8, JQ.upconv_int8 = rec_conv, rec_up
        try:
            logits = np.asarray(JQ.packed_unet_apply_v2_int8(q, x))
        finally:
            JQ.conv_int8, JQ.upconv_int8 = conv, upconv
        mask = np.asarray(JQ.packed_unet_mask_v2_int8(q, x))
    assert len(convs) == len(CONV_SITES) and len(ups) == len(UP_SITES)
    return {"variables": variables, "x": x, "calib": calib,
            "q": jax.tree_util.tree_map(np.asarray, q), "convs": convs,
            "ups": ups, "logits": logits, "mask": mask}


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 2, 2, 16, 24), (3, 3, 3, 4, 5),
                                   (8, 16)])
def test_quantize_weight_per_oc_matches_jax(shape):
    w = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    w8, scale = TQ.quantize_weight_per_oc(torch.from_numpy(w))
    w8_ref, scale_ref = JQ.quantize_weight_per_oc(jnp.asarray(w))
    assert w8.dtype == torch.int8
    np.testing.assert_array_equal(w8.numpy(), np.asarray(w8_ref))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(scale_ref))


def test_requant_rounds_half_to_even_and_clips():
    """`_requant` and `quantize_act`: ties to even as `jnp.round`, values
    beyond +-127 clipped before the cast (a torch cast would wrap)."""
    y = np.asarray([0.5, 1.5, 2.5, -0.5, -2.5, 126.5, 300.0, -1e9, 3.49],
                   np.float32)
    for rq in (1.0, np.float32(0.75)):
        got = TQ._requant(torch.from_numpy(y), rq).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(JQ._requant(jnp.asarray(y), rq)))
    np.testing.assert_array_equal(
        TQ.quantize_act(torch.from_numpy(y), 0.5).numpy(),
        np.asarray(JQ.quantize_act(jnp.asarray(y), 0.5)))


@pytest.mark.parametrize("nb", [2, 3, 4])
def test_site_names_match_jax(nb):
    assert TQ.site_names(nb) == JQ.site_names(nb)


# ---------------------------------------------------------------------------
# calibration and quantization
# ---------------------------------------------------------------------------


def _close_rel(got, ref, rtol=SCALE_RTOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= rtol * np.abs(ref).max()


def test_calibrate_matches_jax(jax_q):
    """Per-site per-fine-channel maxima of the port's (explicit-decoder)
    float forward == JAX's (composed) within 1e-5 relative."""
    sd = TU.fold_bn_inference(variables_to_state_dict(jax_q["variables"],
                                                      device="cpu"))
    got = TQ.calibrate(sd, torch.from_numpy(jax_q["x"]))
    assert set(got) == set(jax_q["calib"]) == set(TQ.site_names(3))
    for k, ref in jax_q["calib"].items():
        _close_rel(got[k].numpy(), ref)


@pytest.mark.parametrize("folded", [False, True])
def test_quantize_inference_matches_jax(jax_q, folded):
    """Every leaf of the port's int8 dict against JAX's: scales 1e-5
    relative; int8 kernels equal except entries that differ by 1 (a scale
    rounded across a tie), at most 1e-4 of all entries."""
    sd = variables_to_state_dict(jax_q["variables"], device="cpu")
    if folded:
        sd = TU.fold_bn_inference(sd)
    got = TQ.quantize_inference(sd, torch.from_numpy(jax_q["x"]))
    ref = jax_q["q"]
    assert set(got) == set(ref) and got["nb"] == int(ref["nb"]) == 3
    _close_rel(got["in_rq"].numpy(), ref["in_rq"])
    flips = total = 0
    for site, e_ref in ref.items():
        if not isinstance(e_ref, dict):
            continue
        assert set(got[site]) == set(e_ref), site
        for key, r in e_ref.items():
            g = got[site][key]
            if r is None:
                assert g is None, (site, key)
                continue
            g = g.numpy()
            if key == "w_u_fine":
                r = np.asarray(r).transpose(4, 3, 0, 1, 2)
            if np.asarray(r).dtype == np.int8:
                assert g.dtype == np.int8 and g.shape == r.shape
                d = np.abs(g.astype(np.int32) - r.astype(np.int32))
                assert d.max() <= 1, (site, key)
                flips += int((d > 0).sum())
                total += d.size
            else:
                _close_rel(g, r)
    assert flips <= W8_FLIP_SHARE * total, (flips, total)


# ---------------------------------------------------------------------------
# the int8 convs: JAX's int8 inputs at every site, int32 equal
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("site", range(len(CONV_SITES)),
                         ids=list(CONV_SITES))
def test_conv_int8_matches_jax_at_every_site(jax_q, site):
    x8, w8, padding, ref = jax_q["convs"][site]
    pad = 0 if padding == "VALID" else 1
    got = TQ.conv_int8(torch.from_numpy(x8), torch.from_numpy(w8), pad)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("site", range(len(UP_SITES)), ids=list(UP_SITES))
def test_upconv_int8_matches_jax_at_every_site(jax_q, site):
    x8, wk8, ref = jax_q["ups"][site]
    got = TQ.upconv_int8(torch.from_numpy(x8), torch.from_numpy(wk8))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("site,zero_pads", [("e0c1", True), ("e1c2", False),
                                            ("d1c1", True)])
def test_epilogue_matches_jax(jax_q, site, zero_pads):
    """`_epilogue` (and K1's fused plain version, which computes it) on
    JAX's int32 sums: the float32 operations in JAX's order, equal int8."""
    idx = CONV_SITES.index(site)
    x8, w8, _, y32 = jax_q["convs"][idx]
    e_ref = jax_q["q"][site]
    e = quantized_to_torch({site: e_ref}, device="cpu")[site]
    ref = np.asarray(JQ._epilogue(jnp.asarray(y32), e_ref,
                                  zero_pads=zero_pads))
    got = TQ._epilogue(torch.from_numpy(y32), e, zero_pads=zero_pads)
    np.testing.assert_array_equal(got.numpy(), ref)
    fused = K.conv2_packed_s8(torch.from_numpy(x8), torch.from_numpy(w8),
                              pad=int(zero_pads), dq=e["dq"], bias=e["b"],
                              alpha=e["alpha"], rq=e["rq"])
    np.testing.assert_array_equal(fused.numpy(), ref)


def test_fused_addend_matches_jax_decoder_sum(jax_q):
    """K1's fused addend: `(y_s * dq + y_u) + b`, PReLU, pads zeroed,
    requantized, as `_trunk_q`'s decoder conv1 computes it in JAX."""
    x8, w8, _, y32 = jax_q["convs"][CONV_SITES.index("d1c1")]
    e_ref = jax_q["q"]["d1c1"]
    y_u = np.random.default_rng(5).normal(size=y32.shape).astype(np.float32)
    y = jnp.asarray(y32).astype(jnp.float32) * e_ref["dq"] + y_u
    y = JP.zero_shifted_pads(JQ.F.prelu(y + e_ref["b"], e_ref["alpha"]))
    ref = np.asarray(JQ._requant(y, e_ref["rq"]))
    e = quantized_to_torch({"d1c1": e_ref}, device="cpu")["d1c1"]
    got = K.conv2_packed_s8(torch.from_numpy(x8), torch.from_numpy(w8),
                            pad=1, dq=e["dq"], bias=e["b"], alpha=e["alpha"],
                            rq=e["rq"], addend=torch.from_numpy(y_u))
    np.testing.assert_array_equal(got.numpy(), ref)


# ---------------------------------------------------------------------------
# the int8 forward
# ---------------------------------------------------------------------------


def test_int8_forward_matches_jax_on_bridged_weights(jax_q):
    q = quantized_to_torch(jax_q["q"], device="cpu")
    x = torch.from_numpy(jax_q["x"])
    with torch.no_grad():
        logits = TQ.packed_unet_apply_v2_int8(q, x).numpy()
        mask = TQ.packed_unet_mask_v2_int8(q, x)
    ref = jax_q["logits"]
    assert logits.shape == ref.shape
    assert np.abs(logits - ref).max() <= LOGIT_TOL * np.abs(ref).max()
    assert mask.dtype == torch.int32
    assert (mask.numpy() == jax_q["mask"]).mean() >= MASK_AGREEMENT


def test_int8_matches_own_float_forward_at_jax_gates():
    """JAX's quality gates (tests/test_quant.py:63-73) on the port alone:
    a JAX-initialised UNet3D, 32^3, batch 2: int8 logits against the
    float packed forward, NRMSE < 0.02, mask agreement > 0.995."""
    model = JaxUNet3D(in_channels=1, out_classes=2, num_encoding_blocks=3,
                      out_channels_first_layer=8)
    variables = jax.jit(model.init)(jax.random.key(0),
                                    jnp.zeros((1, 16, 16, 16, 1)))
    sd = variables_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                        variables),
                                 device="cpu")
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, 32, 32, 32, 1)).astype(np.float32))
    with torch.no_grad():
        ref = TU.packed_unet_apply_v2(TU.fold_bn_inference(sd), x).numpy()
        q = TQ.quantize_inference(sd, x)
        out = TQ.packed_unet_apply_v2_int8(q, x).numpy()
        mask = TQ.packed_unet_mask_v2_int8(q, x).numpy()
    nrmse = np.sqrt(((out - ref) ** 2).mean()) / ref.std()
    assert nrmse < 0.02, nrmse
    assert (mask == ref.argmax(-1)).mean() > 0.995


def test_quantize_accepts_folded_and_live_bn(jax_q):
    sd = variables_to_state_dict(jax_q["variables"], device="cpu")
    x = torch.from_numpy(jax_q["x"])
    with torch.no_grad():
        a = TQ.packed_unet_apply_v2_int8(TQ.quantize_inference(sd, x), x)
        b = TQ.packed_unet_apply_v2_int8(
            TQ.quantize_inference(TU.fold_bn_inference(sd), x), x)
    torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


def test_int8_serves_through_segment_volumes(jax_q):
    """`segment_volumes(mask_fn=packed_unet_mask_v2_int8)` streams the int8
    masks, equal to the direct call, with no new argument."""
    q = quantized_to_torch(jax_q["q"], device="cpu")
    vols = [v[..., 0] for v in jax_q["x"]]
    outs = list(segment_volumes(None, q, vols, batch_size=2,
                                dtype=torch.float32, device="cpu",
                                mask_fn=TQ.packed_unet_mask_v2_int8,
                                pack_masks=True))
    with torch.no_grad():
        ref = TQ.packed_unet_mask_v2_int8(q, torch.from_numpy(jax_q["x"]))
    np.testing.assert_array_equal(np.stack([o["mask"] for o in outs]),
                                  ref.numpy().astype(np.uint8))


def test_quantized_to_torch_layout(jax_q):
    q = quantized_to_torch(jax_q["q"], device="cpu")
    ref = jax_q["q"]
    assert q["nb"] == 3 and isinstance(q["nb"], int)
    e, e_ref = q["d0c1"], ref["d0c1"]
    assert e["w8"].dtype == e["w8_u"].dtype == torch.int8
    assert tuple(e["w8_u"].shape) == e_ref["w8_u"].shape
    np.testing.assert_array_equal(e["w8"].numpy(), e_ref["w8"])
    np.testing.assert_array_equal(e["w_u_fine"].numpy(),
                                  e_ref["w_u_fine"].transpose(4, 3, 0, 1, 2))
    np.testing.assert_array_equal(q["head"]["w8"].numpy(),
                                  ref["head"]["w8"])


# ---------------------------------------------------------------------------
# K1 and K2: plain versions, plans and index math
# ---------------------------------------------------------------------------


def _int8(rng, shape):
    return rng.integers(-127, 128, size=shape).astype(np.int8)


@pytest.mark.parametrize("pad", [0, 1])
@pytest.mark.parametrize("c8i", [8, 16, 40])
def test_conv2_s8_kernel_walk_matches_jax(pad, c8i):
    """K1's K loop walked with torch exactly as the kernel walks it:
    32-byte K steps of four 8-byte groups over the K-major weights
    (`s8_kmajor_weights`), each group one tap (k // 8Ci) and 8 channels,
    zero past K and outside the input; and the plain version: both equal
    to JAX's `conv_int8`."""
    rng = np.random.default_rng(c8i + pad)
    x8 = _int8(rng, (2, 4, 3, 5, c8i))
    w8 = _int8(rng, (2, 2, 2, c8i, 24))
    ref = np.asarray(JQ.conv_int8(jnp.asarray(x8), jnp.asarray(w8),
                                  [(1, 1)] * 3 if pad else "VALID"))
    wk = K.s8_kmajor_weights(torch.from_numpy(w8)).long()
    xp = torch.from_numpy(x8).long()
    if pad:
        xp = torch.nn.functional.pad(xp, (0, 0) + (1, 1) * 3)
    do, ho, wo = (s - 1 for s in xp.shape[1:4])
    out = torch.zeros((2, do, ho, wo, 24), dtype=torch.int64)
    kk = wk.shape[1]
    for step in range(-(-kk // K._S8_K_STEP)):
        for grp in range(K._S8_K_STEP // K._S8_GROUP):
            k = step * K._S8_K_STEP + grp * K._S8_GROUP
            if k >= kk:
                continue
            tap, ci = divmod(k, c8i)
            qd, qh, qw = tap >> 2, (tap >> 1) & 1, tap & 1
            sl = xp[:, qd:qd + do, qh:qh + ho, qw:qw + wo, ci:ci + 8]
            out += torch.einsum("ndhwc,oc->ndhwo", sl, wk[:, k:k + 8])
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(
        K.conv2_packed_s8(torch.from_numpy(x8), torch.from_numpy(w8),
                          pad=pad).numpy(), ref)


@pytest.mark.parametrize("shape,c8i", [((2, 3, 4, 2), 16), ((1, 2, 2, 2), 8),
                                       ((1, 3, 2, 3), 24)])
def test_upconv_s8_plan_walk_matches_jax(shape, c8i):
    """K2's parity classes walked with torch (`upconv_s8_plan`, the
    concatenated tap-major class weights of `upconv_s8_weights`, tap t of
    class c at row block (tap0 + t) x 8Co, input cell p + j), written to
    the output cells 2p + r; and the plain version: both equal to JAX's
    `upconv_int8`.  (`tests/test_torch_s8_tc.py` walks the kernel's tiles
    and K steps.)"""
    rng = np.random.default_rng(c8i)
    x8 = _int8(rng, shape + (c8i,))
    wk8 = _int8(rng, (5, 5, 5, c8i, 16))
    ref = np.asarray(JQ.upconv_int8(jnp.asarray(x8), jnp.asarray(wk8)))
    xe = TP.edge_pad_cells(torch.from_numpy(x8))
    plan = K.upconv_s8_plan(tuple(xe.shape[1:4]), c8i, 16)
    w = K.upconv_s8_weights(torch.from_numpy(wk8), plan)
    assert w.numel() == sum(16 * c.k for c in plan)
    w = w.reshape(-1, 16, c8i).long()
    out = torch.full(ref.shape, -2 ** 40, dtype=torch.int64)
    xl = xe.long()
    for cls in plan:
        assert cls.w_offset == cls.tap0 * 16 * c8i
        cd, ch, cw = cls.cells
        acc = torch.zeros((xe.shape[0], cd, ch, cw, 16), dtype=torch.int64)
        t = 0
        for jd in range(cls.taps[0]):
            for jh in range(cls.taps[1]):
                for jw in range(cls.taps[2]):
                    sl = xl[:, jd:jd + cd, jh:jh + ch, jw:jw + cw]
                    acc += torch.einsum("ndhwc,oc->ndhwo", sl,
                                        w[cls.tap0 + t])
                    t += 1
        out[:, cls.r[0]::2, cls.r[1]::2, cls.r[2]::2] = acc
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(
        K.upconv_packed_s8(xe, torch.from_numpy(wk8)).numpy(), ref)


@pytest.mark.parametrize("sc", [3, 24, 48])
def test_upconv_s8_plan_partitions_the_output(sc):
    """The 8 classes' rows tile the (2Sc+1)^3 output exactly once; each
    cell meets 2 or 3 taps per axis, 125 over the classes' tap boxes and
    ((2 (Sc+1) + 3 Sc) / (2 Sc + 1))^3 a cell (2.5^3 as Sc grows); the
    weights' offsets follow each other."""
    plan = K.upconv_s8_plan((sc + 2,) * 3, 256, 128)
    cells = sum(np.prod(c.cells) for c in plan)
    assert cells == (2 * sc + 1) ** 3
    assert sum(np.prod(c.taps) for c in plan) == 125
    # per axis, Sc + 1 even cells of 2 taps and Sc odd ones of 3
    per_axis = (2 * (sc + 1) + 3 * sc) / (2 * sc + 1)
    taps_per_cell = sum(np.prod(c.cells) * np.prod(c.taps)
                        for c in plan) / cells
    assert abs(taps_per_cell - per_axis ** 3) < 1e-9
    seen = np.zeros((2 * sc + 1,) * 3, np.int32)
    for c in plan:
        seen[c.r[0]::2, c.r[1]::2, c.r[2]::2] += 1
        assert tuple(len(range(r, 2 * sc + 1, 2)) for r in c.r) == c.cells
        for kd, kh, kw in c.kernel_index:
            assert all((k - r) % 2 == 1 for k, r in zip((kd, kh, kw), c.r))
    assert (seen == 1).all()
    offsets = [c.w_offset for c in plan]
    assert offsets == list(np.cumsum([0] + [128 * c.k for c in plan])[:-1])
    assert [c.tap0 for c in plan] == list(
        np.cumsum([0] + [np.prod(c.taps) for c in plan])[:-1])


def test_s8_wrappers_refuse_wrong_inputs():
    x8 = torch.zeros((1, 3, 3, 3, 8), dtype=torch.int8)
    with pytest.raises(TypeError):
        K.conv2_packed_s8(x8.float(), torch.zeros((2, 2, 2, 8, 8)), pad=0)
    with pytest.raises(ValueError, match="rq"):
        K.conv2_packed_s8(x8, torch.zeros((2, 2, 2, 8, 8), dtype=torch.int8),
                          pad=0, dq=torch.ones(8))
    with pytest.raises(ValueError):
        K.upconv_packed_s8(x8, torch.zeros((3, 3, 3, 8, 8),
                                           dtype=torch.int8))

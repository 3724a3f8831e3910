"""Kernel B1's tensor-core route (`csrc/conv2_packed_tc.cu`), checked on
the CPU through what the wrapper computes in Python: the route of every
call, the tile plan, and the K-major weight layout.

The kernel itself runs only on the card (`tests/test_torch_cuda.py`,
`chip_smoke.py`).  Here the tile plan is walked with torch slicing, the
way the kernel's TMA boxes walk it, and held to `conv2_packed_plain`.
Inputs and weights are small integers in float32, so every product and
sum is exact in any order and the walk must equal the plain version
bit for bit (tolerance 0)."""
import numpy as np
import pytest
import torch

from mri_epilepsy_diagnosis_torch.models import UNet3D
from mri_epilepsy_diagnosis_torch.models import unet_packed as TU
from mri_epilepsy_diagnosis_torch.ops import cuda_kernels as K

torch.set_num_threads(2)

# the 12 B1 sites of the served UNet3D (out_channels_first_layer 8, 3
# encoding blocks), in call order, and the route each takes in bf16
SITES = ("e0c1", "e0c2", "e1c1", "e1c2", "bc1", "bc2", "d0c1.skip",
         "d0c1.up", "d0c2", "d1c1.skip", "d1c1.up", "d1c2")
BF16_ROUTES = ("cuda_core",) + ("tc",) * 11

# (N, D, H, W) of x, ragged against every box; the last gives M below
# one 128-row tile
SHAPES = ((2, 7, 6, 9), (1, 13, 5, 17), (1, 2, 3, 4))


def _int_tensor(rng, shape, lo=-3, hi=4):
    return torch.from_numpy(rng.integers(lo, hi, size=shape)).float()


@pytest.fixture(scope="module")
def served_sites():
    """(8Ci, 8Co, pad) of every B1 launch of one packed forward: the
    conv2_packed calls and the conv2_packed_as_bn_act calls (pad 1, B2
    fused), in call order."""
    torch.manual_seed(0)
    model = UNet3D(out_classes=2, num_encoding_blocks=3,
                   out_channels_first_layer=8, device="cpu").eval()
    params = TU.fold_bn_inference(model.state_dict())
    sites, conv, fused = [], K.conv2_packed, K.conv2_packed_as_bn_act

    def record(x, wp, bias=None, *, pad=0):
        sites.append((x.shape[4], wp.shape[4], pad))
        return conv(x, wp, bias, pad=pad)

    def record_fused(x, wp, *args, **kw):
        sites.append((x.shape[4], wp.shape[4], 1))
        return fused(x, wp, *args, **kw)

    K.conv2_packed, K.conv2_packed_as_bn_act = record, record_fused
    try:
        with torch.no_grad():
            TU.packed_unet_mask_v2(params, torch.zeros(1, 16, 16, 16, 1))
    finally:
        K.conv2_packed, K.conv2_packed_as_bn_act = conv, fused
    return sites


@pytest.mark.parametrize("i", range(len(SITES)), ids=SITES)
def test_served_site_routes(served_sites, i):
    assert len(served_sites) == len(SITES)
    c8i, c8o, _ = served_sites[i]
    assert K._conv2_route(torch.bfloat16, c8i, c8o) == BF16_ROUTES[i]
    assert K._conv2_route(torch.float32, c8i, c8o) == "cuda_core"


@pytest.mark.parametrize("dtype,c8i,c8o,route", [
    (torch.bfloat16, 64, 64, "tc"), (torch.bfloat16, 512, 256, "tc"),
    (torch.bfloat16, 8, 64, "cuda_core"), (torch.bfloat16, 256, 96,
                                           "cuda_core"),
    (torch.bfloat16, 96, 128, "cuda_core"), (torch.float32, 64, 64,
                                             "cuda_core")])
def test_route_rule(dtype, c8i, c8o, route):
    assert K._conv2_route(dtype, c8i, c8o) == route


@pytest.mark.parametrize("extent,box,waste", [
    ((96, 96, 96), (32, 4, 1), 0.0), ((97, 97, 97), (14, 9, 1), 0.0454),
    ((48, 48, 48), (16, 8, 1), 0.0), ((49, 49, 49), (25, 5, 1), 0.0621),
    ((24, 24, 24), (8, 8, 2), 0.0), ((25, 25, 25), (25, 5, 1), 0.0234)])
def test_plan_at_served_extents(extent, box, waste):
    """The boxes of the served output extents (D, H, W) and the share of
    tile rows they leave unstored (to 1e-4)."""
    plan = K.conv2_tc_plan(8, *extent, 128, pad=1)
    assert plan.box == box
    assert np.prod(plan.box) <= 128
    assert plan.waste == pytest.approx(waste, abs=1e-4)
    assert plan.grid == 8 * int(np.prod(plan.tiles))


@pytest.mark.parametrize("c8o,bn", [(64, 64), (128, 128), (256, 256),
                                    (512, 256), (192, 64), (384, 128)])
def test_plan_n_tile(c8o, bn):
    plan = K.conv2_tc_plan(2, 5, 6, 7, c8o, pad=0)
    assert plan.bn == bn
    assert plan.grid == 2 * int(np.prod(plan.tiles)) * (c8o // bn)


def _walk_plan(x, wk, bias, pad):
    """The tensor-core kernel's computation in torch: per tile, per tap and
    per 64-channel K step, the input box at the tile origin + the tap
    offset (zero outside x) times the K-major weight slice, summed in
    float32; the cells inside the output are stored.  Also returns how
    often each output cell was stored."""
    n, di, hi, wi, c8i = x.shape
    c8o = wk.shape[1]
    step = 1 if pad else -1
    do, ho, wo = di + step, hi + step, wi + step
    plan = K.conv2_tc_plan(n, do, ho, wo, c8o, pad)
    bw, bh, bd = plan.box
    tw, th, td = plan.tiles
    out = torch.zeros(n, do, ho, wo, c8o)
    stores = torch.zeros(n, do, ho, wo, dtype=torch.int64)
    # x with a zero margin wide enough for any box at any offset
    mz, my, mx = bd + 1, bh + 1, bw + 1
    xz = torch.zeros(n, di + 2 * mz, hi + 2 * my, wi + 2 * mx, c8i)
    xz[:, mz:mz + di, my:my + hi, mx:mx + wi] = x
    for b in range(n):
        for tz in range(td):
            for ty in range(th):
                for tx in range(tw):
                    z0, y0, x0 = tz * bd, ty * bh, tx * bw
                    for n0 in range(0, c8o, plan.bn):
                        acc = torch.zeros(bd, bh, bw, plan.bn)
                        for tap, (dz, dy, dx) in enumerate(plan.tap_offsets):
                            box = xz[b, mz + z0 + dz:mz + z0 + dz + bd,
                                     my + y0 + dy:my + y0 + dy + bh,
                                     mx + x0 + dx:mx + x0 + dx + bw]
                            for c0 in range(0, c8i, 64):
                                acc += box[..., c0:c0 + 64] @ wk[
                                    tap, n0:n0 + plan.bn, c0:c0 + 64].T
                        if bias is not None:
                            acc += bias[n0:n0 + plan.bn]
                        ez, ey, ex = (min(bd, do - z0), min(bh, ho - y0),
                                      min(bw, wo - x0))
                        out[b, z0:z0 + ez, y0:y0 + ey, x0:x0 + ex,
                            n0:n0 + plan.bn] = acc[:ez, :ey, :ex]
                        if n0 == 0:
                            stores[b, z0:z0 + ez, y0:y0 + ey,
                                   x0:x0 + ex] += 1
    return out, stores


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("pad", [0, 1])
@pytest.mark.parametrize("c8i,c8o", [(64, 64), (128, 192)])
def test_tile_plan_walk_equals_plain(shape, pad, c8i, c8o):
    """Walking the tile plan covers every output cell exactly once and
    reproduces conv2_packed_plain exactly (integer-valued float32)."""
    rng = np.random.default_rng(sum(shape) * 10 + pad * 1000 + c8i)
    x = _int_tensor(rng, (*shape, c8i))
    wp = _int_tensor(rng, (2, 2, 2, c8i, c8o), -2, 3)
    bias = _int_tensor(rng, (c8o,))
    got, stores = _walk_plan(x, K.kmajor_weights(wp), bias, pad)
    assert torch.equal(stores, torch.ones_like(stores))
    ref = K.conv2_packed_plain(x, wp, bias, pad=pad)
    assert got.shape == ref.shape
    assert torch.equal(got, ref)


@pytest.mark.parametrize("pad", [0, 1])
def test_kmajor_weights_contract_to_plain(pad):
    """The (8 taps, 8Co, 8Ci) re-layout contracted with the 8 shifted
    slices of xin equals conv2_packed_plain, exactly (integer-valued)."""
    rng = np.random.default_rng(7 + pad)
    x = _int_tensor(rng, (2, 4, 5, 3, 64))
    wp = _int_tensor(rng, (2, 2, 2, 64, 128), -2, 3)
    wk = K.kmajor_weights(wp)
    assert wk.shape == (8, 128, 64) and wk.is_contiguous()
    xin = torch.nn.functional.pad(x, (0, 0) + (1, 1) * 3) if pad else x
    d, h, w = (s - 1 for s in xin.shape[1:4])
    got = sum(torch.einsum("nzyxc,oc->nzyxo",
                           xin[:, qd:qd + d, qh:qh + h, qw:qw + w],
                           wk[4 * qd + 2 * qh + qw])
              for qd in range(2) for qh in range(2) for qw in range(2))
    assert torch.equal(got, K.conv2_packed_plain(x, wp, pad=pad))


def test_cpu_call_takes_plain_version_and_counts_nothing():
    rng = np.random.default_rng(11)
    x = _int_tensor(rng, (1, 3, 3, 3, 64)).to(torch.bfloat16)
    wp = _int_tensor(rng, (2, 2, 2, 64, 64)).to(torch.bfloat16)
    before = (K.conv2_packed.launches, K.conv2_packed.tc_launches)
    got = K.conv2_packed(x, wp, pad=1)
    assert (K.conv2_packed.launches, K.conv2_packed.tc_launches) == before
    assert torch.equal(got, K.conv2_packed_plain(x, wp, pad=1))


def test_reset_launch_counts_resets_tc_count():
    K.conv2_packed.tc_launches = 3
    K.conv2_packed.launches = 5
    K.reset_launch_counts()
    assert K.conv2_packed.launches == 0 and K.conv2_packed.tc_launches == 0

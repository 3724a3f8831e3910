"""K1's and K2's wgmma route (`csrc/s8_wgmma.cuh`: `conv2_packed_s8_tc.cu`,
`upconv_packed_s8.cu`), checked on the CPU through what the wrappers
compute in Python: the route of every served K1 site, the K step, the
tile plans and K2's work list.

The kernels themselves run only on the card (`tests/test_torch_cuda.py`,
`chip_smoke.py`).  Here both plans are walked with torch slicing the way
the kernels' TMA boxes walk them, tile by tile and K step by K step, in
int64, and held bit for bit (tolerance 0) to `conv2_packed_s8_plain` and
`upconv_packed_s8_plain`, K1's fused epilogue included: the walk applies
it per tile in float32 with the kernel's pad-drop bits."""
import math

import numpy as np
import pytest
import torch

from mri_epilepsy_diagnosis_torch.models import UNet3D
from mri_epilepsy_diagnosis_torch.models import unet_packed_q as Q
from mri_epilepsy_diagnosis_torch.ops import cuda_kernels as K
from mri_epilepsy_diagnosis_torch.ops import packed as P

torch.set_num_threads(2)

# the 10 K1 sites of the served int8 UNet3D (out_channels_first_layer 8,
# 3 encoding blocks) in call order: (8Ci, 8Co, pad, addend), and the
# route each takes; the 2 K2 sites: (8Ci, 8Co)
K1_SITES = ("e0c1", "e0c2", "e1c1", "e1c2", "bc1", "bc2", "d0c1", "d0c2",
            "d1c1", "d1c2")
K1_SHAPES = ((8, 64, 1, False), (64, 128, 0, False), (128, 128, 1, False),
             (128, 256, 0, False), (256, 256, 1, False),
             (256, 512, 0, False), (256, 256, 1, True), (256, 256, 0, False),
             (128, 128, 1, True), (128, 128, 0, False))
K1_ROUTES = ("mma_sync",) + ("wgmma",) * 9
K2_SHAPES = ((512, 256), (256, 128))

# K1 at 192^3, batch 8: the output extent of each wgmma site, its box,
# N tile and tiles (grid)
K1_PLANS = {
    "e0c2": (96, (32, 4, 1), 128, 8 * 3 * 24 * 96),
    "e1c1": (49, (25, 5, 1), 128, 8 * 2 * 10 * 49),
    "e1c2": (48, (16, 8, 1), 256, 8 * 3 * 6 * 48),
    "bc1": (25, (25, 5, 1), 256, 8 * 1 * 5 * 25),
    "bc2": (24, (8, 8, 2), 256, 8 * 3 * 3 * 12 * 2),
    "d0c1": (49, (25, 5, 1), 256, 8 * 2 * 10 * 49),
    "d0c2": (48, (16, 8, 1), 256, 8 * 3 * 6 * 48),
    "d1c1": (97, (14, 9, 1), 128, 8 * 7 * 11 * 97),
    "d1c2": (96, (32, 4, 1), 128, 8 * 3 * 24 * 96),
}


def _int8(rng, shape):
    return torch.from_numpy(rng.integers(-127, 128, size=shape)
                            .astype(np.int8))


@pytest.fixture(scope="module")
def served_s8_calls():
    """The K1 and K2 calls of one int8 forward of the served UNet3D at
    16^3 (the widths do not depend on the size), with their arguments."""
    torch.manual_seed(0)
    model = UNet3D(out_classes=2, num_encoding_blocks=3,
                   out_channels_first_layer=8, device="cpu").eval()
    x = torch.randn((1, 16, 16, 16, 1),
                    generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        q = Q.quantize_inference(model.state_dict(), x)
    calls = {"k1": [], "k2": []}
    k1, k2 = K.conv2_packed_s8, K.upconv_packed_s8

    def rec1(x8, wp8, **kw):
        calls["k1"].append((x8, wp8, kw))
        return k1(x8, wp8, **kw)

    def rec2(xe8, wk8):
        calls["k2"].append((xe8, wk8))
        return k2(xe8, wk8)

    K.conv2_packed_s8, K.upconv_packed_s8 = rec1, rec2
    try:
        with torch.no_grad():
            Q.packed_unet_mask_v2_int8(q, x)
    finally:
        K.conv2_packed_s8, K.upconv_packed_s8 = k1, k2
    return calls


@pytest.mark.parametrize("i", range(len(K1_SITES)), ids=K1_SITES)
def test_served_k1_site_routes(served_s8_calls, i):
    """Every served K1 site: its widths, pad and addend, its route (the
    stem on mma.sync, the others on wgmma) and the tensors the path hands
    it: contiguous (the wrapper raises on a strided tensor on the card)."""
    calls = served_s8_calls["k1"]
    assert len(calls) == len(K1_SITES)
    x8, wp8, kw = calls[i]
    c8i, c8o, pad, addend = K1_SHAPES[i]
    assert (x8.shape[4], wp8.shape[4], kw["pad"]) == (c8i, c8o, pad)
    assert (kw.get("addend") is not None) == addend
    assert kw.get("dq") is not None
    assert K._conv2_s8_route(c8i, c8o) == K1_ROUTES[i]
    assert x8.is_contiguous()
    if addend:
        assert kw["addend"].is_contiguous()


@pytest.mark.parametrize("i", range(len(K2_SHAPES)), ids=("d0", "d1"))
def test_served_k2_sites_take_the_wgmma_kernel(served_s8_calls, i):
    calls = served_s8_calls["k2"]
    assert len(calls) == len(K2_SHAPES)
    xe8, wk8 = calls[i]
    assert (xe8.shape[4], wk8.shape[4]) == K2_SHAPES[i]
    assert all(c % K._S8_TC_ALIGN == 0 for c in K2_SHAPES[i])
    assert xe8.is_contiguous()


@pytest.mark.parametrize("c8i,c8o,route", [
    (8, 64, "mma_sync"), (64, 64, "wgmma"), (64, 128, "wgmma"),
    (512, 512, "wgmma"), (40, 24, "mma_sync"), (256, 96, "mma_sync"),
    (96, 128, "mma_sync"), (192, 64, "wgmma")])
def test_k1_route_rule(c8i, c8o, route):
    assert K._conv2_s8_route(c8i, c8o) == route


@pytest.mark.parametrize("c8i,kb", [(64, 64), (128, 128), (256, 128),
                                    (512, 128), (192, 64), (384, 128)])
def test_k_step_per_c8i(c8i, kb):
    """64-byte K steps (64-byte swizzle) at 8Ci = 64 and wherever 128 does
    not divide 8Ci, one 128-byte row of one tap above."""
    assert K.s8_k_step(c8i) == kb
    assert c8i % kb == 0


@pytest.mark.parametrize("site", list(K1_PLANS))
def test_k1_plan_at_served_extents(site):
    """B1's plan serves K1's wgmma sites at 192^3, batch 8: the box, the
    N tile (the whole 8Co up to 256; two tiles at bc2) and the grid."""
    i = K1_SITES.index(site)
    c8i, c8o, pad, _ = K1_SHAPES[i]
    extent, box, bn, grid = K1_PLANS[site]
    plan = K.conv2_tc_plan(8, extent, extent, extent, c8o, pad)
    assert (plan.box, plan.bn, plan.grid) == (box, bn, grid)
    assert math.prod(plan.box) <= 128
    assert c8o // plan.bn == (2 if site == "bc2" else 1)


@pytest.mark.parametrize("site,padded,c8i,c8o", [
    ("d0", 26, 512, 256), ("d1", 50, 256, 128)])
def test_k2_plan_at_served_extents(site, padded, c8i, c8o):
    """K2's plan at 192^3, batch 8: one box (that of the largest class
    grid) for every class, the whole 8Co as the N tile, 128-byte K steps,
    classes heaviest first, and the items of each class."""
    plan = K.upconv_s8_tc_plan(8, (padded,) * 3, c8i, c8o)
    assert plan.box == K._tc_box(*(padded - 1,) * 3) == (25, 5, 1)
    assert (plan.bn, plan.kb) == (c8o, 128)
    assert plan.order == (7, 3, 5, 6, 1, 2, 4, 0)
    taps = [math.prod(plan.classes[c].taps) for c in plan.order]
    assert taps == [27, 18, 18, 18, 12, 12, 12, 8]
    for c, cls in enumerate(plan.classes):
        tw, th, td = plan.tiles[c]
        assert (tw * 25 >= cls.cells[2] > (tw - 1) * 25
                and th * 5 >= cls.cells[1] > (th - 1) * 5
                and td == cls.cells[0])
        assert plan.items[c] == 8 * tw * th * td
        assert cls.w_offset == cls.tap0 * c8o * c8i
        assert cls.w_offset % 16 == 0


@pytest.mark.parametrize("n,cells,c8o", [(1, (25, 25, 25), 256),
                                         (2, (4, 7, 5), 512),
                                         (1, (3, 3, 3), 192)])
def test_k2_work_covers_every_output_cell_once_heaviest_first(n, cells,
                                                             c8o):
    """Walking K2's work items, every output cell of every class is stored
    exactly once per N tile, and the items run heaviest class first."""
    padded = tuple(c + 2 for c in cells)
    plan = K.upconv_s8_tc_plan(n, padded, 256, c8o)
    bw, bh, bd = plan.box
    out = tuple(2 * c + 1 for c in cells)
    stores = np.zeros((n, *out, c8o // plan.bn), np.int32)
    taps = []
    for c, b, (tz, ty, tx), n0 in K.upconv_s8_work(plan, n):
        cls = plan.classes[c]
        taps.append(math.prod(cls.taps))
        pd, ph, pw = cls.cells
        z, y, x = tz * bd, ty * bh, tx * bw
        ez, ey, ex = min(bd, pd - z), min(bh, ph - y), min(bw, pw - x)
        assert min(ez, ey, ex) > 0
        rd, rh, rw = cls.r
        stores[b, rd + 2 * z:rd + 2 * (z + ez):2,
               rh + 2 * y:rh + 2 * (y + ey):2,
               rw + 2 * x:rw + 2 * (x + ex):2, n0 // plan.bn] += 1
    assert (stores == 1).all()
    assert len(taps) == sum(plan.items)
    assert taps == sorted(taps, reverse=True)


def _shifted_drop(od, oh, ow, do, ho, wo):
    """The kernels' pad-voxel bits (`common.cuh::shifted_drop`) of output
    cell (od, oh, ow): bit s set where packed sub s is a pad voxel."""
    d = 0xF0 if od == do - 1 else 0x0F if od == 0 else 0
    h = 0xCC if oh == ho - 1 else 0x33 if oh == 0 else 0
    w = 0xAA if ow == wo - 1 else 0x55 if ow == 0 else 0
    return d | h | w


def _epilogue_tile(acc, cells, extent, n0, c8o, pad, epi, addend):
    """K1's fused store on one tile as the kernel computes it: float32
    operations in JAX's order, then the drop bits of each output cell and
    the column's sub, rint half to even, the clip, int8."""
    dq, bias, alpha, rq = epi
    bn = acc.shape[-1]
    cols = slice(n0, n0 + bn)
    y = acc.to(torch.int32).float() * dq[cols]
    if addend is not None:
        y = y + addend
    y = y + bias[cols]
    y = torch.where(y >= 0, y, y * alpha[cols])
    if pad == 1:
        sub = torch.arange(n0, n0 + bn) // (c8o // 8)
        for (iz, iy, ix), (od, oh, ow) in cells:
            bits = _shifted_drop(od, oh, ow, *extent)
            y[iz, iy, ix] = torch.where((bits >> sub) & 1 == 1, 0.0,
                                        y[iz, iy, ix])
    return torch.clamp(torch.round(y * rq[cols]), -127, 127).to(torch.int8)


def _walk_k1(x8, wp8, pad, epi=None, addend=None):
    """K1's wgmma kernel in torch: per tile of `conv2_tc_plan` (box, N
    tile) and per tap, the input box at the tile origin + the tap offset
    (zero outside x, as TMA fills) in K steps of `s8_k_step` bytes times
    the K-major weights (`kmajor_weights`), summed in int64; the store
    (raw, or the fused epilogue) of the cells inside the output.  Also
    returns how often each (cell, N tile) was stored."""
    n, di, hi, wi, c8i = x8.shape
    c8o = wp8.shape[4]
    step = 1 if pad else -1
    ext = (di + step, hi + step, wi + step)
    plan = K.conv2_tc_plan(n, *ext, c8o, pad)
    kb, bn = K.s8_k_step(c8i), plan.bn
    wk = K.kmajor_weights(wp8).long()
    bw, bh, bd = plan.box
    tw, th, td = plan.tiles
    m = (bd + 1, bh + 1, bw + 1)
    xz = torch.zeros((n, di + 2 * m[0], hi + 2 * m[1], wi + 2 * m[2], c8i),
                     dtype=torch.int64)
    xz[:, m[0]:m[0] + di, m[1]:m[1] + hi, m[2]:m[2] + wi] = x8.long()
    out = torch.zeros((n, *ext, c8o),
                      dtype=torch.int32 if epi is None else torch.int8)
    stores = torch.zeros((n, *ext, c8o // bn), dtype=torch.int64)
    for b in range(n):
        for tz in range(td):
            for ty in range(th):
                for tx in range(tw):
                    z0, y0, x0 = tz * bd, ty * bh, tx * bw
                    ez, ey, ex = (min(bd, ext[0] - z0), min(bh, ext[1] - y0),
                                  min(bw, ext[2] - x0))
                    for n0 in range(0, c8o, bn):
                        acc = torch.zeros((bd, bh, bw, bn), dtype=torch.int64)
                        for tap, (dz, dy, dx) in enumerate(plan.tap_offsets):
                            z, y, x = (m[0] + z0 + dz, m[1] + y0 + dy,
                                       m[2] + x0 + dx)
                            box = xz[b, z:z + bd, y:y + bh, x:x + bw]
                            for c0 in range(0, c8i, kb):
                                acc += torch.einsum(
                                    "zyxc,oc->zyxo", box[..., c0:c0 + kb],
                                    wk[tap, n0:n0 + bn, c0:c0 + kb])
                        acc = acc[:ez, :ey, :ex]
                        sl = (b, slice(z0, z0 + ez), slice(y0, y0 + ey),
                              slice(x0, x0 + ex))
                        if epi is None:
                            vals = acc.to(torch.int32)
                        else:
                            cells = [((iz, iy, ix),
                                      (z0 + iz, y0 + iy, x0 + ix))
                                     for iz in range(ez) for iy in range(ey)
                                     for ix in range(ex)]
                            vals = _epilogue_tile(
                                acc, cells, ext, n0, c8o, pad, epi,
                                None if addend is None
                                else addend[sl][..., n0:n0 + bn])
                        out[sl + (slice(n0, n0 + bn),)] = vals
                        stores[sl + (n0 // bn,)] += 1
    return out, stores


@pytest.mark.parametrize("c8i,c8o,shape", [
    (64, 128, (2, 3, 4, 5)), (128, 64, (1, 5, 2, 3)),
    (256, 512, (1, 2, 3, 4)), (512, 192, (1, 3, 2, 2))])
@pytest.mark.parametrize("pad", [0, 1])
def test_k1_walk_raw_equals_plain(c8i, c8o, shape, pad):
    """The walk of K1's tile plan covers every output cell once per N
    tile and gives the plain version's int32 sums exactly."""
    rng = np.random.default_rng(c8i + c8o + pad)
    x8 = _int8(rng, (*shape, c8i))
    wp8 = _int8(rng, (2, 2, 2, c8i, c8o))
    got, stores = _walk_k1(x8, wp8, pad)
    assert (stores == 1).all()
    assert torch.equal(got, K.conv2_packed_s8_plain(x8, wp8, pad=pad))
    assert torch.equal(got, K.conv2_packed_s8(x8, wp8, pad=pad))


@pytest.mark.parametrize("c8i,c8o,shape", [
    (64, 128, (1, 4, 3, 5)), (128, 128, (2, 2, 3, 3)),
    (256, 256, (1, 3, 2, 4)), (512, 64, (1, 2, 2, 3))])
@pytest.mark.parametrize("pad", [0, 1])
@pytest.mark.parametrize("addend", [False, True])
def test_k1_walk_fused_equals_plain(c8i, c8o, shape, pad, addend):
    """The walk with K1's fused epilogue (dequantization, the float32
    addend, bias, PReLU, the shifted pad drop by the kernel's bits,
    requantization) equals the plain version's int8 exactly; scales are
    drawn so that values saturate."""
    rng = np.random.default_rng(7 * c8i + c8o + pad + 100 * addend)
    x8 = _int8(rng, (*shape, c8i))
    wp8 = _int8(rng, (2, 2, 2, c8i, c8o))
    g = torch.Generator().manual_seed(c8i + pad)
    dq = torch.rand(c8o, generator=g) * 1e-4
    bias = torch.randn(c8o, generator=g)
    alpha = torch.rand(c8o, generator=g)
    rq = 10 + 50 * torch.rand(c8o, generator=g)
    step = 1 if pad else -1
    out_shape = (shape[0], *(s + step for s in shape[1:]), c8o)
    add = torch.randn(out_shape, generator=g) if addend else None
    got, stores = _walk_k1(x8, wp8, pad, (dq, bias, alpha, rq), add)
    assert (stores == 1).all()
    kw = dict(pad=pad, dq=dq, bias=bias, alpha=alpha, rq=rq, addend=add)
    ref = K.conv2_packed_s8_plain(x8, wp8, **kw)
    assert torch.equal(got, ref)
    assert torch.equal(got, K.conv2_packed_s8(x8, wp8, **kw))
    assert (ref.abs() == 127).any()
    if pad:
        assert (ref == 0).any()


def _walk_k2(xe8, wk8):
    """K2's kernel in torch: per work item of `upconv_s8_tc_plan` (class,
    batch item, box, N tile), per tap j of the class, the box of xe at the
    tile origin + j (zero past xe, as TMA fills) in K steps of `s8_k_step`
    bytes times the class's tap-major weights (`upconv_s8_weights`, rows
    (tap0 + t) x 8Co), summed in int64; the rows inside the class grid
    stored to output cells 2p + r.  Also returns the store counts."""
    n, dp, hp, wp, c8i = xe8.shape
    c8o = wk8.shape[4]
    plan = K.upconv_s8_tc_plan(n, (dp, hp, wp), c8i, c8o)
    w = K.upconv_s8_weights(wk8, plan.classes).long().reshape(-1, c8o, c8i)
    assert w.shape[0] == 125
    bw, bh, bd = plan.box
    bn, kb = plan.bn, plan.kb
    xz = torch.zeros((n, dp + bd + 2, hp + bh + 2, wp + bw + 2, c8i),
                     dtype=torch.int64)
    xz[:, :dp, :hp, :wp] = xe8.long()
    ext = (2 * dp - 3, 2 * hp - 3, 2 * wp - 3)
    out = torch.zeros((n, *ext, c8o), dtype=torch.int32)
    stores = torch.zeros((n, *ext, c8o // bn), dtype=torch.int64)
    for c, b, (tz, ty, tx), n0 in K.upconv_s8_work(plan, n):
        cls = plan.classes[c]
        z0, y0, x0 = tz * bd, ty * bh, tx * bw
        acc = torch.zeros((bd, bh, bw, bn), dtype=torch.int64)
        t = 0
        for jd in range(cls.taps[0]):
            for jh in range(cls.taps[1]):
                for jw in range(cls.taps[2]):
                    box = xz[b, z0 + jd:z0 + jd + bd, y0 + jh:y0 + jh + bh,
                             x0 + jw:x0 + jw + bw]
                    for c0 in range(0, c8i, kb):
                        acc += torch.einsum(
                            "zyxc,oc->zyxo", box[..., c0:c0 + kb],
                            w[cls.tap0 + t, n0:n0 + bn, c0:c0 + kb])
                    t += 1
        pd, ph, pw = cls.cells
        ez, ey, ex = min(bd, pd - z0), min(bh, ph - y0), min(bw, pw - x0)
        rd, rh, rw = cls.r
        sl = (b, slice(rd + 2 * z0, rd + 2 * (z0 + ez), 2),
              slice(rh + 2 * y0, rh + 2 * (y0 + ey), 2),
              slice(rw + 2 * x0, rw + 2 * (x0 + ex), 2))
        out[sl + (slice(n0, n0 + bn),)] = acc[:ez, :ey, :ex].to(torch.int32)
        stores[sl + (n0 // bn,)] += 1
    return out, stores


@pytest.mark.parametrize("c8i,c8o,cells", [
    (64, 64, (3, 2, 4)), (128, 192, (2, 3, 2)), (256, 128, (4, 3, 3)),
    (512, 512, (2, 2, 3))])
def test_k2_walk_equals_plain(c8i, c8o, cells):
    """The walk of K2's plan at ragged coarse extents stores every output
    cell once per N tile and gives the plain version's int32 exactly."""
    rng = np.random.default_rng(c8i + c8o)
    xe8 = P.edge_pad_cells(_int8(rng, (2, *cells, c8i)))
    wk8 = _int8(rng, (5, 5, 5, c8i, c8o))
    got, stores = _walk_k2(xe8, wk8)
    assert (stores == 1).all()
    ref = K.upconv_packed_s8_plain(xe8, wk8)
    assert torch.equal(got, ref)
    assert torch.equal(got, K.upconv_packed_s8(xe8, wk8))


def test_cpu_calls_count_nothing_and_reset_clears_the_route_count():
    rng = np.random.default_rng(5)
    x8 = _int8(rng, (1, 3, 3, 3, 64))
    wp8 = _int8(rng, (2, 2, 2, 64, 64))
    before = (K.conv2_packed_s8.launches, K.conv2_packed_s8.wgmma_launches)
    K.conv2_packed_s8(x8, wp8, pad=1)
    assert (K.conv2_packed_s8.launches,
            K.conv2_packed_s8.wgmma_launches) == before
    K.conv2_packed_s8.wgmma_launches = 3
    K.reset_launch_counts()
    assert K.conv2_packed_s8.wgmma_launches == 0

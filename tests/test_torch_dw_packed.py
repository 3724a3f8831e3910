"""The packed convs' weight gradient (`ops/cuda_kernels.py::dw_packed`,
reached through `ops/packed.py::_dw_packed_qgroup`) on the CPU: the pad
read from the extents, the plain GEMM route against the function it
replaced, the route choice, the kernel's tile plan at every site of the
benchmark's three cells, and the kernel's walk (its boxes, haloed x
tiles, windows, splits and fold) replayed with torch in float64.  The
kernel itself runs only on the card (`tests/test_torch_cuda.py`)."""
import numpy as np
import pytest
import torch
import torch.nn.functional as TF

from mri_epilepsy_diagnosis_torch.ops import cuda_kernels as K
from mri_epilepsy_diagnosis_torch.ops import packed as TP

torch.set_num_threads(2)


def _dw_before(x_padded, g):
    """`_dw_packed_qgroup` as it was: the 8 window GEMMs over the input
    with its pad already applied (CPU route: float32 operands)."""
    od, oh, ow, c8o = g.shape[1:]
    c8i = x_padded.shape[-1]
    g2 = g.reshape(-1, c8o).float()
    rows = [torch.mm(x_padded[:, qd:qd + od, qh:qh + oh, qw:qw + ow]
                     .reshape(-1, c8i).float().t(), g2)
            for qd in range(2) for qh in range(2) for qw in range(2)]
    return torch.stack(rows).reshape(2, 2, 2, c8i, c8o)


def _operands(n, g_cells, c8i, c8o, pad, dtype=torch.float32, seed=0):
    rng = np.random.default_rng(seed)
    x_cells = [c + 1 - 2 * pad for c in g_cells]
    x = torch.from_numpy(rng.normal(size=(n, *x_cells, c8i)).astype(
        np.float32)).to(dtype)
    g = torch.from_numpy(rng.normal(size=(n, *g_cells, c8o)).astype(
        np.float32)).to(dtype)
    return x, g


# ---------------------------------------------------------------------------
# the pad from the extents, the plain route, the route choice
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("x_cells,g_cells,pad", [
    ((5, 4, 6), (4, 3, 5), 0), ((97, 97, 97), (96, 96, 96), 0),
    ((4, 3, 5), (5, 4, 6), 1), ((48, 48, 48), (49, 49, 49), 1),
    ((1, 1, 1), (2, 2, 2), 1), ((2, 2, 2), (1, 1, 1), 0)])
def test_pad_is_read_from_the_extents(x_cells, g_cells, pad):
    assert K.dw_pad(x_cells, g_cells) == pad


@pytest.mark.parametrize("x_cells,g_cells", [
    ((4, 4, 4), (4, 4, 4)), ((6, 4, 4), (4, 4, 4)), ((5, 3, 5), (4, 4, 4)),
    ((5, 5, 4), (4, 4, 4)), ((3, 3, 3), (5, 5, 5)), ((5, 5), (4, 4))])
def test_other_extents_raise(x_cells, g_cells):
    with pytest.raises(ValueError, match="one more or one fewer"):
        K.dw_pad(x_cells, g_cells)
    x = torch.zeros(1, *x_cells, 8)
    g = torch.zeros(1, *g_cells, 8)
    with pytest.raises(ValueError):
        K.dw_packed(x, g)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pad", [0, 1])
def test_plain_route_equals_the_function_it_replaced(pad, dtype):
    """With the pad implied by the extents, the plain route gives the old
    function's bits on the explicitly padded input; so do `dw_packed` and
    `_dw_packed_qgroup` on the CPU."""
    x, g = _operands(2, (4, 3, 5), 16, 24, pad, dtype, seed=3)
    x_padded = TF.pad(x, (0, 0) + (1, 1) * 3) if pad else x
    ref = _dw_before(x_padded, g)
    for fn in (K.dw_packed_plain, K.dw_packed, TP._dw_packed_qgroup):
        got = fn(x, g)
        assert got.dtype == torch.float32
        assert torch.equal(got, ref), fn.__name__
    # a pre-padded input still reads as pad 0
    assert torch.equal(K.dw_packed(x_padded, g), ref)


@pytest.mark.parametrize("device,dtype,route", [
    ("cpu", torch.float32, "plain"), ("cpu", torch.bfloat16, "plain"),
    ("cpu", torch.float16, "plain"), ("cuda", torch.float32, "plain"),
    ("cuda", torch.bfloat16, "tc")])
def test_route(device, dtype, route):
    assert K.dw_packed_route(dtype, torch.device(device)) == route


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_other_dtypes_on_the_card_raise(dtype):
    with pytest.raises(TypeError):
        K.dw_packed_route(dtype, torch.device("cuda"))


def test_plain_route_counts_no_launch():
    x, g = _operands(1, (3, 3, 3), 8, 64, 1, torch.bfloat16)
    before = (K.dw_packed.launches, K.dw_packed.fold_launches)
    K.dw_packed(x, g)
    assert (K.dw_packed.launches, K.dw_packed.fold_launches) == before


@pytest.mark.parametrize("cls,pad", [(TP.Conv3Packed, 0),
                                     (TP.Conv3PackedAs, 1)])
def test_packed_conv_backward_passes_the_saved_input(cls, pad, monkeypatch):
    """The backward hands dw the input the forward saved, unpadded."""
    seen = []
    orig = TP._dw_packed_qgroup

    def rec(x, g):
        seen.append((x, tuple(g.shape)))
        return orig(x, g)

    monkeypatch.setattr(TP, "_dw_packed_qgroup", rec)
    x, _ = _operands(1, (4, 4, 4), 16, 8, pad, seed=5)
    wp = torch.randn(2, 2, 2, 16, 24, requires_grad=True)
    y = cls.apply(x, wp, None)
    y.sum().backward()
    (xs, g_shape), = seen
    assert xs.data_ptr() == x.data_ptr() and xs.shape == x.shape
    assert g_shape == tuple(y.shape)
    assert K.dw_pad(xs.shape[1:4], g_shape[1:4]) == pad


# ---------------------------------------------------------------------------
# the kernel's tile plan at the benchmark's sites
# ---------------------------------------------------------------------------


def _unet_sites(n, s):
    """(n, g cells, 8Ci, 8Co, pad) of the 12 dw calls of a packed UNet3D
    step (3 blocks, 8 first-layer channels) at s aligned cells a side."""
    h, q = s // 2, s // 4
    return [(n, s + 1, 8, 64, 1), (n, s, 64, 128, 0),
            (n, h + 1, 128, 128, 1), (n, h, 128, 256, 0),
            (n, q + 1, 256, 256, 1), (n, q, 256, 512, 0),
            (n, h + 1, 256, 256, 1), (n, h + 1, 512, 256, 1),
            (n, h, 256, 256, 0), (n, s + 1, 128, 128, 1),
            (n, s + 1, 256, 128, 1), (n, s, 128, 128, 0)]


def _voxresnet_sites(n=10):
    """The 22 dw calls of a packed VoxResNet step at 192^3 (stride-2 stem,
    widths 32/64/64/128/128): the stem, conv3d_2, then per stage its
    downsample (8Co = Co) and two blocks of two convs."""
    sites = [(n, 49, 64, 256, 1), (n, 48, 256, 256, 0)]
    c_in, cells = 256, 48
    for co in (64, 64, 128, 128):
        sites.append((n, cells, c_in, co, 0))
        cells //= 2
        c_in = 8 * co
        sites += [(n, cells + 1, c_in, c_in, 1), (n, cells, c_in, c_in, 0)] * 2
    return sites


SITES = sorted(set(_unet_sites(2, 96)) | set(_unet_sites(16, 32))
               | set(_voxresnet_sites()))


def test_site_lists_count_the_calls():
    assert len(_unet_sites(2, 96)) == 12 and len(_voxresnet_sites()) == 22


def test_unet_sites_match_a_recorded_step(monkeypatch):
    """The UNet site list against the dw calls of a float32 packed train
    step on the CPU at 16^3 (s = 8 cells a side)."""
    from mri_epilepsy_diagnosis_torch.train import seg as TS

    seen = []
    orig = TP._dw_packed_qgroup

    def rec(x, g):
        seen.append((g.shape[0], g.shape[1], x.shape[-1], g.shape[-1],
                     K.dw_pad(x.shape[1:4], g.shape[1:4])))
        return orig(x, g)

    monkeypatch.setattr(TP, "_dw_packed_qgroup", rec)
    model, _, _ = TS.get_model_and_optimizer(out_channels_first_layer=8,
                                             device="cpu")
    x = torch.randn(2, 16, 16, 16, 1)
    labels = (torch.rand(x.shape) > 0.9).to(torch.int16) * 1001
    loss, _ = TS.packed_seg_loss(model, x, labels)
    loss.backward()
    assert sorted(seen) == sorted(_unet_sites(2, 8))


@pytest.mark.parametrize("site", SITES, ids=lambda s: "x".join(map(str, s)))
def test_plan_covers_every_site(site):
    n, c, c8i, c8o, pad = site
    p = K.dw_packed_plan(n, c, c, c, c8i, c8o)
    (bw, bh), (tw, th) = p.box, p.tiles
    tm, tn = p.tiles_mn
    # tiles cover 8Co and 8Ci; the stem's 8 channels take the narrow tile
    assert p.bn == (8 if c8i == 8 else 64)
    assert tm * 64 >= c8o > (tm - 1) * 64 and tn * p.bn >= c8i > (
        tn - 1) * p.bn
    # boxes cover the output's H x W, each window on an 8-row group,
    # wgmma's K a multiple of 16, and no box wholly outside
    assert bw % 8 == 0 and (bw * bh) % 16 == 0 and bw * bh <= 128
    assert (tw - 1) * bw < c <= tw * bw and (th - 1) * bh < c <= th * bh
    assert p.steps == n * c * tw * th
    # the splits cover every step once, none empty
    bounds = [s * p.steps // p.splits for s in range(p.splits + 1)]
    assert bounds[0] == 0 and bounds[-1] == p.steps
    assert all(b1 > b0 for b0, b1 in zip(bounds, bounds[1:]))
    assert p.grid == tm * tn * p.splits < 2 ** 31
    assert p.ws_floats == p.splits * 8 * tm * 64 * tn * p.bn
    assert 3 <= p.stages <= 8 and p.smem <= 232448
    assert p.stage_bytes == K._dwp_stage_bytes(bw, bh, p.bn)
    assert 0.0 <= p.waste < 1.0


def test_plan_fills_the_card():
    """Every site of the two 192^3 cells runs at least one block per SM."""
    for site in set(_unet_sites(2, 96)) | set(_voxresnet_sites()):
        n, c, c8i, c8o, _ = site
        assert K.dw_packed_plan(n, c, c, c, c8i, c8o).grid >= 132, site


# ---------------------------------------------------------------------------
# the kernel's walk, replayed with torch
# ---------------------------------------------------------------------------


def _kernel_walk(x, g, plan):
    """dw as `csrc/dw_packed_tc.cu` computes it, in float64: per split,
    the K steps of its range; per step g's box and, per qw, x's haloed box
    as TMA lays them out (rows (z, y, x), x fastest; zeros outside the
    tensors and past the channels), each window (qd, qh) the run of bw bh
    rows from row (qd (bh + 1) + qh) bw; partial tiles (q, 8Co, 8Ci) per
    split, folded in split order and transposed."""
    pad = K.dw_pad(x.shape[1:4], g.shape[1:4])
    n, do, ho, wo, c8o = g.shape
    c8i = x.shape[-1]
    (bw, bh), (tw, th) = plan.box, plan.tiles
    ldm, ldn = plan.tiles_mn[0] * 64, plan.tiles_mn[1] * plan.bn
    rows = bw * bh
    gz = torch.zeros(n, do, th * bh, tw * bw, ldm, dtype=torch.float64)
    gz[:, :, :ho, :wo, :c8o] = g.double()
    # x at offset 1: the haloed boxes reach one cell below 0 and past the end
    xz = torch.zeros(n, do + 3, th * bh + 3, tw * bw + 3, ldn,
                     dtype=torch.float64)
    xz[:, 1:1 + x.shape[1], 1:1 + x.shape[2], 1:1 + x.shape[3], :c8i] = (
        x.double())
    ws = torch.zeros(plan.splits, 8, ldm, ldn, dtype=torch.float64)
    for s in range(plan.splits):
        for k in range(s * plan.steps // plan.splits,
                       (s + 1) * plan.steps // plan.splits):
            b = k
            ow0 = (b % tw) * bw
            b //= tw
            oh0 = (b % th) * bh
            b //= th
            od, nb = b % do, b // do
            a = gz[nb, od, oh0:oh0 + bh, ow0:ow0 + bw].reshape(rows, ldm)
            for qw in range(2):
                z0, y0, x0 = od - pad + 1, oh0 - pad + 1, ow0 + qw - pad + 1
                box = xz[nb, z0:z0 + 2, y0:y0 + bh + 1, x0:x0 + bw]
                box = box.reshape(2 * (bh + 1) * bw, ldn)
                for w in range(4):
                    qd, qh = w >> 1, w & 1
                    r0 = (qd * (bh + 1) + qh) * bw
                    ws[s, 4 * qd + 2 * qh + qw] += a.t() @ box[r0:r0 + rows]
    folded = ws.sum(0)[:, :c8o, :c8i]
    return folded.transpose(1, 2).reshape(2, 2, 2, c8i, c8o)


@pytest.mark.parametrize("n,g_cells,c8i,c8o,pad", [
    (2, (5, 7, 9), 8, 64, 1), (1, (3, 4, 17), 64, 128, 0),
    (3, (2, 9, 5), 136, 72, 1), (1, (6, 3, 10), 24, 40, 0),
    (2, (4, 4, 4), 64, 64, 1)])
def test_kernel_walk_equals_plain(n, g_cells, c8i, c8o, pad, monkeypatch):
    """The plan's walk sums every (cell, offset, channel) product once:
    at the plan as made, and with splits and boxes forced small."""
    x, g = _operands(n, g_cells, c8i, c8o, pad, seed=7)
    do, ho, wo = g_cells
    xp = TF.pad(x.double(), (0, 0) + (1, 1) * 3) if pad else x.double()
    ref = torch.stack([torch.einsum(
        "ndhwi,ndhwo->io", xp[:, qd:qd + do, qh:qh + ho, qw:qw + wo],
        g.double()) for qd, qh, qw in np.ndindex(2, 2, 2)]).reshape(
        2, 2, 2, c8i, c8o)
    plan = K.dw_packed_plan(n, do, ho, wo, c8i, c8o)
    torch.testing.assert_close(_kernel_walk(x, g, plan), ref, rtol=1e-12,
                               atol=1e-10)
    monkeypatch.setattr(K, "_DWP_MAX_ROWS", 16)
    small = K.dw_packed_plan(n, do, ho, wo, c8i, c8o, sms=4096)
    assert small.box[0] * small.box[1] == 16 and small.splits > 1
    torch.testing.assert_close(_kernel_walk(x, g, small), ref, rtol=1e-12,
                               atol=1e-10)

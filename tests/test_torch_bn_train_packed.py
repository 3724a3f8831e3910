"""The train-mode tail of a packed ConvBlock (`ops/packed.py::
BnActTrainPacked` over the four passes of `ops/cuda_kernels.py`, their
plain versions on the CPU) against the composition it replaced
(`zero_shifted_pads`, `_bn_train_packed`, `prelu`, `zero_shifted_pads`,
differentiated by autograd) and against the JAX package's `_block_train`.

The composition runs in float32 on the same values: the Function's one
rounding of a float32 result is held to half a bfloat16 step of the
largest value, its float32 sums to float32 summation order."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mri_epilepsy_diagnosis_torch.models import unet_packed as TU
from mri_epilepsy_diagnosis_torch.ops import cuda_kernels as K
from mri_epilepsy_diagnosis_torch.ops import functional as TF
from mri_epilepsy_diagnosis_torch.ops import packed as TP
from mri_epilepsy_diagnosis_tpu.models import unet_packed as JU
from mri_epilepsy_diagnosis_tpu.ops import packed as JP

torch.set_num_threads(2)

FINE = 8          # fine voxels per axis
BATCH = 2


def _inputs(c, shifted, seed, dtype=torch.float32, bn=True):
    """Packed y (pads hold non-zero values, as a conv's extrapolation
    does), a cotangent g, and the block's parameters."""
    rng = np.random.default_rng(seed)
    cells = FINE // 2 + (1 if shifted else 0)
    shape = (BATCH, cells, cells, cells, 8 * c)
    y = torch.from_numpy(rng.normal(0.5, 2.0, shape).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    prm = {"alpha": torch.tensor([0.25], dtype=torch.float32)}
    if bn:
        f32 = np.float32
        prm.update(
            gamma=torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(f32)),
            beta=torch.from_numpy(rng.normal(size=c).astype(f32)),
            rm=torch.from_numpy(rng.normal(size=c).astype(f32)),
            rv=torch.from_numpy(rng.uniform(0.5, 2, c).astype(f32)))
    return y.to(dtype), g.to(dtype), prm


def _leaves(prm):
    return {k: v.clone().requires_grad_() for k, v in prm.items()
            if k in ("gamma", "beta", "alpha")}


def _composed(y, prm, *, shifted, owned_d):
    """The tail as `models/unet_packed.py::_block_train` composed it, in
    y's dtype: (out, running statistics, leaves)."""
    leaves = _leaves(prm)
    if shifted:
        y = TP.zero_shifted_pads(y)
    stats = None
    if "gamma" in prm:
        sd = {"b.norm_layer.weight": leaves["gamma"],
              "b.norm_layer.bias": leaves["beta"],
              "b.norm_layer.running_mean": prm["rm"],
              "b.norm_layer.running_var": prm["rv"]}
        owned = None if owned_d == y.shape[1] else y.narrow(1, 0, owned_d)
        y, st = TU._bn_train_packed(y, sd, "b",
                                    valid=float(BATCH * FINE ** 3),
                                    owned=owned)
        stats = (st["b.norm_layer.running_mean"],
                 st["b.norm_layer.running_var"])
    y = TF.prelu(y, leaves["alpha"])
    if shifted:
        y = TP.zero_shifted_pads(y)
    return y, stats, leaves


def _function(y, prm, *, shifted, owned_d):
    leaves = _leaves(prm)
    out, mean, var = TP.BnActTrainPacked.apply(
        y, leaves.get("gamma"), leaves.get("beta"), leaves["alpha"], shifted,
        float(BATCH * FINE ** 3), owned_d)
    stats = None
    if "gamma" in prm:
        stats = TF.update_running_stats(prm["rm"], prm["rv"], mean, var,
                                        float(BATCH * FINE ** 3))
    return out, stats, leaves


def _grads(out, g, y, leaves):
    names = sorted(leaves)
    got = torch.autograd.grad(out, [y, *(leaves[k] for k in names)], g)
    return dict(zip(["y", *names], got))


def _max_err(a, b):
    return (a.double() - b.double()).abs().max().item()


CASES = [(True, True, False), (True, True, True), (False, True, False),
         (True, False, False), (False, False, False)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shifted,bn,narrow", CASES)
def test_function_matches_composition(shifted, bn, narrow, dtype):
    """Output, running statistics and the gradients of y, gamma, beta and
    alpha against autograd through the float32 composition: shifted and
    aligned tensors, with and without BatchNorm (the stem's conv1), a
    slab whose last D cell another rank counts (`narrow`)."""
    c = 8
    y, g, prm = _inputs(c, shifted, seed=3, dtype=dtype, bn=bn)
    owned_d = y.shape[1] - 1 if narrow else y.shape[1]
    y32 = y.float().requires_grad_()
    ref, ref_stats, ref_leaves = _composed(y32, prm, shifted=shifted,
                                           owned_d=owned_d)
    ref_grads = _grads(ref, g.float(), y32, ref_leaves)
    yy = y.clone().requires_grad_()
    out, stats, leaves = _function(yy, prm, shifted=shifted, owned_d=owned_d)
    grads = _grads(out, g, yy, leaves)

    assert out.dtype == dtype and grads["y"].dtype == dtype
    # one rounding of a float32 value: half a step of the dtype
    step = 2.0 ** -8 if dtype == torch.bfloat16 else 1e-6
    assert _max_err(out, ref) <= step * ref.abs().max().item()
    assert _max_err(grads["y"], ref_grads["y"]) <= (
        2 * step * ref_grads["y"].abs().max().item())
    for k in leaves:
        r = ref_grads[k]
        assert grads[k].shape == r.shape and grads[k].dtype == r.dtype
        assert _max_err(grads[k], r) <= 1e-5 * r.abs().max().item(), k
    if bn:
        for a, b in zip(stats, ref_stats):
            assert _max_err(a, b) <= 1e-6 * b.abs().max().item()
    else:
        assert stats is None
    if shifted:
        keep = TP.zero_shifted_pads(torch.ones_like(out))
        assert (out[keep == 0] == 0).all()
        assert (grads["y"][keep == 0] == 0).all()


def test_bf16_rounds_once():
    """In bfloat16 the Function's output lies at least as close to the
    float32 tail as the composition's four roundings do."""
    y, _, prm = _inputs(8, True, seed=5, dtype=torch.bfloat16)
    ref, _, _ = _composed(y.float(), prm, shifted=True, owned_d=y.shape[1])
    old, _, _ = _composed(y, prm, shifted=True, owned_d=y.shape[1])
    new, _, _ = _function(y, prm, shifted=True, owned_d=y.shape[1])
    assert _max_err(new, ref) <= _max_err(old, ref)


@pytest.mark.parametrize("c", [3, 16])
def test_function_other_widths(c):
    """Fine channel counts that are not 8 (a thread's 8 packed channels
    then span several sub-positions), float32."""
    y, g, prm = _inputs(c, True, seed=7)
    y32 = y.clone().requires_grad_()
    ref, ref_stats, ref_leaves = _composed(y32, prm, shifted=True,
                                           owned_d=y.shape[1])
    ref_grads = _grads(ref, g, y32, ref_leaves)
    yy = y.clone().requires_grad_()
    out, stats, leaves = _function(yy, prm, shifted=True, owned_d=y.shape[1])
    grads = _grads(out, g, yy, leaves)
    assert _max_err(out, ref) <= 1e-6 * ref.abs().max().item()
    for k, r in ref_grads.items():
        assert _max_err(grads[k], r) <= 1e-5 * r.abs().max().item(), k


def test_function_repeats_bit_for_bit():
    y, g, prm = _inputs(8, True, seed=9, dtype=torch.bfloat16)
    runs = []
    for _ in range(2):
        yy = y.clone().requires_grad_()
        out, stats, leaves = _function(yy, prm, shifted=True,
                                       owned_d=y.shape[1])
        runs.append((out, *stats, *_grads(out, g, yy, leaves).values()))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_block_train_calls_the_function(monkeypatch):
    """`_block_train` runs every tail through `BnActTrainPacked`, for the
    stem (no BatchNorm) and a block with one."""
    calls = []
    apply = TP.BnActTrainPacked.apply

    def spy(*args):
        calls.append(args[1] is None)
        return apply(*args)

    monkeypatch.setattr(TP.BnActTrainPacked, "apply", spy)
    y, _, prm = _inputs(8, True, seed=11)
    sd = {"s.activation_layer.weight": prm["alpha"],
          "b.norm_layer.weight": prm["gamma"],
          "b.norm_layer.bias": prm["beta"],
          "b.norm_layer.running_mean": prm["rm"],
          "b.norm_layer.running_var": prm["rv"],
          "b.activation_layer.weight": prm["alpha"]}
    _, st0 = TU._block_train(y, sd, "s", shifted=True,
                             valid=float(BATCH * FINE ** 3))
    _, st1 = TU._block_train(y, sd, "b", shifted=True,
                             valid=float(BATCH * FINE ** 3))
    assert calls == [True, False] and st0 == {}
    assert set(st1) == {"b.norm_layer.running_mean",
                        "b.norm_layer.running_var"}


@pytest.mark.parametrize("faces", [(True, True), (True, False),
                                   (False, True), (False, False)])
def test_pad_keep_faces(faces):
    """The one pad-mask rule (`cuda_kernels.shifted_pad_keep`, the kernels'
    index arithmetic) leaves the first or last D cell whole where a rank's
    slab does not hold that face of the volume, and otherwise gives JAX's
    pad-mask plane; the plain passes' mask is the product of its planes,
    1 for an aligned tensor."""
    want = JP._shifted_pad_axis_mask(0, 4, 24).astype(bool)
    want[0] |= not faces[0]
    want[-1] |= not faces[1]
    got = K.shifted_pad_keep(0, 4, 24, first=faces[0], last=faces[1])
    np.testing.assert_array_equal(got.numpy(), want)
    y = torch.zeros(1, 4, 3, 5, 24)
    mh, mw = (K.shifted_pad_keep(a, n, 24).float() for a, n in ((1, 3),
                                                                (2, 5)))
    ref = (got.float()[:, None, None, :] * mh[None, :, None, :]
           * mw[None, None, :, :])
    assert torch.equal(K._bn_keep_plain(y, True, faces), ref)
    assert torch.equal(K._bn_keep_plain(y, False, faces), torch.ones(()))


# ---------------------------------------------------------------------------
# the JAX package's `_block_train`
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_tail():
    """JAX's `_block_train` forward, new statistics and vjp at 8^3 fine,
    batch 2, 8 channels, a shifted tensor (f32)."""
    y, g, prm = _inputs(8, True, seed=13)
    params = {"norm_layer": {"weight": jnp.asarray(prm["gamma"].numpy()),
                             "bias": jnp.asarray(prm["beta"].numpy())},
              "activation_layer": {
                  "weight": jnp.asarray(prm["alpha"].numpy())}}
    stats = {"norm_layer": {"running_mean": jnp.asarray(prm["rm"].numpy()),
                            "running_var": jnp.asarray(prm["rv"].numpy())}}

    def fn(yy, pp):
        return JU._block_train(yy, pp, stats, shifted=True, fine_size=FINE,
                               batch=BATCH)

    (out, new), vjp = jax.vjp(fn, jnp.asarray(y.numpy()), params)
    dy, dp = vjp((jnp.asarray(g.numpy()),
                  jax.tree_util.tree_map(jnp.zeros_like, new)))
    return y, g, prm, {
        "out": np.asarray(out),
        "rm": np.asarray(new["norm_layer"]["running_mean"]),
        "rv": np.asarray(new["norm_layer"]["running_var"]),
        "y": np.asarray(dy),
        "gamma": np.asarray(dp["norm_layer"]["weight"]),
        "beta": np.asarray(dp["norm_layer"]["bias"]),
        "alpha": np.asarray(dp["activation_layer"]["weight"])}


def test_function_matches_jax_block_train(jax_tail):
    y, g, prm, ref = jax_tail
    yy = y.clone().requires_grad_()
    out, stats, leaves = _function(yy, prm, shifted=True, owned_d=y.shape[1])
    grads = _grads(out, g, yy, leaves)
    got = {"out": out, "rm": stats[0], "rv": stats[1], **grads}
    for k, r in ref.items():
        a = got[k].detach().numpy()
        assert a.shape == r.shape, k
        np.testing.assert_allclose(a, r, rtol=0,
                                   atol=2e-5 * np.abs(r).max(), err_msg=k)

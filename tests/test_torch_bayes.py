"""Port parity: the Bayesian conv layers and the conv + InstanceNorm + ReLU
blocks (`models/bayes.py`) against the JAX package's, on the CPU.

JAX draws its noise from the "sample" stream, the port from a
`torch.Generator` (ROADMAP §C "RNG streams"), so the tests capture what
`jax.random.normal` returns during the JAX apply (`jax_draws`) and feed
it to the port's layers in call order (`port_replay`, which stands in for
`models.bayes.draw_eps` and `ops.functional.dropout` through
`chip_smoke.replaced_draws`); the JAX package itself is unchanged.
float32, JAX at `Precision.HIGHEST`; outputs within 1e-5 x max(1,
max|ref|)."""
import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chip_smoke import replaced_draws
from mri_epilepsy_diagnosis_torch.interop import variables_to_state_dict
from mri_epilepsy_diagnosis_torch.models import bayes as TB
from mri_epilepsy_diagnosis_tpu.models import bayes as JB

torch.set_num_threads(2)

TOL = 1e-5


@contextlib.contextmanager
def jax_draws():
    """Record every `jax.random.normal` and `jax.random.bernoulli` result
    of the JAX code run inside, as numpy arrays in call order.  The JAX
    code must run eagerly (no jit, or under `jax.disable_jit()`), so that
    the draws are values."""
    rec = {"normal": [], "bernoulli": []}
    normal, bernoulli = jax.random.normal, jax.random.bernoulli

    def rec_normal(*args, **kw):
        out = normal(*args, **kw)
        rec["normal"].append(np.array(out))
        return out

    def rec_bernoulli(*args, **kw):
        out = bernoulli(*args, **kw)
        rec["bernoulli"].append(np.array(out))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "normal", rec_normal)
        mp.setattr(jax.random, "bernoulli", rec_bernoulli)
        yield rec


@contextlib.contextmanager
def port_replay(rec):
    """Replay recorded JAX draws in the port, in call order
    (`chip_smoke.replaced_draws`): the normals as the Bayesian layers'
    eps, the Bernoulli keep masks as Dropout's; every draw must be used,
    at its shape."""
    normals, masks = iter(rec["normal"]), iter(rec["bernoulli"])

    def eps(like):
        a = next(normals)
        assert a.shape == tuple(like.shape)
        return torch.from_numpy(a)

    def keep(x, rate):
        m = next(masks)
        assert m.shape == tuple(x.shape)
        return torch.from_numpy(m)

    with replaced_draws(eps, keep):
        yield
    assert next(normals, None) is None and next(masks, None) is None


def close(got: torch.Tensor, ref, tol=TOL):
    ref = np.asarray(ref)
    assert tuple(got.shape) == ref.shape
    err = np.abs(got.detach().numpy().astype(np.float64) - ref).max()
    assert err <= tol * max(1.0, np.abs(ref).max()), err


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _init(module, x, seed=0):
    return _np_tree(module.init({"params": jax.random.key(seed),
                                 "sample": jax.random.key(seed + 1)}, x))


def _port(module, variables, train):
    module.load_state_dict(variables_to_state_dict(variables, device="cpu"),
                           strict=True)
    return module.train(train)


def _spread_logsigma(variables, rng):
    """logsigma and mu spread so that log_alpha straddles the pruning
    threshold 3 (and both clip bounds)."""
    p = dict(variables["params"])
    p["mu_weight"] = (0.2 * rng.normal(size=p["mu_weight"].shape)).astype(
        np.float32)
    p["logsigma_weight"] = rng.uniform(
        -9.0, 2.0, p["logsigma_weight"].shape).astype(np.float32)
    return {"params": p}


BAYES_CASES = [
    dict(kernel_size=3, padding=1),
    dict(kernel_size=3, stride=2, padding=1, use_bias=False),
    dict(kernel_size=3, padding=2, dilation=2),
    dict(kernel_size=1, zero_mean=True),
    dict(kernel_size=(1, 3, 3), padding=(0, 1, 1), threshold=1.0),
]


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("kw", BAYES_CASES)
def test_bayes_conv3d_matches_jax(kw, train):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 7, 8, 6, 3)).astype(np.float32)
    jm = JB.BayesConv3d(3, 5, **kw)
    v = _spread_logsigma(_init(jm, jnp.asarray(x)), rng)
    with jax_draws() as rec:
        ref = jm.apply(v, jnp.asarray(x), train,
                       rngs={"sample": jax.random.key(7)})
    assert len(rec["normal"]) == 1
    pm = _port(TB.BayesConv3d(3, 5, device="cpu", **kw), v, train)
    with port_replay(rec):
        got = pm(torch.from_numpy(x))
    close(got, ref)
    if not train:        # the pruning mask is not vacuous
        log_alpha = np.clip(v["params"]["logsigma_weight"] - np.log(
            v["params"]["mu_weight"] ** 2 + 1e-8), -5, 5)
        pruned = log_alpha >= kw.get("threshold", 3.0)
        assert pruned.any() and not pruned.all()


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("kw", [dict(kernel_size=3, padding=1),
                                dict(kernel_size=2, stride=2,
                                     use_bias=False)])
def test_bayes_conv2d_matches_jax(kw, train):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 8, 10, 3)).astype(np.float32)
    jm = JB.BayesConv2d(3, 4, **kw)
    v = _spread_logsigma(_init(jm, jnp.asarray(x)), rng)
    with jax_draws() as rec:
        ref = jm.apply(v, jnp.asarray(x), train,
                       rngs={"sample": jax.random.key(8)})
    pm = _port(TB.BayesConv2d(3, 4, device="cpu", **kw), v, train)
    with port_replay(rec):
        got = pm(torch.from_numpy(x))
    close(got, ref)


def test_bayes_moments_and_sample_are_the_layer():
    """The layer is `reparameterize(*bayes_moments(...), eps)` with eps
    from its generator: the same seed gives the same output, another
    seed another."""
    layer = TB.BayesConv3d(2, 3, 3, padding=1, device="cpu").train()
    x = torch.randn(1, 5, 5, 5, 2, generator=torch.Generator().manual_seed(0))
    a = layer(x, torch.Generator().manual_seed(1))
    b = layer(x, torch.Generator().manual_seed(1))
    c = layer(x, torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    mu, sigma = layer.moments(x)
    eps = TB.draw_eps(sigma, torch.Generator().manual_seed(1))
    torch.testing.assert_close(a, TB.reparameterize(mu, sigma, eps),
                               rtol=0, atol=0)
    assert (sigma >= 1e-2).all()        # sqrt(1e-4 + var) >= 1e-2


def test_conv_sample_matches_jax():
    rng = np.random.default_rng(2)
    x = (np.abs(rng.normal(size=(2, 10, 9, 4))) + 0.1).astype(np.float32)
    jm = JB.ConvSample(4, 6, 3)
    v = _init(jm, jnp.asarray(x))
    with jax_draws() as rec:
        ref = jm.apply(v, jnp.asarray(x), rngs={"sample": jax.random.key(3)})
    pm = _port(TB.ConvSample(4, 6, 3, device="cpu"), v, True)
    with port_replay(rec):
        got = pm(torch.from_numpy(x))
    close(got, ref)


def test_flatten_and_deflatten_match_jax():
    x = np.random.default_rng(3).normal(size=(2, 4, 3, 5, 6)).astype(
        np.float32)
    flat = TB.flatten(torch.from_numpy(x))
    np.testing.assert_array_equal(flat.numpy(), np.asarray(
        JB.flatten(jnp.asarray(x))))
    back = TB.DeFlatten((4, 3, 5, 6))(flat)
    np.testing.assert_array_equal(back.numpy(), np.asarray(
        JB.DeFlatten((4, 3, 5, 6)).apply({}, jnp.asarray(flat.numpy()))))


@pytest.mark.parametrize("name,args,shape", [
    ("ConvLayer", (3, 5), (2, 8, 7, 6, 3)),
    ("ConvLayer", (3, 5, 2), (1, 8, 7, 6, 3)),
    ("ConvTransposeLayer", (4, 2), (1, 5, 5, 5, 4)),
    ("ConvTransposeLayer", (4, 3, 1, 3), (2, 4, 5, 3, 4)),
    ("DownConv", (2, 4), (1, 8, 8, 8, 2)),
    ("InitConv", (1, 4), (2, 6, 6, 6, 1)),
    ("FinalConv", (4, 2), (2, 5, 6, 7, 4)),
])
def test_conv_blocks_match_jax(name, args, shape):
    rng = np.random.default_rng(4)
    x = rng.normal(size=shape).astype(np.float32)
    jm = getattr(JB, name)(*args)
    v = _init(jm, jnp.asarray(x))
    ref = jm.apply(v, jnp.asarray(x))
    pm = _port(getattr(TB, name)(*args, device="cpu"), v, True)
    close(pm(torch.from_numpy(x)), ref)


@pytest.mark.parametrize("x1_shape,x2_shape", [
    ((1, 8, 8, 8, 8), (1, 16, 16, 16, 4)),     # 18^3 cropped to 16^3
    ((2, 5, 5, 5, 8), (2, 13, 12, 15, 4)),     # padded, even and odd
    ((1, 4, 6, 5, 6), (1, 9, 13, 12, 3)),      # cropped and padded
])
def test_up_conv_matches_jax(x1_shape, x2_shape):
    """`UpConv` pads or, for a negative difference, crops the deconv's
    2N + 2 output to the skip, as torch's `F.pad` does."""
    rng = np.random.default_rng(5)
    x1 = rng.normal(size=x1_shape).astype(np.float32)
    x2 = rng.normal(size=x2_shape).astype(np.float32)
    cin = x1_shape[-1]
    jm = JB.UpConv(cin, 3)
    v = _np_tree(jm.init(jax.random.key(0), jnp.asarray(x1), jnp.asarray(x2)))
    ref = jm.apply(v, jnp.asarray(x1), jnp.asarray(x2))
    pm = _port(TB.UpConv(cin, 3, device="cpu"), v, True)
    close(pm(torch.from_numpy(x1), torch.from_numpy(x2)), ref)

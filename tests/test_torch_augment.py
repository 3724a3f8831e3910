"""Port parity: the random augmentations
(`mri_epilepsy_diagnosis_torch/transforms/augment.py`) against the JAX
package's, on the CPU.

JAX draws from a key and the port from a `torch.Generator`, so the two
cannot draw the same numbers.  Each test draws the parameters from a key
exactly as the JAX transform does, runs the JAX transform on that key,
and feeds the port's deterministic core the same parameters.  JAX's
large contractions (the bias field's tensordot, the elastic field's
resize) run at float32 matmul precision: this JAX build's default is
bf16-level even on the CPU."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mri_epilepsy_diagnosis_torch.transforms import augment as TA
from mri_epilepsy_diagnosis_torch.transforms import spatial as TS
from mri_epilepsy_diagnosis_tpu.transforms import augment as JA

torch.set_num_threads(2)
SHAPE = (20, 18, 22)
TOL = 1e-5


def _vol(seed=0):
    """Smooth intensities plus noise, positive, like a T1w crop."""
    rng = np.random.default_rng(seed)
    g = np.stack(np.meshgrid(*[np.linspace(-1, 1, s) for s in SHAPE],
                             indexing="ij"))
    v = 100 + 60 * np.cos(2 * g[0] + 1) * np.sin(3 * g[1]) + 40 * g[2]
    return (v + rng.normal(0, 5, SHAPE)).astype(np.float32)


def _close(got, ref, rel=TOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    err = np.abs(got.astype(np.float64) - ref).max()
    assert err <= rel * np.abs(ref).max(), (err, rel * np.abs(ref).max())


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("seed", range(4))
def test_flip_core_matches_jax(seed):
    v, key, axes = _vol(), jax.random.key(seed), (0, 1, 2)
    ref = np.asarray(JA.random_flip(key, jnp.asarray(v), axes, 0.5))
    do = [bool(jax.random.bernoulli(k, 0.5))
          for k in jax.random.split(key, len(axes))]
    flipped = [ax for ax, d in zip(axes, do) if d]
    np.testing.assert_array_equal(
        TS.flip(torch.from_numpy(v), flipped).numpy(), ref)


def test_noise_core_matches_jax():
    v, key = _vol(), jax.random.key(5)
    ref = np.asarray(JA.random_noise(key, jnp.asarray(v), 0.5, (0.1, 0.3)))
    k1, k2 = jax.random.split(key)
    s = float(jax.random.uniform(k1, (), minval=0.1, maxval=0.3))
    field = np.array(jax.random.normal(k2, v.shape, jnp.float32))
    _close(TA._add_noise(torch.from_numpy(v), 0.5, s,
                         torch.from_numpy(field)).numpy(), ref)


@pytest.mark.parametrize("order", [1, 3])
def test_bias_field_core_matches_jax(order):
    v, key = _vol(), jax.random.key(6)
    with jax.default_matmul_precision("float32"):
        ref = np.asarray(JA.random_bias_field(key, jnp.asarray(v), 0.5,
                                              order))
        basis = np.asarray(JA._poly_basis(v.shape, order))
    coeffs = np.array(jax.random.uniform(key, (basis.shape[0],),
                                         minval=-0.5, maxval=0.5))
    assert len(TA._poly_terms(order)) == basis.shape[0]
    _close(TA._apply_bias_field(torch.from_numpy(v), coeffs, order).numpy(),
           ref)


def _jax_affine_params(key, scales, degrees, translation):
    k1, k2, k3 = jax.random.split(key, 3)
    return (np.array(jax.random.uniform(k1, (3,), minval=scales[0],
                                        maxval=scales[1])),
            np.array(jax.random.uniform(k2, (3,), minval=-degrees,
                                        maxval=degrees)),
            np.array(jax.random.uniform(k3, (3,), minval=-translation,
                                        maxval=translation)))


@pytest.mark.parametrize("seed,translation", [(7, 0.0), (8, 3.0)])
def test_affine_core_matches_jax(seed, translation):
    v, key = _vol(), jax.random.key(seed)
    ref = np.asarray(JA.random_affine(key, jnp.asarray(v), (0.9, 1.1), 10.0,
                                      translation, fill_value=-1.0))
    affine = TA._affine_from_params(v.shape, *_jax_affine_params(
        key, (0.9, 1.1), 10.0, translation))
    got = TS.affine_resample(torch.from_numpy(v), affine, fill_value=-1.0)
    _close(got.numpy(), ref)


def test_rotation_matrix_matches_jax():
    ang = np.deg2rad(np.array([7.5, -3.0, 12.0], np.float32))
    _close(TA._rotation_matrix(torch.from_numpy(ang)).numpy(),
           JA._rotation_matrix(jnp.asarray(ang)), 1e-6)


@pytest.mark.parametrize("points,displacement", [(7, 7.5), (4, 3.0)])
def test_elastic_core_matches_jax(points, displacement):
    v, key = _vol(), jax.random.key(9)
    with jax.default_matmul_precision("float32"):
        ref = np.asarray(JA.random_elastic_deformation(
            key, jnp.asarray(v), points, displacement, fill_value=0.0))
    cp = np.array(jax.random.uniform(
        key, (3,) + (points,) * 3, minval=-displacement,
        maxval=displacement))
    _close(TA._elastic_from_control_points(torch.from_numpy(v), cp).numpy(),
           ref)


def test_motion_core_matches_jax():
    v, key = _vol(), jax.random.key(10)
    ref = np.asarray(JA.random_motion(key, jnp.asarray(v), 10.0, 10.0, 2))
    affines = [TA._affine_from_params(v.shape, *_jax_affine_params(
        k, (1.0, 1.0), 10.0, 10.0)) for k in jax.random.split(key, 2)]
    _close(TA._motion(torch.from_numpy(v), affines).numpy(), ref)


def _draws(gen, n):
    return [float(TA._uniform(gen, (), 0.0, 1.0)) for _ in range(n)]


def test_random_transforms_draw_from_the_generator_in_range():
    """Each transform draws its parameters from the generator, in their
    ranges: the same seed gives the same result twice, another seed
    another result, and the result is the core's on the drawn values."""
    v = torch.from_numpy(_vol())
    for fn in (TA.random_flip, TA.random_noise, TA.random_bias_field,
               TA.random_affine, TA.random_elastic_deformation,
               TA.random_motion):
        a, b = fn(_gen(1), v), fn(_gen(1), v)
        assert torch.equal(a, b), fn.__name__
        if fn is not TA.random_flip:
            assert not torch.equal(a, fn(_gen(2), v)), fn.__name__

    g = _gen(3)
    sc, ang, tr = TA._affine_params(g, (0.9, 1.1), 10.0, 4.0)
    assert ((0.9 <= sc) & (sc <= 1.1)).all()
    assert (ang.abs() <= 10).all() and (tr.abs() <= 4).all()
    np.testing.assert_array_equal(
        TA.random_affine(_gen(3), v, translation=4.0).numpy(),
        TS.affine_resample(v, TA._affine_from_params(v.shape, sc, ang,
                                                     tr)).numpy())

    g = _gen(4)
    coeffs = TA._uniform(g, (20,), -0.5, 0.5)
    assert (coeffs.abs() <= 0.5).all()
    np.testing.assert_array_equal(
        TA.random_bias_field(_gen(4), v).numpy(),
        TA._apply_bias_field(v, coeffs, 3).numpy())

    g = _gen(5)
    cp = TA._uniform(g, (3, 7, 7, 7), -7.5, 7.5)
    assert (cp.abs() <= 7.5).all()
    np.testing.assert_array_equal(
        TA.random_elastic_deformation(_gen(5), v).numpy(),
        TA._elastic_from_control_points(v, cp).numpy())

    g = _gen(6)
    s = TA._uniform(g, (), 0.0, 0.25)
    noisy = TA.random_noise(_gen(6), v)
    assert 0 <= s <= 0.25
    field = (noisy - v) / s
    assert abs(field.mean()) < 0.05 and abs(field.std() - 1) < 0.05

    u = _draws(_gen(7), 3)
    flipped = TA.random_flip(_gen(7), v, (0, 1, 2), 0.5)
    want = [ax for ax, d in zip((0, 1, 2), u) if d < 0.5]
    assert torch.equal(flipped, TS.flip(v, want) if want else v)


def test_generator_on_the_volume_device_is_used_as_it_is():
    """A generator on the volume's device draws the noise field itself;
    one elsewhere seeds a generator there (tests/test_torch_cuda.py)."""
    g = _gen(1)
    assert TA._generator_on(g, torch.device("cpu")) is g


def test_compose_and_one_of():
    v = torch.from_numpy(_vol())

    def shift(gen, x):
        return x + TA._uniform(gen, (), 0.0, 1.0)

    def scale(gen, x):
        return x * 2

    got = TA.Compose([shift, scale, TA.random_flip])(_gen(8), v)
    g = _gen(8)
    want = TA.random_flip(g, scale(g, shift(g, v)))
    assert torch.equal(got, want)
    assert torch.equal(TA.Compose([])(_gen(8), v), v)

    branches = [lambda g, x: x + 1, lambda g, x: x - 1, scale]
    chosen = set()
    for seed in range(20):
        out = TA.OneOf(branches)(_gen(seed), v)
        idx = int(torch.randint(0, 3, (), generator=_gen(seed)))
        assert torch.equal(out, branches[idx](None, v))
        chosen.add(idx)
    assert chosen == {0, 1, 2}


def test_compose_matches_jax_on_deterministic_transforms():
    """With transforms that draw nothing, Compose is the same chain."""
    v = _vol()
    jfns = [lambda k, x: jnp.flip(x, 1), lambda k, x: x * 3 - 1]
    tfns = [lambda g, x: torch.flip(x, (1,)), lambda g, x: x * 3 - 1]
    np.testing.assert_array_equal(
        TA.Compose(tfns)(_gen(0), torch.from_numpy(v)).numpy(),
        np.asarray(JA.Compose(jfns)(jax.random.key(0), jnp.asarray(v))))

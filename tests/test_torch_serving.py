"""Port parity: the serving path (`infer/serving.py::segment_volumes`,
`data/pipeline.py::DevicePrefetcher`, `transforms/intensity.py::
znormalization`) against the JAX package, on the CPU."""
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mri_epilepsy_diagnosis_torch.data.pipeline import DevicePrefetcher
from mri_epilepsy_diagnosis_torch.infer import serving as TS
from mri_epilepsy_diagnosis_torch.interop import variables_to_state_dict
from mri_epilepsy_diagnosis_torch.models import unet_packed as TU
from mri_epilepsy_diagnosis_torch.transforms import (
    znormalization as t_znorm)
from mri_epilepsy_diagnosis_tpu.infer import serving as JS
from mri_epilepsy_diagnosis_tpu.models import unet_packed as JU
from mri_epilepsy_diagnosis_tpu.transforms import znormalization as j_znorm
from test_torch_bridge import jax_unet_variables, torch_unet

torch.set_num_threads(2)

SIZE = 16


def t1_like(rng, n):
    """T1w-like int16 volumes: blobs + noise (tests/test_serving_quant.py)."""
    vols = []
    g = np.indices((SIZE,) * 3)
    for _ in range(n):
        v = rng.normal(size=(SIZE,) * 3) * 40 + 600
        c = rng.integers(4, 12, 3)
        v = v + 400 * np.exp(-(((g[0] - c[0]) ** 2 + (g[1] - c[1]) ** 2
                                + (g[2] - c[2]) ** 2) / 18.0))
        vols.append(v.astype(np.int16))
    return vols


def jax_znorm_batch(batch):
    return jax.vmap(lambda v: j_znorm(
        v[..., 0].astype(jnp.float32))[..., None])(batch)


def torch_znorm_batch(batch):
    return torch.stack([t_znorm(v) for v in batch])


@pytest.fixture(scope="module")
def served():
    """5 volumes at batch 2 (a ragged final batch) through both packages'
    BN-folded packed serving path, int16 and uint8 transfers."""
    _, variables = jax_unet_variables(ocfl=8, nb=3, seed=7)
    jv = JU.fold_bn_inference(variables)
    params = TU.fold_bn_inference(
        variables_to_state_dict(variables, device="cpu"))
    vols = t1_like(np.random.default_rng(8), 5)
    out = {"vols": vols, "params": params, "variables": variables}
    for quant in (False, True):
        kw = (dict(transfer_quant="uint8") if quant
              else dict(transfer_dtype=np.int16))
        out[("jax", quant)] = np.stack([r["mask"] for r in JS.segment_volumes(
            None, jv, vols, batch_size=2, dtype=jnp.float32,
            device_preprocess=jax_znorm_batch,
            mask_fn=JU.packed_unet_mask_v2, pack_masks=True, **kw)])
        res = list(TS.segment_volumes(
            None, params, vols, batch_size=2, dtype=torch.float32,
            device="cpu", device_preprocess=torch_znorm_batch,
            mask_fn=TU.packed_unet_mask_v2, pack_masks=True, **kw))
        assert all(r["mask"].dtype == np.uint8 for r in res)
        out[("torch", quant)] = np.stack([r["mask"] for r in res])
    # JAX's logit margins on the int16 path, to tell ties from errors
    x = jax_znorm_batch(jnp.asarray(np.stack(vols))[..., None])
    logits = np.asarray(jax.jit(JU.packed_unet_apply_v2)(jv, x))
    out["margin"] = np.abs(logits[..., 1] - logits[..., 0])
    return out


def test_segment_volumes_matches_jax(served):
    ours, ref = served[("torch", False)], served[("jax", False)]
    assert ours.shape == ref.shape == (5, SIZE, SIZE, SIZE)
    clear = served["margin"] >= 1e-4
    np.testing.assert_array_equal(ours[clear], ref[clear])
    assert clear.mean() > 0.9


def test_uint8_transfer_matches_jax_and_int16(served):
    """The uint8 path agrees with JAX's uint8 path and with the int16
    path at the gate of tests/test_serving_quant.py."""
    ours = served[("torch", True)]
    assert np.mean(ours == served[("jax", True)]) >= 0.999
    assert np.mean(ours == served[("torch", False)]) >= 0.999


def test_pack_masks_round_trip(served):
    plain = np.stack([r["mask"] for r in TS.segment_volumes(
        None, served["params"], served["vols"], batch_size=2,
        dtype=torch.float32, device="cpu", transfer_dtype=np.int16,
        device_preprocess=torch_znorm_batch,
        mask_fn=TU.packed_unet_mask_v2)])
    np.testing.assert_array_equal(plain, served[("torch", False)])


def test_argmax_path_with_ragged_batch_matches_direct_forward(served):
    """apply_fn path (argmax of logits, host preprocess), 5 volumes at
    batch 3: every volume's mask equals the direct fine forward's."""
    model = torch_unet(served["variables"])
    vols = [v.astype(np.float32) for v in served["vols"]]
    res = list(TS.segment_volumes(
        lambda p, b: model(b), None, vols, batch_size=3,
        dtype=torch.float32, device="cpu",
        preprocess=lambda v: t_znorm(torch.from_numpy(v)).numpy()))
    assert len(res) == 5
    with torch.no_grad():
        for v, r in zip(vols, res):
            x = t_znorm(torch.from_numpy(v))[None, ..., None]
            direct = model(x).argmax(-1)[0].to(torch.uint8).numpy()
            np.testing.assert_array_equal(r["mask"], direct)


def test_quantize_u8_matches_jax():
    rng = np.random.default_rng(0)
    v = (rng.normal(size=(8, 8, 8, 1)) * 300 + 700).astype(np.int16)
    q, aff = TS._quantize_u8(v)
    jq, jaff = JS._quantize_u8(v)
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(aff, jaff)
    flat = np.zeros((4, 4, 4, 1), np.float32)
    q0, aff0 = TS._quantize_u8(flat)
    assert aff0[1] == 1.0 and (q0 == 0).all()


def test_packbits_matches_jax_and_unpacks():
    mask = (np.random.default_rng(1).random((2, 16, 5, 3)) > 0.5).astype(
        np.uint8)
    ours = TS._packbits_device(torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(
        ours, np.asarray(JS._packbits_device(jnp.asarray(mask))))
    np.testing.assert_array_equal(TS._unpackbits_host(ours, 16), mask)


@pytest.mark.parametrize("method", [None, "mean"])
def test_znormalization_matches_jax(method):
    v = (np.random.default_rng(2).normal(size=(6, 7, 8)) * 200 + 600
         ).astype(np.int16)
    np.testing.assert_allclose(
        t_znorm(torch.from_numpy(v), masking_method=method).numpy(),
        np.asarray(j_znorm(jnp.asarray(v), masking_method=method)),
        atol=1e-5)


def _apply_identity_logits(params, batch):
    return torch.cat([batch, -batch], dim=-1)


def test_producer_error_reraised_after_completed_batch():
    """A producer failure in volume 3 re-raises in the consumer, after the
    masks of the batch already computed are flushed."""
    vol = np.random.default_rng(3).normal(size=(8, 8, 8)).astype(np.float32)

    def volumes():
        yield vol
        yield vol
        raise RuntimeError("stream died")

    got = []
    with pytest.raises(RuntimeError, match="stream died"):
        for r in TS.segment_volumes(_apply_identity_logits, None, volumes(),
                                    batch_size=2, dtype=torch.float32,
                                    device="cpu"):
            got.append(r)
    assert len(got) == 2


def test_flushes_on_stream_pause():
    """A paused request stream still receives completed masks."""
    vol = np.random.default_rng(4).normal(size=(8, 8, 8)).astype(np.float32)
    got_first = threading.Event()

    def volumes():
        yield vol
        yield vol
        assert got_first.wait(timeout=60), "results withheld while paused"
        yield vol

    results = TS.segment_volumes(_apply_identity_logits, None, volumes(),
                                 batch_size=2, dtype=torch.float32,
                                 device="cpu")
    first = [next(results), next(results)]
    got_first.set()
    assert len(first) + len(list(results)) == 3


@pytest.mark.parametrize("case", ["dtype_and_preprocess", "unknown_quant",
                                  "quant_and_dtype", "quant_and_preprocess",
                                  "pack_odd_depth", "pack_multiclass"])
def test_argument_checks(case):
    vols = [np.zeros((8, 8, 8), np.float32)]
    kw = dict(batch_size=1, dtype=torch.float32, device="cpu")
    apply_fn = _apply_identity_logits
    if case == "dtype_and_preprocess":
        kw.update(transfer_dtype=np.int16, preprocess=lambda v: v)
        match = "mutually exclusive"
    elif case == "unknown_quant":
        kw.update(transfer_quant="int4")
        match = "unknown transfer_quant"
    elif case == "quant_and_dtype":
        kw.update(transfer_quant="uint8", transfer_dtype=np.int16)
        match = "replaces transfer_dtype"
    elif case == "quant_and_preprocess":
        kw.update(transfer_quant="uint8", preprocess=lambda v: v)
        match = "replaces transfer_dtype"
    elif case == "pack_odd_depth":
        vols = [np.zeros((9, 8, 8), np.float32)]
        kw.update(pack_masks=True)
        match = "divisible by 8"
    else:
        def apply_fn(params, batch):
            return torch.cat([batch] * 3, dim=-1)
        kw.update(pack_masks=True)
        match = "binary mask"
    with pytest.raises(ValueError, match=match):
        list(TS.segment_volumes(apply_fn, None, vols, **kw))


def test_entry_point_without_device_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        list(TS.segment_volumes(_apply_identity_logits, None,
                                [np.zeros((8, 8, 8), np.float32)]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        variables_to_state_dict({"params": {}})


def test_device_prefetcher_contract():
    """get(block=False) is None until a batch is staged (`exhausted`
    tells it from the end); the end is None; errors re-raise."""
    release = threading.Event()

    def batches():
        assert release.wait(timeout=60)
        yield np.ones((2, 3), np.float32)
        yield (np.zeros(2, np.uint8), np.ones(2, np.float32))

    pf = DevicePrefetcher(batches(), size=1, device="cpu")
    assert pf.get(block=False) is None and not pf.exhausted
    release.set()
    first = pf.get()
    assert isinstance(first, torch.Tensor) and first.shape == (2, 3)
    second = pf.get()
    assert isinstance(second, tuple) and second[0].dtype == torch.uint8
    assert pf.get() is None and pf.exhausted

    def failing():
        yield np.ones(1)
        raise OSError("disk")

    pf = DevicePrefetcher(failing(), device="cpu")
    pf.get()
    with pytest.raises(OSError, match="disk"):
        pf.get()
    assert pf.exhausted and pf.get() is None


def test_classify_fn_probs():
    """`classify_fn` rides along: per-volume softmax probabilities."""
    vols = [np.full((8, 8, 8), float(i), np.float32) for i in range(3)]

    def classify(params, batch):
        return torch.stack([batch.mean(dim=(1, 2, 3, 4)),
                            torch.zeros(batch.shape[0])], dim=-1)

    res = list(TS.segment_volumes(_apply_identity_logits, None, vols,
                                  batch_size=2, dtype=torch.float32,
                                  device="cpu", classify_fn=classify))
    assert len(res) == 3
    for i, r in enumerate(res):
        want = torch.softmax(torch.tensor([float(i), 0.0]), -1).numpy()
        np.testing.assert_allclose(r["probs"], want, rtol=1e-6)


# ---------------------------------------------------------------------------
# the seg+clf ensemble: packed UNet masks plus fader encoder/Classificator
# probabilities, composed by the caller as bench.py's `bench_ensemble` does
# ---------------------------------------------------------------------------

ENS_SIZE = 48          # a 3-block UNet and a deapth=2 fader encoder (-> 3^3)
# float32 on both sides; the probabilities differ only by summation order
PROBS_ATOL = 1e-5


def _ensemble_vols(rng, n):
    g = np.indices((ENS_SIZE,) * 3)
    vols = []
    for _ in range(n):
        v = rng.normal(size=(ENS_SIZE,) * 3) * 40 + 600
        c = rng.integers(12, 36, 3)
        v = v + 400 * np.exp(-(((g[0] - c[0]) ** 2 + (g[1] - c[1]) ** 2
                                + (g[2] - c[2]) ** 2) / 50.0))
        vols.append(v.astype(np.int16))
    return vols


@pytest.fixture(scope="module")
def ensemble():
    """3 volumes at batch 2 through both packages' ensemble serving, with
    the same bridged weights: masks from the BN-folded packed UNet,
    softmax probabilities from the fader encoder + Classificator."""
    from mri_epilepsy_diagnosis_torch.models import fader as TFd
    from mri_epilepsy_diagnosis_tpu.models import fader as JFd
    from test_torch_fader import ENC_KW, HEAD_KW as head_kw, randomized

    vols = _ensemble_vols(np.random.default_rng(14), 3)
    _, seg_v = jax_unet_variables(ocfl=8, nb=3, seed=11)
    # the random UNet labels every voxel foreground: shift the classifier
    # bias so that 30% of the voxels are, keeping the mask gate meaningful
    x = jax_znorm_batch(jnp.asarray(np.stack(vols))[..., None])
    logits = np.asarray(jax.jit(JU.packed_unet_apply_v2)(
        JU.fold_bn_inference(seg_v), x))
    margin = logits[..., 1] - logits[..., 0]
    shift = np.float32(np.quantile(margin, 0.7))
    clf_conv = seg_v["params"]["classifier"]["conv_layer"]
    clf_conv["bias"] = clf_conv["bias"] - np.asarray([0, shift], np.float32)
    jenc = JFd.make_encoder(ENC_KW)
    jclf = JFd.Classificator(n_class=2, **head_kw)
    x0 = jnp.zeros((1,) + (ENS_SIZE,) * 3 + (1,))
    enc_v = randomized(jenc.init(jax.random.key(12), x0), 12)
    clf_v = randomized(jclf.init(jax.random.key(13),
                                 jnp.zeros((1, 3, 3, 3, 16))), 13)
    # and its classifier saturates: rescale the last Linear so that the
    # three volumes' logit differences have mean 0 and spread 1
    _, hidden = jclf.apply(clf_v, jenc.apply(enc_v, x)[0],
                           return_hidden=True)
    lf = clf_v["params"]["clf__9_l_f"]
    z = np.asarray(hidden) @ lf["weight"]
    d = z[:, 1] - z[:, 0]
    lf["weight"] = lf["weight"] / d.std()
    lf["bias"] = np.asarray([0, -d.mean() / d.std()], np.float32)
    jparams = {"seg": JU.fold_bn_inference(seg_v), "enc": enc_v,
               "clf": clf_v}
    tenc = TFd.make_encoder(ENC_KW, device="cpu").eval()
    tenc.load_state_dict(variables_to_state_dict(enc_v, device="cpu"))
    tclf = TFd.Classificator(n_class=2, device="cpu", **head_kw).eval()
    tclf.load_state_dict(variables_to_state_dict(clf_v, device="cpu"))
    tparams = {"seg": TU.fold_bn_inference(
        variables_to_state_dict(seg_v, device="cpu")), "enc": tenc,
        "clf": tclf}
    kw = dict(batch_size=2, transfer_dtype=np.int16, pack_masks=True)

    ref = list(JS.segment_volumes(
        None, jparams, vols, dtype=jnp.float32,
        device_preprocess=jax_znorm_batch,
        mask_fn=lambda p, x: JU.packed_unet_mask_v2(p["seg"], x),
        classify_fn=lambda p, x: jclf.apply(p["clf"],
                                            jenc.apply(p["enc"], x)[0]),
        **kw))
    got = list(TS.segment_volumes(
        None, tparams, vols, dtype=torch.float32, device="cpu",
        device_preprocess=torch_znorm_batch,
        mask_fn=lambda p, x: TU.packed_unet_mask_v2(p["seg"], x),
        classify_fn=lambda p, x: p["clf"](p["enc"](x)[0]), **kw))
    # the bias shift moves every margin by the same amount
    return {"ref": ref, "got": got, "margin": np.abs(margin - shift)}


def test_ensemble_masks_match_jax(ensemble):
    ours = np.stack([r["mask"] for r in ensemble["got"]])
    ref = np.stack([r["mask"] for r in ensemble["ref"]])
    assert ours.shape == ref.shape == (3,) + (ENS_SIZE,) * 3
    # ties of the random net (|margin| < 1e-4) may round either way
    clear = ensemble["margin"] >= 1e-4
    np.testing.assert_array_equal(ours[clear], ref[clear])
    assert clear.mean() > 0.9 and 0.2 < ref.mean() < 0.4


def test_ensemble_probs_match_jax(ensemble):
    ours = np.stack([r["probs"] for r in ensemble["got"]])
    ref = np.stack([np.asarray(r["probs"]) for r in ensemble["ref"]])
    assert ours.shape == ref.shape == (3, 2) and ours.dtype == np.float32
    np.testing.assert_allclose(ours, ref, atol=PROBS_ATOL, rtol=0)
    np.testing.assert_allclose(ours.sum(-1), 1.0, atol=1e-6)
    # not degenerate: the three volumes get different probabilities
    assert np.ptp(ref[:, 1]) > 0.1 and (0.01 < ref).all()

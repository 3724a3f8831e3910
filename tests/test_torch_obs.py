"""Port parity: observability (`obs/logger.py`, `obs/profile.py`,
`obs/dashboard.py`, `obs/analysis.py`), `utils/viz_tools.py` and the
`dashboard` argument of the training loops, against the JAX package and,
for PCA and t-SNE, sklearn (which only the tests import), on the CPU.

Tolerances: the logger's records are equal apart from `ts`; the moving
average exactly; the dashboards' recorded updates of the JAX and the port
loops (bridged weights, the same batches, SGD, float32, JAX at "highest"
precision) 1e-5 relative; `collect_latents` 1e-4 x max|ref|; PCA 1e-6 x
max|ref| per component up to its sign; t-SNE's joint probabilities 1e-8
absolute and its gradient 1e-6 x max|ref| against sklearn's exact
internals.  A full t-SNE run is held to sklearn's exact run by KL (1%) and
trustworthiness (0.01), and to the JAX package's Barnes-Hut run by
trustworthiness (0.02), on points along a curve: exact t-SNE is chaotic
(on random points a 1e-13 relative nudge of the input moves the final KL
by several per cent), and a curve in 20 dimensions has one layout to
find."""
import copy
import json

import numpy as np
import optax
import pytest
import torch
from scipy.spatial.distance import squareform
from sklearn.decomposition import PCA
from sklearn.manifold import TSNE, trustworthiness
from sklearn.manifold import _t_sne as sk_tsne
from sklearn.metrics import pairwise_distances
from threadpoolctl import threadpool_limits

import jax
import jax.numpy as jnp

from mri_epilepsy_diagnosis_torch import obs as TO
from mri_epilepsy_diagnosis_torch.interop import variables_to_state_dict
from mri_epilepsy_diagnosis_torch.models import cnn as TCnn
from mri_epilepsy_diagnosis_torch.models import UNet3D as TUNet3D
from mri_epilepsy_diagnosis_torch.models import fader as TFd
from mri_epilepsy_diagnosis_torch.obs import analysis as TA
from mri_epilepsy_diagnosis_torch.train import classification as TC
from mri_epilepsy_diagnosis_torch.train import fader as TF
from mri_epilepsy_diagnosis_torch.train import resilience as TR
from mri_epilepsy_diagnosis_torch.train import seg as TS
from mri_epilepsy_diagnosis_torch.train.state import TrainState
from mri_epilepsy_diagnosis_torch.utils import viz_tools as TV
from mri_epilepsy_diagnosis_torch.utils.nifti import NiftiImage
from mri_epilepsy_diagnosis_tpu import obs as JO
from mri_epilepsy_diagnosis_tpu.models import cnn as JCnn
from mri_epilepsy_diagnosis_tpu.models import fader as JFd
from mri_epilepsy_diagnosis_tpu.obs import analysis as JA
from mri_epilepsy_diagnosis_tpu.train import classification as JC
from mri_epilepsy_diagnosis_tpu.train import fader as JF
from mri_epilepsy_diagnosis_tpu.train import resilience as JR
from mri_epilepsy_diagnosis_tpu.train import seg as JS
from mri_epilepsy_diagnosis_tpu.train.state import create_train_state
from test_torch_bridge import jax_unet_variables
from test_torch_fader import randomized

torch.set_num_threads(2)

REL_TOL = 1e-5
LATENT_TOL = 1e-4
PCA_TOL = 1e-6


# ---------------------------------------------------------------------------
# logger, step timer, dashboards, viz_tools
# ---------------------------------------------------------------------------


def _log_session(module, path):
    log = module.JsonlLogger(path)
    log.log_metric("train_dice_loss", 0.5)
    log.set_name("exp1")
    log.log_metric("train_dice_loss", np.float32(0.25), step=7)
    log.log_metrics({"mean_val_loss": 0.4, "val_metric": np.float64(0.9)},
                    epoch=3)
    log.log_metrics({"lambda": 1e-4}, step=2)
    log.log_epoch_end(3)
    log.close()
    records = [json.loads(line) for line in open(path)]
    for r in records:
        assert isinstance(r.pop("ts"), float)
    return records


def test_jsonl_logger_writes_the_jax_records(tmp_path):
    got = _log_session(TO, str(tmp_path / "port" / "m.jsonl"))
    ref = _log_session(JO, str(tmp_path / "jax" / "m.jsonl"))
    assert got == ref and len(got) == 5
    assert got[1] == {"metric": "train_dice_loss", "value": 0.25, "step": 7,
                      "experiment": "exp1"}


def test_experiment_factory_and_null_logger(tmp_path):
    exp = TO.Experiment(project_name="seg", log_dir=str(tmp_path))
    exp.log_metric("x", 1.0)
    exp.close()
    (path,) = tmp_path.iterdir()
    assert path.name.startswith("seg-") and path.suffix == ".jsonl"
    null = TO.NullLogger()
    null.log_metric("x", 1.0)
    null.log_metrics({"x": 1.0}, epoch=0)
    null.log_epoch_end(0)
    null.set_name("n")


def test_step_timer_on_cpu_tensors():
    t = TO.StepTimer()
    assert np.isnan(t.mean) and t.total == 0.0
    for _ in range(3):
        t.start()
        x = torch.ones((8, 8)) * 2
        t.stop(x, "not a tensor")
    assert len(t.times) == 3 and t.total >= t.mean > 0


@pytest.mark.parametrize("n,w", [(0, 20), (1, 20), (4, 2), (30, 20),
                                 (7, 7), (12, 1)])
def test_moving_average_matches_jax(n, w):
    x = np.random.default_rng(n).random(n) * 10
    np.testing.assert_array_equal(TO.moving_average(x, w),
                                  JO.moving_average(x, w))


def test_dashboards_write_pngs(tmp_path):
    out = tmp_path / "dash.png"
    d = TO.TrainingDashboard(metric_name="roc_auc", out_path=str(out))
    d.update(train_loss=1.0, val_loss=1.2, train_metric=0.5, val_metric=0.45)
    d.update(train_loss=np.float32(0.75), train_metric=0.6)
    assert d.train_loss == [1.0, 0.75] and d.val_loss == [1.2]
    assert out.stat().st_size > 1000
    hist = {k: list(np.random.default_rng(0).random(30) + 0.1)
            for k, _, _ in TO.FaderDashboard._PANELS}
    hist["roc"][3] = float("nan")     # single-class epochs give NaN
    fout = tmp_path / "fader.png"
    TO.FaderDashboard(out_path=str(fout)).update(hist)
    assert fout.stat().st_size > 1000
    assert TO.FaderDashboard._PANELS == JO.FaderDashboard._PANELS


def test_viz_tools_take_arrays_tensors_and_nifti(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.normal(size=(1, 16, 16, 16)).astype(np.float32)
    seg = (rng.random((1, 16, 16, 16)) > 0.5).astype(np.float32)
    for i, (im, sg) in enumerate((
            (img, seg), (torch.from_numpy(img)[None], torch.from_numpy(seg)),
            (NiftiImage(img[0], np.eye(4)), seg[0]))):
        TV.plot_central_cuts(im, title="t", save_path=str(tmp_path / f"a{i}"))
        TV.plot_predicted(im, sg, save_path=str(tmp_path / f"b{i}"))
        TV.plot_difference(im, sg, delta=1,
                           save_path=str(tmp_path / f"c{i}"))
    assert len(list(tmp_path.iterdir())) == 9
    assert all(p.stat().st_size > 1000 for p in tmp_path.iterdir())
    np.testing.assert_array_equal(TV._as_volume(torch.from_numpy(img)),
                                  img[0])


# ---------------------------------------------------------------------------
# the dashboard argument of the training loops, against JAX's
# ---------------------------------------------------------------------------


class Recorder:
    """A dashboard that keeps a copy of every update's arguments."""

    def __init__(self):
        self.calls = []

    def update(self, *args, **kw):
        self.calls.append(copy.deepcopy((args, kw)))


def _assert_same_values(got, ref):
    """Nested dicts, lists and tuples of floats (or None) equal within
    REL_TOL relative, NaN equal to NaN."""
    if isinstance(ref, dict):
        assert got.keys() == ref.keys()
        for k in ref:
            _assert_same_values(got[k], ref[k])
    elif isinstance(ref, (list, tuple)):
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            _assert_same_values(g, r)
    elif ref is None:
        assert got is None
    else:
        np.testing.assert_allclose(float(got), float(ref), rtol=REL_TOL,
                                   equal_nan=True)


CLASS_KW = dict(input_shape=(32,) * 3, n_filters=2)


def _volume_batches(seed, n):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(4, 32, 32, 32, 1)).astype(np.float32),
             np.array([0, 1, 1, 0], np.int32)) for _ in range(n)]


@pytest.mark.parametrize("with_val", [False, True])
def test_classification_dashboard_matches_jax(with_val):
    """`train` updates the dashboard once per epoch with the four values
    (validation None without a validation loader), as JAX's does
    (`test_torch_classification.py`'s VoxResNet, no Dropout)."""
    variables = randomized(jax.jit(JCnn.VoxResNet(**CLASS_KW).init)(
        jax.random.key(0), jnp.zeros((1, 32, 32, 32, 1))), seed=1)
    train_b, val_b = _volume_batches(2, 2), _volume_batches(3, 1)

    def metric(t, p):
        return float(np.mean(np.asarray(p)) + np.mean(t))

    jrec, trec = Recorder(), Recorder()
    jstate = create_train_state(
        JCnn.VoxResNet(**CLASS_KW), optax.sgd(1e-3), None,
        variables=jax.tree_util.tree_map(jnp.asarray, variables))
    with jax.default_matmul_precision("highest"):
        JC.train(jstate, train_b, val_b if with_val else None, metric,
                 max_epoch=2, eps=0.0, dashboard=jrec)
    model = TCnn.VoxResNet(device="cpu", **CLASS_KW)
    model.load_state_dict(variables_to_state_dict(variables, device="cpu"))
    TC.train(TrainState(model, torch.optim.SGD(model.parameters(), 1e-3)),
             train_b, val_b if with_val else None, metric, max_epoch=2,
             eps=0.0, dashboard=trec)
    assert len(trec.calls) == 2
    assert trec.calls[0][1].keys() == {"train_loss", "train_metric",
                                       "val_loss", "val_metric"}
    assert (trec.calls[0][1]["val_loss"] is None) == (not with_val)
    _assert_same_values(trec.calls, jrec.calls)


SEG_SIZE = 16


def _seg_batches(seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        x = rng.normal(size=(2, SEG_SIZE, SEG_SIZE, SEG_SIZE, 1)).astype(
            np.float32)
        blob = np.zeros(x.shape, bool)
        blob[:, 4:11, 3:12, 5:10] = True
        x[blob] += 2.0
        out.append((x, np.where(blob, 1002, 41).astype(np.float32)))
    return out


@pytest.fixture(scope="module")
def seg_variables():
    return jax_unet_variables(ocfl=4, nb=2, seed=5)


@pytest.mark.parametrize("loop", ["train_segmentation", "resilient"])
def test_segmentation_dashboard_matches_jax(tmp_path, seg_variables, loop):
    """`train_segmentation` and `train_segmentation_resilient` update the
    dashboard once per completed epoch with its mean train and validation
    losses, as JAX's loops do."""
    jmodel, variables = seg_variables
    train_b, val_b = _seg_batches(6), _seg_batches(7)
    jrec, trec = Recorder(), Recorder()
    jstate = create_train_state(
        jmodel, optax.sgd(1e-2), None,
        variables=jax.tree_util.tree_map(jnp.asarray, variables))
    model = TUNet3D(out_channels_first_layer=4, num_encoding_blocks=2,
                    device="cpu")
    model.load_state_dict(variables_to_state_dict(variables, device="cpu"))
    tstate = TrainState(model, torch.optim.SGD(model.parameters(), 1e-2))
    kw = dict(verbose=False)
    with jax.default_matmul_precision("highest"):
        if loop == "resilient":
            JR.train_segmentation_resilient(
                2, train_b, val_b, jstate, None,
                JR.CheckpointManager(str(tmp_path / "jax")), dashboard=jrec,
                **kw)
        else:
            JS.train_segmentation(2, train_b, val_b, jstate, None, "j",
                                  save_epoch=99, weights_dir=str(tmp_path),
                                  dashboard=jrec, **kw)
    if loop == "resilient":
        TR.train_segmentation_resilient(
            2, train_b, val_b, tstate, None,
            TR.CheckpointManager(str(tmp_path / "port")), dashboard=trec,
            **kw)
    else:
        TS.train_segmentation(2, train_b, val_b, tstate, None, "t",
                              save_epoch=99, weights_dir=str(tmp_path),
                              dashboard=trec, **kw)
    assert len(trec.calls) == 2
    assert trec.calls[0] == ((), {"train_loss": trec.calls[0][1][
        "train_loss"], "val_loss": trec.calls[0][1]["val_loss"]})
    _assert_same_values(trec.calls, jrec.calls)


FADER_SIZE = 12
N_DOMAINS = 3
ENC_KW = dict(c_in=1, deapth=1, c_base=8, inc_size=2, reduce_size=False,
              down_block_kwargs=dict(conv_k=6, conv_pad=2, conv_s=2,
                                     maxpool_k=2, maxpool_s=2,
                                     batch_norm=True, act="l_relu"))
HEAD_KW = dict(c_in=8, c_out=16, conv_k=3, conv_s=1, conv_pad=0, l_in=16,
               l_out=8, batch_norm=True, act="relu", p_drop=0.0)


@pytest.fixture(scope="module")
def fader_case():
    """JAX-initialised fader encoder, classifier and discriminator
    variables (random BatchNorm statistics and biases) and batches of
    (x, y, domain)."""
    rng = np.random.default_rng(8)
    batches = [(rng.normal(size=(4,) + (FADER_SIZE,) * 3 + (1,)).astype(
        np.float32), np.array([0, 1, 1, 0], np.int32),
        np.array([0, 2, 1, 2], np.int32)) for _ in range(2)]
    x = jnp.asarray(batches[0][0])
    jenc = JFd.make_encoder(ENC_KW)
    venc = randomized(jax.jit(jenc.init)(jax.random.key(1), x), 2)
    latent, _ = jenc.apply(venc, x)
    vclf = randomized(jax.jit(JFd.Classificator(n_class=2, **HEAD_KW).init)(
        jax.random.key(3), latent), 4)
    vdisc = randomized(jax.jit(JFd.Discriminator(
        n_domains=N_DOMAINS, **HEAD_KW).init)(jax.random.key(5), latent), 6)
    return batches, venc, vclf, vdisc


def _torch_fader(venc, vclf, vdisc):
    enc = TFd.make_encoder(ENC_KW, device="cpu")
    clf = TFd.Classificator(n_class=2, device="cpu", **HEAD_KW)
    disc = TFd.Discriminator(n_domains=N_DOMAINS, device="cpu", **HEAD_KW)
    for m, v in ((enc, venc), (clf, vclf), (disc, vdisc)):
        m.load_state_dict(variables_to_state_dict(v, device="cpu"),
                          strict=True)
    return enc, clf, disc


def test_fader_dashboard_matches_jax(fader_case):
    """`train_fader` hands the dashboard its history after each epoch, as
    JAX's does: the same keys and values."""
    batches, venc, vclf, vdisc = fader_case
    lr = 1e-3

    def jstate(module, v):
        return create_train_state(
            module, optax.sgd(lr), None,
            variables=jax.tree_util.tree_map(jnp.asarray, v))

    jfs = JF.FaderState(
        encoder=jstate(JFd.make_encoder(ENC_KW), venc),
        clf=jstate(JFd.Classificator(n_class=2, **HEAD_KW), vclf),
        disc=jstate(JFd.Discriminator(n_domains=N_DOMAINS, **HEAD_KW),
                    vdisc))
    enc, clf, disc = _torch_fader(venc, vclf, vdisc)
    tfs = TF.FaderState(*(TrainState(m, torch.optim.SGD(m.parameters(), lr))
                          for m in (enc, clf, disc)))
    args = (batches, batches[:1], 2, 1e-4, 0.05, 3, N_DOMAINS)
    kw = dict(disc_loop=2, class_weight=[1.0, 2.0], verbose=False)
    jrec, trec = Recorder(), Recorder()
    with jax.default_matmul_precision("highest"):
        JF.train_fader(jfs, *args, dashboard=jrec, **kw)
    TF.train_fader(tfs, *args, dashboard=trec, **kw)
    assert len(trec.calls) == 2 and len(trec.calls[0][0]) == 1
    assert len(trec.calls[1][0][0]["train_loss"]) == 4
    _assert_same_values(trec.calls, jrec.calls)


# ---------------------------------------------------------------------------
# latent analysis
# ---------------------------------------------------------------------------


def test_collect_latents_matches_jax(fader_case):
    """The encoder's latents and the heads' hidden embeddings over a
    loader, in eval mode (the modules' modes are given back)."""
    batches, venc, vclf, vdisc = fader_case
    jenc = JFd.make_encoder(ENC_KW)
    jclf = JFd.Classificator(n_class=2, **HEAD_KW)
    jdisc = JFd.Discriminator(n_domains=N_DOMAINS, **HEAD_KW)
    with jax.default_matmul_precision("highest"):
        ref = JA.collect_latents(jenc.apply, venc, batches, jdisc.apply,
                                 vdisc, jclf.apply, vclf)
    enc, clf, disc = _torch_fader(venc, vclf, vdisc)
    enc.train()
    clf.eval()
    got = TA.collect_latents(enc, batches, disc=disc, clf=clf, device="cpu")
    assert enc.training and not clf.training
    assert got.keys() == ref.keys() == {"encoder", "disc", "clf", "targets",
                                        "domains"}
    for k in ("encoder", "disc", "clf"):
        assert got[k].shape == ref[k].shape and got[k].dtype == np.float32
        assert np.abs(got[k] - ref[k]).max() <= (
            LATENT_TOL * np.abs(ref[k]).max()), k
    for k in ("targets", "domains"):
        np.testing.assert_array_equal(got[k], ref[k])
    only = TA.collect_latents(enc, batches, device="cpu")
    assert only.keys() == {"encoder", "targets", "domains"}


def _curve(seed=1, n=60):
    """Points along a helix in 20 dimensions (see the module docstring)."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 3 * np.pi, n)
    return (np.stack([np.cos(t), np.sin(t), t / 3], 1)
            @ rng.normal(size=(3, 20)) + 1e-3 * rng.normal(size=(n, 20)))


def _blobs(seed=0):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.normal(size=(40, 20))
                           + 3 * rng.normal(size=(1, 20)) for _ in range(3)])


@pytest.mark.parametrize("n_components", [2, 3])
def test_pca_embed_matches_sklearn(n_components):
    x = _blobs(1)
    ref = PCA(n_components).fit_transform(x)
    got = TA.pca_embed(x, n_components, device="cpu")
    for k in range(n_components):
        err = min(np.abs(got[:, k] - s * ref[:, k]).max() for s in (1, -1))
        assert err <= PCA_TOL * np.abs(ref[:, k]).max(), k


@pytest.mark.parametrize("perplexity", [5.0, 30.0])
def test_tsne_joint_probabilities_match_sklearn(perplexity):
    x = _blobs(2)
    ref = squareform(sk_tsne._joint_probabilities(
        pairwise_distances(x, squared=True), perplexity, 0))
    got = TA.joint_probabilities(x, perplexity, device="cpu").numpy()
    assert np.abs(got - ref).max() <= 1e-8


def test_tsne_gradient_matches_sklearn():
    x = _blobs(3)
    p = TA.joint_probabilities(x, device="cpu")
    y = np.random.default_rng(4).normal(size=(len(x), 2))
    kl_ref, grad_ref = sk_tsne._kl_divergence(
        y.ravel(), squareform(p.numpy(), checks=False), 1, len(x), 2)
    kl, grad = TA.kl_divergence(y, p)
    np.testing.assert_allclose(float(kl), kl_ref, rtol=1e-6)
    assert np.abs(grad.numpy().ravel() - grad_ref).max() <= (
        1e-6 * np.abs(grad_ref).max())


def test_tsne_run_matches_sklearn_exact_and_jax():
    x = _curve()
    p = TA.joint_probabilities(x, device="cpu")
    # one thread: sklearn's OpenMP pool spins against the other test
    # workers' threads and slows a sub-second run a hundredfold
    with threadpool_limits(limits=1):
        ref = TSNE(2, method="exact", learning_rate=50.0, max_iter=2000,
                   random_state=42).fit_transform(x)
        jax_bh = JA.tsne_embed(x)
    got = TA.tsne_embed(x, device="cpu")
    assert got.shape == (len(x), 2) and np.isfinite(got).all()
    kl_ref, kl = (float(TA.kl_divergence(y, p)[0]) for y in (
        ref.astype(np.float64), got))
    assert abs(kl - kl_ref) <= 0.01 * kl_ref
    trust = trustworthiness(x, got)
    assert abs(trust - trustworthiness(x, ref)) <= 0.01
    assert abs(trust - trustworthiness(x, jax_bh)) <= 0.02
    assert TA.trustworthiness(x, got, device="cpu") == pytest.approx(
        trust, abs=1e-12)
    with pytest.raises(ValueError, match="perplexity"):
        TA.tsne_embed(x[:20], device="cpu")


def test_tsne_plot_writes_a_figure(tmp_path):
    x = _curve(2, 40)
    latents = {"encoder": x, "clf": x[:, :5],
               "domains": np.arange(len(x)) % 3}
    path = tmp_path / "tsne.png"
    embeds = TA.tsne_plot(latents, keys=["a", "b", "c"],
                          save_path=str(path), device="cpu")
    assert embeds.keys() == {"encoder", "clf"} and path.stat().st_size > 1000

"""Port parity: fader training (`train/fader.py`: `disc_step`,
`enc_clf_step`, `ae_step`, `train_fader`; the fader models in train mode)
against the JAX package's `train/fader.py`, on the CPU.

The steps run at 12^3 with one encoder block (the reference's k=6/s=2
DownBlock, a 3^3 latent), p_drop 0, float32, on both sides from the same
JAX-initialised variables (random BatchNorm statistics and biases) and the
same numpy inputs.  Their optimizer is SGD at lr 1 in both packages, so
that the updated parameters p - g hold the gradient at full weight.
Tolerances: losses 1e-5 relative; updated parameters and BatchNorm
statistics 1e-5 x max|ref| per leaf, plus a floor of 1e-6 x the largest
leaf for the conv biases before a max pool and BatchNorm, whose true
gradient is 0 and whose computed one is float32 noise on both sides."""
import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from mri_epilepsy_diagnosis_torch.interop import variables_to_state_dict
from mri_epilepsy_diagnosis_torch.models import fader as TFd
from mri_epilepsy_diagnosis_torch.ops import functional as TFn
from mri_epilepsy_diagnosis_torch.train import fader as TF
from mri_epilepsy_diagnosis_torch.train.state import TrainState
from mri_epilepsy_diagnosis_tpu.models import fader as JFd
from mri_epilepsy_diagnosis_tpu.ops.layers import BatchNorm as JBatchNorm
from mri_epilepsy_diagnosis_tpu.train import fader as JF
from mri_epilepsy_diagnosis_tpu.train.state import create_train_state
from test_torch_fader import randomized

torch.set_num_threads(2)

REL_TOL = 1e-5
FLOOR = 1e-6
SIZE = 12
N = 4
N_DOMAINS = 3
DOWN = dict(conv_k=6, conv_pad=2, conv_s=2, maxpool_k=2, maxpool_s=2,
            batch_norm=True, act="l_relu")
ENC_KW = dict(c_in=1, deapth=1, c_base=8, inc_size=2, reduce_size=False,
              down_block_kwargs=DOWN)
HEAD_KW = dict(c_in=8, c_out=16, conv_k=3, conv_s=1, conv_pad=0, l_in=16,
               l_out=8, batch_norm=True, act="relu", p_drop=0.0)
# train_AE.ipynb cell 8 geometry at 12^3, depth 1: a 6^3 x 4 latent whose
# discriminator halves it with a 2^3/s2 conv (examples/train_ae.py)
AE_KW = dict(c_in=1, deapth=1, c_base=4, inc_size=2,
             down_block_kwargs=dict(conv_k=3, conv_pad=1, conv_s=1,
                                    maxpool_k=2, maxpool_s=2,
                                    batch_norm=True, act="relu"),
             up_block_kwargs=dict(up="upsample", scale=2,
                                  scale_mode="nearest", conv_k=3,
                                  conv_pad=1, conv_s=1, batch_norm=True,
                                  act="relu"))
AE_DISC_KW = dict(c_in=4, c_out=8, conv_k=2, conv_s=2, conv_pad=0,
                  l_in=8 * 27, l_out=8, batch_norm=False, act="l_relu",
                  p_drop=0.0)
LAMBDA = 0.3
CLASS_WEIGHT = [1.0, 2.0]


def _sd(variables):
    return variables_to_state_dict(
        jax.tree_util.tree_map(np.asarray, variables), device="cpu")


def _init(module, x, seed):
    variables = jax.jit(module.init)(jax.random.key(seed), jnp.asarray(x))
    return randomized(variables, seed)


def _jstate(module, variables):
    return create_train_state(
        module, optax.sgd(1.0), None,
        variables=jax.tree_util.tree_map(jnp.asarray, variables))


def _tstate(model):
    return TrainState(model, torch.optim.SGD(model.parameters(), lr=1.0))


def _torch(module, variables):
    module.load_state_dict(variables_to_state_dict(variables, device="cpu"),
                           strict=True)
    return module


def _assert_state_close(model, ref_variables, trained: bool):
    """The torch model's state dict against the JAX variables after the
    step (see the module docstring for the tolerances)."""
    ref = _sd(ref_variables)
    got = model.state_dict()
    assert got.keys() == ref.keys()
    floor = FLOOR * max(float(v.abs().max()) for v in ref.values())
    for k, r in ref.items():
        if k.endswith("num_batches_tracked"):
            assert int(got[k]) == int(trained), k
            continue
        err = float((got[k] - r).abs().max())
        assert err <= REL_TOL * float(r.abs().max()) + floor, (k, err)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, SIZE, SIZE, SIZE, 1)).astype(np.float32)
    y = np.array([0, 1, 1, 0], np.int32)
    dom = np.array([0, 2, 1, 2], np.int32)
    return x, y, dom


@pytest.fixture(scope="module")
def enc_clf_case():
    """JAX variables of the encoder, classifier and discriminator, the
    inputs, and the JAX states after one disc_step and one enc_clf_step
    (each from the initial variables)."""
    x, y, dom = _inputs(1)
    jenc = JFd.make_encoder(ENC_KW)
    jclf = JFd.Classificator(n_class=2, **HEAD_KW)
    jdisc = JFd.Discriminator(n_domains=N_DOMAINS, **HEAD_KW)
    venc = _init(jenc, x, 2)
    latent, _ = jenc.apply(venc, jnp.asarray(x))
    vclf, vdisc = _init(jclf, latent, 3), _init(jdisc, latent, 4)

    def fstate():
        return JF.FaderState(encoder=_jstate(jenc, venc),
                             clf=_jstate(jclf, vclf),
                             disc=_jstate(jdisc, vdisc))

    key = jax.random.key(0)
    with jax.default_matmul_precision("highest"):
        ds, d_loss, d_logits = JF.disc_step(fstate(), jnp.asarray(x),
                                            jnp.asarray(dom), key, N_DOMAINS)
        es, e_loss, e_adv, e_logits = JF.enc_clf_step(
            fstate(), jnp.asarray(x), jnp.asarray(y), jnp.asarray(dom),
            jnp.float32(LAMBDA), key, N_DOMAINS,
            jnp.asarray(CLASS_WEIGHT, jnp.float32))
    return dict(x=x, y=y, dom=dom, venc=venc, vclf=vclf, vdisc=vdisc,
                disc=(ds, float(d_loss), np.asarray(d_logits)),
                enc_clf=(es, float(e_loss), float(e_adv),
                         np.asarray(e_logits)))


def _torch_fstate(case):
    enc = _torch(TFd.make_encoder(ENC_KW, device="cpu"), case["venc"])
    clf = _torch(TFd.Classificator(n_class=2, device="cpu", **HEAD_KW),
                 case["vclf"])
    disc = _torch(TFd.Discriminator(n_domains=N_DOMAINS, device="cpu",
                                    **HEAD_KW), case["vdisc"])
    return TF.FaderState(encoder=_tstate(enc), clf=_tstate(clf),
                         disc=_tstate(disc))


def _variables(jstate):
    v = {"params": jstate.params}
    if jstate.batch_stats is not None:
        v["batch_stats"] = jstate.batch_stats
    return v


def test_disc_step_matches_jax(enc_clf_case):
    case = enc_clf_case
    fs = _torch_fstate(case)
    fs, loss, logits = TF.disc_step(fs, torch.from_numpy(case["x"]),
                                    torch.from_numpy(case["dom"]), None,
                                    N_DOMAINS)
    ds, ref_loss, ref_logits = case["disc"]
    np.testing.assert_allclose(loss.item(), ref_loss, rtol=REL_TOL)
    assert np.abs(logits.numpy() - ref_logits).max() <= (
        REL_TOL * np.abs(ref_logits).max())
    _assert_state_close(fs.disc.model, _variables(ds.disc), trained=True)
    # the encoder ran in eval mode under no_grad: nothing of it moved
    _assert_state_close(fs.encoder.model, case["venc"], trained=False)
    assert fs.disc.step == 1 and fs.encoder.step == 0
    assert all(p.grad is None for p in fs.disc.model.parameters())


def test_enc_clf_step_matches_jax(enc_clf_case):
    case = enc_clf_case
    fs = _torch_fstate(case)
    fs, loss, loss_adv, logits = TF.enc_clf_step(
        fs, torch.from_numpy(case["x"]), torch.from_numpy(case["y"]),
        torch.from_numpy(case["dom"]), LAMBDA, None, N_DOMAINS,
        CLASS_WEIGHT)
    es, ref_loss, ref_adv, ref_logits = case["enc_clf"]
    np.testing.assert_allclose(loss.item(), ref_loss, rtol=REL_TOL)
    np.testing.assert_allclose(loss_adv.item(), ref_adv, rtol=REL_TOL)
    assert np.abs(logits.numpy() - ref_logits).max() <= (
        REL_TOL * np.abs(ref_logits).max())
    _assert_state_close(fs.encoder.model, _variables(es.encoder), True)
    _assert_state_close(fs.clf.model, _variables(es.clf), True)
    # the frozen discriminator: no gradient, no update, no BN update
    _assert_state_close(fs.disc.model, case["vdisc"], trained=False)
    assert all(p.grad is None and p.requires_grad
               for p in fs.disc.model.parameters())
    assert (fs.encoder.step, fs.clf.step, fs.disc.step) == (1, 1, 0)


@pytest.fixture(scope="module")
def ae_case():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(N, SIZE, SIZE, SIZE, 1)).astype(np.float32)
    dom = np.array([1, 0, 2, 2], np.int32)
    jae = JFd.AE(**AE_KW)
    vae = _init(jae, x, 6)
    latent, sizes = jae.apply(vae, jnp.asarray(x), method=JFd.AE.encode)
    jdisc = JFd.Discriminator(n_domains=N_DOMAINS, **AE_DISC_KW)
    vdisc = _init(jdisc, latent, 7)
    chans = JFd._build_channels(1, 4, 2, 1)
    jenc = JFd.Encoder(deapth=1, chanels=tuple(chans),
                       down_block_kwargs=AE_KW["down_block_kwargs"])
    jdec = JFd.Decoder(deapth=1, chanels=tuple(chans[::-1]),
                       up_block_kwargs=AE_KW["up_block_kwargs"])
    venc = {"params": vae["params"]["enc"],
            "batch_stats": vae["batch_stats"]["enc"]}
    vdec = {"params": vae["params"]["dec"],
            "batch_stats": vae["batch_stats"]["dec"]}
    fstate = JF.FaderState(encoder=_jstate(jenc, venc), clf=None,
                           disc=_jstate(jdisc, vdisc),
                           decoder=_jstate(jdec, vdec))
    with jax.default_matmul_precision("highest"):
        new, loss = JF.ae_step(fstate, jnp.asarray(x), jnp.asarray(dom),
                               jnp.float32(LAMBDA), jax.random.key(0))
    return dict(x=x, dom=dom, vae=vae, vdisc=vdisc, new=new,
                loss=float(loss))


def test_ae_step_matches_jax(ae_case):
    case = ae_case
    ae = _torch(TFd.AE(device="cpu", **AE_KW), case["vae"])
    disc = _torch(TFd.Discriminator(n_domains=N_DOMAINS, device="cpu",
                                    **AE_DISC_KW), case["vdisc"])
    fs = TF.FaderState(encoder=_tstate(ae.enc), clf=None,
                       disc=_tstate(disc), decoder=_tstate(ae.dec))
    fs, loss = TF.ae_step(fs, torch.from_numpy(case["x"]),
                          torch.from_numpy(case["dom"]), LAMBDA, None)
    np.testing.assert_allclose(loss.item(), case["loss"], rtol=REL_TOL)
    _assert_state_close(fs.encoder.model, _variables(case["new"].encoder),
                        True)
    _assert_state_close(fs.decoder.model, _variables(case["new"].decoder),
                        True)
    _assert_state_close(fs.disc.model, case["vdisc"], trained=False)
    assert all(p.grad is None for p in disc.parameters())


@pytest.mark.parametrize("shape", [(6, 5), (3, 4, 5, 6, 7)])
def test_train_mode_batch_norm_matches_jax(shape):
    """Batch statistics (biased variance) normalize; the running ones move
    by torch's momentum 0.1 with the unbiased variance, as JAX's
    `ops/layers.py::BatchNorm`."""
    rng = np.random.default_rng(8)
    x = (rng.normal(size=shape) * 3 + 1).astype(np.float32)
    c = shape[-1]
    stats = {"running_mean": rng.normal(size=c).astype(np.float32),
             "running_var": rng.uniform(0.5, 1.5, c).astype(np.float32)}
    params = {"weight": rng.uniform(0.5, 1.5, c).astype(np.float32),
              "bias": rng.normal(size=c).astype(np.float32)}
    ref, new = JBatchNorm(c).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x),
        use_running_average=False, mutable=["batch_stats"])
    bn = (torch.nn.BatchNorm1d if len(shape) == 2 else
          torch.nn.BatchNorm3d)(c)
    bn.load_state_dict({**{k: torch.from_numpy(v) for k, v in
                           {**stats, **params}.items()},
                        "num_batches_tracked": torch.tensor(0)})
    got = TFn.module_batch_norm(bn.train(), torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=0, atol=REL_TOL * np.abs(ref).max())
    for k in stats:
        np.testing.assert_allclose(
            getattr(bn, k).numpy(), np.asarray(new["batch_stats"][k]),
            rtol=0, atol=REL_TOL)
    assert int(bn.num_batches_tracked) == 1
    # eval mode: the running statistics, nothing moves
    before = bn.running_mean.clone()
    TFn.module_batch_norm(bn.eval(), torch.from_numpy(x))
    assert torch.equal(bn.running_mean, before)


def test_train_mode_batch_norm_refuses_one_value_per_channel():
    bn = torch.nn.BatchNorm1d(4).train()
    with pytest.raises(ValueError, match="more than 1 value per channel"):
        TFn.module_batch_norm(bn, torch.zeros(1, 4))


def test_dropout_core_is_jax_inverted_dropout():
    """Given the keep mask, the port's core is JAX's `ops/layers.py::
    Dropout` expression `where(mask, x / keep, 0)` exactly."""
    rng = np.random.default_rng(9)
    x = rng.normal(size=(6, 32)).astype(np.float32)
    mask = rng.random((6, 32)) < 0.5
    ref = jnp.where(jnp.asarray(mask), jnp.asarray(x) / 0.5, 0.0)
    got = TFn.dropout_core(torch.from_numpy(x), torch.from_numpy(mask), 0.5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_dropout_draws_from_its_generator():
    x = torch.ones(64, 32)
    a = TFn.dropout(x, 0.5, True, torch.Generator().manual_seed(3))
    b = TFn.dropout(x, 0.5, True, torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    assert set(a.unique().tolist()) == {0.0, 2.0}
    assert 0.4 < (a > 0).float().mean().item() < 0.6
    assert TFn.dropout(x, 0.5, False) is x
    assert TFn.dropout(x, 0.0, True) is x


def test_heads_apply_dropout_in_train_mode_only():
    head = TFd.Classificator(n_class=2, device="cpu",
                             **dict(HEAD_KW, p_drop=0.5))
    z = torch.randn(N, 3, 3, 3, 8)
    g = torch.Generator().manual_seed(0)
    _, hidden = head.train()(z, return_hidden=True, generator=g)
    assert (hidden == 0).float().mean() > 0.3
    with torch.no_grad():
        _, h1 = head.eval()(z, return_hidden=True)
    assert (h1 == torch.relu(h1)).all()


@pytest.mark.parametrize("weighted", [False, True])
def test_adv_and_main_loss_match_jax(weighted):
    rng = np.random.default_rng(10)
    clf = rng.normal(size=(5, 2)).astype(np.float32)
    disc = rng.normal(size=(5, 4)).astype(np.float32)
    y = np.array([0, 1, 1, 0, 1])
    dom = np.array([3, 0, 2, 1, 3])
    cw = [1.0, 2.0] if weighted else None
    ref, ref_adv = JF.fader_main_loss(
        jnp.asarray(clf), jnp.asarray(y), jnp.asarray(disc),
        jnp.asarray(dom), 0.25, 4,
        None if cw is None else jnp.asarray(cw))
    got, adv = TF.fader_main_loss(torch.from_numpy(clf), torch.from_numpy(y),
                                  torch.from_numpy(disc),
                                  torch.from_numpy(dom), 0.25, 4, cw)
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6)
    np.testing.assert_allclose(adv.item(), float(ref_adv), rtol=1e-6)
    np.testing.assert_allclose(
        TF.adv_loss(torch.from_numpy(dom), torch.from_numpy(disc), 4).item(),
        float(JF.adv_loss(jnp.asarray(dom), jnp.asarray(disc), 4)),
        rtol=1e-6)


class _Loader:
    def __init__(self, batches):
        self.batches = batches

    def __iter__(self):
        return iter(self.batches)


def test_train_fader_schedule_and_history(monkeypatch):
    """`disc_loop` discriminator steps per batch while epoch < 5, then 1;
    lambda grows by lambda_step per step while step < max_step; the
    history has the JAX package's keys and lengths."""
    torch.manual_seed(0)
    enc = TFd.make_encoder(ENC_KW, device="cpu")
    clf = TFd.Classificator(n_class=2, device="cpu", **HEAD_KW)
    disc = TFd.Discriminator(n_domains=N_DOMAINS, device="cpu", **HEAD_KW)
    opt = lambda m: TrainState(m, torch.optim.Adam(m.parameters(), 1e-4))
    fs = TF.FaderState(encoder=opt(enc), clf=opt(clf), disc=opt(disc))
    rng = np.random.default_rng(11)
    batches = [(rng.normal(size=(N, SIZE, SIZE, SIZE, 1)).astype(np.float32),
                np.array([0, 1, 0, 1]), np.array([0, 1, 2, 0]))
               for _ in range(2)]
    calls = []
    disc_step, enc_clf_step = TF.disc_step, TF.enc_clf_step

    def rec_disc(*a, **kw):
        calls.append("d")
        return disc_step(*a, **kw)

    def rec_enc(fstate, x, y, dom, lambda_t, *a, **kw):
        calls.append(("e", lambda_t))
        return enc_clf_step(fstate, x, y, dom, lambda_t, *a, **kw)

    monkeypatch.setattr(TF, "disc_step", rec_disc)
    monkeypatch.setattr(TF, "enc_clf_step", rec_enc)
    fs, hist = TF.train_fader(fs, _Loader(batches), _Loader(batches[:1]),
                              epochs=6, lambda_initial=1e-4,
                              lambda_step=0.1, max_step=4,
                              n_domains=N_DOMAINS, disc_loop=3,
                              class_weight=CLASS_WEIGHT, verbose=False)
    disc_per_batch, n = [], 0
    for c in calls:
        if c == "d":
            n += 1
        else:
            disc_per_batch.append(n)
            n = 0
    assert disc_per_batch == [3] * 10 + [1] * 2
    lambdas = [c[1] for c in calls if c != "d"]
    want = [1e-4 + 0.1 * min(i, 3) for i in range(12)]
    np.testing.assert_allclose(lambdas, want, rtol=1e-12)
    assert set(hist) == {"train_loss", "train_loss_disc", "train_loss_adv",
                         "val_loss", "val_loss_disc", "acc_train",
                         "roc_train", "acc_domain_train", "acc", "roc",
                         "acc_domain"}
    assert len(hist["train_loss"]) == 12 and len(hist["acc"]) == 6
    assert all(np.isfinite(hist["train_loss"]))
    # the dashboard gets the history after each epoch, as in JAX
    # (`test_torch_obs.py` holds its values to JAX's)
    seen = []

    class Dashboard:
        def update(self, h):
            seen.append({k: len(v) for k, v in h.items()})

    TF.train_fader(fs, _Loader(batches), None, 2, 0.0, 0.0, 1, N_DOMAINS,
                   dashboard=Dashboard(), verbose=False)
    assert len(seen) == 2 and set(seen[0]) == set(hist)
    assert [s["train_loss"] for s in seen] == [2, 4]
    assert [s["acc_train"] for s in seen] == [1, 2]


"""Port parity: the classification CNNs (`models/cnn.py`: BasicBlock,
VoxResNet, CNN, LSTM, ConvLSTM, DilatedCNN) against the JAX package's
`models/cnn.py`, in eval mode and in train mode (batch statistics, the
running ones moved), with JAX-initialised variables (random BatchNorm
statistics and biases) carried across by `interop.variables_to_state_dict`.

DilatedCNN's flatten needs an input of at least 157^3: it runs at 160^3
with n_channels=2; the others at 32^3 or less.  float32, JAX at "highest"
precision.  Tolerance: 1e-5 x max|ref|, from summation order."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mri_epilepsy_diagnosis_torch.interop import variables_to_state_dict
from mri_epilepsy_diagnosis_torch.models import cnn as TC
from mri_epilepsy_diagnosis_tpu.models import cnn as JC
from test_torch_fader import randomized

torch.set_num_threads(2)

REL_TOL = 1e-5

# name: (JAX module, port module factory, input shape)
CASES = {
    "basic_block": (JC.BasicBlock(4, 4),
                    lambda: TC.BasicBlock(4, 4, device="cpu"),
                    (2, 8, 8, 8, 4)),
    "voxresnet": (JC.VoxResNet(input_shape=(32,) * 3, n_filters=4),
                  lambda: TC.VoxResNet(input_shape=(32,) * 3, n_filters=4,
                                       device="cpu"), (2, 32, 32, 32, 1)),
    # n_blocks 4: no activation after fully_conn_1 (the reference's
    # duplicated `activation_6`)
    "voxresnet_4": (JC.VoxResNet(input_shape=(32,) * 3, n_filters=2,
                                 n_blocks=4),
                    lambda: TC.VoxResNet(input_shape=(32,) * 3, n_filters=2,
                                         n_blocks=4, device="cpu"),
                    (2, 32, 32, 32, 1)),
    "cnn": (JC.CNN(input_shape=(16,) * 3, n_filters=4, n_fc_units=8),
            lambda: TC.CNN(input_shape=(16,) * 3, n_filters=4, n_fc_units=8,
                           device="cpu"), (3, 16, 16, 16, 1)),
    "lstm": (JC.LSTM(6, 4, 2), lambda: TC.LSTM(6, 4, 2, device="cpu"),
             (2, 5, 6)),
    "conv_lstm": (JC.ConvLSTM(input_shape=(16,) * 3, n_outputs=1,
                              hidden_size=6, n_fc_units_rnn=5, n_filters=2,
                              n_fc_units_cnn=8),
                  lambda: TC.ConvLSTM(input_shape=(16,) * 3, n_outputs=1,
                                      hidden_size=6, n_fc_units_rnn=5,
                                      n_filters=2, n_fc_units_cnn=8,
                                      device="cpu"), (2, 3, 16, 16, 16, 1)),
    "dilated_cnn": (JC.DilatedCNN(input_shape=(160,) * 3, n_channels=2),
                    lambda: TC.DilatedCNN(input_shape=(160,) * 3,
                                          n_channels=2, device="cpu"),
                    (2, 160, 160, 160, 1)),
}
HAS_TRAIN = {"lstm": False}
# the six modules at small widths, built with no device: the card's
DEFAULT_DEVICE_CASES = {
    "basic_block": lambda: TC.BasicBlock(2, 2),
    "voxresnet": lambda: TC.VoxResNet(input_shape=(16,) * 3, n_filters=2),
    "cnn": lambda: TC.CNN(input_shape=(16,) * 3, n_filters=2, n_fc_units=4),
    "lstm": lambda: TC.LSTM(3, 2, 1),
    "conv_lstm": lambda: TC.ConvLSTM(input_shape=(16,) * 3, n_outputs=1,
                                     hidden_size=2, n_fc_units_rnn=2,
                                     n_filters=2, n_fc_units_cnn=4),
    "dilated_cnn": lambda: TC.DilatedCNN(input_shape=(160,) * 3,
                                         n_channels=1),
}


@pytest.fixture(scope="module", params=list(CASES))
def bridged(request):
    """(name, torch module, JAX variables, input, JAX eval output, JAX
    train output and new batch statistics or None)."""
    name = request.param
    jmodel, factory, shape = CASES[name]
    x = np.random.default_rng(len(name)).normal(size=shape).astype(
        np.float32)
    variables = randomized(jax.jit(jmodel.init)(
        jax.random.key(1), jnp.asarray(x)), seed=2)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jmodel.apply(variables, jnp.asarray(x)))
        train = None
        if HAS_TRAIN.get(name, True):
            out, new = jmodel.apply(variables, jnp.asarray(x), train=True,
                                    mutable=["batch_stats"])
            train = (np.asarray(out), jax.tree_util.tree_map(
                np.asarray, new["batch_stats"]))
    tmodel = factory()
    tmodel.load_state_dict(variables_to_state_dict(variables, device="cpu"),
                           strict=True)
    return name, tmodel, variables, x, ref, train


def _assert_close(got, ref):
    got = got.detach().numpy()
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= REL_TOL * np.abs(ref).max(), err


def test_eval_forward_matches_jax(bridged):
    name, tmodel, _, x, ref, _ = bridged
    with torch.no_grad():
        _assert_close(tmodel.eval()(torch.from_numpy(x)), ref)


def test_train_forward_matches_jax(bridged):
    """Train mode: the output from batch statistics, and the running
    statistics after the batch (1e-5 x max of each)."""
    name, tmodel, _, x, _, train = bridged
    if train is None:
        assert name == "lstm"   # no BatchNorm, no Dropout: one mode only
        return
    out, new_stats = train
    with torch.no_grad():
        _assert_close(tmodel.train()(torch.from_numpy(x)), out)
    ref = variables_to_state_dict({"batch_stats": new_stats}, device="cpu")
    got = tmodel.state_dict()
    for k, r in ref.items():
        if k.endswith("num_batches_tracked"):
            assert int(got[k]) == 1, k
            continue
        err = float((got[k] - r).abs().max())
        assert err <= REL_TOL * max(1.0, float(r.abs().max())), (k, err)


@pytest.mark.parametrize("n_blocks,relu", [(3, True), (4, False)])
def test_voxresnet_activation_quirk(monkeypatch, n_blocks, relu):
    """VoxResNet with n_blocks >= 4 has no activation after fully_conn_1
    (the reference's duplicated `activation_6`): negative values reach
    fully_conn_2 there, and only there."""
    torch.manual_seed(0)
    m = TC.VoxResNet(input_shape=(32,) * 3, n_filters=2, n_blocks=n_blocks,
                     device="cpu").eval()
    seen = {}
    linear = TC._linear

    def rec(lin, x):
        seen[lin] = x
        return linear(lin, x)

    monkeypatch.setattr(TC, "_linear", rec)
    with torch.no_grad():
        m(torch.randn(4, 32, 32, 32, 1))
    assert bool((seen[m.model["fully_conn_2"]] >= 0).all()) == relu


def test_dilated_cnn_returns_probabilities():
    torch.manual_seed(0)
    m = TC.DilatedCNN(input_shape=(160,) * 3, n_channels=1,
                      device="cpu").eval()
    with torch.no_grad():
        p = m(torch.randn(1, 160, 160, 160, 1))
    assert torch.allclose(p.sum(-1), torch.ones(1)) and (p >= 0).all()


def test_lstm_gate_order_is_torch():
    """The port's LSTM is torch's `nn.LSTM` (gates i, f, g, o) and takes
    bf16 features in float32, as JAX promotes them against its float32
    weights."""
    torch.manual_seed(0)
    m = TC.LSTM(6, 4, 2, device="cpu")
    ref = torch.nn.LSTM(6, 4, 2, batch_first=True)
    ref.load_state_dict(m.state_dict())
    x = torch.randn(2, 5, 6)
    with torch.no_grad():
        assert torch.equal(m(x), ref(x)[0])
        assert m(x.bfloat16()).dtype == torch.float32


@pytest.mark.parametrize("name", list(DEFAULT_DEVICE_CASES))
def test_modules_default_to_the_card(name):
    """With no device, every module builds on the card, and raises where
    there is none, rather than building on the CPU."""
    if torch.cuda.is_available():
        model = DEFAULT_DEVICE_CASES[name]()
        assert all(t.is_cuda for t in model.state_dict().values())
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DEFAULT_DEVICE_CASES[name]()

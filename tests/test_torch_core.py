"""Port parity: `core/` (mesh, config, rngs, dtypes) and the
single-process side of `parallel/` against the JAX package's `core/`
and `parallel/`, in this process (the two-rank runs are in
`test_torch_parallel.py` and `test_torch_multihost.py`)."""
import dataclasses
import json
import sys
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mri_epilepsy_diagnosis_torch.core as TC
import mri_epilepsy_diagnosis_torch.parallel as TP
from mri_epilepsy_diagnosis_torch.core import config as TCfg
from mri_epilepsy_diagnosis_torch.core import dtypes as TD
from mri_epilepsy_diagnosis_torch.core import mesh as TM
from mri_epilepsy_diagnosis_torch.core import rngs as TR
from mri_epilepsy_diagnosis_torch.interop import variables_to_state_dict
from mri_epilepsy_diagnosis_torch.models import fader as TFd
import mri_epilepsy_diagnosis_tpu.core as JC
import mri_epilepsy_diagnosis_tpu.parallel as JP
from mri_epilepsy_diagnosis_tpu.core import config as JCfg
from mri_epilepsy_diagnosis_tpu.core import mesh as JM
from mri_epilepsy_diagnosis_tpu.models import Classificator, Discriminator
from mri_epilepsy_diagnosis_tpu.models.fader import make_encoder

CONFIGS = ["DataConfig", "SegTrainingConfig", "CVConfig", "FaderConfig"]


def _mesh(data, spatial):
    """A mesh object of the given shape for the placement arithmetic (no
    process group: this rank sits at coordinate 0)."""
    return TM.Mesh(("data", "spatial"), {"data": data, "spatial": spatial},
                   torch.device("cpu"))


def test_exports_cover_jax():
    assert set(JC.__all__) <= set(TC.__all__)
    assert set(JP.__all__) <= set(TP.__all__)


def test_create_mesh_shapes_and_refusals():
    mesh = TC.create_mesh(("data", "spatial"))
    assert dict(mesh.shape) == {"data": 1, "spatial": 1}
    assert not mesh.distributed and mesh.group() is None
    assert TC.create_mesh(("data",)).shape["data"] == 1
    with pytest.raises(ValueError, match="do not multiply"):
        TC.create_mesh(("data", "spatial"), (2, 1))
    with pytest.raises(RuntimeError, match="multi-process runtime"):
        TC.create_mesh(("data",), multi_host=True)
    assert TM.initialize_distributed() is False
    # the backend follows the device and never falls back to gloo for a
    # card: a CUDA group without a card raises before any connection
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TM.initialize_distributed("127.0.0.1:1", 2, 0, device="cuda")
    with pytest.raises(ValueError, match="no process-group backend"):
        TM.initialize_distributed("127.0.0.1:1", 2, 0, device="meta")


def test_multi_host_batch_arithmetic_matches_jax():
    for hosts in (1, 2, 4):
        for h in range(hosts):
            assert TM.process_batch_bounds(32, hosts, h) == \
                JM.process_batch_bounds(32, num_hosts=hosts, host_id=h)
    msgs = []
    for mod in (TM, JM):
        with pytest.raises(ValueError) as err:
            mod.process_batch_bounds(30, num_hosts=4, host_id=0)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1] and "not divisible" in msgs[0]
    # without a process group: one host holding the whole batch, and the
    # data coordinate of a mesh plays the host's part
    assert TM.process_batch_bounds(8) == (0, 8)
    assert TM.process_batch_bounds(8, mesh=_mesh(4, 2)) == (0, 2)
    x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    got = TM.host_local_batch(x, TC.create_mesh(("data",)))
    np.testing.assert_array_equal(got.numpy(), x)
    rows = TM.host_local_batch(np.zeros((2, 4, 2, 2, 1)), _mesh(2, 2),
                               TP.volume_sharding(_mesh(2, 2)),
                               process_rows=True)
    assert tuple(rows.shape) == (2, 2, 2, 2, 1)


def test_uneven_shard_guards_match_jax():
    tmesh = _mesh(4, 2)
    jmesh = JC.create_mesh(("data", "spatial"), (4, 2))
    for shape, axes in (((3, 4, 4, 4, 1), ("data", None)),
                        ((4, 9, 8, 8, 1), ("data", "spatial"))):
        errs = []
        for mod, mesh in ((TP, tmesh), (JP, jmesh)):
            with pytest.raises(ValueError) as err:
                mod.check_shard_divisibility(shape, mesh, *axes)
            errs.append(str(err.value))
        assert errs[0] == errs[1]
    with pytest.raises(ValueError, match="batch dim 3 not divisible"):
        TP.shard_batch(np.zeros((3, 4, 4, 4, 1), np.float32), tmesh)
    out = TP.shard_batch(np.zeros((8, 4, 4, 4, 1), np.float32), tmesh)
    assert tuple(out.shape) == (2, 4, 4, 4, 1)
    f = TP.make_parallel_apply(lambda v, x: x * 2.0, tmesh)
    with pytest.raises(ValueError, match="spatial dim D=7"):
        f({}, torch.zeros((4, 7, 8, 8, 1)))


def test_local_shards_and_gather_without_a_group():
    x = torch.arange(4 * 6 * 2 * 2 * 1.0).reshape(4, 6, 2, 2, 1)
    mesh = _mesh(2, 3)
    vs = TP.volume_sharding(mesh)
    from mri_epilepsy_diagnosis_torch.parallel.sharding import local_shard

    assert torch.equal(local_shard(x, vs), x[:2, :2])
    # spatial splits only volumes: a (N, F) tensor keeps its columns
    assert torch.equal(local_shard(x[:, :, 0, 0, 0], vs),
                       x[:2, :, 0, 0, 0])
    one = TC.create_mesh(("data", "spatial"))
    assert TP.gather(x, TP.volume_sharding(one)) is x
    assert TP.replicate({"a": x}, one)["a"] is x


@pytest.mark.parametrize("mode", ["zeros", "edge"])
def test_halo_exchange_of_a_single_rank_pads(mode):
    """With no neighbours both halos are the volume's faces: zeros, or the
    boundary plane repeated; the gradient of an edge halo flows into the
    boundary plane."""
    x = torch.randn(1, 4, 2, 2, 3, requires_grad=True)
    h = TP.halo_exchange(x, None, 2, dim=1, mode=mode)
    idx = torch.arange(-2, 6)
    ref = (x[:, idx.clamp(0, 3)] if mode == "edge" else
           torch.nn.functional.pad(x, (0,) * 6 + (2, 2)))
    assert torch.equal(h, ref)
    g = torch.randn_like(h)
    (gx,) = torch.autograd.grad(h, x, g)
    (gr,) = torch.autograd.grad(ref, x, g)
    torch.testing.assert_close(gx, gr)
    with pytest.raises(ValueError, match="mode"):
        TP.halo_exchange(x, None, 1, mode="wrap")


def test_wait_for_backend_paths():
    ok = [sys.executable, "-c", "print('up')"]
    assert TM.wait_for_backend(max_wait_s=5, _probe_cmd=ok) is True
    if torch.version.cuda is None:
        # a torch without CUDA has no backend to wait for
        t0 = time.monotonic()
        assert TM.wait_for_backend(max_wait_s=5) is True
        assert time.monotonic() - t0 < 1.0
    bad = [sys.executable, "-c", "raise SystemExit(1)"]
    t0 = time.monotonic()
    assert TM.wait_for_backend(max_wait_s=1.0, retry_sleep_s=0.1,
                               _probe_cmd=bad) is False
    assert time.monotonic() - t0 >= 1.0
    hang = [sys.executable, "-c", "import time; time.sleep(30)"]
    assert TM.wait_for_backend(max_wait_s=0.5, probe_timeout_s=0.3,
                               retry_sleep_s=0.1, _probe_cmd=hang) is False
    assert TM.local_device_count() == torch.cuda.device_count()


def test_seed_everything_and_streams():
    gen = TR.seed_everything(3)
    a = np.random.rand(4)
    np.random.seed(3)
    np.testing.assert_array_equal(a, np.random.rand(4))
    assert torch.equal(torch.rand(5, generator=gen),
                       torch.rand(5, generator=torch.Generator()
                                  .manual_seed(3)))
    s1, s2 = TR.RngStream.from_seed(7), TR.RngStream.from_seed(7)
    g1, g2 = s1.next(), s2.next()
    assert torch.equal(torch.rand(3, generator=g1),
                       torch.rand(3, generator=g2))
    subs = s1.next_n(3)
    draws = [torch.rand(3, generator=g) for g in subs]
    assert len(subs) == 3 and not torch.equal(draws[0], draws[1])
    assert s1.next_seed() != s1.next_seed()


def test_policy_matches_jax_fields():
    from mri_epilepsy_diagnosis_tpu.core import dtypes as JD

    assert [f.name for f in dataclasses.fields(TD.Policy)] == \
        [f.name for f in dataclasses.fields(JD.Policy)]
    assert TD.DEFAULT_POLICY.compute_dtype == torch.float32
    assert TD.BF16_POLICY.compute_dtype == torch.bfloat16
    assert TD.BF16_POLICY.param_dtype == torch.float32
    x = TD.BF16_POLICY.cast_to_compute(np.ones(3, np.float32))
    assert x.dtype == torch.bfloat16
    assert TD.BF16_POLICY.cast_to_output(x).dtype == torch.float32


@pytest.mark.parametrize("name", CONFIGS)
def test_config_roundtrip_and_defaults_match_jax(name):
    tcls, jcls = getattr(TCfg, name), getattr(JCfg, name)
    cfg = tcls()
    restored = TCfg.from_json(tcls, TCfg.to_json(cfg))
    assert (json.loads(TCfg.to_json(restored))
            == json.loads(json.dumps(dataclasses.asdict(cfg))))
    assert json.loads(TCfg.to_json(cfg)) == json.loads(JCfg.to_json(jcls()))


def test_fader_config_builds_the_ports_models_with_jax_shapes():
    cfg = TCfg.FaderConfig()
    assert cfg.ae_kwargs["down_block_kwargs"]["conv_k"] == 6
    assert cfg.discriminator_kwargs["n_domains"] == 18
    # the reference geometry: a 192^3 input gives the heads' latent
    shape = (1, 192, 192, 192, 1)
    jenc = make_encoder(cfg.ae_kwargs)
    venc = jax.eval_shape(jenc.init, jax.random.key(0), jnp.zeros(shape))
    latent, sizes = jax.eval_shape(jenc.apply, venc, jnp.zeros(shape))
    assert latent.shape[-1] == 32 and len(sizes) == 3
    jheads = {"disc": Discriminator(**cfg.discriminator_kwargs),
              "clf": Classificator(**cfg.classificator_kwargs)}
    heads = {"disc": TFd.Discriminator(**cfg.discriminator_kwargs,
                                       device="cpu"),
             "clf": TFd.Classificator(**cfg.classificator_kwargs,
                                      device="cpu")}
    pairs = [(TFd.make_encoder(cfg.ae_kwargs, device="cpu"), venc)]
    for k, m in jheads.items():
        pairs.append((heads[k], jax.eval_shape(
            m.init, jax.random.key(0), jnp.zeros(latent.shape))))
    for model, shapes in pairs:
        want = variables_to_state_dict(jax.tree_util.tree_map(
            lambda s: np.zeros(s.shape, np.float32), shapes), device="cpu")
        got = {k: v.shape for k, v in model.state_dict().items()
               if not k.endswith("num_batches_tracked")}
        assert got == {k: v.shape for k, v in want.items()
                       if not k.endswith("num_batches_tracked")}

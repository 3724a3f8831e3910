"""Port parity: REAL multi-process execution of the training step
(`parallel/multihost_demo.py`) against the JAX package's unsharded step.

Two pairs of Python processes, each pair a gloo group of two ranks,
launch `python -m mri_epilepsy_diagnosis_torch.parallel.multihost_demo`
(torch and the port only) with JAX-initialised weights bridged into a
`torch.save` file: the fine `seg_train_step` on a (data 2, spatial 1)
mesh and the packed step on (1, 2).  Each rank feeds its
`process_batch_bounds` rows through `host_local_batch` (and its D slab),
runs one step, and writes its loss, checksum, parameters and gradients.
Both ranks must agree exactly; the loss must match JAX's unsharded step
to 1e-5 and the gradients as in `test_torch_parallel.py`."""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mri_epilepsy_diagnosis_torch.interop import variables_to_state_dict
from mri_epilepsy_diagnosis_torch.parallel import multihost_demo as demo
from mri_epilepsy_diagnosis_torch.train.seg import (
    packed_seg_train_step, seg_loss, seg_train_step)
from mri_epilepsy_diagnosis_tpu.models import unet_packed as JU
from mri_epilepsy_diagnosis_tpu.train import seg as JS
from mri_epilepsy_diagnosis_tpu.transforms.labels import (
    binarize_segmentation as j_binarize)
from test_torch_bridge import jax_unet_variables, torch_unet
from test_torch_parallel import _assert_grads, _is_unet_pre_bn, _rounding

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNS = {"fine": "2,1", "packed": "1,2"}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both runs' two ranks, started together; waited for on first use."""
    tmp = tmp_path_factory.mktemp("multihost")
    jmodel, variables = jax_unet_variables(ocfl=4, nb=2, seed=21)
    weights = str(tmp / "unet.pt")
    torch.save(variables_to_state_dict(variables, device="cpu"), weights)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs, outs = [], {}
    for name, mesh in RUNS.items():
        init = f"tcp://127.0.0.1:{_free_port()}"
        outs[name] = [str(tmp / f"{name}{r}.json") for r in range(2)]
        for r in range(2):
            cmd = [sys.executable, "-m",
                   "mri_epilepsy_diagnosis_torch.parallel.multihost_demo",
                   "--init", init, "--world-size", "2", "--rank", str(r),
                   "--mesh", mesh, "--weights", weights,
                   "--out", outs[name][r]]
            if name == "packed":
                cmd.append("--packed")
            procs.append(subprocess.Popen(cmd, env=env, cwd=REPO,
                                          stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT))
    done = {}

    def results():
        if not done:
            logs = []
            for p in procs:
                try:
                    out, _ = p.communicate(timeout=600)
                except subprocess.TimeoutExpired:
                    for q in procs:
                        q.kill()
                    raise
                logs.append(out.decode(errors="replace"))
            assert all(p.returncode == 0 for p in procs), "\n".join(logs)
            for name, paths in outs.items():
                done[name] = [(json.load(open(p)),
                               torch.load(p + ".pt", weights_only=False))
                              for p in paths]
        return done

    yield dict(jmodel=jmodel, variables=variables, weights=weights,
               results=results)
    for p in procs:
        if p.poll() is None:
            p.kill()


@pytest.fixture(scope="module")
def jax_reference(runs):
    """JAX's unsharded loss and gradients of the same step on the same
    global batch (the demo's `make_data`)."""
    jmodel, v = runs["jmodel"], runs["variables"]
    x, y = (jnp.asarray(a) for a in demo.make_data())
    targets = j_binarize(y)

    def fine(params):
        logits, _ = jmodel.apply(
            {"params": params, "batch_stats": v["batch_stats"]}, x,
            train=True, mutable=["batch_stats"])
        return JS._dice_loss_from_logits(logits, targets)

    def packed(params):
        yp, _ = JU.packed_unet_train_apply(
            {"params": params, "batch_stats": v["batch_stats"]}, x,
            num_encoding_blocks=2)
        return JU.packed_dice_loss(yp, targets)

    out = {}
    for name, fn in (("fine", fine), ("packed", packed)):
        loss, g = jax.jit(jax.value_and_grad(fn))(v["params"])
        out[name] = (float(loss), variables_to_state_dict(
            {"params": jax.tree_util.tree_map(np.asarray, g)},
            device="cpu"))
    return out


@pytest.mark.parametrize("name", list(RUNS))
def test_two_process_train_step_matches_jax(runs, jax_reference, name):
    (m0, t0), (m1, t1) = runs["results"]()[name]
    sizes = [int(s) for s in RUNS[name].split(",")]
    for i, m in enumerate((m0, m1)):
        assert m["world_size"] == 2 and m["backend"] == "gloo"
        assert m["mesh"] == {"data": sizes[0], "spatial": sizes[1]}
        if sizes[0] == 2:
            assert m["batch_bounds"] == [2 * i, 2 * i + 2]
            assert m["local_shape"] == [2, 16, 16, 16, 1]
        else:
            assert m["batch_bounds"] == [0, 4]
            assert m["local_shape"] == [4, 8, 16, 16, 1]
    # one program on both ranks: the same loss and the same state
    assert m0["loss"] == m1["loss"]
    assert m0["param_checksum"] == m1["param_checksum"]
    for k in t0["state"]:
        assert torch.equal(t0["state"][k], t1["state"][k]), k
    loss, grads = jax_reference[name]
    np.testing.assert_allclose(m0["loss"], loss, rtol=1e-5)
    x, y = (torch.from_numpy(a) for a in demo.make_data())

    def loss_fn(model, dtype):
        return seg_loss(model, x.to(dtype), y.to(dtype))

    rounding = _rounding(lambda: torch_unet(runs["variables"], ocfl=4,
                                            nb=2), loss_fn)
    _assert_grads(t0["grads"], grads, rounding, _is_unet_pre_bn(grads))
    # the stepped parameters' checksum against the unsharded port step
    # (Adam moves a near-zero gradient's parameter by up to lr)
    ref = demo.make_state(runs["weights"], 2, 4)
    step = packed_seg_train_step if name == "packed" else seg_train_step
    ref, ref_loss = step(ref, x, y)
    np.testing.assert_allclose(m0["loss"], float(ref_loss), rtol=1e-6)
    np.testing.assert_allclose(m0["param_checksum"],
                               demo.param_checksum(ref.model), rtol=1e-5)

"""What decides `correct`, on the CPU at tiny sizes: the program agrees
with the plain reference in float32; the control (the reference with
float8 operands in the program's place) and the faults a training cell
can have (a step that leaves its state unchanged, half of each batch left
out) come out not correct under the cells' own limits."""
import pytest

from portbench.lib import compare, harness
from portbench.tests.conftest import dry_run

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]


def _limits(cell):
    return harness.load_mix(harness.cell(harness.benchmark(),
                                         cell)["traffic"])["limits"]


@pytest.mark.parametrize("cell", CELLS)
def test_program_matches_reference_in_float32(cell):
    result, _ = dry_run(cell)
    assert result["correct"], result["checks"]
    for c in result["checks"].values():
        assert c["value"] < 1e-3


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    result, _ = dry_run(cell, calibrate=True)
    ex = result["extra"]
    checks = compare.training_checks(ex["control"], ex["ref"],
                                     _limits(cell))
    assert any(c["value"] > c["limit"] for c in checks), checks


def _seg_faults(monkeypatch, fault):
    from mri_epilepsy_diagnosis_torch.train import seg
    if fault == "unchanged":
        def step(state, inputs, labels, **kw):
            loss, _ = seg.packed_seg_loss(state.model, inputs,
                                          seg.binarize_segmentation(labels))
            return state, loss.detach()
    else:
        orig = seg.packed_seg_train_step

        def step(state, inputs, labels, **kw):
            n = inputs.shape[0] // 2
            return orig(state, inputs[:n], labels[:n], **kw)
    monkeypatch.setattr(seg, "packed_seg_train_step", step)


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
@pytest.mark.parametrize("cell", CELLS)
def test_faults_are_not_correct(cell, fault, monkeypatch):
    _seg_faults(monkeypatch, fault)
    result, _ = dry_run(cell)
    assert not result["correct"], result["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell, cuda_device):
    result, _ = harness.run_cell(cell, 2 ** 31 + 99, 2.0, False)
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"



def test_a_fault_at_one_conv_kernel_is_not_correct():
    """A weight gradient gone wrong at one site moves one conv kernel's
    leaf: the median leaf stays, the worst conv kernel reads it."""
    leaves = {f"c{i}.weight": 1.0 + 0.1 * i for i in range(12)}
    leaves.update({f"c{i}.bias": 0.5 for i in range(12)})
    ref = {"losses": [0.7, 0.6, 0.5], "grads": leaves, "change": leaves,
           "stats": {"bn.running_var": 1.0},
           "convs": sorted(k for k in leaves if k.endswith("weight"))}
    prog = {**ref, "grads": {**leaves, "c5.weight": 1.3 * leaves["c5.weight"]}}
    limits = harness.load_mix("seg_whole192_b2")["limits"]
    checks = {c["name"]: c for c in compare.training_checks(prog, ref,
                                                             limits)}
    assert checks["grad_median_gap"]["value"] == 0.0
    assert checks["grad_conv_gap"]["value"] > checks["grad_conv_gap"]["limit"]

"""The harness finds its cells, configurations, traffic mixes and metrics
by name, and prints its result line."""
import ast
import json
import shutil
from pathlib import Path

import pytest

from portbench.lib import harness
from portbench.tests.conftest import ROOT, TINY, dry_run

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "mri_epilepsy_diagnosis_tpu"}


def test_every_entry_has_its_files():
    bench = harness.benchmark()
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
    for w in bench["workloads"]:
        mix = harness.load_mix(w["traffic"])
        assert (harness.HERE / "drivers" / f"{mix['driver']}.py").is_file()
        assert w["name"] in TINY
    for m in bench["per_layer"]:
        assert callable(harness.reader(m["name"]).read)


def test_a_file_added_in_a_copy_is_found(tmp_path):
    shutil.copytree(harness.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = harness.benchmark()
    bench["per_layer"].append({
        "name": "probe_ms.train", "unit": "ms", "better": "lower",
        "source": "device_trace", "layer": "device",
        "moves": "train_samples_s", "workloads": ["unet3d_train_192_b2"]})
    bench["workloads"].append({
        "name": "unet3d_train_192_b4", "config": "unet3d_fepegar_ocfl8",
        "traffic": "seg_whole192_b4", "chips": 1, "why": "probe"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "portbench/metrics/probe_ms.train.py").write_text(
        "def read(view):\n    return 1.5\n")
    mix = json.loads((harness.HERE / "mixes/seg_whole192_b2.json")
                     .read_text())
    (tmp_path / "portbench/mixes/seg_whole192_b4.json").write_text(
        json.dumps({**mix, "batch": 4}))
    got = harness.benchmark(tmp_path)
    names = [m["name"] for m in harness.cell_metrics(
        got, "unet3d_train_192_b2", "per_layer")]
    assert "probe_ms.train" in names
    assert harness.reader("probe_ms.train", tmp_path).read(None) == 1.5
    # a second name of the same quantity finds the quantity's reader
    (tmp_path / "portbench/metrics/probe_ms.py").write_text(
        "def read(view):\n    return 2.5\n")
    assert harness.reader("probe_ms.patch", tmp_path).read(None) == 2.5
    assert harness.reader("probe_ms.train", tmp_path).read(None) == 1.5
    w = harness.cell(got, "unet3d_train_192_b4")
    assert harness.load_config(got, w["config"], tmp_path)["name"] \
        == "unet3d_fepegar_ocfl8"
    assert json.loads((tmp_path / "portbench/mixes" / f"{w['traffic']}.json")
                      .read_text())["batch"] == 4


def test_result_line_keys():
    result, lines = dry_run("unet3d_train_192_b2")
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "checks"]
    assert set(result["metrics"]) == {"train_samples_s", "train_step_p95_ms",
                                      "setup_s"}
    assert result["device"]["platform"] == "cpu"
    assert len([x for x in lines if x.startswith("check ")]) \
        == len(result["checks"])
    assert lines[-1].startswith("check ")
    json.dumps(result)


def test_traced_result_line_keys():
    result, _ = dry_run("unet3d_train_192_b2", trace=True, seconds=3.0)
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics",
                                "device"]
    assert list(result)[-1] == "checks"
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    # a CPU trace has no device events: the device metrics are left out
    assert "idle_pct.train" not in result["metrics"]


def test_no_run_without_a_card(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        harness.device_of(None, 1)


def _imported_names(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


@pytest.mark.parametrize("package", ["portbench",
                                     "mri_epilepsy_diagnosis_torch"])
def test_nothing_imports_jax(package):
    found = []
    for path in sorted((ROOT / package).rglob("*.py")):
        for name in _imported_names(path):
            if name and name.split(".")[0] in FORBIDDEN:
                found.append((str(path), name))
    assert not found

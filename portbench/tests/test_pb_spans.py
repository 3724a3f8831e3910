"""The readers of the loop's spans (`loop_idle_ms`, `launch_idle_ms`,
`batch_wait_ms`) on a hand-made trace, and in a traced CPU dry run of each
cell."""
from types import SimpleNamespace

import pytest

from portbench.lib import harness
from portbench.lib import trace as T
from portbench.metrics._common import idle_pct
from portbench.tests.conftest import TINY

MAIN, OTHER = 11, 12


def _x(name, ts, end, tid=MAIN, cat="user_annotation", pid=100):
    return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid,
            "ts": float(ts), "dur": float(end - ts), "args": {}}


def _kernel(ts, end):
    return _x("void k<1>(int)", ts, end, tid=7, cat="kernel", pid=0)


# two steps in a stretch of [100, 1100]; the first step's pull starts
# before the stretch, the second step's log ends after it
STEPS = [
    ("seg::step", 50, 600), ("seg::next_batch", 50, 120),
    ("seg::forward", 120, 300), ("seg::backward", 300, 400),
    ("seg::optimizer", 400, 450), ("seg::loss_sync", 450, 550),
    ("seg::log", 550, 600),
    ("seg::step", 600, 1200), ("seg::next_batch", 600, 610),
    ("seg::cast", 610, 620), ("seg::forward", 620, 800),
    ("seg::backward", 800, 900), ("seg::optimizer", 900, 950),
    ("seg::stats", 950, 960), ("seg::loss_sync", 960, 1050),
    ("seg::log", 1050, 1200)]
BUSY = [(130, 280), (310, 390), (410, 500), (640, 790), (800, 880),
        (905, 1000)]
# idle: [100,130] [280,310] [390,410] [500,640] [790,800] [880,905]
# [1000,1100] = 355 us; inside the launch leaves ([120,450], [620,960]):
# 10 + 30 + 20 + 20 + 10 + 25 = 115 us; the rest, 240 us, is the loop's
LAUNCH_US, LOOP_US, WAIT_US = 115.0, 240.0, 20.0 + 10.0


def _events(spans=True, kernels=True):
    ev = [_x(T.STRETCH, 100, 1100)]
    if spans:
        ev += [_x(n, a, b) for n, a, b in STEPS]
        # another thread's ranges are not the loop's
        ev += [_x("seg::forward", 100, 1100, tid=OTHER),
               _x("seg::next_batch", 100, 1100, tid=OTHER)]
    if kernels:
        ev += [_kernel(a, b) for a, b in BUSY]
    return ev


def _view(events, steps=2):
    span = T.stretches(events)[0]
    return SimpleNamespace(plain=events, span=span, steps=steps,
                           devs=T.device_events(events, span),
                           work={"kind": "train"})


def _read(name, view):
    return harness.reader(name).read(view)


def test_readers_give_the_hand_computed_values():
    view = _view(_events())
    assert _read("loop_idle_ms.train", view) == pytest.approx(
        LOOP_US / 1e3 / 2, rel=1e-12)
    assert _read("launch_idle_ms.patch", view) == pytest.approx(
        LAUNCH_US / 1e3 / 2, rel=1e-12)
    # clipped to the stretch: the first pull counts from 100, not 50
    assert _read("batch_wait_ms.train", view) == pytest.approx(
        WAIT_US / 1e3 / 2, rel=1e-12)


def test_loop_and_launch_add_up_to_the_idle_time_per_step():
    for steps in (1, 2, 5):
        view = _view(_events(), steps)
        total = (_read("loop_idle_ms.train", view)
                 + _read("launch_idle_ms.train", view))
        want = (idle_pct(view) / 100 * (view.span[1] - view.span[0]) / 1e3
                / steps)
        assert total == pytest.approx(want, rel=1e-9)


def test_without_device_events_the_idle_metrics_read_nothing():
    view = _view(_events(kernels=False))
    assert _read("loop_idle_ms.train", view) is None
    assert _read("launch_idle_ms.train", view) is None
    assert _read("batch_wait_ms.train", view) == pytest.approx(
        WAIT_US / 1e3 / 2, rel=1e-12)


def test_a_program_without_spans_gives_no_reading():
    view = _view(_events(spans=False))
    for name in ("loop_idle_ms", "launch_idle_ms", "batch_wait_ms"):
        assert _read(f"{name}.train", view) is None


@pytest.mark.parametrize("cell", sorted(TINY))
def test_traced_dry_run_reports_batch_wait(cell):
    """A traced CPU run at the cell's tiny size, its stretches moved to the
    window's first steps so that a loaded CPU still reaches them."""
    suffix = "train" if cell.endswith("192_b2") else "patch"
    mix, cfg = TINY[cell]
    result, _ = harness.run_cell(
        cell, 2 ** 31 + 11, 3.0, True, device="cpu",
        mix_overrides={**mix, "profile_start": 1, "profile_steps": 2},
        cfg_overrides={**cfg, "dtype": "float32"})
    metrics = result["metrics"]
    assert metrics[f"batch_wait_ms.{suffix}"]["unit"] == "ms"
    assert metrics[f"batch_wait_ms.{suffix}"]["value"] >= 0.0
    # on the CPU no device events: nothing to split
    assert f"loop_idle_ms.{suffix}" not in metrics
    assert f"launch_idle_ms.{suffix}" not in metrics

"""The plain reference against the port's CPU path, a whole run of each
cell at CPU size: sound runs read rounding, and the control (the
reference in bfloat16 in the program's place) and each fault the cells
can have (a step that returns its state unchanged, half of the particles
left out of the step, the pose altered where it is produced, a resampler
that leaves the set as it is, an injection skipped, a staged hand-off
that never switches) make ``correct`` false."""

import time

import pytest
import torch

from benchmark import harness
from benchmark.tests.conftest import small
from mcmh_localization_tpu_torch.filter import online, staged, step

CELLS = ["house_staged_1m.square_track", "house_amcl_default.square_track",
         "house_staged_1m.kidnap"]


def _run(cell, seed=2**31 + 5, **kw):
    torch.manual_seed(0)
    return harness.run_cell(cell, seed, 1.5, False, "cpu", time.perf_counter(),
                            overrides=small(cell), log=lambda *a: None, **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_and_the_control_fails(cell):
    out = _run(cell, control=True)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 4
    prog, ctrl = out["readings"]["program"], out["readings"]["control"]
    for k in ("pose_gap_m", "cov_gap", "ess_gap", "wfast_gap",
              "set_mean_gap_m", "set_cov_gap", "set_ess_gap"):
        assert prog[k] < 1e-5
    assert prog["handoff_mismatch"] == prog["draws_mismatch"] == 0
    for k in ("pose_gap_m", "cov_gap"):
        assert ctrl[k] > 30 * max(prog[k], 1e-7)
    limits = harness.world.load("reference/limits", cell)
    ok, _ = harness.check.judge(out["readings"]["control"], limits)
    assert not ok


def _unchanged(model, state, ranges, angles, _real=online._correct_scan):
    """The correct step returns its state as it came, and the last info."""
    st, info = _real(model, state, ranges, angles)
    prev = getattr(_unchanged, "info", info)
    _unchanged.info = info
    return state, prev


def _half(model, state, ranges, angles, _real=online._correct_scan):
    """Half of the particles left out, the step taken over the rest."""
    half = state.replace(count=torch.clamp(state.count // 2, min=1))
    st, info = _real(model, half, ranges, angles)
    return st.replace(count=state.count), info


def _moved(self, _real=online.OnlineLocalizer.estimate):
    """The pose altered where it is produced: 2 cm along x."""
    est = dict(_real(self))
    if est:
        x, y, yaw = est["pose3"]
        est["pose3"] = (x + 0.02, y, yaw)
    return est


@pytest.mark.parametrize("fault", ["unchanged", "half", "moved"])
@pytest.mark.parametrize("cell", ["house_staged_1m.square_track",
                                  "house_amcl_default.square_track"])
def test_each_fault_makes_correct_false(monkeypatch, cell, fault):
    if fault == "moved":
        monkeypatch.setattr(online.OnlineLocalizer, "estimate", _moved)
    else:
        monkeypatch.setattr(online, "_correct_scan",
                            {"unchanged": _unchanged, "half": _half}[fault])
    out = _run(cell)
    assert not out["correct"], out["checks"]


def _no_resample(state, grid_map, config, d):
    """The resampler returns the set as it came, with the injection share
    it would have used."""
    return state, step._p_random(state, config)


def _no_injection(pred, fn, carry, donate=False, _real=step.run_if):
    """The injection's conditional body is skipped: the kept samples stay
    where the injected poses should go."""
    if fn.__name__ == "inject":
        return carry
    return _real(pred, fn, carry, donate=donate)


def _never_switch(in_small, *args, **kw):
    """The staged hand-off keeps whichever program is running."""
    return in_small


@pytest.mark.parametrize("fault,cell", [
    ("no_resample", "house_staged_1m.kidnap"),
    ("no_resample", "house_amcl_default.square_track"),
    ("no_injection", "house_staged_1m.kidnap"),
    ("never_switch", "house_staged_1m.kidnap")])
def test_each_staged_fault_makes_correct_false(monkeypatch, fault, cell):
    """The kidnap cell's sampled scans take in a teleport, the escalation
    it sets off, its injection and the shrink back."""
    if fault == "no_resample":
        monkeypatch.setattr(step, "_resample_kld", _no_resample)
    elif fault == "no_injection":
        monkeypatch.setattr(step, "run_if", _no_injection)
    else:
        monkeypatch.setattr(staged, "next_stage", _never_switch)
    out = _run(cell)
    assert not out["correct"], out["checks"]


def test_a_changed_draw_layout_is_reported_apart(monkeypatch):
    """A program that draws one uniform more a scan than the documented
    layout is caught by the generator's state after the scan."""
    real = step._resample_draws

    def extra(state, *args, **kw):
        torch.rand((), generator=state.key, device=state.device)
        return real(state, *args, **kw)

    monkeypatch.setattr(step, "_resample_draws", extra)
    out = _run("house_amcl_default.square_track")
    assert out["checks"]["draws_mismatch"][0] == 1 and not out["correct"]

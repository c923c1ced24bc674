"""A run with the timed path broken underneath comes out not correct; the controls fail.

Each fault is planted in the program (``repro_torch``) where the timed
path runs it, and the harness drives the rest of a run on the CPU (its
look for a card skipped): a growth that returns its initial state, half
of the rows left out, one answer altered where it is produced. One chip,
so no exchange between chips can be left out.
"""
import time

import pytest
import torch

from prfbench import calibrate, harness


def _run(cell):
    return harness.run_cell(cell, 2 ** 31 + 3, 0.01, False, "cpu", time.perf_counter())


def _unchanged(real):
    def grow(*a, **k):
        f = real(*a, **k)
        f.feature.fill_(-1)
        f.left_child.fill_(-1)
        f.threshold.zero_()
        f.class_counts[:, 1:] = 0.0
        return f
    return grow


def _altered(real):
    def grow(*a, **k):
        f = real(*a, **k)
        f.threshold[0, 0] += 1
        return f
    return grow


@pytest.mark.parametrize("fault", ["none", "unchanged", "half_rows", "altered"])
def test_train_fault_is_not_correct(fault, tiny, monkeypatch):
    import repro_torch.core.api as api

    if fault == "unchanged":
        monkeypatch.setattr(api, "grow_forest", _unchanged(api.grow_forest))
    elif fault == "altered":
        monkeypatch.setattr(api, "grow_forest", _altered(api.grow_forest))
    elif fault == "half_rows":
        real = api.fit_prf_from_draws

        def fit(x, y, cfg, w, u, **k):
            h = len(y) // 2
            return real(x[:h], y[:h], cfg, w[:, :h], u, **k)
        monkeypatch.setattr(api, "fit_prf_from_draws", fit)
    line = _run(tiny("covtype.train"))
    assert line["correct"] == (fault == "none"), line["checks"]


@pytest.mark.parametrize("fault", ["none", "half_rows", "altered"])
def test_score_fault_is_not_correct(fault, tiny, monkeypatch):
    import repro_torch.core.api as api

    if fault == "altered":
        real = api.predict

        def predict(forest, xb, **k):
            out = real(forest, xb, **k).clone()
            out[-1] = 1 - out[-1]
            return out
        monkeypatch.setattr(api, "predict", predict)
    elif fault == "half_rows":
        real = api.PRFModel.predict
        monkeypatch.setattr(api.PRFModel, "predict", lambda self, x: real(self, x[: len(x) // 2]))
    line = _run(tiny("higgs.score"))
    assert line["correct"] == (fault == "none"), line["checks"]


def _fails(numbers: dict, limits: dict) -> bool:
    return any(v > limits[name] for name, v in numbers.items())


def test_train_control_and_faults_fail(tiny):
    c = tiny("covtype.train", rows=2500, trees=8, depth=5, bins=32, chunk=5)
    limits = c.params["limits"]
    r = calibrate.train_readings(c.config, 5, torch.device("cpu"))
    assert set(r["program"]) == set(limits) and all(v == 0 for v in r["program"].values())
    for key in ("control", "fault_unchanged", "fault_half_rows", "fault_altered"):
        assert _fails(r[key], limits), key


@pytest.mark.parametrize("seed", [1, 2])
def test_score_controls_fail(tiny, seed):
    c = tiny("higgs.score", rows=4000, trees=24, depth=6, bins=64, chunk=8)
    c.config["test_rows"] = 20000
    limits = c.params["limits"]
    r = calibrate.score_readings(c.config, c.params, seed, torch.device("cpu"))
    assert set(r["program"]) == set(limits) and not _fails(r["program"], limits)
    for key in ("control", "fault_half_rows", "fault_altered"):
        assert _fails(r[key], limits), key
    assert r["fault_half_rows"]["vote_gap"] == 1.0

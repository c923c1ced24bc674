"""The generators: deterministic from the seed, the sources' shapes and class counts."""
import numpy as np
import pytest
import torch

from prfbench import gen, harness

MAN = harness.manifest()
CONFIGS = {c["name"]: harness.read_json(harness.ROOT / c["file"]) for c in MAN["configs"]}
PUBLISHED = {"covtype": (581012, 54, [211840, 283301, 35754, 2747, 9493, 17367, 20510]),
             "higgs": (11000000, 28, None)}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_split_counts_are_the_sources(name):
    cfg = CONFIGS[name]
    rows, feats, counts = PUBLISHED[name]
    assert cfg["n_features"] == feats == sum(c["count"] for c in cfg["columns"])
    train, test = gen.split_counts(cfg)
    assert sum(train) == cfg["train_rows"] and sum(test) == cfg["test_rows"]
    assert min(train) > 0 and min(test) > 0
    if counts is not None:                     # nothing cut: the splits add up to the source
        assert cfg["train_rows"] + cfg["test_rows"] == rows
        assert np.add(train, test).tolist() == counts
        share = np.asarray(train) / np.asarray(counts)
        assert np.abs(share - cfg["train_rows"] / rows).max() < 1e-3
    else:
        share = np.asarray(train) / cfg["train_rows"]
        assert np.abs(share - cfg["class_priors"]).max() < 1e-5


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_deterministic_shapes_and_kinds(name):
    cfg = dict(CONFIGS[name], train_rows=4000, test_rows=1000)
    dev = torch.device("cpu")
    a = gen.make_table(cfg, 2 ** 31 + 11, dev)
    b = gen.make_table(cfg, 2 ** 31 + 11, dev)
    c = gen.make_table(cfg, 5, dev)
    for k in a:
        assert np.array_equal(a[k], b[k])
    assert not np.array_equal(a["x"], c["x"])
    assert a["x"].shape == (4000, cfg["n_features"]) and a["x"].dtype == np.float32
    assert a["x_test"].shape == (1000, cfg["n_features"]) and a["y"].dtype == np.int32
    assert np.bincount(a["y"], minlength=cfg["n_classes"]).tolist() == gen.class_counts(cfg, 4000)
    assert np.bincount(a["y_test"], minlength=cfg["n_classes"]).tolist() == \
        gen.class_counts(cfg, 1000)
    assert np.isfinite(a["x"]).all()
    col = 0
    for group in cfg["columns"]:
        block = a["x"][:, col:col + group["count"]]
        if group["kind"] == "one_hot":
            assert set(np.unique(block)) <= {0.0, 1.0} and (block.sum(1) == 1).all()
        if group["kind"] == "integer_blobs":
            assert (block == np.round(block)).all()
            assert len(np.unique(block[:, 0])) < len(block)       # values tie
        col += group["count"]


def test_draws_are_bootstrap_counts():
    w, u = gen.make_draws(5, 1000, 7, 123, torch.device("cpu"))
    w2, u2 = gen.make_draws(5, 1000, 7, 123, torch.device("cpu"))
    assert torch.equal(w, w2) and torch.equal(u, u2)
    assert w.shape == (5, 1000) and u.shape == (5, 7)
    assert (w.sum(1) == 1000).all() and (w == w.round()).all() and (w >= 0).all()
    assert ((u >= 0) & (u < 1)).all()

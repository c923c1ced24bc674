"""The plain reference equals the program's CPU path bit for bit on tiny forests."""
import copy

import numpy as np
import pytest
import torch

from prfbench import compare, gen, harness, reference

MAN = harness.manifest()


def _config(name, rows, trees, depth, bins, reuse):
    conf = next(c for c in MAN["configs"] if c["name"] == name)
    cfg = copy.deepcopy(harness.read_json(harness.ROOT / conf["file"]))
    cfg.update(train_rows=rows, test_rows=rows // 2)
    cfg["forest"].update(n_trees=trees, max_depth=depth, n_bins=bins, tree_chunk=4,
                         hist_reuse=reuse)
    return cfg


@pytest.mark.parametrize("name, rows, trees, depth, bins, reuse", [
    ("covtype", 3000, 9, 6, 32, "off"),
    ("covtype", 2500, 6, 5, 64, "on"),
    ("higgs", 3000, 10, 7, 16, "auto"),
])
def test_reference_equals_the_cpu_path(name, rows, trees, depth, bins, reuse):
    from repro_torch.core.binning import apply_bins, bin_dataset
    from repro_torch.core.dimred import dimension_reduction
    from repro_torch.core.forest import fused_vote_scores, grow_forest
    from repro_torch.core.types import ForestConfig
    from repro_torch.core.voting import build_payload, oob_accuracy

    cfg = _config(name, rows, trees, depth, bins, reuse)
    dev = torch.device("cpu")
    table = gen.make_table(cfg, 99, dev)
    x, y, xt = table["x"], table["y"], table["x_test"]
    w, u = gen.make_draws(trees, rows, cfg["n_features"], 99, dev)
    spec = reference.spec_from(cfg["forest"], cfg["n_classes"], cfg["n_features"])

    fcfg = ForestConfig(**cfg["forest"], n_classes=cfg["n_classes"]).resolved(cfg["n_features"])
    xb, edges = bin_dataset(x, bins, device="cpu")
    yt = torch.from_numpy(y)
    mask = dimension_reduction(xb, yt, w, fcfg, u)
    forest = grow_forest(xb, yt, w, fcfg, mask, device="cpu")
    forest.tree_weight = oob_accuracy(forest, xb, yt, w)
    # the card's vote: the traversal kernel's order, through its plain version on the CPU
    xbt = apply_bins(torch.from_numpy(xt), torch.from_numpy(edges))
    labels = torch.argmax(fused_vote_scores(forest, xbt, build_payload(forest)), dim=-1)

    ref = reference.train(x, y, w, u, spec, dev)
    assert np.array_equal(edges, ref["edges"]) and edges.dtype == ref["edges"].dtype
    assert torch.equal(xb, ref["bins"])
    assert torch.equal(mask, ref["mask"])
    got = {f: getattr(forest, f) for f in reference.Forest.FIELDS}
    assert compare.forest(got, ref["forest"]) == 0
    assert (ref["forest"].feature >= 0).sum() > trees            # the trees split
    assert compare.differ(forest.tree_weight, ref["tree_weight"]) == 0
    want = reference.predict(ref["forest"], ref["tree_weight"],
                             reference.digitize(torch.from_numpy(xt), ref["edges"]), spec)
    assert torch.equal(labels, want)


def test_a_wrong_split_is_seen():
    cfg = _config("covtype", 2000, 4, 4, 16, "off")
    dev = torch.device("cpu")
    table = gen.make_table(cfg, 3, dev)
    w, u = gen.make_draws(4, 2000, cfg["n_features"], 3, dev)
    spec = reference.spec_from(cfg["forest"], cfg["n_classes"], cfg["n_features"])
    ref = reference.train(table["x"], table["y"], w, u, spec, dev)
    bad = {f: getattr(ref["forest"], f).clone() for f in reference.Forest.FIELDS}
    bad["class_counts"][0, 0, 0] += 1
    assert compare.forest(bad, ref["forest"]) == 1
    assert compare.differ(np.zeros(3), np.zeros(4)) == 4
    judge = compare.TrainingJudge(ref, w, spec)
    good = {**{f: getattr(ref["forest"], f) for f in reference.Forest.FIELDS},
            "tree_weight": ref["tree_weight"], "edges": ref["edges"]}
    assert judge.numbers(good, ref["mask"]) == {"edges_mismatch": 0, "count_mismatch": 0,
                                                 "trees_differ_pct": 0.0}
    assert judge.numbers({**good, **bad})["count_mismatch"] == 1
    moved = {f: getattr(ref["forest"], f).clone() for f in reference.Forest.FIELDS}
    split = int(torch.nonzero(moved["feature"][1] >= 0)[0, 0])
    moved["threshold"][1, split] = spec.n_bins            # every row of the node goes left
    numbers = judge.numbers({**good, **moved})
    assert numbers["count_mismatch"] > 0 and numbers["trees_differ_pct"] == 25.0


@pytest.mark.parametrize("name, rows, trees", [("covtype", 3000, 12), ("higgs", 3000, 12)])
def test_routed_counts_are_the_stored_counts(name, rows, trees):
    cfg = _config(name, rows, trees, 6, 32, "off")
    dev = torch.device("cpu")
    table = gen.make_table(cfg, 11, dev)
    w, u = gen.make_draws(trees, rows, cfg["n_features"], 11, dev)
    spec = reference.spec_from(cfg["forest"], cfg["n_classes"], cfg["n_features"])
    ref = reference.train(table["x"], table["y"], w, u, spec, dev)
    forest = {f: getattr(ref["forest"], f) for f in reference.Forest.FIELDS}
    routed = reference.node_counts(forest, ref["bins"], ref["y"], w, spec)
    assert compare.differ(routed, ref["forest"].class_counts) == 0
    assert int((ref["forest"].feature >= 0).sum()) > trees


def test_vote_gap_reads_the_margin_of_a_wrong_label():
    scores = torch.tensor([[3.0, 1.0], [2.0, 2.0], [0.5, 1.5]], dtype=torch.float64)
    assert compare.vote_gap(np.array([0, 1, 1]), scores) == 0.0          # a tie either way
    assert compare.vote_gap(np.array([1, 0, 1]), scores) == 0.5
    assert compare.vote_gap(np.array([0, 0, 0]), scores) == 0.5
    assert compare.vote_gap(np.array([0, 0]), scores) == 1.0             # a row left out
    assert compare.vote_gap(np.array([0, 7, 1]), scores) == 1.0          # no such class

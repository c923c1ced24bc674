"""The frozen work counts against hand counts on small cases."""
import pytest
import torch

from prfbench import harness, reference, work

SPEC = reference.Spec(n_trees=1, max_depth=2, n_bins=4, n_classes=2, max_frontier=2,
                      min_samples_split=2, min_gain=1e-7, tree_chunk=1, n_features=2)


def _forest():
    """One tree: the root splits on feature 0 at bin 1 into two leaves (nodes 1 and 2)."""
    P = SPEC.n_nodes
    feature = torch.full((1, P), -1, dtype=torch.int32)
    threshold = torch.zeros((1, P), dtype=torch.int32)
    left = torch.full((1, P), -1, dtype=torch.int32)
    counts = torch.zeros((1, P, 2))
    feature[0, 0], threshold[0, 0], left[0, 0] = 0, 1, 1
    counts[0, 0] = torch.tensor([2.0, 2.0])
    counts[0, 1] = torch.tensor([1.0, 0.0])          # row 0 (row 1 is out of bag)
    counts[0, 2] = torch.tensor([1.0, 2.0])          # rows 2, 3
    return reference.Forest(feature, threshold, left, counts)


XB = torch.tensor([[0, 0], [1, 3], [2, 1], [3, 2]], dtype=torch.uint8)
W = torch.tensor([[1.0, 0.0, 2.0, 1.0]])
MASK = torch.tensor([[True, False]])


def test_level_counts_by_hand():
    levels = work.level_counts(_forest(), XB, W, MASK, SPEC, reuse=False)
    assert len(levels) == 2                          # the root's level, and its children's
    assert levels[0] == {"live": 3, "rows": 3, "feats": 1, "occupied": 1, "hist_live": 3,
                         "hist_rows": 3, "hist_occupied": 1}
    assert levels[1] == {"live": 3, "rows": 3, "feats": 1, "occupied": 2, "hist_live": 3,
                         "hist_rows": 3, "hist_occupied": 2}


def test_level_counts_with_reuse_take_the_smaller_child():
    levels = work.level_counts(_forest(), XB, W, MASK, SPEC, reuse=True)
    assert levels[0]["hist_live"] == 3 and levels[0]["hist_occupied"] == 1
    # node 1 holds 1 in-bag sample, node 2 holds 3: only row 0 is histogrammed, in segment 0
    assert levels[1]["hist_live"] == 1 and levels[1]["hist_rows"] == 1
    assert levels[1]["hist_occupied"] == 1 and levels[1]["occupied"] == 2


def test_hist_and_scan_work_by_hand():
    w = work.hist_work(rows=3, feats=1, live=3, occupied=1, m=1, spec=SPEC)
    assert w.bytes == 3 * 1 + 3 * 2 * 4 + 3 * 8 + 1 * 1 * 4 * 2 * 4 and w.ops == 6
    levels = work.level_counts(_forest(), XB, W, MASK, SPEC, reuse=False)
    s = work.split_scan_work(levels, SPEC)
    occ, m, B, C = 3, SPEC.n_selected, 4, 2          # one slot at level 0, two at level 1
    assert s.bytes == occ * m * B * C * 4 + occ * (12 + 8 * C)
    assert s.ops == occ * m * ((B - 1) * (57 * C + 60) + B * C)
    assert work.Work(3.35e12, 0).bound_s == pytest.approx(1.0)
    assert work.Work(0, 67e12).bound_s == pytest.approx(1.0)


def test_traverse_counts_by_hand():
    internal, leaves, steps = work.traverse_counts(_forest(), XB, SPEC.max_depth)
    assert (internal, leaves, steps) == (1, 2, 4)
    t = work.traverse_work(4, 2, (internal, leaves, steps), SPEC)
    assert t.bytes == 4 * 2 + 1 * 12 + 2 * 2 * 4 + 4 * 2 * 4 and t.ops == 2 * 4 + 4 * 1 * 2


def test_reuse_resolution_at_the_configurations_sizes():
    cfgs = {c["name"]: harness.read_json(harness.ROOT / c["file"])
            for c in harness.manifest()["configs"]}
    cov, hig = cfgs["covtype"], cfgs["higgs"]
    # [500, 16, 54, 64, 7] float32 is 774 MB, past the 256 MiB budget; higgs' is 115 MB
    assert not work.reuse_resolves_on(cov["forest"], cov["n_features"], cov["n_classes"])
    assert work.reuse_resolves_on(hig["forest"], hig["n_features"], hig["n_classes"])


def test_binning_and_fit_work_by_hand():
    # 10 rows x 3 features: 30 floats read (120 bytes) and 30 bin ids written (30 bytes);
    # 64 bins: 63 edges, a binary search of 6 steps a value
    assert work.bin_fit_work(10, 3) == work.Work(bytes=120, ops=0.0)
    assert work.binning_work(10, 3, 64) == work.Work(bytes=150, ops=180.0)

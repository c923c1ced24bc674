"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: every test takes the ``cuda_device`` fixture, which skips
when no card is present (decided inside the fixture, never at import).
Run on a machine with an H100:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.gain_ratio import ops as hist_ops
from repro_torch.kernels.gain_ratio.ref import multi_tree_hist_ref
from repro_torch.kernels.split_scan import ops as scan_ops
from repro_torch.kernels.split_scan.ref import init_carry, split_scan_block_ref
from repro_torch.kernels.tree_traverse import ops as trav_ops
from repro_torch.kernels.tree_traverse.ref import traverse_block_ref

pytestmark = pytest.mark.cuda
RNG = np.random.default_rng(53)


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU form)")
    return torch.device("cuda")


def _hist_inputs(dev, tc=3, N=1001, F=13, S=6, B=16, C=4, regression=False):
    xb = torch.from_numpy(RNG.integers(0, B, (N, F)).astype(np.uint8)).to(dev)
    if regression:
        y = torch.from_numpy(RNG.normal(size=N).astype(np.float32)).to(dev)
        base = torch.stack([torch.ones_like(y), y, y * y], -1)
    else:
        base = torch.eye(C, device=dev)[torch.from_numpy(RNG.integers(0, C, N)).to(dev)]
    w = torch.from_numpy(RNG.integers(0, 4, (tc, N)).astype(np.float32)).to(dev)
    slot = RNG.integers(0, S, (tc, N)).astype(np.int32)
    slot[RNG.random((tc, N)) < 0.1] = -1
    return xb, base, w, torch.from_numpy(slot).to(dev)


@pytest.mark.parametrize("packed", [False, True])
def test_hist_kernel_bitwise(cuda_device, packed):
    xb, base, w, slot = _hist_inputs(cuda_device)
    n0 = hist_ops.launches
    got = hist_ops.multi_tree_hist(xb, base, w, slot, n_slots=6, n_bins=16, packed=packed)
    want = multi_tree_hist_ref(xb, base, w, slot, n_slots=6, n_bins=16, packed=packed)
    torch.cuda.synchronize()
    assert hist_ops.launches == n0 + 1
    assert torch.equal(got, want)
    sl = hist_ops.multi_tree_hist(xb[:, 3:9], base, w, slot, n_slots=6, n_bins=16, packed=packed)
    assert torch.equal(sl, got[:, :, 3:9])


def test_hist_kernel_regression_close(cuda_device):
    xb, base, w, slot = _hist_inputs(cuda_device, C=3, regression=True)
    got = hist_ops.multi_tree_hist(xb, base, w, slot, n_slots=6, n_bins=16)
    want = multi_tree_hist_ref(xb, base, w, slot, n_slots=6, n_bins=16)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("regression", [False, True])
def test_split_scan_kernel_matches_plain(cuda_device, regression):
    C = 3 if regression else 4
    xb, base, w, slot = _hist_inputs(cuda_device, C=C, regression=regression)
    hist = multi_tree_hist_ref(xb, base, w, slot, n_slots=6, n_bins=16)
    mask = torch.from_numpy(RNG.random((3, 13)) > 0.3).to(cuda_device)
    k_carry = p_carry = init_carry(3, 6, C, cuda_device)
    for f0, f1 in [(0, 5), (5, 9), (9, 13)]:
        k_carry = scan_ops.split_scan_block(hist[:, :, f0:f1], mask[:, f0:f1], k_carry, f0,
                                            regression=regression)
        p_carry = split_scan_block_ref(hist[:, :, f0:f1], mask[:, f0:f1], p_carry, f0,
                                       regression=regression)
    torch.cuda.synchronize()
    assert torch.equal(k_carry[1], p_carry[1]) and torch.equal(k_carry[2], p_carry[2])
    if regression:
        torch.testing.assert_close(k_carry[0], p_carry[0], rtol=1e-5, atol=1e-5)
    else:
        assert torch.equal(k_carry[0], p_carry[0])
        assert torch.equal(k_carry[3], p_carry[3]) and torch.equal(k_carry[4], p_carry[4])


def test_traverse_kernel_matches_plain(cuda_device):
    N, F, k, P, C, depth = 3001, 9, 7, 63, 4, 5
    xb = torch.from_numpy(RNG.integers(0, 16, (N, F)).astype(np.uint8)).to(cuda_device)
    feature = np.full((k, P), -1, np.int32)
    threshold = np.zeros((k, P), np.int32)
    left = np.full((k, P), -1, np.int32)
    for t in range(k):
        for node in range(31):
            if node == 0 or RNG.random() < 0.8:
                feature[t, node] = RNG.integers(0, F)
                threshold[t, node] = RNG.integers(0, 15)
                left[t, node] = 2 * node + 1
    payload = (RNG.random((k, P, C)) * (feature < 0)[..., None]).astype(np.float32)
    args = [torch.from_numpy(a).to(cuda_device) for a in (feature, threshold, left, payload)]
    carry = torch.from_numpy(RNG.random((N, C)).astype(np.float32)).to(cuda_device)
    got = trav_ops.traverse_block(xb, *args, carry, depth=depth)
    want = traverse_block_ref(xb, *args, carry, depth=depth)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_train_prf_kernel_path_equals_plain_path(cuda_device):
    from repro_torch import ForestConfig, train_prf
    from repro_torch.data.tabular import make_classification, train_test_split

    x, y = make_classification(n_samples=4000, n_features=20, n_classes=3, seed=1)
    xtr, ytr, xte, _ = train_test_split(x, y, 0.25, 0)
    cfg = ForestConfig(n_trees=6, max_depth=5, n_bins=32, n_classes=3, hist_reuse="off")
    plain = ForestConfig(**{**cfg.__dict__, "hist_backend": "segment_sum",
                            "split_backend": "xla", "predict_backend": "xla"})
    a = train_prf(xtr, ytr, cfg, 0, device=cuda_device)
    b = train_prf(xtr, ytr, plain, 0, device=cuda_device)
    for name in ("feature", "threshold", "left_child", "class_counts", "tree_weight"):
        assert torch.equal(getattr(a.forest, name), getattr(b.forest, name)), name
    np.testing.assert_array_equal(a.predict(xte), b.predict(xte))

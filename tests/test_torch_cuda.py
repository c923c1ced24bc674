"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: every test takes the ``cuda_device`` fixture, which skips
when no card is present (decided inside the fixture, never at import).
Run on a machine with an H100:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import MaskSpec, attention_bwd_ref, gqa_attend, gqa_attend_lse
from repro_torch.kernels.gain_ratio import ops as hist_ops
from repro_torch.kernels.gain_ratio.ref import (
    FixedPoint, fixed_shift, multi_tree_hist_fixed_ref, multi_tree_hist_ref,
)
from repro_torch.kernels.split_scan import ops as scan_ops
from repro_torch.kernels.split_scan.ref import init_carry, split_scan_block_ref
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import ssd_chunked, ssd_chunked_bwd
from repro_torch.kernels.tree_traverse import ops as trav_ops
from repro_torch.kernels.tree_traverse.ref import traverse_block_ref

from test_torch_split_cases import SPLIT_CASES, split_scan_case
from test_torch_traverse_cases import TRAVERSE_CASES, traverse_case

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


def _spread(slot_np, S, how):
    if how == "one slot":
        return np.where(slot_np >= 0, 0, -1).astype(np.int32)
    return slot_np % S if how == "spread" else slot_np


@pytest.mark.parametrize("how,S,parked,B,C", [("spread", 6, 0.1, 16, 4), ("one slot", 6, 0.0, 16, 4),
                                              ("one slot", 1, 0.1, 16, 4), ("spread", 40, 0.0, 16, 4),
                                              ("spread", 9, 0.1, 7, 3)])   # B * C odd: scalar flush
@pytest.mark.parametrize("packed", [False, True])
def test_hist_kernel_ordered_bitwise(cuda_device, how, S, parked, B, C, packed):
    """The privatised kernel against the plain version, bitwise: slots
    spread over S or all in one, 10% parked or none, a strided slab
    (ld != W), the grouping made by the wrapper or handed in."""
    from repro_torch.kernels.gain_ratio.ops import slot_order

    tc, N, F = 3, 5003, 40
    xb = torch.from_numpy(RNG.integers(0, B, (N, F)).astype(np.uint8)).to(cuda_device)
    base = torch.eye(C, device=cuda_device)[torch.from_numpy(RNG.integers(0, C, N)).to(cuda_device)]
    w = torch.from_numpy(RNG.integers(0, 4, (tc, N)).astype(np.float32)).to(cuda_device)
    slot_np = _spread(RNG.integers(0, S, (tc, N)).astype(np.int32), S, how)
    slot_np[RNG.random((tc, N)) < parked] = -1
    slot = torch.from_numpy(slot_np).to(cuda_device)
    order = slot_order(slot, w, S)
    for xs in (xb, xb[:, 3:38]):                  # full width, then a strided slab (ld 40, W 35)
        want = multi_tree_hist_ref(xs, base, w, slot, n_slots=S, n_bins=B, packed=packed)
        n0 = hist_ops.launches
        got = hist_ops.multi_tree_hist(xs, base, w, slot, n_slots=S, n_bins=B, packed=packed)
        given = hist_ops.multi_tree_hist(xs, base, w, slot, n_slots=S, n_bins=B, packed=packed,
                                         order=order)
        torch.cuda.synchronize()
        assert hist_ops.launches == n0 + 2
        assert torch.equal(got, want) and torch.equal(given, want)


def test_hist_kernel_ordered_regression_close(cuda_device):
    xb, base, w, slot = _hist_inputs(cuda_device, N=7001, S=20, C=3, regression=True)
    got = hist_ops.multi_tree_hist(xb, base, w, slot, n_slots=20, n_bins=16)
    want = multi_tree_hist_ref(xb, base, w, slot, n_slots=20, n_bins=16)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


def test_hist_kernel_regression_close(cuda_device):
    xb, base, w, slot = _hist_inputs(cuda_device, C=3, regression=True)
    got = hist_ops.multi_tree_hist(xb, base, w, slot, n_slots=6, n_bins=16)
    want = multi_tree_hist_ref(xb, base, w, slot, n_slots=6, n_bins=16)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("name", SPLIT_CASES)
def test_split_scan_kernel_matrix(cuda_device, name):
    """The kernel's carry over three chained slabs against the plain
    version's: bitwise for classification, gain included."""
    hist, mask, slabs, regression = split_scan_case(name)
    h, m = torch.from_numpy(hist).to(cuda_device), torch.from_numpy(mask).to(cuda_device)
    tc, S, _, _, C = hist.shape
    k_carry = p_carry = init_carry(tc, S, C, cuda_device)
    n0 = scan_ops.launches
    for f0, f1 in slabs:
        k_carry = scan_ops.split_scan_block(h[:, :, f0:f1], m[:, f0:f1], k_carry, f0, regression=regression)
        p_carry = split_scan_block_ref(h[:, :, f0:f1], m[:, f0:f1], p_carry, f0, regression=regression)
    torch.cuda.synchronize()
    assert scan_ops.launches == n0 + 3
    assert torch.equal(k_carry[1], p_carry[1]) and torch.equal(k_carry[2], p_carry[2])
    if regression:
        for i in (0, 3, 4):
            torch.testing.assert_close(k_carry[i], p_carry[i], rtol=1e-5, atol=1e-5)
    else:
        for i in (0, 3, 4):
            assert torch.equal(k_carry[i], p_carry[i]), i


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


@pytest.mark.parametrize("B,C", [(256, 300), (64, 1000), (256, 199)])   # the last: one tile each
@pytest.mark.parametrize("packed", [False, True])
def test_class_tiled_kernels_bitwise(cuda_device, B, C, packed):
    """Past shared memory's class limits (C >= 227 for the histogram,
    C >= 200 for the split scan at B 256) both kernels take the class axis
    in tiles (``class_tile``): the histogram (ordered by slot; unpacked
    rows with several channels too) and the split scan's carry over two
    slabs, every field, bitwise the plain versions."""
    tc, N, F, S = 2, 3001, 6, 5
    dev = cuda_device
    xb = torch.from_numpy(RNG.integers(0, B, (N, F)).astype(np.uint8)).to(dev)
    base = torch.eye(C, device=dev)[torch.from_numpy(RNG.integers(0, C, N)).to(dev)]
    if not packed:
        base[:50] = torch.from_numpy(RNG.integers(0, 3, (50, C)).astype(np.float32)).to(dev)
    w = torch.from_numpy(RNG.integers(0, 4, (tc, N)).astype(np.float32)).to(dev)
    slot = torch.from_numpy(RNG.integers(-1, S, (tc, N)).astype(np.int32)).to(dev)
    n0 = (hist_ops.launches, scan_ops.launches)
    got = hist_ops.multi_tree_hist(xb, base, w, slot, n_slots=S, n_bins=B, packed=packed)
    want = multi_tree_hist_ref(xb, base, w, slot, n_slots=S, n_bins=B, packed=packed)
    mask = torch.from_numpy(RNG.random((tc, F)) > 0.2).to(dev)
    k_carry = p_carry = init_carry(tc, S, C, dev)
    for f0, f1 in ((0, 4), (4, F)):
        k_carry = scan_ops.split_scan_block(want[:, :, f0:f1], mask[:, f0:f1], k_carry, f0)
        p_carry = split_scan_block_ref(want[:, :, f0:f1], mask[:, f0:f1], p_carry, f0)
    torch.cuda.synchronize()
    assert (hist_ops.launches, scan_ops.launches) == (n0[0] + 1, n0[1] + 2)
    assert torch.equal(got, want)
    for i in range(5):
        assert torch.equal(k_carry[i], p_carry[i]), i
    assert (hist_ops.class_tile(B, C) < C) == (B * C + 1 > 227 * 256)
    assert (scan_ops.class_tile(B, C) < C) == (B * (C | 1) > 200 * 256)


def test_train_prf_many_classes_stays_on_the_kernels(cuda_device):
    """250 classes at 256 bins: ``"auto"`` grows on the histogram and split
    scan kernels (both in class tiles) and gives the plain path's forest."""
    import dataclasses

    from repro_torch import ForestConfig, train_prf

    rng = np.random.default_rng(11)
    N, F, C = 4000, 8, 250
    y = rng.integers(0, C, N).astype(np.int32)
    x = rng.standard_normal((N, F)).astype(np.float32)
    x[:, 0] += y / 10.0
    x[:, 1] -= (y % 17) / 3.0
    cfg = ForestConfig(n_trees=3, max_depth=4, n_bins=256, n_classes=C, hist_reuse="off")
    plain = dataclasses.replace(cfg, hist_backend="segment_sum", split_backend="xla",
                                predict_backend="xla")
    n0 = (hist_ops.launches, scan_ops.launches)
    a = train_prf(x, y, cfg, 0, device=cuda_device)
    torch.cuda.synchronize()
    assert hist_ops.launches > n0[0] and scan_ops.launches > n0[1]
    b = train_prf(x, y, plain, 0, device=cuda_device)
    for name in ("feature", "threshold", "left_child", "class_counts", "tree_weight"):
        assert torch.equal(getattr(a.forest, name), getattr(b.forest, name)), name
    np.testing.assert_array_equal(a.predict(x), b.predict(x))


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


@pytest.mark.parametrize("name", list(TRAVERSE_CASES))
def test_traverse_kernel_cases_bitwise(cuda_device, name):
    x, forest, carry, tc, depth = traverse_case(name)
    xb = torch.from_numpy(x).to(cuda_device)
    arrays = [torch.from_numpy(a).to(cuda_device) for a in forest]
    got = want = torch.from_numpy(carry).to(cuda_device)
    k = arrays[0].shape[0]
    before = trav_ops.launches
    for c0 in range(0, k, tc):
        part = [a[c0:c0 + tc] for a in arrays]
        got = trav_ops.traverse_block(xb, *part, got, depth=depth)
        want = traverse_block_ref(xb, *part, want, depth=depth)
    torch.cuda.synchronize()
    assert trav_ops.launches == before + -(-k // tc)
    assert torch.equal(got, want)


def test_reuse_kernel_path_equals_plain_path_and_reuse_off(cuda_device):
    """Histogram reuse on the card: the kernel path (rank-segment
    histograms, expanded slabs into the split scan) gives the plain
    path's forest and reuse off's forest, bitwise."""
    from repro_torch import ForestConfig, train_prf
    from repro_torch.data.tabular import make_classification

    x, y = make_classification(n_samples=6000, n_features=24, n_classes=3, seed=2)
    cfg = ForestConfig(n_trees=6, max_depth=6, n_bins=32, n_classes=3, hist_reuse="on")
    plain = ForestConfig(**{**cfg.__dict__, "hist_backend": "segment_sum", "split_backend": "xla"})
    off = ForestConfig(**{**cfg.__dict__, "hist_reuse": "off"})
    n0 = hist_ops.launches
    a = train_prf(x, y, cfg, 0, device=cuda_device)
    assert hist_ops.launches > n0
    for other in (train_prf(x, y, plain, 0, device=cuda_device), train_prf(x, y, off, 0, device=cuda_device)):
        for name in ("feature", "threshold", "left_child", "class_counts", "tree_weight"):
            assert torch.equal(getattr(a.forest, name), getattr(other.forest, name)), name


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


def test_streamed_kernel_path_equals_plain_path(cuda_device, tmp_path):
    """The streaming plane on the card: ``train_prf`` from an ``np.memmap``
    with ``sample_block`` (5 blocks, a remainder; exact bins) on the
    kernel path gives the plain path's model and the resident kernel
    path's forest bitwise, and its streamed prediction equals the
    resident one; the three kernels ran on the streamed run."""
    import dataclasses

    from repro_torch import ForestConfig, train_prf
    from repro_torch.data.tabular import make_classification, train_test_split

    x, y = make_classification(n_samples=6000, n_features=20, n_classes=3, seed=4)
    xtr, ytr, xte, _ = train_test_split(x, y, 0.25, 0)
    mm = np.memmap(tmp_path / "x.f32", np.float32, "w+", shape=xtr.shape)
    mm[:] = xtr
    mm.flush()
    cfg = ForestConfig(n_trees=6, max_depth=5, n_bins=32, n_classes=3, hist_reuse="off",
                       sample_block=1000, bin_fit="exact")
    plain = dataclasses.replace(cfg, hist_backend="segment_sum", split_backend="xla",
                                predict_backend="xla")
    n0 = (hist_ops.launches, scan_ops.launches, trav_ops.launches)
    a = train_prf(mm, ytr, cfg, 0, device=cuda_device)
    pa = a.predict(xte[:1700])                         # 2 blocks of prediction
    torch.cuda.synchronize()
    assert hist_ops.launches > n0[0] and scan_ops.launches > n0[1] and trav_ops.launches > n0[2]
    b = train_prf(mm, ytr, plain, 0, device=cuda_device)
    r = train_prf(xtr.astype(np.float32), ytr, dataclasses.replace(cfg, sample_block=0), 0,
                  device=cuda_device)
    for other in (b, r):
        for name in ("feature", "threshold", "left_child", "class_counts", "tree_weight"):
            assert torch.equal(getattr(a.forest, name), getattr(other.forest, name)), name
    np.testing.assert_array_equal(pa, b.predict(xte[:1700]))
    np.testing.assert_array_equal(pa, r.predict(xte[:1700]))


@pytest.mark.parametrize("consumer", ["slow host", "busy card"])
def test_block_feeder_pinned_ring_never_overwrites_a_block_in_flight(cuda_device, consumer):
    """``prefetch`` 2 (a ring of 3 pinned buffers) over 24 blocks of 4 MiB,
    each block's content distinct: every block the consumer receives
    equals its host array, whether the consumer sleeps between blocks or
    queues long kernels on the card before reading each one."""
    import time

    from repro_torch.data.pipeline import BlockFeeder

    blocks = [np.full((4096, 1024), i % 251, np.uint8) for i in range(24)]
    for i, b in enumerate(blocks):
        b[i % 4096] = 255 - i % 251
    feeder = BlockFeeder(blocks, placement=cuda_device, prefetch=2)
    busy = torch.randn((2048, 2048), device=cuda_device)
    got = []
    with feeder:
        for i, blk in zip(feeder.live_blocks, feeder.sweep()):
            if consumer == "slow host":
                time.sleep(0.02)
            else:
                for _ in range(8):
                    busy = busy @ busy / 2048
            got.append(blk.clone())
    torch.cuda.synchronize()
    assert len(got) == len(blocks)
    for g, b in zip(got, blocks):
        assert torch.equal(g.cpu(), torch.from_numpy(b))


def test_predict_past_16_bit_features_stays_on_the_kernel(cuda_device):
    """F = 70,000: ``"auto"`` prediction runs the traversal kernel (wide
    nodes) and equals the plain path."""
    from repro_torch import ForestConfig, train_prf

    rng = np.random.default_rng(7)
    N, F = 1200, 70_000
    x = rng.standard_normal((N, F), dtype=np.float32)
    y = (x[:, 69_999] > 0).astype(np.int32) + 2 * (x[:, 3] > 0)
    cfg = ForestConfig(n_trees=4, max_depth=3, n_bins=16, n_classes=4, hist_reuse="off",
                       feature_mode="all")
    model = train_prf(x, y, cfg, 0, device=cuda_device)
    assert trav_ops.traverse_plan(F)["wide"]
    assert int(model.forest.feature.max()) >= 1 << 16
    n0 = trav_ops.launches
    got = model.predict(x)
    torch.cuda.synchronize()
    assert trav_ops.launches == n0 + 1
    np.testing.assert_array_equal(got, model.with_predict_backend("xla").predict(x))
    np.testing.assert_allclose(model.predict_scores(x),
                               model.with_predict_backend("xla").predict_scores(x), rtol=1e-6, atol=1e-6)


# The LM kernels' tolerance, per element: |got - want| <= rtol |want| +
# atol rms(want). f32: sums taken in another order. bf16 output: one
# rounding may land one bf16 ulp (at most 2^-7 |want|) away.
LM_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (2.0 ** -7, 1e-2)}


def _scaled_close(got, want, dtype):
    rtol, atol = LM_TOL[dtype]
    want = want.double()
    rms = float(want.square().mean().sqrt())
    torch.testing.assert_close(got.double(), want, rtol=rtol, atol=atol * rms)


@pytest.mark.parametrize("B,H,KV,Lq,Lk,D,causal,window", [
    (2, 9, 3, 200, 200, 64, True, 0),      # GQA 3:1, ragged tiles
    (1, 4, 2, 77, 301, 64, True, 0),       # Lq < Lk, odd lengths
    (1, 4, 4, 257, 257, 32, True, 100),    # window
    (1, 2, 1, 130, 250, 128, False, 0),    # unmasked
    (1, 2, 2, 65, 190, 256, True, 33),     # widest head dim
    (1, 4, 2, 300, 77, 64, False, 0),      # unmasked, more queries than keys (cross-attention)
    (2, 16, 2, 256, 128, 128, False, 0),   # unmasked, GQA 8:1 at hd 128, Lq = 2 Lk (llama-vision's)
    (2, 4, 4, 150, 150, 64, False, 0),     # unmasked, Lq = Lk, ragged tiles (an encoder's)
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(cuda_device, B, H, KV, Lq, Lk, D, causal, window, dtype):
    q = torch.from_numpy(RNG.standard_normal((B, Lq, H, D)).astype(np.float32)).to(cuda_device, dtype)
    k = torch.from_numpy(RNG.standard_normal((B, Lk, KV, D)).astype(np.float32)).to(cuda_device, dtype)
    v = torch.from_numpy(RNG.standard_normal((B, Lk, KV, D)).astype(np.float32)).to(cuda_device, dtype)
    n0, n_bf16, n_f32 = flash_ops.launches, flash_ops.launches_bf16, flash_ops.launches_f32
    got = flash_ops.flash_attention(q, k, v, causal=causal, window=window)
    want = gqa_attend(q, k, v, mask_spec=MaskSpec(causal=causal, window=window, offset=Lk - Lq))
    torch.cuda.synchronize()
    assert flash_ops.launches == n0 + 1 and got.dtype == dtype
    # bf16 runs on the tensor-core kernel, f32 on the CUDA-core kernel
    bf16 = dtype == torch.bfloat16
    assert (flash_ops.launches_bf16, flash_ops.launches_f32) == (n_bf16 + bf16, n_f32 + (not bf16))
    _scaled_close(got, want, dtype)


@pytest.mark.parametrize("B,H,KV,Lq,Lk,D,window,prefix", [
    (1, 4, 2, 130, 130, 240, 70, 0),       # gemma3-12b's head dim, window
    (1, 4, 2, 100, 100, 168, 0, 0),        # gemma3-27b's
    (2, 4, 4, 90, 90, 56, 0, 0),           # deepseek-v3's dense layers'
    (1, 5, 1, 150, 214, 64, 40, 64),       # hymba's meta prefix, ends aligned, window
    (1, 2, 1, 70, 200, 20, 50, 100),       # a head dim the wrapper pads, a prefix of two tiles
    (2, 2, 2, 130, 130, 40, 0, 70),        # a prefix past the causal edge of the first queries
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_head_dims_and_prefix(cuda_device, B, H, KV, Lq, Lk, D, window, prefix, dtype):
    q = torch.from_numpy(RNG.standard_normal((B, Lq, H, D)).astype(np.float32)).to(cuda_device, dtype)
    k = torch.from_numpy(RNG.standard_normal((B, Lk, KV, D)).astype(np.float32)).to(cuda_device, dtype)
    v = torch.from_numpy(RNG.standard_normal((B, Lk, KV, D)).astype(np.float32)).to(cuda_device, dtype)
    n_bf16 = flash_ops.launches_bf16
    got = flash_ops.flash_attention(q, k, v, window=window, prefix=prefix)
    want = gqa_attend(q, k, v, mask_spec=MaskSpec(window=window, offset=Lk - Lq, prefix=prefix))
    torch.cuda.synchronize()
    assert flash_ops.launches_bf16 == n_bf16 + (dtype == torch.bfloat16) and got.shape == q.shape
    _scaled_close(got, want, dtype)


def test_flash_attention_bf16_takes_only_its_head_dims(cuda_device):
    """Every head dim up to 256 runs (the test above); a wider one raises."""
    q = torch.zeros((1, 64, 2, 264), device=cuda_device, dtype=torch.bfloat16)
    n0 = flash_ops.launches
    with pytest.raises(ValueError):
        flash_ops.flash_attention(q, q, q)
    assert flash_ops.launches == n0


@pytest.mark.parametrize("B,H,KV,Lq,Lk,D,causal,window,prefix", [
    (2, 9, 3, 200, 200, 64, True, 0, 0),      # GQA 3:1, ragged tiles
    (1, 4, 2, 77, 301, 32, True, 0, 0),       # Lq < Lk, odd lengths
    (1, 4, 4, 257, 257, 56, True, 100, 0),    # window, deepseek-v3's dense head dim
    (1, 4, 2, 100, 164, 168, True, 30, 64),   # window and prefix, gemma3-27b's head dim
    (1, 4, 2, 300, 77, 64, False, 0, 0),      # unmasked, more queries than keys
    (1, 2, 1, 130, 250, 240, False, 0, 0),    # unmasked, fewer queries, gemma3-12b's head dim
    (1, 2, 2, 65, 190, 256, True, 33, 0),     # widest head dim (32-key tiles)
    (1, 4, 2, 90, 150, 20, True, 0, 0),       # a head dim no multiple of 8 (bf16: padded to 24)
    (1, 6, 2, 1000, 1000, 128, True, 0, 0),   # GQA 3:1, the two-stage rings wrap many times
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_kernel_matches_plain(cuda_device, B, H, KV, Lq, Lk, D, causal, window, prefix, dtype):
    """The backward kernels on the forward kernel's out and lse against
    ``attention_bwd_ref`` on the same tensors, the route's counts (bf16 at a
    padded head dim up to 128 on the tensor-core kernels, wider on the
    CUDA-core ones), and two calls bitwise equal; the lse against
    ``gqa_attend_lse``'s."""
    q, do = (torch.from_numpy(RNG.standard_normal((B, Lq, H, D)).astype(np.float32)).to(cuda_device, dtype)
             for _ in range(2))
    k, v = (torch.from_numpy(RNG.standard_normal((B, Lk, KV, D)).astype(np.float32)).to(cuda_device, dtype)
            for _ in range(2))
    spec = MaskSpec(causal=causal, window=window, offset=Lk - Lq, prefix=prefix)
    out, lse = flash_ops.flash_attention_lse(q, k, v, causal=causal, window=window, prefix=prefix)
    _scaled_close(lse, gqa_attend_lse(q, k, v, mask_spec=spec)[1], torch.float32)
    counts = lambda: (flash_ops.launches_bwd_bf16, flash_ops.launches_bwd_tc, flash_ops.launches_bwd_bf16_fma,
                      flash_ops.launches_bwd_f32)
    n0 = counts()
    got = flash_ops.flash_attention_bwd(q, k, v, out, lse, do, causal=causal, window=window, prefix=prefix)
    again = flash_ops.flash_attention_bwd(q, k, v, out, lse, do, causal=causal, window=window, prefix=prefix)
    torch.cuda.synchronize()
    bf16 = dtype == torch.bfloat16
    tc = bf16 and -(-D // 8) * 8 <= 128
    assert flash_ops.bwd_route(dtype, D)[0] == tc
    assert counts() == (n0[0] + 2 * bf16, n0[1] + 2 * tc, n0[2] + 2 * (bf16 and not tc), n0[3] + 2 * (not bf16))
    for g, w, g2 in zip(got, attention_bwd_ref(q, k, v, out, lse, do, spec), again):
        assert g.dtype == dtype and g.shape == w.shape and torch.equal(g, g2)
        _scaled_close(g, w, dtype)


def test_flash_attention_autograd_on_the_card(cuda_device):
    """``flash_attention`` under autograd runs both kernels; in f32 its
    gradients match autograd through the plain ``gqa_attend``."""
    dtype = torch.float32
    B, H, KV, L, D = 2, 6, 2, 150, 64
    q, do = (torch.from_numpy(RNG.standard_normal((B, L, H, D)).astype(np.float32)).to(cuda_device, dtype)
             for _ in range(2))
    k, v = (torch.from_numpy(RNG.standard_normal((B, L, KV, D)).astype(np.float32)).to(cuda_device, dtype)
            for _ in range(2))
    qkv = [t.requires_grad_(True) for t in (q, k, v)]
    n0, nb0 = flash_ops.launches, flash_ops.launches_bwd
    got = torch.autograd.grad(flash_ops.flash_attention(*qkv, window=40), qkv, do)
    assert (flash_ops.launches, flash_ops.launches_bwd) == (n0 + 1, nb0 + 1)
    want = torch.autograd.grad(gqa_attend(*qkv, mask_spec=MaskSpec(window=40)), qkv, do)
    for g, w in zip(got, want):
        _scaled_close(g, w, dtype)


def _ssd_inputs(dev, B, S, H, P, N, dtype):
    x = torch.from_numpy(RNG.standard_normal((B, S, H, P)).astype(np.float32)).to(dev, dtype)
    loga = torch.from_numpy((-np.abs(RNG.standard_normal((B, S, H))) * 0.4).astype(np.float32)).to(dev)
    b = torch.from_numpy((RNG.standard_normal((B, S, N)) * 0.3).astype(np.float32)).to(dev, dtype)
    c = torch.from_numpy((RNG.standard_normal((B, S, N)) * 0.3).astype(np.float32)).to(dev, dtype)
    return x, loga, b, c


def _ssd_check(dev, B, S, H, P, N, chunk, dtype):
    x, loga, b, c = _ssd_inputs(dev, B, S, H, P, N, dtype)
    n0, n_bf16, n_f32 = ssd_ops.launches, ssd_ops.launches_bf16, ssd_ops.launches_f32
    y, h = ssd_ops.ssd_scan(x, loga, b, c, chunk=chunk)
    # the plain version walks chunks that divide S; the bf16 kernel ignores ``chunk``
    yp, hp = ssd_chunked(x, loga, b, c, None, math.gcd(min(chunk, S), S))
    torch.cuda.synchronize()
    assert ssd_ops.launches == n0 + 1 and y.dtype == dtype and h.dtype == torch.float32
    # bf16 runs on the tensor-core kernel, f32 on the CUDA-core kernel
    bf16 = dtype == torch.bfloat16
    assert (ssd_ops.launches_bf16, ssd_ops.launches_f32) == (n_bf16 + bf16, n_f32 + (not bf16))
    _scaled_close(y, yp, dtype)
    _scaled_close(h, hp, torch.float32)


@pytest.mark.parametrize("B,S,H,P,N", [(2, 64, 3, 64, 16), (1, 384, 2, 64, 128), (2, 256, 4, 32, 64),
                                       (2, 512, 50, 64, 16)])      # hymba's heads
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_kernel_matches_plain(cuda_device, B, S, H, P, N, dtype):
    _ssd_check(cuda_device, B, S, H, P, N, 128, dtype)


@pytest.mark.parametrize("chunk", [64, 128])
@pytest.mark.parametrize("P", [32, 64])
@pytest.mark.parametrize("N", [16, 64, 128])
def test_ssd_scan_bf16_tensor_core_shapes(cuda_device, chunk, P, N):
    """The tensor-core kernel at every chunk, head dim and state size of
    the small checks; h_final at f32's tolerance."""
    _ssd_check(cuda_device, 2, 256, 3, P, N, chunk, torch.bfloat16)


@pytest.mark.parametrize("S,chunk,N", [(200, 8, 32), (96, 32, 16), (1, 1, 64), (200, 128, 32), (100, 64, 128)])
def test_ssd_scan_bf16_any_length(cuda_device, S, chunk, N):
    """Lengths that are no multiple of the kernel's 64-step chunk, and
    (the last two) none of ``chunk``, which the bf16 route ignores."""
    _ssd_check(cuda_device, 1, S, 2, 64, N, chunk, torch.bfloat16)


@pytest.mark.parametrize("P,N", [(48, 64), (64, 256), (16, 16)])
def test_ssd_scan_bf16_raises_on_shapes_it_does_not_take(cuda_device, P, N):
    x, loga, b, c = _ssd_inputs(cuda_device, 1, 64, 2, P, N, torch.bfloat16)
    n0 = ssd_ops.launches
    with pytest.raises(ValueError):
        ssd_ops.ssd_scan(x, loga, b, c)
    assert ssd_ops.launches == n0


@pytest.mark.parametrize("B,S,H,P,N", [
    (2, 64, 3, 64, 16),           # one chunk
    (1, 200, 2, 64, 128),         # L off the 64-step chunk
    (2, 40, 4, 32, 32),           # L < chunk
    (1, 384, 5, 32, 64),
    (2, 256, 50, 64, 16),         # hymba's heads
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_backward_kernel_matches_plain(cuda_device, B, S, H, P, N, dtype):
    """The backward kernel against ``ssd_chunked_bwd`` per element at
    LM_TOL (d log a, f32 in both dtypes, at f32's), one launch counted on
    its dtype's route, two calls bitwise equal."""
    x, loga, b, c = _ssd_inputs(cuda_device, B, S, H, P, N, dtype)
    dy = torch.from_numpy(RNG.standard_normal((B, S, H, P)).astype(np.float32)).to(cuda_device, dtype)
    n0, n_bf16, n_f32 = ssd_ops.launches_bwd, ssd_ops.launches_bwd_bf16, ssd_ops.launches_bwd_f32
    got = ssd_ops.ssd_scan_bwd(x, loga, b, c, dy)
    bf16 = dtype == torch.bfloat16
    assert (ssd_ops.launches_bwd, ssd_ops.launches_bwd_bf16, ssd_ops.launches_bwd_f32) == (
        n0 + 1, n_bf16 + bf16, n_f32 + (not bf16))
    again = ssd_ops.ssd_scan_bwd(x, loga, b, c, dy)
    want = ssd_chunked_bwd(x, loga, b, c, dy, math.gcd(min(128, S), S))
    for g, w, a in zip(got, want, again):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, a)
        _scaled_close(g, w, g.dtype)


def _ssd_bwd_route(dev, B, S, H, P, N, dtype):
    """One backward call against ``ssd_chunked_bwd`` at LM_TOL (d log a at
    f32's), counted on its route (bf16: the tensor cores; f32: the CUDA
    cores), two calls bitwise equal."""
    x, loga, b, c = _ssd_inputs(dev, B, S, H, P, N, dtype)
    dy = torch.from_numpy(RNG.standard_normal((B, S, H, P)).astype(np.float32)).to(dev, dtype)
    n0 = (ssd_ops.launches_bwd, ssd_ops.launches_bwd_tc, ssd_ops.launches_bwd_f32)
    got = ssd_ops.ssd_scan_bwd(x, loga, b, c, dy)
    bf16 = dtype == torch.bfloat16
    assert (ssd_ops.launches_bwd, ssd_ops.launches_bwd_tc, ssd_ops.launches_bwd_f32) == (
        n0[0] + 1, n0[1] + bf16, n0[2] + (not bf16))
    again = ssd_ops.ssd_scan_bwd(x, loga, b, c, dy)
    want = ssd_chunked_bwd(x, loga, b, c, dy, math.gcd(min(128, S), S))
    for g, w, a in zip(got, want, again):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, a)
        _scaled_close(g, w, g.dtype)


@pytest.mark.parametrize("P", [32, 64])
@pytest.mark.parametrize("N", [16, 32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_backward_routes_per_shape(cuda_device, P, N, dtype):
    """Every (P, N) the backward takes: bf16 on the tensor cores, f32 on the CUDA cores."""
    _ssd_bwd_route(cuda_device, 2, 192, 5, P, N, dtype)


@pytest.mark.parametrize("S", [1, 17, 63, 64, 65, 130, 1000])
def test_ssd_backward_tensor_cores_any_length(cuda_device, S):
    """L off the 64-step chunk and below it: TMA zero-fills the rows past L."""
    _ssd_bwd_route(cuda_device, 2, S, 3, 64, 128, torch.bfloat16)
    _ssd_bwd_route(cuda_device, 1, S, 4, 32, 16, torch.bfloat16)


@pytest.mark.parametrize("P,N", [(48, 64), (64, 256), (16, 16), (64, 8)])
def test_ssd_backward_tensor_cores_raise_on_shapes_they_do_not_take(cuda_device, P, N):
    x, loga, b, c = _ssd_inputs(cuda_device, 1, 64, 2, P, N, torch.bfloat16)
    n0 = (ssd_ops.launches_bwd, ssd_ops.launches_bwd_tc)
    with pytest.raises(ValueError, match="backward kernel"):
        ssd_ops.ssd_scan_bwd(x, loga, b, c, torch.ones_like(x))
    assert (ssd_ops.launches_bwd, ssd_ops.launches_bwd_tc) == n0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_fn_backward_on_the_card(cuda_device, dtype):
    """Autograd through ``SSDScanFn`` (forward kernel, backward kernel)
    against autograd of ``ssd_chunked``."""
    x, loga, b, c = _ssd_inputs(cuda_device, 2, 256, 3, 64, 64, dtype)
    dy = torch.from_numpy(RNG.standard_normal((2, 256, 3, 64)).astype(np.float32)).to(cuda_device, dtype)
    ins = [t.clone().requires_grad_(True) for t in (x, loga, b, c)]
    n0, nb0 = ssd_ops.launches, ssd_ops.launches_bwd
    got = torch.autograd.grad(ssd_ops.SSDScanFn.apply(*ins, 128), ins, dy)
    assert (ssd_ops.launches, ssd_ops.launches_bwd) == (n0 + 1, nb0 + 1)
    want = torch.autograd.grad(ssd_chunked(*ins, None, 128)[0], ins, dy)
    for g, w in zip(got, want):
        _scaled_close(g, w, g.dtype)


@pytest.mark.parametrize("P,N", [(48, 64), (64, 256), (16, 16)])
def test_ssd_backward_raises_on_shapes_it_does_not_take(cuda_device, P, N):
    x, loga, b, c = _ssd_inputs(cuda_device, 1, 64, 2, P, N, torch.float32)
    n0 = ssd_ops.launches_bwd
    with pytest.raises(ValueError, match="backward kernel"):
        ssd_ops.ssd_scan_bwd(x, loga, b, c, torch.ones_like(x))
    assert ssd_ops.launches_bwd == n0


@pytest.mark.parametrize("arch", ["smollm-135m", "mamba2-780m", "whisper-large-v3", "llama-3.2-vision-90b"])
def test_lm_kernel_path_equals_plain_path(cuda_device, arch):
    """Reduced widths, f32, TF32 off: the kernel path and the plain path
    generate the same greedy tokens, and the kernels were launched once an
    attention or SSD layer (whisper: 2 encoder + 4 decoder layers over 300
    frames, a decoder layer launching twice; llama-vision: [dense, cross] x
    2 over 100 vision tokens, fewer keys than queries, its gates open)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.base import _layer_kinds
    from repro_torch.models import Model
    from repro_torch.serving.serve_step import greedy_generate

    cfg = dataclasses.replace(get_config(arch), n_layers=4, d_model=256, n_heads=4, n_kv_heads=2,
                              d_ff=0 if arch == "mamba2-780m" else 512, vocab_size=4096, head_dim=64,
                              compute_dtype="float32", encoder_layers=2 if arch == "whisper-large-v3" else 0,
                              encoder_frames=300, vision_tokens=100 if arch == "llama-3.2-vision-90b" else 0,
                              cross_attn_every=2 if arch == "llama-3.2-vision-90b" else 0)
    kern = Model(cfg, cuda_device, use_kernels=True, seed=1)
    for p in kern.layers:
        if "xgate" in p:
            p["xgate"].fill_(1.0)
    plain = Model(cfg, cuda_device, use_kernels=False)
    plain.load_state_dict(kern.state_dict())
    toks = torch.from_numpy(RNG.integers(0, cfg.vocab_size, (4, 256))).to(cuda_device)
    extras = None
    if cfg.family in ("vlm", "encdec"):
        n, key = (cfg.vision_tokens, "vision_embeds") if cfg.family == "vlm" else (cfg.encoder_frames, "frames")
        extras = {key: torch.from_numpy(RNG.standard_normal((4, n, cfg.d_model)) * 0.1).float().to(cuda_device)}
    want = sum(2 if k == "dec" else 1 for k in _layer_kinds(cfg))
    n0 = flash_ops.launches + ssd_ops.launches
    a = greedy_generate(kern, toks, extras, steps=8, s_max=272)
    assert flash_ops.launches + ssd_ops.launches == n0 + want
    b = greedy_generate(plain, toks, extras, steps=8, s_max=272)
    assert torch.equal(a, b)


class _Kill(Exception):
    pass


def _kill_at(level_to_kill):
    def boom(level, _):
        if level == level_to_kill:
            raise _Kill
    return boom


def _resume_case(tmp_path, streamed):
    """A classification case on the card: the memmap and config of a
    streamed run (exact bins, 5 blocks and a remainder) or a resident one
    (``hist_reuse`` auto, on at this size)."""
    from repro_torch import ForestConfig
    from repro_torch.data.tabular import make_classification

    x, y = make_classification(n_samples=6000, n_features=20, n_classes=3, seed=6)
    cfg = ForestConfig(n_trees=6, max_depth=6, n_bins=32, n_classes=3)
    if streamed:
        mm = np.memmap(tmp_path / "x.f32", np.float32, "w+", shape=x.shape)
        mm[:] = x
        mm.flush()
        x = mm
        cfg = ForestConfig(**{**cfg.__dict__, "sample_block": 1100, "bin_fit": "exact"})
    return x, y, cfg


def _assert_same_model(a, b, x, msg):
    for name in ("feature", "threshold", "left_child", "class_counts", "value", "tree_weight"):
        assert torch.equal(getattr(a.forest, name), getattr(b.forest, name)), f"{name} {msg}"
    np.testing.assert_array_equal(a.predict(x[:2000]), b.predict(x[:2000]), err_msg=msg)


@pytest.mark.parametrize("plane", ["resident", "streamed"])
def test_kill_and_resume_on_the_kernels(cuda_device, tmp_path, plane):
    """Checkpointed growth on the kernel path, killed after levels 1 and 4
    and resumed: the uninterrupted kernel run's model bitwise, the resumed
    run starting after the crash level and launching the kernels."""
    from repro_torch import train_prf

    x, y, cfg = _resume_case(tmp_path, plane == "streamed")
    baseline = train_prf(x, y, cfg, 0, device=cuda_device)
    for kill_at in (1, 4):
        d = str(tmp_path / f"k{kill_at}")
        with pytest.raises(_Kill):
            train_prf(x, y, cfg, 0, device=cuda_device, checkpoint_dir=d, on_level=_kill_at(kill_at))
        levels, n0 = [], (hist_ops.launches, scan_ops.launches)
        model = train_prf(x, y, cfg, 0, device=cuda_device, checkpoint_dir=d, resume_from=d,
                          on_level=lambda level, _: levels.append(level))
        torch.cuda.synchronize()
        assert levels[0] == kill_at + 1, levels
        assert hist_ops.launches > n0[0] and scan_ops.launches > n0[1]
        _assert_same_model(model, baseline, x, f"{plane} kill@{kill_at}")


def test_corrupted_resume_on_the_card(cuda_device, tmp_path):
    """Kill at level 3, flip bytes in the newest checkpoint, resume: the
    walk-back warns, regrows level 3 on the kernels and gives the
    uninterrupted model bitwise."""
    from repro_torch import train_prf
    from repro_torch.launch.fault import CheckpointCorruptor

    x, y, cfg = _resume_case(tmp_path, False)
    baseline = train_prf(x, y, cfg, 0, device=cuda_device)
    d = str(tmp_path / "c")
    with pytest.raises(_Kill):
        train_prf(x, y, cfg, 0, device=cuda_device, checkpoint_dir=d, on_level=_kill_at(3))
    assert CheckpointCorruptor(seed=0).corrupt(d) == 3
    levels = []
    with pytest.warns(RuntimeWarning, match="skipping corrupt checkpoint"):
        model = train_prf(x, y, cfg, 0, device=cuda_device, resume_from=d,
                          on_level=lambda level, _: levels.append(level))
    assert levels[0] == 3, levels
    _assert_same_model(model, baseline, x, "corrupted resume")


def _regression_case():
    from repro_torch import ForestConfig
    from repro_torch.data.tabular import make_regression, train_test_split

    x, y = make_regression(n_samples=16000, n_features=20, n_informative=6, seed=5)
    return train_test_split(x, y, 0.25, 0), ForestConfig(n_trees=6, max_depth=5, n_bins=32,
                                                         regression=True)


def _regression_agree(a, b, xtr, ytr, xte, dev, msg):
    """Two regression models trained with seed 0 on the same data, their
    float channels summed by atomics in run-dependent orders: every split
    where their trees diverge is a tie to float rounding
    (``test_torch_regression_ties.compare_regression_forests``: the two
    choices' float64 gains within ``TIE_TOL * sqrt(m)`` of the node's sum
    of ``w y^2``, m its in-bag rows),
    matched leaves agree to rounding, the trees that did not diverge have
    weights within 1e-6, and with no divergence the predictions agree
    within 1e-5 of their scale. Returns the comparison."""
    from repro_torch.core.dsi import bootstrap_counts
    from test_torch_regression_ties import compare_regression_forests

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    w = bootstrap_counts(gen, a.forest.config.n_trees, xtr.shape[0], dev).cpu().numpy()
    names = ("feature", "threshold", "left_child", "value")
    fa, fb = ({n: getattr(m.forest, n).cpu().numpy() for n in names} for m in (a, b))
    out = compare_regression_forests(fa, fb, a._binned(xtr).cpu().numpy(), ytr, w)
    assert not out["untied"], f"{msg}: divergences that are not ties {out['untied'][:4]}"
    assert not out["leaves_off"], f"{msg}: matched leaves differ {out['leaves_off'][:4]}"
    same = ~out["divergent"].any(1)
    torch.testing.assert_close(a.forest.tree_weight[same], b.forest.tree_weight[same], rtol=0, atol=1e-6)
    if not out["divergences"]:
        pa, pb = a.predict(xte), b.predict(xte)
        np.testing.assert_allclose(pa, pb, rtol=1e-5, atol=1e-5 * np.abs(pb).max(), err_msg=msg)
    print(f"{msg}: {len(out['divergences'])} tied divergences in {int((~same).sum())} of {len(same)} trees")
    return out


def test_train_prf_regression_kernel_path_close_to_plain_path(cuda_device):
    """``train_prf(regression=True)`` on the three PRF kernels (fixed-point
    channels in the histogram, variance gains in the split scan, a value
    payload in the traversal) against the plain path (on CUDA the same
    fixed point through int64 ``index_add_``): the forests bitwise, the
    predictions by ``_regression_agree``."""
    from repro_torch import train_prf

    (xtr, ytr, xte, _), cfg = _regression_case()
    plain = type(cfg)(**{**cfg.__dict__, "hist_backend": "segment_sum", "split_backend": "xla",
                         "predict_backend": "xla"})
    n0 = (hist_ops.launches, scan_ops.launches, trav_ops.launches)
    a = train_prf(xtr, ytr, cfg, 0, device=cuda_device)
    pa = a.predict(xte)
    torch.cuda.synchronize()
    assert hist_ops.launches > n0[0] and scan_ops.launches > n0[1] and trav_ops.launches > n0[2]
    assert pa.dtype == np.float32 and np.isfinite(pa).all()
    b = train_prf(xtr, ytr, plain, 0, device=cuda_device)
    for n in ("feature", "threshold", "left_child", "class_counts", "value", "tree_weight"):
        assert torch.equal(getattr(a.forest, n), getattr(b.forest, n)), f"kernel vs plain: {n}"
    _regression_agree(a, b, xtr, ytr, xte, cuda_device, "kernel vs plain")


def test_predict_regression_through_the_traversal_kernel(cuda_device):
    """``predict_regression`` with a ``[k, P, 1]`` value payload on the
    traversal kernel against the plain per-tree sum (trees added in the
    same order), streamed equal to resident."""
    from repro_torch import train_prf
    from repro_torch.core import voting

    (xtr, ytr, xte, _), cfg = _regression_case()
    model = train_prf(xtr, ytr, cfg, 0, device=cuda_device)
    xb = model._binned(xte)
    n0 = trav_ops.launches
    got = voting.predict_regression(model.forest, xb, backend="pallas")
    torch.cuda.synchronize()
    assert trav_ops.launches == n0 + 1
    want = voting.predict_regression(model.forest, xb, backend="xla")
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6 * float(want.abs().max()))
    streamed = voting.predict_regression_streamed(model.forest, xb.cpu().numpy(), sample_block=1000)
    assert torch.equal(streamed, got)


def test_regression_growth_twice_on_the_kernels(cuda_device):
    """Two regression trainings with the same draws on the kernel path are
    bitwise equal: the histogram sums the float channels in fixed point,
    so the order of its atomics does not matter (ROADMAP Queue 3 item 6,
    closed). Their predictions are equal too."""
    from repro_torch import train_prf

    (xtr, ytr, xte, _), cfg = _regression_case()
    n0 = hist_ops.launches
    a = train_prf(xtr, ytr, cfg, 0, device=cuda_device)
    b = train_prf(xtr, ytr, cfg, 0, device=cuda_device)
    assert hist_ops.launches > n0
    for n in a.forest.FIELDS:
        assert torch.equal(getattr(a.forest, n), getattr(b.forest, n)), f"two runs differ in {n}"
    np.testing.assert_array_equal(a.predict(xte), b.predict(xte))


@pytest.mark.parametrize("case", ["slots", "one slot", "carry", "class tiles", "big y"])
def test_hist_kernel_fixed_point_bitwise(cuda_device, case):
    """The kernel's fixed-point channels against ``multi_tree_hist_fixed_ref``,
    bitwise: slot-grouped samples; one slot in index order; added into a
    carry (``out=``); a class axis in tiles (64-bit cells, C 150 at B 256);
    targets of 1e6 (a coarse scale)."""
    dev = cuda_device
    N, F, S, B, tc = 20_011, 9, 6, 32, 3
    if case == "class tiles":
        N, F, S, B = 5003, 4, 3, 256
    if case == "one slot":
        S = 1
    xb = torch.from_numpy(RNG.integers(0, B, (N, F)).astype(np.uint8)).to(dev)
    y = torch.from_numpy(RNG.normal(size=N).astype(np.float32) * (1e6 if case == "big y" else 1.0))
    base = torch.stack([torch.ones_like(y), y, y * y], -1)
    if case == "class tiles":
        base = torch.from_numpy(RNG.normal(size=(N, 150)).astype(np.float32))
        base[:, 0] = 1.0
    base = base.to(dev)
    w = torch.from_numpy(RNG.integers(0, 4, (tc, N)).astype(np.float32)).to(dev)
    slot = torch.from_numpy(RNG.integers(-1, S, (tc, N)).astype(np.int32)).to(dev)
    vmax = float(base[:, 1:].abs().max())
    fp = FixedPoint(1, fixed_shift(N, 3.0, vmax))
    if case == "class tiles":
        assert hist_ops.class_tile(B, 150, True) < 150
    want = multi_tree_hist_fixed_ref(xb, base, w, slot, n_slots=S, n_bins=B, fixed=fp)
    out = None
    if case == "carry":
        out = torch.from_numpy(RNG.normal(size=tuple(want.shape)).astype(np.float32)).to(dev)
        out[..., 0] = torch.round(out[..., 0] * 50)
        want = out + want
    n0 = hist_ops.launches
    got = hist_ops.multi_tree_hist(xb, base, w, slot, n_slots=S, n_bins=B, fixed=fp, out=out)
    torch.cuda.synchronize()
    assert hist_ops.launches == n0 + 1
    assert torch.equal(got, want), f"{case}: max |d| {float((got - want).abs().max())}"
    again = hist_ops.multi_tree_hist(xb, base, w, slot, n_slots=S, n_bins=B, fixed=fp)
    assert torch.equal(again, multi_tree_hist_fixed_ref(xb, base, w, slot, n_slots=S, n_bins=B,
                                                        fixed=fp))


def test_service_stays_on_the_traversal_at_every_bucket(cuda_device):
    """``PRFService`` under ``"auto"`` on the card: one traversal launch
    per bucket-chunk at every bucket from 8 to 1024 rows, labels equal to
    ``model.predict``."""
    from repro_torch import ForestConfig, train_prf
    from repro_torch.data.tabular import make_classification
    from repro_torch.serving import PRFService

    x, y = make_classification(n_samples=4000, n_features=20, n_classes=3, seed=3)
    model = train_prf(x[:3000], y[:3000], ForestConfig(n_trees=8, max_depth=5, n_bins=32, n_classes=3),
                      0, device=cuda_device)
    svc = PRFService(model, max_batch=1024, min_bucket=8)
    for n in (1, 8, 9, 64, 255, 1000, 1024, 1025, 2100):
        n0 = trav_ops.launches
        got = svc.predict(x[:n])
        assert trav_ops.launches == n0 + -(-n // 1024), n
        np.testing.assert_array_equal(got, model.predict(x[:n]), err_msg=f"batch size {n}")
    assert svc.stats()["buckets_compiled"] == [8, 16, 64, 256, 1024]


def test_prf_beats_rf_in_high_dim_regime_at_full_depth(cuda_device):
    """``tests/test_forest.py::test_prf_beats_rf_in_high_dim_regime`` at
    its own depth 6, on the kernels (the CPU test grows to depth 4)."""
    from repro_torch import ForestConfig, train_prf
    from repro_torch.core.baselines import train_rf
    from repro_torch.data.tabular import make_classification, train_test_split

    x, y = make_classification(n_samples=3000, n_features=800, n_classes=3, n_informative=8,
                               n_redundant=4, label_noise=0.1, class_sep=1.2, seed=7)
    xtr, ytr, xte, yte = train_test_split(x, y, 0.25, 0)
    cfg = ForestConfig(n_trees=16, max_depth=6, n_bins=16, n_classes=3)
    acc_prf = train_prf(xtr, ytr, cfg, seed=0, device=cuda_device).accuracy(xte, yte)
    acc_rf = train_rf(xtr, ytr, cfg, seed=0, device=cuda_device).accuracy(xte, yte)
    assert acc_prf > acc_rf + 0.1, (acc_prf, acc_rf)

"""The per-level grouping of samples by slot that the T_GR histogram kernel
walks (``slot_order``), and the histogram entry points that take it.

Each tree's segment of slot s must hold exactly the live samples of slot
s (slot in [0, S), nonzero weight) in ascending index order, with
segment starts the cumulative per-slot counts. The plain histogram
ignores the grouping, so ``level_histograms`` and ``fused_level_scores``
with it must equal the versions without it, and the reference's
``segment_sum`` histogram, bitwise for integer weights."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.histograms import level_histograms as jlevel
from repro_torch.core import engine as E
from repro_torch.core import histograms as th
from repro_torch.core.types import ForestConfig
from repro_torch.kernels.gain_ratio.ops import SlotOrder, multi_tree_hist

RNG = np.random.default_rng(71)


def _slots(tc, N, S, parked=0.1, zero_w=0.3, empty=()):
    used = np.array([s for s in range(S) if s not in empty])   # `empty` slots get no sample
    slot = RNG.choice(used, (tc, N)).astype(np.int32)
    slot[RNG.random((tc, N)) < parked] = -1
    w = RNG.integers(0, 4, (tc, N)).astype(np.float32)
    w[RNG.random((tc, N)) < zero_w] = 0.0
    return slot, w


def _expected(slot, w, S):
    """Per tree: the ascending live indices of each slot."""
    return [[np.flatnonzero((slot[t] == s) & (w[t] != 0)) for s in range(S)] for t in range(slot.shape[0])]


@pytest.mark.parametrize("tc,N,S,parked,empty", [
    (3, 1037, 5, 0.1, ()),          # N not a multiple of any block size
    (2, 999, 8, 0.1, (0, 3, 7)),    # empty slots, first and last among them
    (2, 257, 4, 1.0, ()),           # all parked
    (1, 4099, 1, 0.0, ()),          # one slot
    (4, 3001, 128, 0.08, (5,)),     # a deep level: many slots, ~8% parked
])
def test_slot_order_groups_live_samples_ascending(tc, N, S, parked, empty):
    slot, w = _slots(tc, N, S, parked=parked, empty=empty)
    got = th.slot_order(torch.from_numpy(slot), torch.from_numpy(w), S)
    assert got.order.dtype == torch.int32 and got.seg.dtype == torch.int32
    assert tuple(got.order.shape) == (tc, N) and tuple(got.seg.shape) == (tc, S + 1)
    order, seg = got.order.numpy(), got.seg.numpy()
    for t, per_slot in enumerate(_expected(slot, w, S)):
        counts = np.array([len(ix) for ix in per_slot])
        np.testing.assert_array_equal(seg[t], np.concatenate([[0], np.cumsum(counts)]))
        for s, ix in enumerate(per_slot):
            np.testing.assert_array_equal(order[t, seg[t, s]:seg[t, s + 1]], ix)
        # the positions after the live ones hold the rest: a permutation in all
        np.testing.assert_array_equal(np.sort(order[t]), np.arange(N))
    for s in empty:
        assert bool((got.seg[:, s] == got.seg[:, s + 1]).all())
    if parked == 1.0:
        assert not got.seg.any()


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("tc,N,F,S,B,C", [(2, 1037, 9, 6, 16, 4), (3, 517, 5, 1, 8, 3)])
def test_level_histograms_with_order_equal_without(packed, tc, N, F, S, B, C):
    slot, w = _slots(tc, N, S, empty=(2,) if S > 2 else ())
    xb = RNG.integers(0, B, (N, F)).astype(np.uint8)
    base = np.eye(C, dtype=np.float32)[RNG.integers(0, C, N)]
    xt, bt, wt, st = (torch.from_numpy(a) for a in (xb, base, w, slot))
    order = th.slot_order(st, wt, S)
    got = th.level_histograms(xt, bt, wt, st, n_slots=S, n_bins=B, packed=packed, order=order)
    plain = th.level_histograms(xt, bt, wt, st, n_slots=S, n_bins=B, packed=packed)
    ref = np.asarray(jlevel(jnp.asarray(xb), jnp.asarray(base), jnp.asarray(w), jnp.asarray(slot),
                            n_slots=S, n_bins=B, packed=packed, backend="segment_sum"))
    assert torch.equal(got, plain)
    np.testing.assert_array_equal(got.numpy(), ref)
    slab = th.level_histograms(xt[:, 2:5], bt, wt, st, n_slots=S, n_bins=B, packed=packed, order=order)
    assert torch.equal(slab, got[:, :, 2:5])


def test_fused_level_scores_with_order_equal_without():
    """``fused_level_scores`` makes one grouping per level for all its slabs;
    its winners equal the one-shot path's, which has none."""
    N, F, S, B, C, tc = 700, 11, 16, 16, 3, 4
    slot, w = _slots(tc, N, S, empty=(0, 9))
    xt = torch.from_numpy(RNG.integers(0, B, (N, F)).astype(np.uint8))
    base = th.class_channels(torch.from_numpy(RNG.integers(0, C, N)), C)
    wt, st = torch.from_numpy(w), torch.from_numpy(slot)
    mask = torch.from_numpy(RNG.random((tc, F)) > 0.3)
    cfg = ForestConfig(n_trees=tc, max_depth=5, max_frontier=S, n_bins=B, n_classes=C, hist_reuse="off")
    made = []
    orig_slab, orig_order = E.hist_feature_slab, E.slot_order
    try:
        E.hist_feature_slab = lambda *a, **k: 4      # 3 slabs share one ordering
        E.slot_order = lambda *a: made.append(orig_order(*a)) or made[-1]
        fused = E.fused_level_scores(xt, base, wt, st, mask, cfg)
    finally:
        E.hist_feature_slab, E.slot_order = orig_slab, orig_order
    assert len(made) == 1
    one_shot = E.chunked_level_scores(xt, base, wt, st, mask, cfg)
    for a, b in zip(fused[0], one_shot[0]):
        assert torch.equal(a, b)
    assert torch.equal(fused[1], one_shot[1])


def test_hist_wrapper_checks_the_order():
    slot, w = _slots(2, 100, 3)
    xt = torch.from_numpy(RNG.integers(0, 8, (100, 4)).astype(np.uint8))
    bt = torch.from_numpy(np.eye(2, dtype=np.float32)[RNG.integers(0, 2, 100)])
    wt, st = torch.from_numpy(w), torch.from_numpy(slot)
    good = th.slot_order(st, wt, 3)
    multi_tree_hist(xt, bt, wt, st, n_slots=3, n_bins=8, order=good)
    with pytest.raises(TypeError):
        multi_tree_hist(xt, bt, wt, st, n_slots=3, n_bins=8, order=SlotOrder(good.order.long(), good.seg))
    with pytest.raises(ValueError):
        multi_tree_hist(xt, bt, wt, st, n_slots=3, n_bins=8, order=SlotOrder(good.order, good.seg[:, :3]))
    with pytest.raises(ValueError):
        multi_tree_hist(xt, bt, wt, st, n_slots=3, n_bins=8, order=SlotOrder(good.order[:1], good.seg[:1]))

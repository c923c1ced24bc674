"""Port parity: the plain split scan (the plain version of
``csrc/split_scan.cu``) against the reference's ``split_scan_block`` in
interpret mode and its XLA oracle ``split_scan_ref``. Feature, threshold
and child counts bitwise; gains at rtol 1e-6 (bitwise against the
oracle under ``jax.jit``, the form training uses)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.split_scan.kernel import split_scan_block as jblock
from repro.kernels.split_scan.ref import split_scan_ref
from repro_torch.kernels.split_scan import ops
from repro_torch.kernels.split_scan.ops import split_scan_block, split_scan_scores
from repro_torch.kernels.split_scan.ref import init_carry

from test_torch_split_cases import SPLIT_CASES, split_scan_case

RNG = np.random.default_rng(31)


def _hist(tc, S, F, B, C, *, regression=False):
    if regression:
        cnt = RNG.integers(0, 3, (tc, S, F, B)).astype(np.float32)
        y = RNG.normal(size=(tc, S, F, B)).astype(np.float32)
        h = np.stack([cnt, cnt * y, cnt * y * y], -1).astype(np.float32)
    else:
        h = RNG.integers(0, 5, (tc, S, F, B, C)).astype(np.float32)
        h *= RNG.random((tc, S, F, B, 1)) < 0.6
    h[0, 0] = 0.0                             # a slot with no valid split
    return h


def _assert_carry(got, want, *, exact_gain=False):
    g_t, f_t, thr_t, l_t, r_t = (np.asarray(a) for a in got)
    g_w, f_w, thr_w, l_w, r_w = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(f_t, f_w)
    np.testing.assert_array_equal(thr_t, thr_w)
    np.testing.assert_array_equal(l_t, l_w)
    np.testing.assert_array_equal(r_t, r_w)
    np.testing.assert_array_equal(np.isfinite(g_t), np.isfinite(g_w))
    if exact_gain:
        np.testing.assert_array_equal(g_t, g_w)
    else:
        np.testing.assert_allclose(g_t, g_w, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("tc,S,F,B,C", [(2, 4, 13, 8, 3), (1, 1, 5, 4, 2), (3, 2, 9, 16, 4)])
@pytest.mark.parametrize("masked", [False, True])
def test_split_scan_matches_reference(tc, S, F, B, C, masked):
    h = _hist(tc, S, F, B, C)
    mask = RNG.random((tc, F)) > 0.4 if masked else np.ones((tc, F), bool)
    mask[:, 0] = True
    got = split_scan_block(torch.from_numpy(h), torch.from_numpy(mask), None, 0)
    pal = jblock(jnp.asarray(h), jnp.asarray(mask), None, 0, interpret=True)
    oracle = jax.jit(lambda hh, m: split_scan_ref(hh, m))(h, mask)
    _assert_carry(got, pal)
    _assert_carry(got, oracle, exact_gain=True)
    # the slot with no valid split: force-accepted at feature 0, threshold 0
    assert int(got[1][0, 0]) == 0 and int(got[2][0, 0]) == 0 and np.isneginf(float(got[0][0, 0]))


def test_chained_carry_over_three_slabs_equals_one_shot():
    tc, S, F, B, C = 2, 4, 14, 8, 3
    h = _hist(tc, S, F, B, C)
    mask = RNG.random((tc, F)) > 0.3
    ht, mt = torch.from_numpy(h), torch.from_numpy(mask)
    one = split_scan_block(ht, mt, None, 0)
    carry = init_carry(tc, S, C, ht.device)
    for f0, f1 in [(0, 5), (5, 9), (9, 14)]:
        carry = split_scan_block(ht[:, :, f0:f1], mt[:, f0:f1], carry, f0)
    _assert_carry(carry, one, exact_gain=True)
    pal = None
    for f0, f1 in [(0, 5), (5, 9), (9, 14)]:
        pal = jblock(jnp.asarray(h[:, :, f0:f1]), jnp.asarray(mask[:, f0:f1]), pal, f0, interpret=True)
    _assert_carry(carry, pal)


def test_regression_scorer():
    h = _hist(2, 3, 6, 8, 3, regression=True)
    got = split_scan_block(torch.from_numpy(h), None, None, 0, regression=True)
    want = split_scan_ref(jnp.asarray(h), None, regression=True)
    g_t, f_t, thr_t, l_t, r_t = (np.asarray(a) for a in got)
    np.testing.assert_array_equal(f_t, np.asarray(want[1]))
    np.testing.assert_array_equal(thr_t, np.asarray(want[2]))
    np.testing.assert_allclose(l_t, np.asarray(want[3]), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(g_t, np.asarray(want[0]), rtol=1e-5, atol=1e-5)


def test_scores_entry_and_input_checks():
    h = _hist(2, 2, 5, 8, 3)
    before = ops.launches
    s = split_scan_scores(torch.from_numpy(h), None)
    assert s.feature.dtype == torch.int32 and s.left_counts.shape == (2, 2, 3)
    assert ops.launches == before
    with pytest.raises(ValueError):
        split_scan_block(torch.from_numpy(h), torch.ones((2, 4), dtype=torch.bool), None, 0)
    with pytest.raises(ValueError):            # regression needs 3 channels
        split_scan_block(torch.from_numpy(_hist(1, 2, 3, 4, 2)), None, None, 0, regression=True)


@pytest.mark.parametrize("name", SPLIT_CASES)
def test_split_scan_matrix_matches_reference(name):
    """The carry over three chained slabs against the reference's kernel in
    interpret mode, on the cases that reach the CUDA kernel's shortcuts
    (zero-mass slots, a slab with every feature masked, B = 2, B = 256,
    C = 3 regression); ``tests/test_torch_cuda.py`` holds the kernel to
    the plain version on the same cases."""
    hist, mask, slabs, regression = split_scan_case(name)
    tc, S, _, _, C = hist.shape
    carry, pal = init_carry(tc, S, C, torch.device("cpu")), None
    for f0, f1 in slabs:
        carry = split_scan_block(torch.from_numpy(hist[:, :, f0:f1]), torch.from_numpy(mask[:, f0:f1]),
                                 carry, f0, regression=regression)
        pal = jblock(jnp.asarray(hist[:, :, f0:f1]), jnp.asarray(mask[:, f0:f1]), pal, f0,
                     regression=regression, interpret=True)
    if not regression:
        _assert_carry(carry, pal)
        return
    g_t, f_t, thr_t, l_t, r_t = (np.asarray(a) for a in carry)
    np.testing.assert_array_equal(f_t, np.asarray(pal[1]))
    np.testing.assert_array_equal(thr_t, np.asarray(pal[2]))
    np.testing.assert_array_equal(np.isfinite(g_t), np.isfinite(np.asarray(pal[0])))
    np.testing.assert_allclose(g_t, np.asarray(pal[0]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(l_t, np.asarray(pal[3]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(r_t, np.asarray(pal[4]), rtol=1e-5, atol=1e-5)

"""The split-scan case matrix, shared by the CPU parity tests
(``test_torch_split_scan.py``, against ``repro`` in interpret mode) and
the card tests (``test_torch_cuda.py``, the kernel against its plain
version). It imports only numpy, so the card tests need no JAX; its own
test checks that each case holds what its name promises."""
import numpy as np
import pytest


SPLIT_CASES = ("classification", "zero-mass slots", "all-masked slab", "B=2", "B=256", "regression")


def split_scan_case(name: str, seed: int = 0):
    """One split-scan input (numpy; no card needed): ``(hist [tc, S, F, B, C]
    f32, mask [tc, F] bool, three slabs (f0, f1), regression)``. The cases
    reach the kernel's shortcuts: masked features (never read), all-zero
    features and slots (skipped after the load), a slab in which every
    feature is masked (every candidate -inf: index 0 when the carry is
    empty), one threshold (B = 2), eight bins per lane (B = 256)."""
    rng = np.random.default_rng(seed)
    tc, S, F, B, C = {"B=2": (2, 4, 9, 2, 2), "B=256": (1, 3, 7, 256, 4),
                      "regression": (2, 5, 9, 16, 3)}.get(name, (3, 6, 13, 16, 4))
    regression = name == "regression"
    if regression:
        cnt = rng.integers(0, 3, (tc, S, F, B)).astype(np.float32)
        y = rng.normal(size=(tc, S, F, B)).astype(np.float32)
        hist = np.stack([cnt, cnt * y, cnt * y * y], -1).astype(np.float32)
    else:
        hist = rng.integers(0, 5, (tc, S, F, B, C)).astype(np.float32)
        hist *= rng.random((tc, S, F, B, 1)) < (0.05 if B == 256 else 0.6)
    mask = rng.random((tc, F)) > 0.3
    if name in ("zero-mass slots", "regression"):
        hist[:, ::2] = 0.0                       # slots with no samples
        hist[0, 1, :, 1:] = 0.0                  # mass in one bin only: no valid split
    if name == "all-masked slab":
        mask[:, 4:9] = False                     # the middle slab
        mask[1, :4] = False                      # tree 1: the first slab too
    slabs = [(0, F // 3), (F // 3, F // 3 + 5 if name == "all-masked slab" else 2 * F // 3),
             (F // 3 + 5 if name == "all-masked slab" else 2 * F // 3, F)]
    return hist, mask, slabs, regression


@pytest.mark.parametrize("name", SPLIT_CASES)
def test_split_case_holds_what_it_names(name):
    hist, mask, slabs, regression = split_scan_case(name)
    tc, S, F, B, C = hist.shape
    assert hist.dtype == np.float32 and mask.shape == (tc, F) and mask.dtype == bool
    # three non-empty slabs that tile [0, F)
    assert slabs[0][0] == 0 and slabs[-1][1] == F and len(slabs) == 3
    assert all(f0 < f1 for f0, f1 in slabs) and all(a[1] == b[0] for a, b in zip(slabs, slabs[1:]))
    counts = hist[..., 0] if regression else hist
    # integer counts below 2^24: every order of summation is exact
    assert np.array_equal(counts, np.round(counts)) and counts.min() >= 0 and counts.max() < 2 ** 24
    assert regression == (name == "regression") and (C == 3 if regression else C >= 2)
    assert B == {"B=2": 2, "B=256": 256}.get(name, 16)
    if name in ("zero-mass slots", "regression"):
        assert not hist[:, ::2].any()                          # slots with no mass
        assert (counts[0, 1].sum(-1) if not regression else counts[0, 1])[:, 1:].sum() == 0
    if name == "all-masked slab":
        f0, f1 = slabs[1]
        assert not mask[:, f0:f1].any() and not mask[1, :slabs[0][1]].any()
    else:
        assert mask.any()

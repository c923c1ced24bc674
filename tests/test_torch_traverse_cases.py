"""The traversal's case matrix and forest builder, shared by the CPU tests
(``test_torch_traverse.py``), the card tests (``test_torch_cuda.py``, the
kernel against its plain version) and ``chip_smoke.py``. It imports only
numpy, so the card tests need no JAX; its own test checks that each case
holds what its name promises."""
import numpy as np
import pytest

# name -> (N, F, k, tree chunk, C, depth, P). The chunks thread the carry.
TRAVERSE_CASES = {
    "one row": (1, 128, 32, 32, 4, 8, 2050),
    "a few rows": (7, 37, 5, 5, 3, 6, 200),
    "256-row batch, two blocks": (256, 128, 32, 32, 4, 8, 2050),
    "small batch, C 3 (scalar payload loads)": (64, 40, 32, 32, 3, 6, 140),
    "small batch, C 11 in two class passes": (64, 40, 32, 32, 11, 6, 140),
    "small batch, C 37 in five class passes": (64, 40, 32, 32, 37, 5, 100),
    "300 trees in one chunk, a ragged last group": (16, 20, 300, 300, 3, 5, 70),
    "ragged last tile and tree group": (70001, 128, 5, 5, 4, 8, 2050),
    "C > 8 over several chunks": (3001, 9, 12, 5, 11, 5, 100),
    "C > 8 in two class passes": (40000, 16, 6, 6, 11, 6, 140),
    "wide F, tile cut to fit shared memory": (20000, 3000, 6, 3, 4, 6, 140),
    "F past 16 bits: wide nodes, bins read from device memory": (300, 70000, 6, 4, 4, 6, 140),
}


def random_forest(rng, k, depth, F, C, P):
    """Near-complete trees (left = 2n + 1) in a pool of P rows, thresholds
    past the bin range on both sides (junk on leaves), payload on the
    leaves only. Returns numpy (feature, threshold, left_child, payload)."""
    feature = np.full((k, P), -1, np.int32)
    threshold = rng.integers(-3, 3, (k, P)).astype(np.int32)
    left = np.full((k, P), -1, np.int32)
    for t in range(k):
        for node in range(2 ** depth - 1):
            if node == 0 or rng.random() < 0.85:
                feature[t, node] = rng.integers(0, F)
                threshold[t, node] = rng.choice([-7, -1, 0, 3, 31, 254, 255, 300, 2 ** 31 - 1])
                left[t, node] = 2 * node + 1
    payload = (rng.random((k, P, C)) * (feature < 0)[..., None]).astype(np.float32)
    return feature, threshold, left, payload


def traverse_case(name: str, seed: int = 0):
    """One case's inputs (numpy): ``(x [N, F] uint8, forest arrays, carry
    [N, C] f32, tree chunk, depth)``."""
    N, F, k, tc, C, depth, P = TRAVERSE_CASES[name]
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, (N, F), dtype=np.uint8)
    forest = random_forest(rng, k, depth, F, C, P)
    carry = rng.random((N, C)).astype(np.float32)
    return x, forest, carry, tc, depth


@pytest.mark.parametrize("name", list(TRAVERSE_CASES))
def test_traverse_case_holds_what_it_names(name):
    from repro_torch.kernels.tree_traverse.ops import traverse_plan

    x, (feature, threshold, left, payload), carry, tc, depth = traverse_case(name)
    N, F, k, _, C, _, P = TRAVERSE_CASES[name]
    assert x.shape == (N, F) and feature.shape == (k, P) and payload.shape == (k, P, C)
    assert carry.shape == (N, C) and P >= 2 ** (depth + 1) - 1
    assert not payload[feature >= 0].any() and feature[:, 0].min() >= 0
    assert (threshold[feature >= 0] < 0).any() and (threshold[feature >= 0] > 255).any()
    TN = traverse_plan(F)["TN"]
    passes = -(-C // 8)                                   # the kernel sums 8 classes a pass
    if name.startswith("256-row") or name.startswith("small batch"):
        assert N <= 2 * TN                                # one or two blocks
    if "class passes" in name:
        assert passes == {"two": 2, "five": 5}[name.split(" in ")[1].split()[0]]
    if name.startswith("small batch, C 3"):
        assert C % 4 != 0                                 # no float4 payload rows
    if name.startswith("300 trees"):
        assert tc == k and tc % 8 != 0 and tc > 8 * 8
    if name.startswith("ragged"):
        assert N % TN != 0 and tc % 8 != 0                # the last group walks 5 of 8 slots
    if name.startswith("C > 8 over"):
        assert C > 8 and k % tc != 0
    if name.startswith("wide F"):
        assert TN < 128 and N > 100 * TN                  # 128 rows would not fit
    if name.startswith("F past 16 bits"):
        assert traverse_plan(F)["wide"] and (feature >= 2 ** 16).any() and k % tc != 0

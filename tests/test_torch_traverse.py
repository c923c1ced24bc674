"""Port parity: the plain traversal (the plain version of
``csrc/tree_traverse.cu``) against the reference's ``traverse_block`` in
interpret mode: scores at rtol 1e-6 / atol 1e-6, argmax identical, trees
chunked with a remainder."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.tree_traverse.kernel import traverse_block as jtraverse
from repro_torch.kernels.tree_traverse import ops
from repro_torch.kernels.tree_traverse.ops import traverse_block

from test_torch_traverse_cases import TRAVERSE_CASES, random_forest, traverse_case

RNG = np.random.default_rng(41)


def _forest(k, depth, F, B, C):
    """A random node-pool forest: complete trees, pool padding as zero leaves."""
    P = 2 ** (depth + 1) + 3
    feature = np.full((k, P), -1, np.int32)
    threshold = np.zeros((k, P), np.int32)
    left = np.full((k, P), -1, np.int32)
    for t in range(k):
        for node in range(2 ** depth - 1):
            if RNG.random() < 0.8 or node == 0:
                feature[t, node] = RNG.integers(0, F)
                threshold[t, node] = RNG.integers(0, B - 1)
                left[t, node] = 2 * node + 1
    payload = (RNG.random((k, P, C)) * (feature < 0)[..., None]).astype(np.float32)
    payload[:, -3:] = 0.0
    return feature, threshold, left, payload


@pytest.mark.parametrize("N,F,k,tc", [(257, 7, 5, 2), (64, 3, 3, 3), (130, 12, 6, 4)])
def test_traverse_matches_reference_chunked(N, F, k, tc):
    depth, B, C = 4, 8, 3
    xb = RNG.integers(0, B, (N, F)).astype(np.uint8)
    feature, threshold, left, payload = _forest(k, depth, F, B, C)
    carry_t, carry_j = None, None
    for c0 in range(0, k, tc):
        sl = slice(c0, min(c0 + tc, k))
        carry_t = traverse_block(
            torch.from_numpy(xb), *(torch.from_numpy(a[sl]) for a in (feature, threshold, left, payload)),
            carry_t, depth=depth,
        )
        carry_j = jtraverse(jnp.asarray(xb), *(jnp.asarray(a[sl]) for a in (feature, threshold, left, payload)),
                            carry_j, depth=depth, interpret=True)
    got, want = carry_t.numpy(), np.asarray(carry_j)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_traverse_resumes_from_carry_and_checks_inputs():
    xb = RNG.integers(0, 8, (50, 4)).astype(np.uint8)
    f, t, lc, p = (torch.from_numpy(a) for a in _forest(3, 3, 4, 8, 2))
    seed = torch.from_numpy(RNG.random((50, 2)).astype(np.float32))
    before = ops.launches
    out = traverse_block(torch.from_numpy(xb), f, t, lc, p, seed, depth=3)
    zero = traverse_block(torch.from_numpy(xb), f, t, lc, p, None, depth=3)
    torch.testing.assert_close(out, seed + zero, rtol=1e-6, atol=1e-6)
    assert ops.launches == before
    with pytest.raises(TypeError):
        traverse_block(torch.from_numpy(xb.astype(np.int32)), f, t, lc, p, None, depth=3)
    with pytest.raises(TypeError):
        traverse_block(torch.from_numpy(xb), f.long(), t, lc, p, None, depth=3)


def test_traverse_wide_classes_and_pool_match_reference():
    """C > 8 (more classes than one pass of the kernel sums), a pool far
    past 2^depth + 3 rows, thresholds outside the bin range: the plain
    path takes them all, as the reference does."""
    N, F, k, C, depth = 97, 10, 3, 11, 4
    P = 2 ** (depth + 1) + 40
    xb = RNG.integers(0, 256, (N, F)).astype(np.uint8)
    arrays = random_forest(RNG, k, depth, F, C, P)
    got = traverse_block(torch.from_numpy(xb), *map(torch.from_numpy, arrays), None, depth=depth)
    want = jtraverse(jnp.asarray(xb), *map(jnp.asarray, arrays), None, depth=depth, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def _kernel_emulation(xb, feature, threshold, left, payload, carry, depth):
    """The kernel's arithmetic in numpy: nodes packed as pack_nodes_kernel
    packs them (a leaf steps to itself) in the plan's layout — narrow,
    ``feature | (threshold + 1) << 16`` in one word, or wide, the feature
    id and ``threshold + 1`` in words of their own — walked depth steps
    by the packed words, then, whatever the tile plan, each (sample,
    class) summed over the trees in order and added to the carry once."""
    tc, P = feature.shape
    thr = np.clip(threshold.astype(np.int64), -1, 255) + 1
    if ops.traverse_plan(xb.shape[1])["wide"]:
        fid = np.where(feature >= 0, feature.astype(np.int64), 0)
        thr1 = np.where(feature >= 0, thr, 256)
    else:
        word = np.where(feature >= 0, feature.astype(np.int64) | (thr << 16), 256 << 16)
        fid, thr1 = word & 0xFFFF, word >> 16
    lc = np.where(feature >= 0, left, np.arange(P)[None, :])
    rows = np.arange(xb.shape[0])
    acc = np.zeros_like(carry)
    for t in range(tc):
        node = np.zeros(len(rows), np.int64)
        for _ in range(depth):
            node = lc[t, node] + (xb[rows, fid[t, node]].astype(np.int64) >= thr1[t, node])
        acc = acc + payload[t, node]
    return carry + acc


@pytest.mark.parametrize("name", list(TRAVERSE_CASES))
def test_packed_walk_is_bitwise_the_plain_version(name):
    """The packing (feature | (threshold + 1) << 16, the threshold clamped
    to [-1, 255], leaves stepping to themselves) changes no leaf: the
    kernel's arithmetic, emulated over the card tests' cases (the carry
    through every chunk), is bitwise the plain version."""
    x, forest, carry, tc, depth = traverse_case(name)
    got = want = carry
    for c0 in range(0, forest[0].shape[0], tc):
        part = [a[c0:c0 + tc] for a in forest]
        got = _kernel_emulation(x, *part, got, depth)
        want = traverse_block(torch.from_numpy(x), *map(torch.from_numpy, part),
                              torch.from_numpy(want), depth=depth).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("F", [1, 3, 37, 128, 1024, 5000, 20000, 65535])
def test_traverse_plan_fits_the_card(F):
    plan = ops.traverse_plan(F)
    TN = plan["TN"]
    assert TN * F <= plan["smem_bytes"] <= ops.SMEM_BYTES
    assert 1 <= TN <= 128 and TN & (TN - 1) == 0
    assert plan["Fs"] >= F and plan["Fs"] % 4 == 0 and (plan["Fs"] // 4) % 2 == 1
    if F <= 1024:
        assert TN == 128                              # the smoke shape's F 128: 128 rows a block
    else:
        assert ops._smem(2 * TN, plan["Fs"]) > ops.SMEM_BYTES   # halved only as far as needed


def test_traverse_plan_refuses_features_past_16_bits():
    """Feature ids past 16 bits no longer make the plan refuse: it picks
    the wide layout (int4 nodes with a 32-bit feature id, bins read from
    device memory, 128 rows a block), and F <= 65536 keeps the narrow
    one."""
    wide = ops.traverse_plan(ops.MAX_FEATURES + 1)
    assert wide == {"TN": 128, "Fs": 0, "smem_bytes": 0, "wide": True}
    assert not ops.traverse_plan(ops.MAX_FEATURES)["wide"]

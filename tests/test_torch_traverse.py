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

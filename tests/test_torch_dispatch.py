"""Backend dispatch on the card's shapes, decided without a card: the
resolvers take ``torch.device("cuda")`` objects, so the rule ``"auto"``
follows is checked here on the CPU.

* The histogram kernel holds one feature's ``[B, C]`` int histogram in
  shared memory and the split scan one ``[B, C | 1]`` float histogram a
  warp: for the class counts that do not fit (C >= 227, C >= 200 at
  B 256) each takes the class axis in tiles (``class_tile``), so
  ``"auto"`` and ``"pallas"`` stay on the kernel at every shape. Numpy /
  torch emulations of the tiled histogram's flush and of the wide split
  scan's two passes give the plain version bitwise.
* The traversal takes any F: past 16 bits of feature id its plan picks
  the wide node layout. A numpy emulation of the wide packing
  (``pack_nodes_kernel<true>``: an int4 ``{feature, threshold + 1,
  left_child, 0}``, a leaf ``{0, 256, its own id, 0}``) walks bitwise as
  the plain version does, where the narrow packing would not.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.gain import (
    _SPLIT_INFO_FLOOR, _TINY, _fma, _xlogx, resolve_split_backend, split_gain_ratios,
)
from repro_torch.core.histograms import resolve_backend
from repro_torch.core.voting import resolve_predict_backend
from repro_torch.kernels.gain_ratio import ops as hist_ops
from repro_torch.kernels.gain_ratio.ref import multi_tree_hist_ref
from repro_torch.kernels.split_scan import ops as scan_ops
from repro_torch.kernels.tree_traverse import ops as trav_ops
from repro_torch.kernels.tree_traverse.ref import traverse_block_ref

from test_torch_traverse_cases import random_forest

CUDA, CPU = torch.device("cuda"), torch.device("cpu")


@pytest.mark.parametrize("B,C,fits", [(256, 226, True), (256, 227, False), (64, 4, True),
                                      (64, 907, True), (64, 908, False), (2, 29056, False)])
def test_histogram_shape_rule(B, C, fits):
    """``fits``: one tile holds every class; else tiles of a multiple of 4
    classes whose row fits 48 KiB. Either way the kernel runs."""
    ct = hist_ops.class_tile(B, C)
    assert (ct == C) == fits == ((B * C + 1) * 4 <= 227 * 1024)
    if not fits:
        assert 4 <= ct < C and ct % 4 == 0 and (B * ct + 1) * 4 <= 48 * 1024
        assert (B * (ct + 4) + 1) * 4 > 48 * 1024          # the largest such tile
    assert resolve_backend("auto", CUDA) == "pallas"
    assert resolve_backend("pallas", CUDA) == "pallas"
    assert resolve_backend("auto", CPU) == "segment_sum"
    assert resolve_backend("segment_sum", CUDA) == "segment_sum"


@pytest.mark.parametrize("B,C,fits", [(256, 199, True), (256, 200, False), (64, 4, True),
                                      (64, 799, True), (64, 800, False), (256, 3, True)])
def test_split_scan_shape_rule(B, C, fits):
    """``fits``: a warp's buffer holds every class (the one-buffer kernel);
    else the wide kernel takes odd tiles, eight warps' buffers in 200 KiB."""
    ct = scan_ops.class_tile(B, C)
    assert (ct == C) == fits == (B * (C | 1) * 4 <= 200 * 1024)
    if not fits:
        assert ct % 2 == 1 and ct < C and 8 * B * ct * 4 <= 200 * 1024 < 8 * B * (ct + 2) * 4
    assert resolve_split_backend("auto", CUDA) == "pallas"
    assert resolve_split_backend("pallas", CUDA) == "pallas"
    assert resolve_split_backend("auto", CPU) == "xla"
    assert resolve_split_backend("xla", CUDA) == "xla"


def test_resolvers_without_a_shape_keep_their_device_rule():
    assert resolve_backend("auto", CUDA) == "pallas"
    assert resolve_split_backend("auto", CUDA) == "pallas"
    with pytest.raises(ValueError, match="CPU"):
        resolve_backend("pallas", CPU)
    with pytest.raises(ValueError, match="CPU"):
        resolve_split_backend("pallas", CPU)


@pytest.mark.parametrize("packed", [False, True])
def test_class_tiled_histogram_flush_is_the_plain_histogram(packed):
    """The tiled kernel's bookkeeping: a block of tile [c0, c0 + nc) adds a
    one-channel sample only when its class lies in the tile (a multi-channel
    row adds its tile's channels), into a [B, nc] shared row whose cell r
    flushes to output cell (r // nc) * C + c0 + r % nc."""
    rng = np.random.default_rng(31)
    N, W, k, S, B, C = 400, 3, 2, 3, 8, 23
    x = torch.from_numpy(rng.integers(0, B, (N, W), dtype=np.uint8))
    base = np.zeros((N, C), np.float32)
    base[np.arange(N), rng.integers(0, C, N)] = 1.0
    base[:40] = rng.integers(0, 3, (40, C))            # multi-channel rows
    base = torch.from_numpy(base)
    w = torch.from_numpy(rng.integers(0, 3, (k, N)).astype(np.float32))
    slot = torch.from_numpy(rng.integers(-1, S, (k, N)).astype(np.int32))
    want = multi_tree_hist_ref(x, base, w, slot, n_slots=S, n_bins=B, packed=packed)
    for ct in (4, 5, C):
        out = np.zeros((k, S, W, B * C), np.float32)
        for c0 in range(0, C, ct):
            nc = min(ct, C - c0)
            for t in range(k):
                for i in range(N):
                    s, v = int(slot[t, i]), float(w[t, i])
                    if s < 0 or v == 0:
                        continue
                    row = base[i].numpy()
                    if packed:
                        cls = int(np.argmax(row))
                        terms = {cls: v * row[cls]}
                    else:
                        terms = {c: v * row[c] for c in range(C) if row[c] != 0}
                    sh = np.zeros((W, B * nc), np.float32)
                    for c, vc in terms.items():
                        if c0 <= c < c0 + nc:
                            sh[np.arange(W), x[i].numpy().astype(int) * nc + c - c0] += vc
                    r = np.arange(B * nc)
                    out[t, s][:, (r // nc) * C + c0 + r % nc] += sh
        np.testing.assert_array_equal(out.reshape(want.shape), want.numpy())


def _wide_scan_gains(hist: torch.Tensor, tile: int) -> torch.Tensor:
    """``split_scan_wide_kernel``'s gains, in its order: pass one sums n,
    n_l and n_r class by class over the tiles; pass two the x log x terms."""
    cum = torch.cumsum(hist, dim=-2)        # a tile's rescan: exact on integer counts
    tot, left = cum[..., -1, :], cum[..., :-1, :]
    C = hist.shape[-1]
    classes = [c for c0 in range(0, C, tile) for c in range(c0, min(C, c0 + tile))]
    n = nl = nr = None
    for c in classes:
        tv, l = tot[..., c], left[..., c]
        n = tv if n is None else n + tv
        nl = l if nl is None else nl + l
        nr = tv[..., None] - l if nr is None else nr + (tv[..., None] - l)
    n_tot = torch.clamp_min(n, _TINY)
    hn = hl = hr = None
    for c in classes:
        tv, l = tot[..., c], left[..., c]
        xn = _xlogx(tv / n_tot)
        xl = _xlogx(l / torch.clamp_min(nl, _TINY))
        xr = _xlogx((tv[..., None] - l) / torch.clamp_min(nr, _TINY))
        hn = xn if hn is None else hn + xn
        hl = xl if hl is None else hl + xl
        hr = xr if hr is None else hr + xr
    nt = n_tot[..., None]
    h_cond = _fma(nr / nt, -hr, (nl / nt) * -hl)
    gn = (-hn)[..., None] - h_cond
    split_info = -(_xlogx(nl / nt) + _xlogx(nr / nt))
    g = gn / torch.clamp_min(split_info, _SPLIT_INFO_FLOOR)
    return torch.where((nl > 0) & (nr > 0), g, torch.full_like(g, -torch.inf))


@pytest.mark.parametrize("B,C", [(16, 37), (256, 203)])
def test_wide_split_scan_passes_are_bitwise_the_plain_gains(B, C):
    rng = np.random.default_rng(B + C)
    counts = rng.integers(0, 4, (3, 2, B, C)) * (rng.random((3, 2, B, C)) < 0.3)
    counts[0, 0] = 0                                    # a zero-mass node
    counts[1, 1, :, 5:] = 0                             # a few classes only
    hist = torch.from_numpy(counts.astype(np.float32))
    want = split_gain_ratios(hist)
    for tile in sorted({1, 5, scan_ops.class_tile(B, C), C}):
        assert torch.equal(_wide_scan_gains(hist, tile), want), tile


@pytest.mark.parametrize("F", [65536, 65537, 70000, 1 << 20])
def test_traversal_auto_stays_on_the_kernel_at_any_width(F):
    assert resolve_predict_backend("auto", CUDA) == "pallas"
    plan = trav_ops.traverse_plan(F)
    assert plan["wide"] == (F > trav_ops.MAX_FEATURES)
    if plan["wide"]:
        assert plan["TN"] == 128 and plan["smem_bytes"] == 0
    else:
        assert plan["TN"] * F <= plan["smem_bytes"] <= trav_ops.SMEM_BYTES


def _pack(feature, threshold, left, wide):
    """Numpy copy of ``pack_nodes_kernel``: [k, Pp, 4] or [k, Pp, 2] int64."""
    k, P = feature.shape
    Pp = P + (P & 1)
    f = np.zeros((k, Pp), np.int64)
    thr1 = np.full((k, Pp), 256, np.int64)
    lc = np.broadcast_to(np.arange(Pp), (k, Pp)).copy()
    inner = np.zeros((k, Pp), bool)
    inner[:, :P] = feature >= 0
    f[:, :P] = np.where(feature >= 0, feature, 0)
    thr1[:, :P] = np.where(feature >= 0, np.clip(threshold, -1, 255) + 1, 256)
    lc[:, :P] = np.where(feature >= 0, left, lc[:, :P])
    if wide:
        return np.stack([f, thr1, lc, np.zeros_like(f)], -1)
    return np.stack([(f | (thr1 << 16)) & 0xFFFFFFFF, lc], -1)


def _walk(xb, nodes, payload, carry, depth, wide):
    """The kernel's walk over packed nodes, trees summed in order."""
    rows = np.arange(xb.shape[0])
    acc = np.zeros_like(carry)
    for t in range(nodes.shape[0]):
        node = np.zeros(len(rows), np.int64)
        for _ in range(depth):
            nd = nodes[t, node]
            if wide:
                fid, thr1, nxt = nd[:, 0], nd[:, 1], nd[:, 2]
            else:
                fid, thr1, nxt = nd[:, 0] & 0xFFFF, nd[:, 0] >> 16, nd[:, 1]
            node = nxt + (xb[rows, fid].astype(np.int64) >= thr1)
        acc = acc + payload[t, node]
    return carry + acc


def test_wide_node_packing_walks_as_the_plain_version():
    rng = np.random.default_rng(23)
    N, F, k, C, depth, P = 97, 70003, 5, 3, 5, 71
    xb = rng.integers(0, 256, (N, F), dtype=np.uint8)
    feature, threshold, left, payload = random_forest(rng, k, depth, F, C, P)
    feature[:, 0] = F - 1                                 # every root splits past 16 bits
    carry = rng.random((N, C)).astype(np.float32)
    want = traverse_block_ref(*(torch.from_numpy(a) for a in (xb, feature, threshold, left,
                                                              payload, carry)), depth=depth).numpy()
    wide = _walk(xb, _pack(feature, threshold, left, True), payload, carry, depth, True)
    np.testing.assert_array_equal(wide, want)
    narrow = _walk(xb, _pack(feature, threshold, left, False), payload, carry, depth, False)
    assert not np.array_equal(narrow, want)               # 16-bit ids lose the high bits
    # below 16 bits the two layouts walk alike
    small = np.where(feature >= 0, feature % 300, feature).astype(np.int32)
    want_s = traverse_block_ref(*(torch.from_numpy(a) for a in (xb[:, :300].copy(), small,
                                                                 threshold, left, payload, carry)),
                                depth=depth).numpy()
    for w in (False, True):
        np.testing.assert_array_equal(
            _walk(xb[:, :300], _pack(small, threshold, left, w), payload, carry, depth, w), want_s)

"""Distributed PRF — vertical data partitioning on a device mesh (paper §4),
over ``torch.distributed`` (counterpart of ``repro/core/distributed.py``).

Sharding layout (the paper's data-parallel optimisation, §4.1):

  x_binned [N, F] : rows over the sample axes, features over ``model``
                    (vertical partitioning: features pinned to model
                    shards, samples to data shards)
  y        [N]    : rows over the sample axes
  weights  [k, N] : DSI counts, columns over the sample axes (§4.1.2)
  forest          : replicated (small)

SPMD, one process per mesh position (``launch.mesh.make_mesh``): every
rank calls the same entry point with the same *global* host arrays (or
``np.memmap``) and the same mesh, takes its own ``(sample x feature)``
block, and returns the replicated result. Rows are padded to a multiple
of the sample-axis size with zero-weight samples (parked in the streamed
driver), which no histogram, root count or vote sees.

Communication (the paper's task DAG, §4.2): T_GR builds per-rank
histograms over the local block, then one ``all_reduce`` over the sample
axes (``hist_reduce="psum"``), or a ``reduce_scatter`` that leaves each
rank a feature slice (``"psum_scatter"``); T_NS scores the local
features, then ``_global_best_splits`` merges the per-shard leaders: an
``all_gather`` of gains and ``(feature, threshold)`` keys, ties to the
smallest global key, and masked ``all_reduce`` s of the tiny winner
descriptors; the go-right bit of the winning feature reaches every
sample shard by a masked ``all_reduce`` over the feature axis. Every rank
issues the same collectives in the same order: dead trees, empty
frontiers and shards with no admitted feature still take part, and the
level loop's one host sync reads the replicated frontier.

Bootstrap is stratified per sample shard in ``make_prf_train_fn`` (each
shard draws its rows from a ``torch.Generator`` seeded by the shard
index); ``fit_sharded_from_draws`` takes global draws instead, which is
how the tests hand in the reference's. Histograms of integer DSI counts
are exact, so classification forests equal the single-device ones
bitwise on every mesh shape, resident, streamed and resumed.

Checkpoints are global: the sample-sharded slot tables and the
feature-sharded reuse cache are gathered, rank 0 writes the step, and
every rank waits at a barrier; a restore reads the step on every rank and
takes this rank's rows and features, so a run resumes onto another mesh
shape. The multi-process plane (``train_prf_multiproc``, ``runtime=``)
is ROADMAP.md Queue 1 item 10.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..device import as_tensor, host_array
from ..launch.mesh import Mesh
from .api import _channels, _stream_state_like
from .dsi import bootstrap_counts
from .engine import (
    CollectivePlane, _gather_feature_bins, _safe_mean, finalize_forest, grow, init_forest,
    init_growth_state, init_hist_cache, level_step, next_frontier, plan_level,
    resolve_hist_reuse, reuse_expand_scores, stream_block_step, write_level,
)
from .gain import SplitScores, level_scores, multiway_gain_ratio, sibling_plan
from .histograms import FixedPoint, class_channels, level_histograms, regression_fixed_point
from .types import Forest, ForestConfig, GrowthState
from .voting import _oob_ratio

_INT32_MAX = torch.iinfo(torch.int32).max


def _masked_psum(mesh: Mesh, val: torch.Tensor, mine: torch.Tensor, axes) -> torch.Tensor:
    """``val`` from the shard where ``mine`` holds; the result on every shard."""
    return mesh.all_reduce(torch.where(mine, val, torch.zeros_like(val)), axes)


def _global_best_splits(mesh: Mesh, scores: SplitScores, n_node: torch.Tensor, axes,
                        f_global_local: torch.Tensor, n_bins: int):
    """T_NS across shards: gather every shard's leaders, pick the winner.

    Equal gains break on the smallest global ``(feature, threshold)`` key,
    the order the single-device first-occurrence argmax uses, never on
    gather order (under reduce-scatter the shards' feature ranges
    interleave over the data axis). A row whose gains are NaN on every
    shard (zero mass, ROADMAP Queue 3 item 1) keeps NaN, and every key
    becomes int32 max, so shard 0 wins, as in the reference.
    """
    my = mesh.index(axes)               # this rank's place in the gather
    gr_all = mesh.all_gather(scores.gain_ratio, axes)                  # [P, k, S]
    best_gr = gr_all.max(dim=0).values
    key = (f_global_local * n_bins + scores.threshold).to(torch.int32)
    key_all = mesh.all_gather(key, axes)
    key_all = torch.where(gr_all == best_gr, key_all, torch.full_like(key_all, _INT32_MAX))
    mine = torch.argmin(key_all, dim=0) == my                          # first minimum
    f_global = _masked_psum(mesh, f_global_local, mine, axes)
    thr = _masked_psum(mesh, scores.threshold, mine, axes)
    lcnt = _masked_psum(mesh, scores.left_counts, mine[..., None], axes)
    rcnt = _masked_psum(mesh, scores.right_counts, mine[..., None], axes)
    n_node = _masked_psum(mesh, n_node, mine, axes)
    return SplitScores(best_gr, f_global, thr, lcnt, rcnt), n_node, mine


class MeshPlane(CollectivePlane):
    """The engine's collective plane for the vertical-partition mesh.

    ``combine_hist``: ``all_reduce`` over the sample axes (every sample
    shard ends with its feature shard's whole histogram), or, with
    ``hist_reduce="psum_scatter"``, one sample axis and a local feature
    width the data axis divides, a ``reduce_scatter`` that leaves data
    shard ``d`` the features ``[d * fl_sub, (d + 1) * fl_sub)`` of its
    feature shard (half the bytes on the wire, 1/D of the scoring).
    ``merge_winners`` maps local feature ids to global ones and runs
    ``_global_best_splits``; ``broadcast_route`` computes the go-right bit
    on the feature shard that holds the winning feature and sums it over
    the feature axis.
    """

    def __init__(self, config: ForestConfig, mesh: Mesh, n_local_features: int, mask_loc=None,
                 *, sample_axes=("data",), feature_axis: str = "model",
                 hist_fixed: Optional[FixedPoint] = None):
        self.mesh = mesh
        self.sample_axes = tuple(sample_axes)
        self.feature_axis = feature_axis
        self.n_bins = config.n_bins
        self.Fl = Fl = n_local_features
        self.midx = mesh.index(feature_axis)
        self.hist_fixed = hist_fixed
        D = mesh.size(self.sample_axes)
        self.use_rs = (config.hist_reduce == "psum_scatter" and len(self.sample_axes) == 1
                       and Fl % D == 0)
        if self.use_rs:
            self.didx = mesh.index(self.sample_axes)
            self.fl_sub = Fl // D
            mask_src = mask_loc if mask_loc is not None else torch.ones(
                (config.n_trees, Fl), dtype=torch.bool, device=mesh.device)
            self.level_mask = mask_src[:, self.didx * self.fl_sub:(self.didx + 1) * self.fl_sub]
            self.combine_hist = self._reduce_scatter
        else:
            self.level_mask = mask_loc
            self.combine_hist = lambda h: mesh.all_reduce(h, self.sample_axes)

    def _reduce_scatter(self, h: torch.Tensor) -> torch.Tensor:
        """``psum_scatter`` along the feature dim (2) of ``[k, S, Fl, B, C]``,
        tiled: torch scatters dim 0, so the feature axis goes first and back."""
        part = self.mesh.reduce_scatter(h.movedim(2, 0).contiguous(), self.sample_axes[0])
        return part.movedim(0, 2).contiguous()

    def reduce_root(self, root_counts: torch.Tensor) -> torch.Tensor:
        return self.mesh.all_reduce(root_counts, self.sample_axes)

    def merge_winners(self, scores: SplitScores, n_node: torch.Tensor):
        if self.use_rs:
            f_glob = scores.feature + self.midx * self.Fl + self.didx * self.fl_sub
            axes = (self.sample_axes[0], self.feature_axis)
        else:
            f_glob = scores.feature + self.midx * self.Fl
            axes = (self.feature_axis,)
        scores, n_node, _ = _global_best_splits(self.mesh, scores, n_node, axes, f_glob,
                                                self.n_bins)
        return scores, n_node

    def hist_width(self, n_features: int) -> int:
        """The reuse cache holds combined histograms: the local feature
        shard under psum, its post-scatter slice under reduce-scatter."""
        return self.fl_sub if self.use_rs else n_features

    def broadcast_route(self, xb_loc, f_i, thr_i) -> torch.Tensor:
        f_shard = torch.div(f_i, self.Fl, rounding_mode="floor")        # global ids
        here = f_shard == self.midx
        f_here = torch.where(here, f_i - self.midx * self.Fl, torch.zeros_like(f_i))
        bins_i = _gather_feature_bins(xb_loc, f_here)                   # [k, Nl]
        go_loc = torch.where(here, (bins_i > thr_i).to(torch.int32), torch.zeros_like(bins_i))
        return self.mesh.all_reduce(go_loc, self.feature_axis)

    def holds_feature0(self) -> torch.Tensor:
        """True on one rank, whose combined histogram starts at global
        feature 0: the first feature shard's first sample shard."""
        first = self.midx == 0 and self.mesh.index(self.sample_axes) == 0
        return torch.tensor(first, device=self.mesh.device)


# ---------------------------------------------------------------------------
# This rank's block of the global arrays
# ---------------------------------------------------------------------------


def _pad_rows(a: np.ndarray, pad: int, fill=0) -> np.ndarray:
    if pad == 0:
        return np.ascontiguousarray(a)
    width = [(0, pad)] + [(0, 0)] * (a.ndim - 1)
    return np.pad(a, width, constant_values=fill)


@dataclasses.dataclass(frozen=True)
class _Shard:
    """This rank's place in the ``(sample x feature)`` layout."""
    D: int          # sample shards
    d: int          # this rank's sample shard
    M: int          # feature shards
    m: int          # this rank's feature shard
    F: int          # global features

    @property
    def Fl(self) -> int:
        return self.F // self.M

    @property
    def cols(self) -> slice:
        return slice(self.m * self.Fl, (self.m + 1) * self.Fl)

    def rows(self, n: int):
        """``(lo, hi, n_local)``: this shard's rows of ``n`` padded to a
        multiple of D, and how many local rows there are."""
        nl = -(-n // self.D)
        return self.d * nl, (self.d + 1) * nl, nl

    def local_rows(self, a, n: int, axis: int = 0, fill=0) -> np.ndarray:
        """Rows ``[lo, hi)`` of ``a`` (length ``n`` along ``axis``), zero-
        (``fill``-) padded past ``n``; a view of ``a`` when nothing pads."""
        lo, hi, nl = self.rows(n)
        a = np.asarray(a)
        part = np.take(a, np.arange(lo, min(hi, n)), axis=axis) if axis else a[lo:min(hi, n)]
        short = nl - part.shape[axis]
        if short == 0:
            return part
        width = [(0, 0)] * a.ndim
        width[axis] = (0, short)
        return np.pad(part, width, constant_values=fill)

    def local_block(self, x, n: Optional[int] = None):
        """This rank's ``[nl, Fl]`` block of a global ``[n, F]`` array (or
        tensor, sliced where it lies)."""
        n = x.shape[0] if n is None else n
        lo, hi, nl = self.rows(n)
        if isinstance(x, torch.Tensor):
            part = x[lo:min(hi, n), self.cols]
            return torch.nn.functional.pad(part, (0, 0, 0, nl - part.shape[0])).contiguous()
        part = np.asarray(x[lo:min(hi, n), self.cols])
        if part.shape[0] < nl:
            part = _pad_rows(part, nl - part.shape[0])
        return part


def _shard(mesh: Mesh, n_features: int, sample_axes, feature_axis) -> _Shard:
    M = mesh.size(feature_axis)
    if n_features % M:
        raise ValueError(f"{n_features} features do not split over {M} '{feature_axis}' shards")
    return _Shard(mesh.size(sample_axes), mesh.index(sample_axes), M, mesh.index(feature_axis),
                  n_features)


def _to_device(a, dev) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(dev)
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def _y_dtype(config: ForestConfig):
    return np.float32 if config.regression else np.int64


def _local_inputs(x_binned, y, weights, feature_mask, config: ForestConfig, mesh: Mesh,
                  sample_axes, feature_axis):
    """This rank's block of the global arrays on the mesh device:
    ``(shard, xb_loc [Nl, Fl] uint8, base_loc [Nl, C], w_loc [k, Nl],
    mask_loc [k, Fl] or None, plane fixed point)``."""
    dev = mesh.device
    N, F = x_binned.shape
    sh = _shard(mesh, F, sample_axes, feature_axis)
    y_np, w_np = host_array(y), host_array(weights).astype(np.float32, copy=False)
    xb = _to_device(sh.local_block(x_binned), dev)
    y_loc = torch.from_numpy(np.ascontiguousarray(
        sh.local_rows(y_np.astype(_y_dtype(config), copy=False), N))).to(dev)
    w_loc = torch.from_numpy(np.ascontiguousarray(sh.local_rows(w_np, N, axis=1))).to(dev)
    mask_loc = None
    if feature_mask is not None:
        mask_loc = as_tensor(host_array(feature_mask)[:, sh.cols], dev, torch.bool).contiguous()
    fixed = regression_fixed_point(y_np, w_np) if config.regression else None
    return sh, xb.to(torch.uint8), _channels(y_loc, config), w_loc, mask_loc, fixed


def _grow_sharded(xb_loc, base_loc, w_loc, mask_loc, config: ForestConfig, mesh: Mesh, *,
                  sample_axes=("data",), feature_axis="model",
                  hist_fixed: Optional[FixedPoint] = None) -> Forest:
    """Level-synchronous growth on this rank's ``(sample x feature)`` block:
    the unified engine (``engine.grow``) on a ``MeshPlane``."""
    plane = MeshPlane(config, mesh, xb_loc.shape[1], mask_loc, sample_axes=sample_axes,
                      feature_axis=feature_axis, hist_fixed=hist_fixed)
    return grow(xb_loc, base_loc, w_loc, config, plane)


def grow_sharded(x_binned, y, weights, config: ForestConfig, mesh: Mesh, feature_mask=None, *,
                 sample_axes: Sequence[str] = ("data",), feature_axis: str = "model") -> Forest:
    """Train k trees on the mesh from the global arrays (``x_binned [N,
    F]`` uint8, ``y [N]``, DSI ``weights [k, N]``, ``feature_mask [k, F]``);
    each rank grows on its block and returns the replicated forest on its
    device, equal to ``forest.grow_forest``'s for classification."""
    sample_axes = tuple(sample_axes)
    _, xb, base, w, mask, fixed = _local_inputs(x_binned, y, weights, feature_mask, config, mesh,
                                                sample_axes, feature_axis)
    return _grow_sharded(xb, base, w, mask, config, mesh, sample_axes=sample_axes,
                         feature_axis=feature_axis, hist_fixed=fixed)


# ---------------------------------------------------------------------------
# Global checkpoints of sharded carries
# ---------------------------------------------------------------------------


def _gather_rows(mesh: Mesh, t: torch.Tensor, n: int, sample_axes) -> torch.Tensor:
    """The global ``[k, n]`` table from each sample shard's ``[k, nl]`` columns."""
    g = mesh.all_gather(t.contiguous(), sample_axes)                  # [D, k, nl]
    return g.permute(1, 0, 2).reshape(t.shape[0], -1)[:, :n]


def _gather_cache_hist(mesh: Mesh, h: torch.Tensor, plane: MeshPlane) -> torch.Tensor:
    """The reuse cache's histogram in global feature order, from the
    feature-sharded pieces (under reduce-scatter, data shard d of feature
    shard m holds features ``m * Fl + d * fl_sub`` on)."""
    axes = plane.sample_axes + (plane.feature_axis,)
    g = mesh.all_gather(h.contiguous(), axes)                         # [D * M, k, S, w, B, C]
    D, M = mesh.size(plane.sample_axes), mesh.size(plane.feature_axis)
    g = g.view((D, M) + tuple(h.shape))
    g = g.permute(1, 0, 2, 3, 4, 5, 6) if plane.use_rs else g[:1].permute(1, 0, 2, 3, 4, 5, 6)
    pieces = g.reshape((-1,) + tuple(h.shape))                        # in global feature order
    return torch.cat(list(pieces), dim=2)


def _local_cache_hist(h: torch.Tensor, plane: MeshPlane) -> torch.Tensor:
    lo = plane.midx * plane.Fl + (plane.didx * plane.fl_sub if plane.use_rs else 0)
    return h[:, :, lo:lo + plane.hist_width(plane.Fl)].contiguous()


def _save_global(manager, mesh: Mesh, step: int, make_tree) -> None:
    """Save one global step: every rank gathers (``make_tree``, collectives
    on every rank), rank 0 writes, every rank waits for the write."""
    if step % manager.save_interval != 0:
        return
    tree = make_tree()
    if mesh.rank == 0:
        manager.maybe_save(tree, step, layout="global")
    mesh.barrier()


def grow_sharded_checkpointed(
    x_binned, y, weights, config: ForestConfig, mesh: Mesh, feature_mask=None, *,
    sample_axes: Sequence[str] = ("data",), feature_axis: str = "model",
    manager=None, resume_from: Optional[str] = None, on_level=None,
) -> Forest:
    """Resident mesh growth with per-level checkpoints and crash resume
    (the mesh counterpart of ``engine.grow_checkpointed``): the same host
    loop over ``level_step`` on a ``MeshPlane``, so the forest equals
    ``grow_sharded``'s.

    After each level the whole ``GrowthState`` is saved as one global
    step (``manager``, a ``CheckpointManager`` every rank holds): the
    slot table ``[k, N]`` (pad rows dropped) and the reuse cache gathered
    to rank 0, which writes; a barrier follows. ``resume_from`` restores
    the newest valid step on every rank, each taking its rows and
    features, so the mesh shape may differ from the one that saved.
    ``on_level(level, state)`` fires on every rank after the save.
    """
    from ..checkpoint.checkpoint import restore_latest_valid

    sample_axes = tuple(sample_axes)
    N = x_binned.shape[0]
    sh, xb, base, w, mask, fixed = _local_inputs(x_binned, y, weights, feature_mask, config, mesh,
                                                 sample_axes, feature_axis)
    plane = MeshPlane(config, mesh, sh.Fl, mask, sample_axes=sample_axes,
                      feature_axis=feature_axis, hist_fixed=fixed)
    state = init_growth_state(base, w, config, plane, n_features=sh.Fl)
    if resume_from is not None:
        def place(key, arr, like):
            if key == "2":                                  # sample_slot [k, N]
                return torch.from_numpy(np.ascontiguousarray(sh.local_rows(arr, N, axis=1))).to(
                    mesh.device)
            if key == "5/hist":
                return _local_cache_hist(torch.from_numpy(arr), plane).to(mesh.device)
            return None

        restored = restore_latest_valid(state, resume_from, placement=place)
        if restored is not None:
            state = restored[0]

    def global_state():
        cache = state.hist_cache
        if cache is not None:
            cache = dict(cache, hist=_gather_cache_hist(mesh, cache["hist"], plane))
        return GrowthState(forest=state.forest, slot_node=state.slot_node,
                           sample_slot=_gather_rows(mesh, state.sample_slot, N, sample_axes),
                           level=state.level, hist_cache=cache)

    while state.level < config.max_depth and bool((state.slot_node >= 0).any()):
        state = level_step(xb, base, w, state, config, plane)
        if manager is not None:
            _save_global(manager, mesh, state.level, global_state)
        if on_level is not None:
            on_level(state.level, state)
    return finalize_forest(state.forest)


# ---------------------------------------------------------------------------
# Mesh x streaming: host sample blocks fed into the collective plane
# ---------------------------------------------------------------------------


class _BlockPlacement:
    """A ``BlockFeeder`` placement that feeds this rank its block of every
    global sample block: the rows of its sample shard (padded to the
    sample-axis multiple) and the columns of its feature shard."""

    def __init__(self, mesh: Mesh, shard: _Shard):
        self.device = mesh.device
        self.shard = shard

    def local(self, block) -> np.ndarray:
        return self.shard.local_block(block)


def _stream_geometry(blocks):
    sizes = [int(b.shape[0]) for b in blocks]
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    return sizes, offsets


def grow_forest_streamed_sharded(
    x_binned, y, weights, config: ForestConfig, mesh: Mesh, feature_mask=None, *,
    sample_axes: Sequence[str] = ("data",), feature_axis: str = "model", prefetch: int = 2,
    manager=None, resume_from: Optional[str] = None, on_level=None,
    feeder_opts: Optional[dict] = None, quarantined: Sequence[int] = (),
) -> Forest:
    """Out-of-core growth on the mesh: the streaming data plane composed
    with ``MeshPlane`` (reference: ``grow_forest_streamed_sharded``).

    ``x_binned`` is a host array / ``np.memmap`` (cut into
    ``config.sample_block`` rows) or a list of global blocks. Per (block,
    level) each rank runs one ``engine.stream_block_step`` on its slice of
    the block (fed by a ``BlockFeeder`` with this rank's placement):
    route by the previous level's plan (the go-right bit summed over the
    feature axis) and add the block into the rank's local histogram
    carry; the plane's ``combine_hist`` runs once a level, so streaming
    adds no collective traffic. Blocks pad to the sample-axis multiple
    with parked samples (slot -1, zero weight); the forest equals the
    resident local growth's for classification.

    ``manager`` / ``resume_from`` / ``on_level`` checkpoint the loop's
    carry (``api._stream_state_like``) as global steps (per-block slot
    tables gathered, pad rows dropped); ``quarantined`` blocks leave every
    sweep. The multi-process form (``runtime=``) is not ported (ROADMAP
    Queue 1 item 10).
    """
    from ..checkpoint.checkpoint import restore_latest_valid
    from ..data.pipeline import BlockFeeder, stream_blocks

    sample_axes = tuple(sample_axes)
    dev = mesh.device
    y_np = host_array(y).astype(_y_dtype(config), copy=False)
    w_np = host_array(weights).astype(np.float32, copy=False)
    blocks = stream_blocks(x_binned, config.sample_block, what="grow_forest_streamed_sharded",
                           n_y=y_np.shape[0], n_w=w_np.shape[1])
    F = int(blocks[0].shape[1])
    sh = _shard(mesh, F, sample_axes, feature_axis)
    sizes, offsets = _stream_geometry(blocks)
    k, S, B = config.n_trees, config.frontier, config.n_bins
    C = 3 if config.regression else config.n_classes
    fixed = regression_fixed_point(y_np, w_np) if config.regression else None
    mask = None
    if feature_mask is not None:
        mask = as_tensor(host_array(feature_mask)[:, sh.cols], dev, torch.bool).contiguous()
    plane = MeshPlane(config, mesh, sh.Fl, mask, sample_axes=sample_axes,
                      feature_axis=feature_axis, hist_fixed=fixed)
    reuse = resolve_hist_reuse(config, sh.Fl)
    n_rows = config.max_splits_per_level if reuse else S

    feeder = BlockFeeder(blocks, placement=_BlockPlacement(mesh, sh), prefetch=prefetch,
                         quarantined=quarantined, **(feeder_opts or {}))
    try:
        base_dev, w_dev = {}, {}
        for i in feeder.live_blocks:
            o0, n = offsets[i], sizes[i]
            base_dev[i] = _channels(feeder.pin(sh.local_rows(y_np[o0:o0 + n], n)), config)
            w_dev[i] = feeder.pin(sh.local_rows(w_np[:, o0:o0 + n], n, axis=1))

        def slot0(n):
            lo, hi, nl = sh.rows(n)
            s0 = torch.zeros((k, nl), dtype=torch.int32, device=dev)
            s0[:, max(n - lo, 0):] = -1                    # pad rows stay parked
            return s0

        state = None
        if resume_from is not None:
            def place(key, arr, like):
                parts = key.split("/")
                if parts[0] == "slots":
                    i = int(parts[1])
                    return torch.from_numpy(np.ascontiguousarray(
                        sh.local_rows(arr, sizes[i], axis=1, fill=-1))).to(dev)
                if key == "hist_cache/hist":
                    return _local_cache_hist(torch.from_numpy(arr), plane).to(dev)
                return None

            like = _stream_state_like(sizes, config, F if reuse else 0, dev)
            restored = restore_latest_valid(like, resume_from, placement=place)
            if restored is not None:
                state = restored[0]
        if state is not None:
            forest, slot_node, scores = state["forest"], state["slot_node"], state["scores"]
            split_rank, slot_dev, start = state["split_rank"], state["slots"], state["level"]
            cache = state["hist_cache"]
        else:
            slot_dev = [slot0(n) for n in sizes]
            slot_node = torch.full((k, S), -1, dtype=torch.int32, device=dev)
            slot_node[:, 0] = 0
            forest = scores = split_rank = None
            cache = init_hist_cache(config, plane.hist_width(sh.Fl), dev) if reuse else None
            start = 0

        def level_sweep(route: bool) -> torch.Tensor:
            hist = torch.zeros((k, n_rows, sh.Fl, B, C), dtype=torch.float32, device=dev)
            for i, xb_b in zip(feeder.live_blocks, feeder.sweep()):
                _, slot_dev[i] = stream_block_step(
                    hist, xb_b, base_dev[i], w_dev[i], slot_dev[i], slot_node, split_rank,
                    scores, config, plane, route=route,
                    small_right=cache["small_right"] if reuse else None,
                )
            return plane.combine_hist(hist)

        def root_forest(hist_c):
            # any feature's bin marginal of the level-0 histogram is the root's
            # counts; global feature 0's, so every rank writes the same root
            root = _masked_psum(mesh, hist_c[:, 0, 0].sum(dim=1), plane.holds_feature0(),
                                plane.sample_axes + (feature_axis,))
            f = init_forest(config, dev)
            f.class_counts[:, 0] = root
            if config.regression:
                f.value[:, 0] = _safe_mean(root)
            return f

        def global_state(level):
            c = cache
            if c is not None:
                c = dict(c, hist=_gather_cache_hist(mesh, c["hist"], plane))
            return {"forest": forest, "slot_node": slot_node, "scores": scores,
                    "split_rank": split_rank, "level": level + 1, "hist_cache": c,
                    "slots": [_gather_rows(mesh, s, n, sample_axes)
                              for s, n in zip(slot_dev, sizes)]}

        for level in range(start, config.max_depth):
            if not bool((slot_node >= 0).any()):
                break                                   # every frontier is empty
            hist_c = level_sweep(route=level > 0)
            if forest is None:
                forest = root_forest(hist_c)
            if reuse:
                scores, n_node, hist2, perm = reuse_expand_scores(hist_c, cache, plane.level_mask,
                                                                  config)
            else:
                scores, n_node = level_scores(hist_c, plane.level_mask,
                                              regression=config.regression,
                                              backend=config.split_backend)
            del hist_c
            scores, n_node = plane.merge_winners(scores, n_node)
            split_rank, is_split, child_base = plan_level(scores, n_node, slot_node, config, level)
            forest = write_level(forest, slot_node, split_rank, is_split, child_base, scores,
                                 config)
            if reuse:
                parent, small_right = sibling_plan(scores, split_rank, is_split,
                                                   n_ranks=config.max_splits_per_level,
                                                   regression=config.regression)
                cache = {"hist": hist2, "perm": perm, "parent": parent,
                         "small_right": small_right}
            slot_node = next_frontier(is_split, child_base, config.frontier)
            if manager is not None:
                _save_global(manager, mesh, level + 1, lambda: global_state(level))
            if on_level is not None:
                on_level(level + 1, forest)
        if forest is None:                              # max_depth == 0: the root only
            forest = root_forest(level_sweep(route=False))
    finally:
        feeder.close()
    return finalize_forest(forest)


def _route_sharded(forest: Forest, xb_loc: torch.Tensor, mesh: Mesh, *,
                   feature_axis: str = "model") -> torch.Tensor:
    """Leaf of every local sample under every tree when features are
    sharded over ``feature_axis``: ``depth`` steps, each step's go-right bit
    from the shard that holds the node's feature, summed over the axis."""
    k = forest.feature.shape[0]
    Nl, Fl = xb_loc.shape
    midx = mesh.index(feature_axis)
    node = torch.zeros((k, Nl), dtype=torch.long, device=xb_loc.device)
    for _ in range(forest.config.max_depth):
        f = torch.gather(forest.feature, 1, node)
        leaf = f < 0
        f_shard = torch.where(leaf, -1, torch.div(f, Fl, rounding_mode="floor"))
        here = f_shard == midx
        b = _gather_feature_bins(xb_loc, torch.where(here, f - midx * Fl, 0))
        thr = torch.gather(forest.threshold, 1, node)
        go = mesh.all_reduce(torch.where(here, (b > thr).to(torch.int32), 0), feature_axis)
        lc = torch.gather(forest.left_child, 1, node)
        node = torch.where(leaf, node, (lc + go).long())
    return node


def _vote_labels_kernel(forest: Forest, xb_loc: torch.Tensor, mesh: Mesh, *,
                        feature_axis: str = "model") -> torch.Tensor:
    """Eq. (10) labels of the local samples over a feature-sharded block:
    the one body of ``predict_sharded`` and ``predict_streamed_sharded``
    (plain gathers, as ``voting.predict``'s plain path votes)."""
    from .voting import _vote_weights, weighted_vote

    leaves = _route_sharded(forest, xb_loc, mesh, feature_axis=feature_axis)
    C = forest.class_counts.shape[-1]
    counts = torch.gather(forest.class_counts, 1, leaves[..., None].expand(-1, -1, C))
    probs = counts / torch.clamp_min(counts.sum(-1, keepdim=True), 1e-38)
    scores = weighted_vote(probs, _vote_weights(forest), soft=forest.config.soft_voting)
    return torch.argmax(scores, dim=-1)


def _gather_labels(mesh: Mesh, labels: torch.Tensor, n: int, sample_axes) -> np.ndarray:
    return mesh.all_gather(labels, sample_axes).reshape(-1)[:n].cpu().numpy()


def predict_sharded(forest: Forest, x_binned, mesh: Mesh, *, sample_axes=("data",),
                    feature_axis: str = "model") -> np.ndarray:
    """Distributed weighted-vote prediction (Eq. 10) of the global
    ``x_binned [N, F]``: ``[N]`` labels on every rank, equal to
    ``voting.predict``'s."""
    sample_axes = tuple(sample_axes)
    sh = _shard(mesh, x_binned.shape[1], sample_axes, feature_axis)
    xb = _to_device(sh.local_block(x_binned), mesh.device)
    labels = _vote_labels_kernel(forest, xb, mesh, feature_axis=feature_axis)
    return _gather_labels(mesh, labels, x_binned.shape[0], sample_axes)


def _oob_counts_sharded(forest: Forest, xb_loc, y_loc, w_loc, valid_loc, mesh: Mesh, *,
                        sample_axes, feature_axis):
    """Eq. (8)'s two sums (#correct, #OOB) per tree over the local samples,
    summed over the sample axes."""
    leaves = _route_sharded(forest, xb_loc, mesh, feature_axis=feature_axis)
    C = forest.class_counts.shape[-1]
    counts = torch.gather(forest.class_counts, 1, leaves[..., None].expand(-1, -1, C))
    pred = torch.argmax(counts, dim=-1)                                    # [k, Nl]
    oob = (w_loc == 0.0).to(torch.float32) * valid_loc[None]
    correct = mesh.all_reduce(torch.sum(oob * (pred == y_loc.long()[None]).to(torch.float32), 1),
                              sample_axes)
    total = mesh.all_reduce(torch.sum(oob, 1), sample_axes)
    return correct, total


def _oob_weights_sharded(forest: Forest, xb_loc, y_loc, w_loc, valid_loc, mesh: Mesh, *,
                         sample_axes=("data",), feature_axis="model") -> torch.Tensor:
    """Eq. (8) with samples and features sharded (pad rows: ``valid_loc`` 0)."""
    return _oob_ratio(*_oob_counts_sharded(forest, xb_loc, y_loc, w_loc, valid_loc, mesh,
                                           sample_axes=tuple(sample_axes),
                                           feature_axis=feature_axis))


def _valid_rows(sh: _Shard, n: int, dev) -> torch.Tensor:
    return torch.from_numpy(sh.local_rows(np.ones(n, np.float32), n)).to(dev)


def oob_accuracy_sharded(forest: Forest, x_binned, y, weights, mesh: Mesh, *,
                         sample_axes=("data",), feature_axis: str = "model") -> torch.Tensor:
    """``voting.oob_accuracy`` of the global arrays on the mesh, bitwise
    (exact integer sums). [k] on every rank."""
    sample_axes = tuple(sample_axes)
    N = x_binned.shape[0]
    sh = _shard(mesh, x_binned.shape[1], sample_axes, feature_axis)
    dev = mesh.device
    xb = _to_device(sh.local_block(x_binned), dev)
    y_loc = torch.from_numpy(sh.local_rows(host_array(y).astype(np.int64), N)).to(dev)
    w_loc = torch.from_numpy(np.ascontiguousarray(
        sh.local_rows(host_array(weights).astype(np.float32), N, axis=1))).to(dev)
    return _oob_weights_sharded(forest, xb, y_loc, w_loc, _valid_rows(sh, N, dev), mesh,
                                sample_axes=sample_axes, feature_axis=feature_axis)


def oob_accuracy_streamed_sharded(forest: Forest, x_binned, y, weights, mesh: Mesh, *,
                                  sample_block: int = 0, sample_axes=("data",),
                                  feature_axis: str = "model", prefetch: int = 2,
                                  feeder_opts: Optional[dict] = None,
                                  quarantined: Sequence[int] = ()) -> torch.Tensor:
    """Eq. (8) over host sample blocks on the mesh: per block each rank
    routes its slice and the ``[k]`` counts are summed over the sample
    axes; the counts add over blocks (exact integers), so the result is
    ``oob_accuracy``'s bitwise. Pad rows leave both sums (validity 0)."""
    from ..data.pipeline import BlockFeeder, stream_blocks

    sample_axes = tuple(sample_axes)
    y_np = host_array(y).astype(np.int64)
    w_np = host_array(weights).astype(np.float32, copy=False)
    blocks = stream_blocks(x_binned, sample_block, what="oob_accuracy_streamed_sharded",
                           n_y=y_np.shape[0], n_w=w_np.shape[1])
    sh = _shard(mesh, int(blocks[0].shape[1]), sample_axes, feature_axis)
    sizes, offsets = _stream_geometry(blocks)
    dev = mesh.device
    k = w_np.shape[0]
    correct = torch.zeros((k,), dtype=torch.float32, device=dev)
    total = torch.zeros_like(correct)
    with BlockFeeder(blocks, placement=_BlockPlacement(mesh, sh), prefetch=prefetch,
                     quarantined=quarantined, **(feeder_opts or {})) as feeder:
        for i, xb_b in zip(feeder.live_blocks, feeder.sweep()):
            o0, n = offsets[i], sizes[i]
            c, t = _oob_counts_sharded(
                forest, xb_b, feeder.pin(sh.local_rows(y_np[o0:o0 + n], n)),
                feeder.pin(sh.local_rows(w_np[:, o0:o0 + n], n, axis=1)), _valid_rows(sh, n, dev),
                mesh, sample_axes=sample_axes, feature_axis=feature_axis)
            correct, total = correct + c, total + t
    return _oob_ratio(correct, total)


def predict_streamed_sharded(forest: Forest, x_binned, mesh: Mesh, *, sample_block: int = 0,
                             sample_axes=("data",), feature_axis: str = "model",
                             prefetch: int = 2, feeder_opts: Optional[dict] = None) -> np.ndarray:
    """Distributed Eq. (10) prediction over host sample blocks: labels
    are per sample, so the sweep equals ``predict_sharded`` bitwise; one
    block's slice is on the device at a time. ``[N]`` labels, every rank."""
    from ..data.pipeline import BlockFeeder, stream_blocks

    sample_axes = tuple(sample_axes)
    blocks = stream_blocks(x_binned, sample_block, what="predict_streamed_sharded")
    sh = _shard(mesh, int(blocks[0].shape[1]), sample_axes, feature_axis)
    out = []
    with BlockFeeder(blocks, placement=_BlockPlacement(mesh, sh), prefetch=prefetch,
                     **(feeder_opts or {})) as feeder:
        for b, xb_b in zip(blocks, feeder.sweep()):
            labels = _vote_labels_kernel(forest, xb_b, mesh, feature_axis=feature_axis)
            out.append(_gather_labels(mesh, labels, b.shape[0], sample_axes))
    return np.concatenate(out)


# ---------------------------------------------------------------------------
# The trainers: dimension reduction, draws, growth, OOB weights
# ---------------------------------------------------------------------------


def _dimred_sharded(xb_loc, base_loc, w_loc, config: ForestConfig, u, mesh: Mesh, *,
                    sample_axes=("data",), feature_axis="model") -> torch.Tensor:
    """Distributed Alg. 3.1: root gain ratios of the local features (the
    root histogram summed over the sample axes), gathered over the feature
    axis for the global VI ranking with the uniform draws ``u [k, F]``;
    returns this rank's ``[k, Fl]`` slice of the mask."""
    from .dimred import select_features

    k, Nl = w_loc.shape
    Fl = xb_loc.shape[1]
    slot0 = torch.zeros((k, Nl), dtype=torch.int32, device=w_loc.device)
    hist = level_histograms(xb_loc, base_loc, w_loc, slot0, n_slots=1, n_bins=config.n_bins,
                            backend=config.hist_backend)
    hist = mesh.all_reduce(hist, sample_axes)
    gr_loc = multiway_gain_ratio(hist[:, 0])                               # [k, Fl]
    gr = mesh.all_gather(gr_loc, feature_axis).permute(1, 0, 2).reshape(k, -1)   # [k, F]
    cfg = config.resolved(gr.shape[1])
    mask = select_features(gr, u, n_selected=cfg.n_selected, n_important=cfg.n_important)
    midx = mesh.index(feature_axis)
    return mask[:, midx * Fl:(midx + 1) * Fl].contiguous()


def _fit_local(xb, y_loc, w_loc, mask_loc, valid, config: ForestConfig, mesh: Mesh,
               sample_axes, feature_axis, fixed) -> Forest:
    base = _channels(y_loc, config)
    forest = _grow_sharded(xb, base, w_loc, mask_loc, config, mesh, sample_axes=sample_axes,
                           feature_axis=feature_axis, hist_fixed=fixed)
    if config.weighted_voting and not config.regression:                # §3.3
        forest.tree_weight = _oob_weights_sharded(forest, xb, y_loc, w_loc, valid, mesh,
                                                  sample_axes=sample_axes,
                                                  feature_axis=feature_axis)
    return forest


def fit_sharded_from_draws(x_binned, y, config: ForestConfig, mesh: Mesh, weights,
                           feature_mask=None, *, sample_axes=("data",),
                           feature_axis: str = "model") -> Forest:
    """``make_prf_train_fn``'s trainer given the global draws: DSI
    ``weights [k, N]`` and ``feature_mask [k, F]`` (None: every feature).
    Growth on the mesh, then the OOB tree weights (classification with
    weighted voting), as the reference's trainer does after its draws.
    The tests hand in the reference's draws here."""
    sample_axes = tuple(sample_axes)
    config = config.resolved(x_binned.shape[1])
    sh, xb, _, w, mask, fixed = _local_inputs(x_binned, y, weights, feature_mask, config, mesh,
                                              sample_axes, feature_axis)
    N = x_binned.shape[0]
    y_loc = torch.from_numpy(sh.local_rows(host_array(y).astype(_y_dtype(config)), N)).to(
        mesh.device)
    return _fit_local(xb, y_loc, w, mask, _valid_rows(sh, N, mesh.device), config, mesh,
                      sample_axes, feature_axis, fixed)


def _shard_seed(seed: int, shard: int) -> int:
    return int(np.random.SeedSequence([seed, shard]).generate_state(1, np.uint64)[0] >> 1)


def make_prf_train_fn(config: ForestConfig, mesh: Mesh, *, sample_axes=("data",),
                      feature_axis: str = "model"):
    """The distributed PRF trainer for ``mesh``. Returns ``(train_fn,
    specs)``: ``train_fn(x_binned, y, seed) -> Forest`` (replicated) on the
    global arrays, and the axes each argument is sharded over (the
    reference's in-shardings: ``x`` rows over ``sample_axes`` and columns
    over ``feature_axis``, ``y`` over ``sample_axes``, the seed replicated).

    Draws: a stratified DSI bootstrap per sample shard (each shard draws
    its real rows from a CPU ``torch.Generator`` seeded by ``(seed, shard
    index)``), and the feature-selection uniforms ``u [k, F]`` from one
    seeded by ``seed`` alone, identical on every shard, so every shard
    computes the same mask. The JAX key streams are not reproducible in
    torch (ROADMAP "RNG"); ``fit_sharded_from_draws`` takes draws instead.
    """
    from .dimred import random_feature_mask

    sample_axes = tuple(sample_axes)

    def train_fn(x_binned, y, seed: int) -> Forest:
        N, F = x_binned.shape
        cfg = config.resolved(F)
        dev = mesh.device
        sh = _shard(mesh, F, sample_axes, feature_axis)
        lo, hi, nl = sh.rows(N)
        n_real = max(min(hi, N) - lo, 0)
        gen = torch.Generator().manual_seed(_shard_seed(seed, sh.d))
        w_np = np.zeros((cfg.n_trees, nl), np.float32)
        if n_real:
            w_np[:, :n_real] = bootstrap_counts(gen, cfg.n_trees, n_real, "cpu").numpy()
        u = torch.rand((cfg.n_trees, F), generator=torch.Generator().manual_seed(seed)).to(dev)
        xb = _to_device(sh.local_block(x_binned), dev)
        y_loc = torch.from_numpy(sh.local_rows(host_array(y).astype(_y_dtype(cfg)), N)).to(dev)
        w_loc = torch.from_numpy(w_np).to(dev)
        fixed = None
        if cfg.regression:
            wmax = mesh.all_reduce(w_loc.max().reshape(1), sample_axes,
                                   op=torch.distributed.ReduceOp.MAX)
            fixed = regression_fixed_point(host_array(y), np.full((1, N), float(wmax[0])))
        mask_loc = None
        if cfg.feature_mode == "importance" and not cfg.regression:
            mask_loc = _dimred_sharded(xb, class_channels(y_loc, cfg.n_classes), w_loc, cfg, u,
                                       mesh, sample_axes=sample_axes, feature_axis=feature_axis)
        elif cfg.feature_mode == "random":
            mask_loc = random_feature_mask(u, n_selected=cfg.n_selected)[:, sh.cols].contiguous()
        return _fit_local(xb, y_loc, w_loc, mask_loc, _valid_rows(sh, N, dev), cfg, mesh,
                          sample_axes, feature_axis, fixed)

    specs = ((sample_axes, feature_axis), (sample_axes,), ())
    return train_fn, specs


# ---------------------------------------------------------------------------
# Distributed bin-edge fitting (blocked quantile sketch over the mesh)
# ---------------------------------------------------------------------------


def fit_bins_sharded(x, n_bins: int, mesh: Mesh, *, sample_block: int,
                     sample_axes: Sequence[str] = ("data",), max_size: Optional[int] = None,
                     exclude_masks=None) -> np.ndarray:
    """Distributed bin-edge fitting: one quantile sketch per sample shard,
    exchanged through the mesh, merged on the host.

    The ``sample_blocks`` of ``x`` (typically an ``np.memmap``) are split
    contiguously over the sample shards; each rank folds only its shard's
    blocks into a ``StreamingQuantileSketch``. The per-feature float64
    summaries cross the mesh as raw bit patterns (int32 words, with one
    metadata row a feature: count, compression, dtype) through one
    ``all_gather`` over the sample axes, bit-exact on every backend, and
    are merged in shard order on every rank. While every summary is
    uncompressed the edges equal ``fit_bins_blocked``'s over the same
    blocks bitwise. ``exclude_masks`` (sequence, dict by block index, or
    callable) carries the validator's imputed-cell masks."""
    from ..data.pipeline import stream_blocks
    from .binning import DEFAULT_SKETCH_SIZE, StreamingQuantileSketch, validate_n_bins

    n_bins = validate_n_bins(n_bins)
    max_size = DEFAULT_SKETCH_SIZE if max_size is None else max_size
    blocks = stream_blocks(x, sample_block, what="fit_bins_sharded")
    n_features = int(np.asarray(blocks[0]).shape[1])
    axes = tuple(sample_axes)
    n_shards = mesh.size(axes)
    parts = np.array_split(np.arange(len(blocks)), n_shards)
    width = 2 * max_size          # a summary never exceeds it (the sketch recompresses past it)

    sk = StreamingQuantileSketch(n_features, max_size=max_size)
    for i in parts[mesh.index(axes)]:
        i = int(i)
        if exclude_masks is None:
            mask = None
        elif isinstance(exclude_masks, dict):
            mask = exclude_masks.get(i)
        elif callable(exclude_masks):
            mask = exclude_masks(i)
        else:
            mask = exclude_masks[i]
        sk.update(np.asarray(blocks[i]), exclude=mask)
    st = sk.state(pad_to=width)
    payload = np.zeros((n_features, width + 1, 4), np.uint32)
    payload[:, :width] = np.ascontiguousarray(
        np.stack([st["values"], st["weights"]], axis=-1)).view(np.uint32).reshape(
            n_features, width, 4)
    cnt = np.asarray(st["count"], np.uint64)
    payload[:, width, 0] = (cnt & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    payload[:, width, 1] = (cnt >> np.uint64(32)).astype(np.uint32)
    payload[:, width, 2] = np.asarray(st["compressed"], np.uint32)
    payload[:, width, 3] = np.uint32(ord(np.dtype(st["value_dtype"]).char))

    words = torch.from_numpy(payload.view(np.int32)).to(mesh.device)
    gathered = mesh.all_gather(words, axes).cpu().numpy().view(np.uint32)   # [D, F, width + 1, 4]

    merged = None
    for d in range(n_shards):
        meta = gathered[d, :, width]
        unpacked = np.ascontiguousarray(gathered[d, :, :width]).view(np.float64).reshape(
            n_features, width, 2)
        sk_d = StreamingQuantileSketch.from_state({
            "values": unpacked[..., 0], "weights": unpacked[..., 1],
            "count": (meta[:, 0].astype(np.uint64)
                      | (meta[:, 1].astype(np.uint64) << np.uint64(32))).astype(np.int64),
            "compressed": meta[:, 2].astype(np.bool_),
            "value_dtype": np.dtype(chr(int(meta[0, 3]))).str,
            "max_size": max_size,
        })
        merged = sk_d if merged is None else merged.merge(sk_d)
    return merged.edges(n_bins)

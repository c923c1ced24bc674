"""Rank programs of the mesh tests (``tests/test_torch_mesh*.py``).

``repro_torch.launch.mesh.run_world`` starts each rank as its own
process and calls one of these functions there, on the CPU with gloo;
this module imports numpy, torch and ``repro_torch`` only, so a rank
never loads JAX or the reference. Each returns plain numpy results for
the test to hold against ``repro``.
"""
import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import distributed as dist_prf
from repro_torch.core.types import ForestConfig
from repro_torch.launch.mesh import make_mesh

FIELDS = ("feature", "threshold", "left_child", "class_counts", "value", "tree_weight")


def forest_np(forest) -> dict:
    return {n: getattr(forest, n).cpu().numpy() for n in FIELDS}


class Kill(Exception):
    """Raised from ``on_level`` after the level's checkpoint: a crash at
    the level boundary, on every rank at once."""


def resident(shape, xb, y, w, cfg_kw, u, mask, sys_case):
    """Resident growth over {psum, psum_scatter} x {early exit on, off},
    reuse on, prediction, OOB, the sharded dimension reduction, the
    draws-taking trainer and ``make_prf_train_fn``'s accuracy."""
    mesh = make_mesh(shape, device="cpu")
    out = {}
    for hr in ("psum", "psum_scatter"):
        for early in (True, False):
            cfg = ForestConfig(**cfg_kw, hist_reduce=hr, early_exit=early, hist_reuse="off")
            out["grow", hr, early] = forest_np(dist_prf.grow_sharded(xb, y, w, cfg, mesh))
        cfg = ForestConfig(**cfg_kw, hist_reduce=hr, hist_reuse="on")
        out["reuse", hr] = forest_np(dist_prf.grow_sharded(xb, y, w, cfg, mesh))
    cfg = ForestConfig(**cfg_kw, hist_reuse="off")
    forest = dist_prf.grow_sharded(xb, y, w, cfg, mesh)
    out["predict"] = dist_prf.predict_sharded(forest, xb, mesh)
    out["oob"] = dist_prf.oob_accuracy_sharded(forest, xb, y, w, mesh).numpy()

    icfg = ForestConfig(**dict(cfg_kw, feature_mode="importance")).resolved(xb.shape[1])
    sh, xl, base, wl, _, _ = dist_prf._local_inputs(xb, y, w, None, icfg, mesh, ("data",), "model")
    m_loc = dist_prf._dimred_sharded(xl, base, wl, icfg, torch.from_numpy(u), mesh)
    out["dimred"] = mesh.all_gather(m_loc, "model").permute(1, 0, 2).reshape(
        m_loc.shape[0], -1).numpy()
    out["draws"] = forest_np(dist_prf.fit_sharded_from_draws(xb, y, icfg, mesh, w, mask))

    out["merge"] = merge_case(mesh)

    if sys_case is not None:
        xtr, ytr, xte, yte, sys_kw = sys_case
        train_fn, _ = dist_prf.make_prf_train_fn(ForestConfig(**sys_kw), mesh)
        f = train_fn(xtr, ytr, 0)
        out["accuracy"] = float(np.mean(dist_prf.predict_sharded(f, xte, mesh) == yte))
    return out


def streamed(shape, xb, y, w, cfg_kw, blocks_at, quarantined, raw, edge_blocks):
    """The mesh-streamed growth over ragged blocks ({psum, psum_scatter} x
    reuse off / on), a quarantined block, streamed OOB and prediction,
    and the sharded bin fitting."""
    mesh = make_mesh(shape, device="cpu")
    blocks = np.split(xb, blocks_at)
    out = {}
    for hr in ("psum", "psum_scatter"):
        for reuse in ("off", "on"):
            cfg = ForestConfig(**cfg_kw, hist_reduce=hr, hist_reuse=reuse)
            out["stream", hr, reuse] = forest_np(
                dist_prf.grow_forest_streamed_sharded(blocks, y, w, cfg, mesh))
    cfg = ForestConfig(**cfg_kw, hist_reuse="off")
    out["quarantined"] = forest_np(dist_prf.grow_forest_streamed_sharded(
        blocks, y, w, cfg, mesh, quarantined=quarantined))
    forest = dist_prf.grow_sharded(xb, y, w, cfg, mesh)
    out["oob_streamed"] = dist_prf.oob_accuracy_streamed_sharded(forest, blocks, y, w, mesh).numpy()
    out["predict_streamed"] = dist_prf.predict_streamed_sharded(forest, blocks, mesh)
    out["predict"] = dist_prf.predict_sharded(forest, xb, mesh)
    out["edges"] = dist_prf.fit_bins_sharded(raw, 16, mesh, sample_block=edge_blocks)
    return out


def _drill(grow, kill_at, ckpt_dir):
    """Grow with a checkpoint every level, killed after level ``kill_at``;
    resume from the directory; return (resumed forest, first resumed level)."""
    try:
        grow(manager=CheckpointManager(ckpt_dir, keep=3, save_interval=1), resume_from=None,
             on_level=lambda level, _: (_ for _ in ()).throw(Kill()) if level == kill_at else None)
        raise AssertionError("the kill did not fire")
    except Kill:
        pass
    resumed = []
    f = grow(manager=None, resume_from=ckpt_dir, on_level=lambda level, _: resumed.append(level))
    return forest_np(f), min(resumed)


def resume(shape, xb, y, w, cfg_kw, block, ckpt_root, elastic_dir):
    """Kill and resume, mesh-resident and mesh-streamed, at levels 1 and 3
    (reuse off and on); then a run killed at level 3 whose checkpoint
    (``elastic_dir``) another mesh shape resumes (``resume_elastic``)."""
    import os

    mesh = make_mesh(shape, device="cpu")
    out = {}
    for reuse in ("off", "on"):
        cfg = ForestConfig(**cfg_kw, hist_reuse=reuse)
        cfgs = ForestConfig(**cfg_kw, hist_reuse=reuse, sample_block=block)
        for kill_at in (1, 3):
            for tag, grow in (
                ("resident", lambda **kw: dist_prf.grow_sharded_checkpointed(
                    xb, y, w, cfg, mesh, **kw)),
                ("streamed", lambda **kw: dist_prf.grow_forest_streamed_sharded(
                    xb, y, w, cfgs, mesh, **kw)),
            ):
                d = os.path.join(ckpt_root, f"{tag}-{reuse}-{kill_at}")
                out[tag, reuse, kill_at] = _drill(grow, kill_at, d)
    for tag, c in (("resident", ForestConfig(**cfg_kw, hist_reuse="on")),
                   ("streamed", ForestConfig(**cfg_kw, hist_reuse="on", sample_block=block))):
        grow = dist_prf.grow_sharded_checkpointed if tag == "resident" else \
            dist_prf.grow_forest_streamed_sharded
        try:
            grow(xb, y, w, c, mesh, manager=CheckpointManager(os.path.join(elastic_dir, tag),
                                                               keep=3, save_interval=1),
                 on_level=lambda level, _: (_ for _ in ()).throw(Kill()) if level == 3 else None)
        except Kill:
            pass
    return out


def resume_elastic(shape, xb, y, w, cfg_kw, block, elastic_dir):
    """Resume the checkpoints another mesh shape wrote (killed at level 3)."""
    import os

    mesh = make_mesh(shape, device="cpu")
    out = {}
    for tag, c in (("resident", ForestConfig(**cfg_kw, hist_reuse="on")),
                   ("streamed", ForestConfig(**cfg_kw, hist_reuse="on", sample_block=block))):
        grow = dist_prf.grow_sharded_checkpointed if tag == "resident" else \
            dist_prf.grow_forest_streamed_sharded
        resumed = []
        f = grow(xb, y, w, c, mesh, resume_from=os.path.join(elastic_dir, tag),
                 on_level=lambda level, _: resumed.append(level))
        out[tag] = (forest_np(f), min(resumed))
    return out


def loaded_modules():
    """Modules of JAX, the reference or msgpack a rank has loaded."""
    import sys

    make_mesh((torch.distributed.get_world_size(),), ("data",), device="cpu")
    return sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "repro", "msgpack"))


def merge_inputs(m: int, k: int = 3, S: int = 4, C: int = 2):
    """Feature shard ``m``'s split leaders for ``merge_case``: gains with
    exact ties across shards and NaN rows (zero mass) on every shard."""
    rng = np.random.default_rng(100 + m)
    gr = rng.choice(np.float32([0.25, 0.5, 0.75]), size=(k, S))
    gr[0, 1] = np.nan                           # a zero-mass row on every shard
    gr[1, 2] = np.nan if m == 0 else 0.5        # NaN on one shard only
    feat = rng.integers(0, 4, (k, S)).astype(np.int32)
    thr = rng.integers(0, 8, (k, S)).astype(np.int32)
    lc = rng.integers(0, 9, (k, S, C)).astype(np.float32)
    rc = rng.integers(0, 9, (k, S, C)).astype(np.float32)
    n = (lc + rc).sum(-1)
    return gr, feat, thr, lc, rc, n


def merge_case(mesh):
    """``_global_best_splits`` over the feature axis on ``merge_inputs``
    (global feature ids ``local + 4 m``)."""
    from repro_torch.core.gain import SplitScores

    m = mesh.index("model")
    gr, feat, thr, lc, rc, n = (torch.from_numpy(a) for a in merge_inputs(m))
    scores, n_node, mine = dist_prf._global_best_splits(
        mesh, SplitScores(gr, feat, thr, lc, rc), n, ("model",), feat + 4 * m, n_bins=8)
    return {"gain": scores.gain_ratio.numpy(), "feature": scores.feature.numpy(),
            "threshold": scores.threshold.numpy(), "left": scores.left_counts.numpy(),
            "right": scores.right_counts.numpy(), "n": n_node.numpy(), "mine": mine.numpy()}


VOTE_MESHES = (((4,), ("data",), "data"), ((2, 2), ("data", "model"), "data"),
               ((2, 2), ("data", "model"), "model"))


def sharded_vote(cases, uneven):
    """``serving.make_sharded_vote_fn`` on each of ``VOTE_MESHES``:
    ``cases`` maps a name to (forest arrays, config kwargs, binned rows);
    the result holds each case's labels or values, and whether a forest
    whose trees do not divide over the axis (``uneven``, the same form)
    was refused with ``ValueError``."""
    from repro_torch.convert import forest_from_numpy
    from repro_torch.serving import make_sharded_vote_fn

    out = {}
    for shape, axes, tree_axis in VOTE_MESHES:
        mesh = make_mesh(shape, axes, device="cpu")
        for name, (arrays, cfg_kw, xb) in cases.items():
            forest = forest_from_numpy(arrays, ForestConfig(**cfg_kw), "cpu")
            fn = make_sharded_vote_fn(forest, mesh, tree_axis=tree_axis)
            out[shape, tree_axis, name] = fn(xb).numpy()
        arrays, cfg_kw, _ = uneven
        try:
            make_sharded_vote_fn(forest_from_numpy(arrays, ForestConfig(**cfg_kw), "cpu"), mesh,
                                 tree_axis=tree_axis)
            out[shape, tree_axis, "refused"] = False
        except ValueError:
            out[shape, tree_axis, "refused"] = True
    return out

"""Traffic kind ``score``: one client re-scores a table with a trained forest, back to back.

The batch-inference job of a trained forest: set-up makes the rows and
the draws from the seed and trains the forest (``fit_prf_from_draws``,
the training the scoring needs), then warms up the scoring call. The
window is a closed loop of ``PRFModel.predict`` calls, each given the
whole host table of held-out rows, until the first call that ends at or
after ``--seconds``. The table is a numpy array over page-locked memory,
staged once in set-up as a job that re-scores a table keeps it: the
copy a client of pageable memory pays is outside this traffic.

End to end: ``score_rows_per_s`` (all rows scored in the window over
its seconds), ``peak_gib`` (the device's peak over the window) and
``setup_s``. A traced run replays the calls stage by stage (the rows'
copy and binning, the traversal and vote, the labels' copy), the first
``traced_calls`` under the profiler.

``correct``: the plain reference grows the forest again from the same
rows and draws and votes on the same table in float64. ``vote_gap`` is
the widest gap by which a label that a sampled call (drawn from the
seed, and the last call) answered lies below the reference's best class,
over the row's whole vote: a sound change of the vote's summation order
reads a few float32 roundings, a wrong label its row's margin. Set-up's
training is judged as a training cell judges it (``compare.TrainingJudge``).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from prfbench import compare, devtrace, gen, program, reference, work
from prfbench.harness import GIB, Outcome, Record


def _keep(kept: list, i: int, labels, rng, k: int) -> None:
    """Reservoir sampling: after call ``i`` every call so far is kept with
    the same chance, k of them in all."""
    if i < k:
        kept.append(labels)
    else:
        j = int(rng.integers(0, i + 1))
        if j < k:
            kept[j] = labels


def run(ctx) -> Outcome:
    cfg, dev, p = ctx.config, ctx.device, ctx.params
    table = gen.make_table(cfg, ctx.seed, dev)
    x, y = table["x"], table["y"]
    xt = gen.host_table(table["x_test"], dev)
    del table
    spec = reference.spec_from(cfg["forest"], cfg["n_classes"], cfg["n_features"])
    w, u = gen.make_draws(spec.n_trees, len(y), spec.n_features, ctx.seed, dev)
    model = program.fit(x, y, program.forest_config(cfg), w, u, dev)
    trained = program.outputs(model)
    del w, u
    devtrace.release(dev)
    for _ in range(p["warmup_calls"]):
        program.predict(model, xt)
    devtrace.reset_peak(dev)
    rng = np.random.default_rng(gen.sub_seed(ctx.seed, 2))
    kept, last = [], None
    t_start = time.perf_counter()
    setup_s = t_start - ctx.t0
    rec = None
    calls = 0
    if not ctx.trace:
        each = []
        while calls == 0 or time.perf_counter() - t_start < ctx.seconds:
            t = time.perf_counter()
            last = program.predict(model, xt)
            each.append(time.perf_counter() - t)
            _keep(kept, calls, last, rng, p["sample_calls"])
            calls += 1
    else:
        before = program.counters()
        first, tr = devtrace.profiled(
            lambda: [program.replay_predict(model, xt, devtrace.Spans(dev))
                     for _ in range(p["traced_calls"])], dev)
        after = program.counters()
        for last in first:
            _keep(kept, calls, last, rng, p["sample_calls"])
            calls += 1
        spans, walls = devtrace.Spans(dev), []
        while calls == p["traced_calls"] or time.perf_counter() - t_start < ctx.seconds:
            t = time.perf_counter()
            last = program.replay_predict(model, xt, spans)
            walls.append(time.perf_counter() - t)
            _keep(kept, calls, last, rng, p["sample_calls"])
            calls += 1
        rec = Record(spans=dict(spans.seconds), walls=walls, trace=tr,
                     launches={k: after[k] - before[k] for k in after}, work={},
                     replays_traced=p["traced_calls"])
    window_s = time.perf_counter() - t_start
    if not ctx.trace:
        devtrace.report_window("calls", each)
    peak_window = devtrace.peak_bytes(dev)
    del model
    devtrace.release(dev)

    w, u = gen.make_draws(spec.n_trees, len(y), spec.n_features, ctx.seed, dev)
    ref = reference.train(x, y, w, u, spec, dev)
    setup_numbers = compare.TrainingJudge(ref, w, spec).numbers(trained)
    del w, u
    xbt = reference.digitize(torch.from_numpy(xt).to(dev), ref["edges"])
    scores = reference.vote_scores(ref["forest"], ref["tree_weight"], xbt, spec, torch.float64)
    judged = list({id(a): a for a in kept + [last]}.values())
    gaps = [compare.vote_gap(got, scores) for got in judged]
    limits = p["limits"]
    checks = [("vote_gap", max(gaps), limits["vote_gap"])]
    checks += [(name, v, limits[name]) for name, v in setup_numbers.items()]
    bad = [g > limits["vote_gap"] for g in gaps]
    if rec is not None:
        counts = work.traverse_counts(ref["forest"], xbt, spec.max_depth)
        rec.work = {"traverse": work.traverse_work(xbt.shape[0], spec.n_features, counts, spec),
                    "binning": work.binning_work(xbt.shape[0], spec.n_features, spec.n_bins)}
    return Outcome(e2e={"score_rows_per_s": len(xt) * calls / window_s,
                        "peak_gib": peak_window / GIB, "setup_s": setup_s},
                   checks=checks, attempted=calls, failed=sum(1 for b in bad if b),
                   memory_peak_bytes=peak_window, record=rec)

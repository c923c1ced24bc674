"""Traffic kind ``train``: one client retrains the forest back to back.

A closed loop of one job at a time, as a user retrains on a table: each
training is a fresh ``fit_prf_from_draws`` on the host rows, with the
same draws, and nothing one training computed is handed to the next.
Set-up makes the rows and the draws from the seed and runs one training
(the first run in a checkout builds the kernels there); the window then
runs trainings until the first one that ends at or after ``--seconds``.

End to end: ``train_s`` (the window's seconds over its trainings),
``peak_gib`` (the device's peak over the window) and ``setup_s``. A
traced run replays the trainings stage by stage instead (each stage a
span), the first replay under the profiler.

``correct``, each training judged against the plain reference, which
works the training out again from the same rows and draws:

* ``edges_mismatch``: bin edges that are not the reference's bit for bit
  (one formula, numpy's linear quantiles; limit 0);
* ``count_mismatch``: class counts the forest stores at a node that are
  not the in-bag counts its own splits route there (sums of integer
  weights, exact in any order; limit 0);
* ``trees_differ_pct``: the share of trees whose node arrays or OOB
  weight (and, in a traced run, feature mask) are not the reference's
  bit for bit; its limit, the cell's, lies between what a sound change
  of summation order reads and what a lowered precision reads.
"""
from __future__ import annotations

import time

from prfbench import compare, devtrace, gen, program, reference, work
from prfbench.harness import GIB, Outcome, Record


def run(ctx) -> Outcome:
    cfg, dev = ctx.config, ctx.device
    table = gen.make_table(cfg, ctx.seed, dev)
    x, y = table["x"], table["y"]
    del table
    spec = reference.spec_from(cfg["forest"], cfg["n_classes"], cfg["n_features"])
    w, u = gen.make_draws(spec.n_trees, len(y), spec.n_features, ctx.seed, dev)
    fcfg = program.forest_config(cfg)
    answers = [program.outputs(program.fit(x, y, fcfg, w, u, dev))]        # set-up's training
    masks = [None]
    devtrace.sync(dev)
    devtrace.reset_peak(dev)
    t_start = time.perf_counter()
    setup_s = t_start - ctx.t0
    rec = None
    if not ctx.trace:
        n, each = 0, []
        while n == 0 or time.perf_counter() - t_start < ctx.seconds:
            t = time.perf_counter()
            answers.append(program.outputs(program.fit(x, y, fcfg, w, u, dev)))
            masks.append(None)
            devtrace.sync(dev)
            each.append(time.perf_counter() - t)
            n += 1
        window_s = time.perf_counter() - t_start
        devtrace.report_window("trainings", each)
    else:
        before = program.counters()
        (model, mask), tr = devtrace.profiled(
            lambda: program.replay_fit(x, y, fcfg, w, u, dev, devtrace.Spans(dev)), dev)
        after = program.counters()
        answers.append(program.outputs(model))
        masks.append(mask)
        del model
        spans, walls, n = devtrace.Spans(dev), [], 1
        while n == 1 or time.perf_counter() - t_start < ctx.seconds:
            t = time.perf_counter()
            model, mask = program.replay_fit(x, y, fcfg, w, u, dev, spans)
            walls.append(time.perf_counter() - t)
            answers.append(program.outputs(model))
            masks.append(mask)
            del model
            n += 1
        window_s = time.perf_counter() - t_start
        rec = Record(spans=dict(spans.seconds), walls=walls, trace=tr,
                     launches={k: after[k] - before[k] for k in after}, work={}, replays_traced=1)
    peak_window = devtrace.peak_bytes(dev)
    devtrace.release(dev)

    ref = reference.train(x, y, w, u, spec, dev)
    judge = compare.TrainingJudge(ref, w, spec)
    per_answer = [judge.numbers(a, m) for a, m in zip(answers, masks)]
    limits = ctx.params["limits"]
    checks = [(name, max(p[name] for p in per_answer), limits[name]) for name in per_answer[0]]
    failed = sum(1 for p in per_answer[1:] if any(p[name] > limits[name] for name in p))
    if rec is not None:
        rec.work = train_work(ref, w, spec, cfg)
    return Outcome(e2e={"train_s": window_s / n, "peak_gib": peak_window / GIB, "setup_s": setup_s},
                   checks=checks, attempted=n, failed=failed, memory_peak_bytes=peak_window,
                   record=rec)


def train_work(ref: dict, w, spec, cfg) -> dict:
    """The work of one training, by layer, counted on the reference's forest
    (the program's, when the run is correct)."""
    reuse = work.reuse_resolves_on(cfg["forest"], spec.n_features, spec.n_classes)
    levels = work.level_counts(ref["forest"], ref["bins"], w, ref["mask"], spec, reuse)
    hist = work.dimred_hist_work(w, spec)
    hist += work.growth_hist_work(levels, spec)
    N, F = ref["bins"].shape
    return {"hist": hist, "split_scan": work.split_scan_work(levels, spec),
            "oob": work.oob_work(w, work.traverse_counts(ref["forest"], ref["bins"],
                                                         spec.max_depth), spec),
            "bin_fit": work.bin_fit_work(N, F), "binning": work.binning_work(N, F, spec.n_bins)}

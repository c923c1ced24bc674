"""Read the program's own spans (``repro_torch.tracing``) on a cell of the benchmark, on the card.

    PYTHONPATH=src python3 tools/program_spans.py --workload covtype.train --seed N
    PYTHONPATH=src python3 tools/program_spans.py --workload higgs.score --seed N

Makes the cell's inputs from the seed as its traffic kind does
(``prfbench/gen.py``; the scoring table in page-locked memory), trains
once to warm up, then:

1. the program-span phase (``prfbench/programtrace.phase``) through the
   real entry point: a training cell 3 trainings without the profiler
   and 1 under it, a scoring cell 100 calls without and ``traced_calls``
   under it. Reports the plain calls' span seconds a call, the mean of a
   synced ``growth.level``, the device operations launched inside each
   span a profiled call, the share of the profiled window's idle device
   time under a program span other than a call's root and under none,
   the device operations the trace could not match, and the gap between
   each span's recorded and profiled durations;
2. the phase's answers judged as the cell judges its own, against the
   plain reference (``prfbench/reference.py``);
3. the cost of recording on: ``TURNS`` trainings or calls a side with
   recording off and on in turns (off, on, on, off, ...), each training
   ending in a synchronise, in this one process; and the host's cost of
   one span, off and on, over a million empty spans.

The set-up and the judging repeat those of ``prfbench/kinds/train.py``
and ``prfbench/kinds/score.py``. Prints one JSON line.
"""
import argparse
import json
import statistics
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from prfbench import compare, devtrace, gen, harness, program, programtrace, reference  # noqa: E402
from repro_torch import tracing  # noqa: E402

PROFILED = {"train": 1, "score": None}     # None: the cell's ``traced_calls``
PLAIN = {"train": 3, "score": 100}
TURNS = {"train": 8, "score": 800}        # trainings or calls a side of the cost's turns
ROOT = {"train": "fit", "score": "predict"}
SPANS = 1_000_000                          # empty spans timed a side


def _turns(fn, turns: int) -> dict:
    """Seconds of each call of ``fn``, off and on, in turns: off, on, on, off, ..."""
    out = {"off": [], "on": []}
    for t in range(turns):
        for side in (("off", "on"), ("on", "off"))[t % 2]:
            if side == "on":
                with tracing.recording() as rec:
                    t0 = time.perf_counter()
                    fn()
                    out[side].append(time.perf_counter() - t0)
                rec.drain()
            else:
                t0 = time.perf_counter()
                fn()
                out[side].append(time.perf_counter() - t0)
    off, on = statistics.fmean(out["off"]), statistics.fmean(out["on"])
    med_off, med_on = statistics.median(out["off"]), statistics.median(out["on"])
    return {"n": turns, "off_mean_s": off, "on_mean_s": on, "cost_pct": 100.0 * (on - off) / off,
            "off_median_s": med_off, "on_median_s": med_on,
            "median_cost_pct": 100.0 * (med_on - med_off) / med_off}


def _span_ns() -> dict:
    """Host nanoseconds of one empty span, recording off and on."""
    def timed():
        t0 = time.perf_counter_ns()
        for _ in range(SPANS):
            with tracing.span("x"):
                pass
        return (time.perf_counter_ns() - t0) / SPANS
    off = timed()
    with tracing.recording() as rec:
        on = timed()
    rec.drain()
    return {"off": off, "on": on}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args()
    c = harness.cell(harness.manifest(), args.workload)
    cfg, p, dev = c.config, c.params, torch.device("cuda")
    table = gen.make_table(cfg, args.seed, dev)
    x, y = table["x"], table["y"]
    xt = gen.host_table(table["x_test"], dev)
    del table
    spec = reference.spec_from(cfg["forest"], cfg["n_classes"], cfg["n_features"])
    w, u = gen.make_draws(spec.n_trees, len(y), spec.n_features, args.seed, dev)
    fcfg = program.forest_config(cfg)
    model = program.fit(x, y, fcfg, w, u, dev)
    devtrace.sync(dev)
    out = {"workload": args.workload, "seed": args.seed, "device": torch.cuda.get_device_name(0)}

    if c.kind == "train":
        def call():
            a = program.outputs(program.fit(x, y, fcfg, w, u, dev))
            devtrace.sync(dev)
            return a
    else:
        for _ in range(p["warmup_calls"]):
            program.predict(model, xt)

        def call():
            return program.predict(model, xt)
    profiled_n = PROFILED[c.kind] or p["traced_calls"]
    t0 = time.perf_counter()
    answers, prog = programtrace.phase(tracing, call, profiled_n, PLAIN[c.kind], dev)
    out["phase_s"] = time.perf_counter() - t0
    tr = prog["trace"]
    gaps = programtrace.clock_gaps_ns(prog["profiled_spans"], tr.ranges)
    out["idle_covered_share"] = tr.covered_share()
    out["idle_outside_share"] = tr.outside_share()
    out["idle_s"] = dict(sorted(tr.idle_s.items(), key=lambda kv: -kv[1]))
    out["unmatched"] = tr.unmatched
    out["busy_s"], out["window_s"] = tr.busy_s, tr.window_s
    out["clock_gaps_ns"] = None if gaps is None else {
        "spans": len(gaps), "within": sum(g <= programtrace.CLOCK_GAP_NS for g, _ in gaps),
        "widest": gaps[:5]}
    calls, per_call = sum(s.name == ROOT[c.kind] for s in prog["spans"]), defaultdict(float)
    for s in prog["spans"]:
        per_call[s.name] += s.seconds / calls
    out["span_per_call_s"] = dict(per_call)
    synced = [s.seconds for s in prog["spans"] if s.name == "growth.level" and s.synced]
    out["synced_level_mean_s"] = statistics.fmean(synced) if synced else None
    out["launches_per_call"] = {k: v / profiled_n for k, v in tr.launches.items()}
    out["cost"] = _turns(call, TURNS[c.kind])
    out["span_ns"] = _span_ns()

    del model
    devtrace.release(dev)
    ref = reference.train(x, y, w, u, spec, dev)
    limits = p["limits"]
    if c.kind == "train":
        judge = compare.TrainingJudge(ref, w, spec)
        nums = [judge.numbers(a) for a in answers]
        checks = {k: max(n[k] for n in nums) for k in nums[0]}
    else:
        xbt = reference.digitize(torch.from_numpy(np.asarray(xt)).to(dev), ref["edges"])
        scores = reference.vote_scores(ref["forest"], ref["tree_weight"], xbt, spec, torch.float64)
        checks = {"vote_gap": max(compare.vote_gap(a, scores) for a in answers)}
    out["checks"] = {k: {"value": v, "limit": limits[k]} for k, v in checks.items()}
    out["correct"] = all(v <= limits[k] for k, v in checks.items())
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Readings that set the limits of ``correct``: the program, the control and planted faults.

    python3 prfbench/calibrate.py --workload <cell> --seeds <n> [<n> ...] [--out FILE]

For each seed, at the cell's own size, one process reads each number the
cell compares (``compare.py``) for:

* ``program``: the program's answer on the timed path (one training, or
  one scoring call on the whole test table, after the set-up the cell
  runs): the lower reading;
* ``reordered``: the reference with every float sum whose order the
  algorithm leaves open taken in another order: what a sound change of
  summation order in the program would read, set beside the lower reading;
* ``control``: the reference put in the program's place, computed in the
  precision below the configuration's float32 (bfloat16 histograms for a
  training, and for set-up's training in a scoring cell,
  ``control_training``; for scoring the rows copied as bfloat16 before
  they are binned, and ``control_vote``, a bfloat16 vote): the upper
  reading;
* the faults a cell can have, planted in the reference put in the
  program's place: a training that returns its initial forest, half the
  rows left out, one answer altered where it is produced.

One JSON line a seed goes to standard output (and to ``--out``). The
benchmark's own runs never run this.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path[0] = str(ROOT)
    sys.path.insert(1, str(ROOT / "src"))

import torch  # noqa: E402

from prfbench import compare, devtrace, gen, harness, program, reference  # noqa: E402


def _answer(forest: reference.Forest, tree_weight, edges) -> dict:
    return {**{f: getattr(forest, f) for f in reference.Forest.FIELDS},
            "tree_weight": tree_weight, "edges": edges}


def _of(r: dict) -> dict:
    return _answer(r["forest"], r["tree_weight"], r["edges"])


def train_readings(cfg: dict, seed: int, dev) -> dict:
    table = gen.make_table(cfg, seed, dev)
    x, y = table["x"], table["y"]
    spec = reference.spec_from(cfg["forest"], cfg["n_classes"], cfg["n_features"])
    w, u = gen.make_draws(spec.n_trees, len(y), spec.n_features, seed, dev)
    t = time.perf_counter()
    got = program.outputs(program.fit(x, y, program.forest_config(cfg), w, u, dev))
    devtrace.sync(dev)
    fit_s = time.perf_counter() - t
    devtrace.release(dev)
    t = time.perf_counter()
    ref = reference.train(x, y, w, u, spec, dev)
    judge = compare.TrainingJudge(ref, w, spec)
    out = {"program": judge.numbers(got)}
    devtrace.sync(dev)
    out.update(fit_s=fit_s, reference_s=time.perf_counter() - t)
    alt = reference.train(x, y, w, u, spec, dev, reordered=True)
    out["reordered"] = judge.numbers(_of(alt), alt["mask"])
    out["reordered_masks_differ_pct"] = 100.0 * float(
        (alt["mask"] != ref["mask"]).any(dim=1).float().mean())
    del alt
    ctl = reference.train(x, y, w, u, spec, dev, hist_dtype=torch.bfloat16)
    out["control"] = judge.numbers(_of(ctl))
    del ctl
    f = ref["forest"]
    root = reference.Forest(feature=torch.full_like(f.feature, -1),
                            threshold=torch.zeros_like(f.threshold),
                            left_child=torch.full_like(f.left_child, -1),
                            class_counts=torch.where(
                                torch.arange(f.class_counts.shape[1], device=dev)[None, :, None] == 0,
                                f.class_counts, torch.zeros_like(f.class_counts)))
    out["fault_unchanged"] = judge.numbers(_answer(root, ref["tree_weight"], ref["edges"]))
    h = len(y) // 2
    half = reference.train(x[:h], y[:h], w[:, :h].contiguous(), u, spec, dev)
    out["fault_half_rows"] = judge.numbers(_of(half))
    del half
    counts = f.class_counts.clone()
    counts[0, 0, 0] += 1
    altered = reference.Forest(f.feature, f.threshold, f.left_child, counts)
    out["fault_altered"] = judge.numbers(_answer(altered, ref["tree_weight"], ref["edges"]))
    return out


def score_readings(cfg: dict, params: dict, seed: int, dev) -> dict:
    table = gen.make_table(cfg, seed, dev)
    x, y = table["x"], table["y"]
    xt = gen.host_table(table["x_test"], dev)
    spec = reference.spec_from(cfg["forest"], cfg["n_classes"], cfg["n_features"])
    w, u = gen.make_draws(spec.n_trees, len(y), spec.n_features, seed, dev)
    model = program.fit(x, y, program.forest_config(cfg), w, u, dev)
    for _ in range(params["warmup_calls"]):
        program.predict(model, xt)
    t = time.perf_counter()
    got = program.predict(model, xt)
    call_s = time.perf_counter() - t
    trained = program.outputs(model)
    del model
    devtrace.release(dev)
    ref = reference.train(x, y, w, u, spec, dev)
    judge = compare.TrainingJudge(ref, w, spec)
    alt = reference.train(x, y, w, u, spec, dev, reordered=True)
    alt_numbers = judge.numbers(_of(alt), alt["mask"])
    del alt
    ctl = reference.train(x, y, w, u, spec, dev, hist_dtype=torch.bfloat16)
    ctl_numbers = judge.numbers(_of(ctl))
    del ctl
    xbt = reference.digitize(torch.from_numpy(xt).to(dev), ref["edges"])
    scores = reference.vote_scores(ref["forest"], ref["tree_weight"], xbt, spec, torch.float64)

    def gap(labels):
        return compare.vote_gap(labels, scores)

    def labels(xb=xbt, **kw):
        return reference.predict(ref["forest"], ref["tree_weight"], xb, spec, **kw)

    want = labels()
    x16 = torch.from_numpy(xt).to(dev).to(torch.bfloat16).to(torch.float32)
    flipped = want.clone()
    flipped[0] = (flipped[0] + 1) % spec.n_classes
    return {"program": {"vote_gap": gap(got), **judge.numbers(trained)},
            "call_s": call_s,
            "reference_f32": {"vote_gap": gap(want)},
            "reordered": {"vote_gap": gap(labels(reordered=True)), **alt_numbers},
            "control": {"vote_gap": gap(labels(reference.digitize(x16, ref["edges"])))},
            "control_vote": {"vote_gap": gap(labels(score_dtype=torch.bfloat16))},
            "control_training": ctl_numbers,
            "fault_half_rows": {"vote_gap": gap(want[: len(want) // 2])},
            "fault_altered": {"vote_gap": gap(flipped)}}


def main(argv) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    c = harness.cell(harness.manifest(), args.workload)
    dev = torch.device("cuda")
    for seed in args.seeds:
        t = time.perf_counter()
        if c.kind == "train":
            r = train_readings(c.config, seed, dev)
        else:
            r = score_readings(c.config, c.params, seed, dev)
        line = json.dumps({"workload": c.name, "seed": seed, "seconds": time.perf_counter() - t,
                           "device": torch.cuda.get_device_name(0), **r})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        devtrace.release(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

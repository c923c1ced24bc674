"""A configuration, a cell and a per-layer metric are added by new files alone."""
import json
import shutil
import time

from prfbench import harness


def test_new_files_are_found_without_an_edit(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(harness.HERE, root / "prfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    here = root / "prfbench"
    before = {p.relative_to(root): p.read_bytes() for p in here.rglob("*") if p.is_file()}

    cfg = harness.read_json(here / "configs" / "covtype.json")
    cfg.update(name="tiny", train_rows=1000, test_rows=300)
    cfg["forest"].update(n_trees=4, max_depth=3, n_bins=16, tree_chunk=4)
    (here / "configs" / "tiny.json").write_text(json.dumps(cfg))
    (here / "workloads" / "tiny.train.json").write_text(
        json.dumps({"name": "tiny.train", "config": "tiny", "traffic": "train",
                    "params": harness.read_json(here / "workloads" / "covtype.train.json")["params"]}))
    (here / "metrics" / "replays.train.py").write_text(
        '"""replays.train: untraced replays in a traced run."""\n\n\n'
        "def read(rec):\n    return len(rec.walls)\n")
    man = json.loads((root / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "tiny", "source": "a test", "file": "prfbench/configs/tiny.json",
                           "reduced": [], "why": "a test"})
    man["workloads"].append({"name": "tiny.train", "config": "tiny", "traffic": "train",
                             "chips": 1, "why": "a test"})
    for m in man["end_to_end"]:
        if "train_s" in m["name"] or m["name"] == "peak_gib":
            m["workloads"].append("tiny.train")
    man["per_layer"].append({"name": "replays.train", "unit": "replays", "better": "higher",
                             "source": "host_clock", "layer": "API", "moves": "train_s",
                             "workloads": ["tiny.train"]})
    (root / "BENCHMARK.json").write_text(json.dumps(man))

    c = harness.cell(man, "tiny.train", here=here, root=root)
    assert c.kind == "train" and c.config["name"] == "tiny"
    assert "replays.train" in {m["name"] for m in c.per_layer}
    line = harness.run_cell(c, 7, 0.01, True, "cpu", time.perf_counter(), here=here)
    assert line["correct"] and line["metrics"]["replays.train"]["value"] >= 1
    after = {p.relative_to(root): p.read_bytes() for p in here.rglob("*")
             if p.is_file() and p.relative_to(root) in before}
    assert after == before          # nothing that was there changed

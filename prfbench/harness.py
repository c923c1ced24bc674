"""The benchmark's driver: finds a cell's files by name, runs it, prints its line.

Everything is found by the names in ``BENCHMARK.json`` at the root of
the checkout:

* a configuration: the file its entry names (``configs/<name>.json``);
* a traffic mix: ``traffic/<traffic>.json``, whose ``kind`` names the
  general generator that reads it, ``kinds/<kind>.py``;
* a cell: ``workloads/<cell>.json`` (its configuration, its traffic and
  the parameters it sets over the traffic's);
* a per-layer metric: ``metrics/<metric>.py``, its reader.

A later change adds a configuration, a cell or a metric by adding files
and entries; no file here names one.

A kind's ``run(ctx)`` makes the inputs from the seed, sets the program
up, measures the window, reads the device's peak, frees the program's
state, runs the plain reference and returns an ``Outcome``. This module
adds the per-layer metrics of a traced run, refuses a run that loaded
JAX, and prints the result as the last line of standard output, each
compared number beside its limit on standard error and under the
line's last key.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
import sys
import traceback
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "prfbench"
BANNED = ("jax", "jaxlib", "flax", "repro")     # top-level module names, compared whole
GIB = float(1 << 30)


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(root: Path = ROOT) -> dict:
    return read_json(root / "BENCHMARK.json")


def load_module(path: Path, prefix: str):
    """A module from its file; names may hold dots, so the module gets a safe one."""
    name = f"prfbench_{prefix}_" + re.sub(r"\W", "_", path.stem)
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no module at {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    kind: str
    params: dict
    end_to_end: list          # the manifest's entries this cell reports
    per_layer: list


def cell(man: dict, name: str, here: Path = HERE, root: Path = ROOT) -> Cell:
    """A cell's spec, each part found by its name."""
    entry = next((w for w in man["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in man["configs"] if c["name"] == entry["config"])
    traffic = read_json(here / "traffic" / f"{entry['traffic']}.json")
    own = read_json(here / "workloads" / f"{name}.json")
    if (own["config"], own["traffic"]) != (entry["config"], entry["traffic"]):
        raise ValueError(f"workloads/{name}.json names {own['config']}/{own['traffic']}, "
                         f"BENCHMARK.json {entry['config']}/{entry['traffic']}")
    e2e = [m for m in man["end_to_end"] if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    layer = [m for m in man["per_layer"]
             if (name in m["workloads"] if "workloads" in m else m["moves"] in moved)]
    return Cell(name=name, chips=entry["chips"], config=read_json(root / conf["file"]),
                kind=traffic["kind"], params={**traffic.get("params", {}), **own.get("params", {})},
                end_to_end=e2e, per_layer=layer)


@dataclasses.dataclass
class Context:
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: object            # torch.device
    t0: float                 # host clock at the process's start

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def params(self) -> dict:
        return self.cell.params


@dataclasses.dataclass
class Record:
    """What a traced run's per-layer readers read."""
    spans: dict               # stage -> host seconds of each untraced replay
    walls: list               # host seconds of each untraced replay
    trace: object             # devtrace.Trace of the profiled replays
    launches: dict            # program counter -> launches during the profiled replays
    work: dict                # layer -> work.Work of one replay
    replays_traced: int


@dataclasses.dataclass
class Outcome:
    e2e: dict                 # end-to-end metric -> value (untraced run)
    checks: list              # (name, value, limit): correct iff every value <= its limit
    attempted: int
    failed: int
    memory_peak_bytes: int
    record: Optional[Record] = None


def banned_loaded(modules=None) -> list:
    """The banned top-level names among ``modules`` (default: this process's)."""
    names = list(sys.modules) if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(BANNED))


def layer_metrics(c: Cell, rec: Record, here: Path = HERE) -> dict:
    """Each per-layer metric whose reader finds something to read."""
    out = {}
    for m in c.per_layer:
        value = load_module(here / "metrics" / f"{m['name']}.py", "metric").read(rec)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def run_cell(c: Cell, seed: int, seconds: float, trace: bool, device, t0: float,
             here: Path = HERE) -> dict:
    """Run one cell; returns the result line as a dict."""
    import torch

    kind = load_module(here / "kinds" / f"{c.kind}.py", "kind")
    out: Outcome = kind.run(Context(c, seed, seconds, trace, torch.device(device), t0))
    if trace:
        metrics = layer_metrics(c, out.record, here)
    else:
        metrics = {}
        for m in c.end_to_end:
            if m["name"] not in out.e2e:
                raise KeyError(f"kind {c.kind!r} reports no {m['name']}")
            metrics[m["name"]] = {"value": float(out.e2e[m["name"]]), "unit": m["unit"]}
    dev = torch.device(device)
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
                   "count": c.chips, "memory_peak_bytes": int(out.memory_peak_bytes)}
    line = {"correct": bool(out.attempted > 0 and out.failed == 0
                            and all(v <= lim for _, v, lim in out.checks)),
            "attempted": out.attempted, "failed": out.failed, "metrics": metrics,
            "device": device_info}
    if trace:
        device_info["busy_s"] = out.record.trace.busy_s
        device_info["window_s"] = out.record.trace.window_s
        line["breakdown"] = out.record.trace.breakdown()
    line["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in out.checks}
    return line


def main(argv, t0: float) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json and print its line.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        import torch

        c = cell(manifest(), args.workload)
        if not torch.cuda.is_available() or torch.cuda.device_count() < c.chips:
            print(f"prfbench: {args.workload} needs {c.chips} CUDA device(s); "
                  f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        line = run_cell(c, args.seed, args.seconds, bool(args.trace), "cuda", t0)
    except Exception:                                       # the run's one boundary
        traceback.print_exc()
        return 1
    found = banned_loaded()
    if found:
        print(f"prfbench: the run loaded {found}; the benchmark measures repro_torch alone",
              file=sys.stderr)
        return 3
    for name, chk in line["checks"].items():
        print(f"check {name}: {chk['value']} (limit {chk['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0

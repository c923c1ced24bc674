"""No run of the benchmark loads JAX or the JAX package; the reference loads nothing of the program."""
import os
import subprocess
import sys

from prfbench import harness

PROBE = r"""
import sys, time
sys.path[:0] = [{root!r}, {src!r}]
from pathlib import Path
from prfbench import harness
import prfbench.reference
assert "repro_torch" not in sys.modules, "the reference imported the program"
for p in sorted(Path({here!r}).rglob("*.py")):
    if "tests" in p.parts:
        continue
    harness.load_module(p, "probe")
sys.path.insert(0, {tests!r})
from conftest import tiny_cell
for name in ("covtype.train", "higgs.score"):
    line = harness.run_cell(tiny_cell(name, rows=1500, trees=4, depth=3), 1, 0.01, False, "cpu",
                            time.perf_counter())
    assert line["correct"], line
print("LOADED", sorted({{m.split(".")[0] for m in sys.modules}} & {{"jax", "jaxlib", "flax", "repro"}}))
"""


def test_no_run_loads_jax_or_the_jax_package():
    code = PROBE.format(root=str(harness.ROOT), src=str(harness.ROOT / "src"),
                        here=str(harness.HERE), tests=str(harness.HERE / "tests"))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                         env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LOADED []" in out.stdout, out.stdout[-2000:]


def test_banned_names_are_compared_whole():
    assert harness.banned_loaded(["repro_torch", "repro_torch.core.api", "jaxtyping", "os"]) == []
    assert harness.banned_loaded(["repro.core", "jaxlib.xla_client", "flax"]) == \
        ["flax", "jaxlib", "repro"]

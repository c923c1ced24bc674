"""Fixtures of the benchmark's CPU tests: the repository's paths, tiny cells.

A tiny cell is a cell of ``BENCHMARK.json`` with its rows and trees cut
so that its whole run (set-up, window, reference) takes a second or two
on the CPU, where the program runs its plain PyTorch path.
"""
import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips without one (run with -m cuda on the card)"
    )


def tiny_cell(name: str, rows: int = 2000, trees: int = 8, depth: int = 4, bins: int = 16,
              chunk: int = 5):
    from prfbench import harness

    c = harness.cell(harness.manifest(), name)
    cfg = copy.deepcopy(c.config)
    cfg.update(train_rows=rows, test_rows=rows // 3)
    cfg["forest"].update(n_trees=trees, max_depth=depth, n_bins=bins, tree_chunk=chunk)
    c.config = cfg
    return c


@pytest.fixture
def tiny():
    return tiny_cell


@pytest.fixture(autouse=True)
def one_thread():
    """Each test on one CPU thread: the suite's workers share the machine's
    cores, and tiny tensors gain nothing from more."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

"""The benchmark's inputs, made from ``--seed``: tabular data and the DSI draws.

One general generator reads a configuration's column groups (a data
file under ``configs/``) and makes its rows on the device with a
``torch.Generator``, in a few large calls, then hands them to the host:
the program is given host arrays, as a user's table arrives. It extends
the repository's ``make_classification`` (informative class-conditional
blobs, redundant linear mixes of them) with the column kinds the
configurations' sources have: integer-valued measurements, which tie,
and one-hot groups of a categorical attribute. Class counts are the
source's, exactly: the labels are a permutation of those counts, and a
``label_noise`` share of rows draws its features from another class.

The classes' parameters are the configuration's (its ``table_seed``);
``--seed`` draws the rows and the DSI draws. The same seed on the same
device gives the same inputs.
"""
from __future__ import annotations

import numpy as np
import torch

DRAW_TREES = 64          # trees whose bootstrap indices are drawn in one call


def sub_seed(seed: int, stream: int) -> int:
    """An independent 64-bit seed for each input stream of one run."""
    return int(np.random.SeedSequence([seed & (2 ** 64 - 1), stream]).generate_state(1, np.uint64)[0])


def class_counts(cfg: dict, rows: int) -> list:
    """Each class's rows in a split of ``rows``: the source's counts (or
    priors) scaled, the remainder given to the largest fractions."""
    src = np.asarray(cfg.get("class_counts") or cfg["class_priors"], dtype=np.float64)
    share = src / src.sum() * rows
    out = np.floor(share).astype(np.int64)
    for c in np.argsort(-(share - out), kind="stable")[: rows - int(out.sum())]:
        out[c] += 1
    return out.tolist()


def split_counts(cfg: dict) -> tuple:
    """(training, test) class counts. Where the two splits make up the
    source's rows, the test split takes the rest of each class, so the
    source's counts hold exactly."""
    train = class_counts(cfg, cfg["train_rows"])
    src = cfg.get("class_counts")
    if src is not None and sum(src) == cfg["train_rows"] + cfg["test_rows"]:
        return train, [s - t for s, t in zip(src, train)]
    return train, class_counts(cfg, cfg["test_rows"])


def _labels(counts: list, g: torch.Generator, dev) -> torch.Tensor:
    rows = sum(counts)
    counts = torch.tensor(counts, device=dev)
    y = torch.repeat_interleave(torch.arange(len(counts), device=dev), counts)
    return y[torch.randperm(rows, generator=g, device=dev)]


def _table_params(cfg: dict, g: torch.Generator, dev) -> list:
    """Each column group's class-conditional parameters, drawn once a table
    and shared by its training and test rows: blob centres, mixing weights,
    category logits."""
    C, out = cfg["n_classes"], []
    for col in cfg["columns"]:
        kind, n = col["kind"], col["count"]
        if kind in ("blobs", "integer_blobs"):
            out.append(torch.randn((C, n), generator=g, device=dev) * col["class_sep"])
        elif kind == "mixes":
            m = cfg["columns"][col["of"]]["count"]
            out.append(torch.randn((m, n), generator=g, device=dev) / float(np.sqrt(m)))
        elif kind == "one_hot":
            logits = torch.randn((C, n), generator=g, device=dev) * col["spread"]
            out.append(torch.cumsum(torch.softmax(logits.double(), dim=1), dim=1))
        else:
            raise ValueError(f"unknown column kind {kind!r}")
    return out


def _mixes(src, mix):
    """Columns that are fixed linear mixes of the ``src`` columns, summed
    left to right (no matrix product, so no rounding that depends on the
    library's blocking)."""
    out = src[:, :1] * mix[0]
    for j in range(1, src.shape[1]):
        out = out + src[:, j:j + 1] * mix[j]
    return out


def make_split(cfg: dict, params: list, counts: list, g: torch.Generator, dev) -> tuple:
    """(x [rows, F] float32, y [rows] int32) as host arrays; ``counts`` rows of each class."""
    C = cfg["n_classes"]
    y = _labels(counts, g, dev)
    rows = len(y)
    noisy = torch.rand(rows, generator=g, device=dev) < cfg["label_noise"]
    z = torch.where(noisy, torch.randint(0, C, (rows,), generator=g, device=dev), y)
    groups = []
    for col, p in zip(cfg["columns"], params):
        kind, n = col["kind"], col["count"]
        if kind in ("blobs", "integer_blobs"):
            x = p[z] + torch.randn((rows, n), generator=g, device=dev)
            groups.append(torch.round(x * col["scale"]) if kind == "integer_blobs" else x)
        elif kind == "mixes":
            groups.append(_mixes(groups[col["of"]], p))
        else:                                            # one_hot: a category per row, by its class
            u = torch.rand(rows, generator=g, device=dev, dtype=torch.float64)
            cat = torch.clamp_max(torch.searchsorted(p[z], u[:, None])[:, 0], n - 1)
            groups.append(torch.nn.functional.one_hot(cat, n).to(torch.float32))
    x = torch.cat(groups, dim=1).to(torch.float32)
    if x.shape[1] != cfg["n_features"]:
        raise ValueError(f"columns make {x.shape[1]} features, the configuration states "
                         f"{cfg['n_features']}")
    return x.cpu().numpy(), y.to(torch.int32).cpu().numpy()


def make_table(cfg: dict, seed: int, dev) -> dict:
    """The configuration's training and test rows. The classes' parameters
    come from the configuration's own ``table_seed``, the rows from ``seed``:
    every seed samples the same data set, so every seed asks the same work
    of the program, up to sampling."""
    g = torch.Generator(device=dev)
    g.manual_seed(sub_seed(cfg["table_seed"], 2))
    params = _table_params(cfg, g, dev)
    g.manual_seed(sub_seed(seed, 0))
    train, test = split_counts(cfg)
    x, y = make_split(cfg, params, train, g, dev)
    xt, yt = make_split(cfg, params, test, g, dev)
    return {"x": x, "y": y, "x_test": xt, "y_test": yt}


def host_table(x: np.ndarray, dev) -> np.ndarray:
    """The table a client hands to every call: a numpy array over
    page-locked host memory, as a job that re-scores a table stages it once
    (off the card, the array as it is)."""
    if dev.type != "cuda":
        return x
    buf = torch.empty(x.shape, dtype=torch.float32, pin_memory=True)
    out = buf.numpy()                          # the array keeps its pinned storage alive
    out[...] = x
    return out


def make_draws(n_trees: int, n_rows: int, n_features: int, seed: int, dev) -> tuple:
    """The DSI in-bag counts [k, N] float32 (each tree draws N rows with
    replacement) and the selection's uniforms [k, F], on ``dev``."""
    g = torch.Generator(device=dev)
    g.manual_seed(sub_seed(seed, 1))
    w = torch.zeros((n_trees, n_rows), dtype=torch.float32, device=dev)
    for t0 in range(0, n_trees, DRAW_TREES):
        t1 = min(t0 + DRAW_TREES, n_trees)
        idx = torch.randint(0, n_rows, (t1 - t0, n_rows), generator=g, device=dev)
        w[t0:t1].scatter_add_(1, idx, torch.ones(idx.shape, dtype=torch.float32, device=dev))
    u = torch.rand((n_trees, n_features), generator=g, device=dev)
    return w, u

"""Quickstart of the PyTorch port: the paper's pipeline on synthetic tabular data.

    python examples/quickstart_torch.py [--trees 32] [--depth 7] [--device cuda]
    python examples/quickstart_torch.py --regression
    python examples/quickstart_torch.py --checkpoint-dir /tmp/prf_ckpt

Trains PRF (dimension reduction + DSI bootstrap + weighted voting) with
``repro_torch`` and prints held-out accuracy (or R^2 with
``--regression``) and the OOB tree weights; for classification it also
trains the paper's two comparison baselines (``core.baselines``: RF with
random subspaces and a plain vote, and Spark-MLRF-like split candidates
from a 300-row sample) and prints a Fig. 8-style summary, as
``examples/quickstart.py`` does. ``--checkpoint-dir`` checkpoints PRF's
growth after every level and resumes from the newest valid checkpoint in
that directory: run it, interrupt it, run it again. The default device
is ``cuda``; ``--device cpu`` runs the plain PyTorch path.
"""
import argparse
import sys
import time

sys.path.insert(0, "src")

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--trees", type=int, default=32)
    ap.add_argument("--depth", type=int, default=7)
    ap.add_argument("--samples", type=int, default=6000)
    ap.add_argument("--features", type=int, default=400)
    ap.add_argument("--regression", action="store_true", help="a regression target, OOB R^2 tree weights")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="checkpoint growth after every level here, and resume from it")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    from repro_torch import ForestConfig, train_prf
    from repro_torch.data.tabular import make_classification, make_regression, train_test_split

    print(f"dataset: N={args.samples} M={args.features} ({'regression' if args.regression else 'high-dim, noisy'})"
          f", device {args.device}")
    if args.regression:
        x, y = make_regression(n_samples=args.samples, n_features=args.features, n_informative=8, seed=7)
        cfg = ForestConfig(n_trees=args.trees, max_depth=args.depth, n_bins=32, regression=True)
    else:
        x, y = make_classification(
            n_samples=args.samples, n_features=args.features, n_classes=3,
            n_informative=8, n_redundant=4, label_noise=0.1, class_sep=1.2, seed=7,
        )
        cfg = ForestConfig(n_trees=args.trees, max_depth=args.depth, n_bins=32, n_classes=3)
    xtr, ytr, xte, yte = train_test_split(x, y, 0.25, 0)

    levels = []
    t0 = time.time()
    model = train_prf(xtr, ytr, cfg, seed=0, device=args.device,
                      checkpoint_dir=args.checkpoint_dir, resume_from=args.checkpoint_dir,
                      on_level=lambda level, _: levels.append(level))
    pred = model.predict(xte)
    if args.regression:
        score = 1.0 - np.mean((pred - yte) ** 2) / np.var(yte)
        print(f"PRF regression  R^2={score:.4f}  ({time.time() - t0:.1f}s)")
    else:
        print(f"{'PRF  (paper: dimred + weighted vote)':42s} acc={np.mean(pred == yte):.4f}  "
              f"({time.time() - t0:.1f}s)")
        from repro_torch.core.baselines import train_mlrf_like, train_rf

        for name, fn in [
            ("RF   (random subspaces, plain vote)", train_rf),
            ("MLRF (sampled split candidates)",
             lambda a, b, c, seed, device: train_mlrf_like(a, b, c, seed, sample_budget=300, device=device)),
        ]:
            t1 = time.time()
            acc = fn(xtr, ytr, cfg, seed=0, device=args.device).accuracy(xte, yte)
            print(f"{name:42s} acc={acc:.4f}  ({time.time() - t1:.1f}s)")
    if args.checkpoint_dir is not None:
        from repro_torch.checkpoint import list_steps

        print(f"levels grown in this run: {levels}; checkpoints in {args.checkpoint_dir}: "
              f"{list_steps(args.checkpoint_dir)}")

    w = model.forest.tree_weight.cpu().numpy()
    print(f"\nOOB tree weights ({'R^2' if args.regression else 'Eq. 8'}): mean={w.mean():.3f} "
          f"min={w.min():.3f} max={w.max():.3f}")


if __name__ == "__main__":
    main()

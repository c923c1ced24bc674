"""Held-out R^2 of the JAX reference (``repro``) on the CPU for the regression
smoke data: the source of ``chip_smoke.py``'s ``R2_FLOOR``.

    JAX_PLATFORMS=cpu PYTHONPATH=src python tools/reference_r2_floor.py [--train-rows 40000]

Draws ``make_regression(1,310,720 x 128, n_informative=12, noise=0.1,
seed=0)`` and splits it 80/20 as ``chip_smoke.py`` phase 5d does, trains
``ForestConfig(n_trees=32, max_depth=8, n_bins=64, regression=True)`` with
seed 0 on the first ``--train-rows`` training rows and scores all 262,144
test rows. (The generator draws the target's weights after ``x``, so a
data set drawn at another ``n_samples`` has another target function: the
sample keeps the smoke run's.)
"""
import argparse
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--train-rows", type=int, default=40_000)
    args = ap.parse_args()

    from repro.core import ForestConfig, train_prf
    from repro.data.tabular import make_regression, train_test_split

    t0 = time.time()
    x, y = make_regression(n_samples=1_310_720, n_features=128, n_informative=12, noise=0.1, seed=0)
    xtr, ytr, xte, yte = train_test_split(x, y, 0.2, 0)
    del x, y
    xtr, ytr = xtr[:args.train_rows].copy(), ytr[:args.train_rows].copy()
    model = train_prf(xtr, ytr, ForestConfig(n_trees=32, max_depth=8, n_bins=64, regression=True), 0)
    pred = np.asarray(model.predict(xte)).astype(np.float64)
    r2 = 1.0 - np.mean((pred - yte) ** 2) / np.var(yte.astype(np.float64))
    print(f"repro on the CPU: train rows {xtr.shape[0]}, test rows {xte.shape[0]}, held-out R^2 {r2:.7f} "
          f"({time.time() - t0:.1f} s)")


if __name__ == "__main__":
    main()

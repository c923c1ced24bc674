"""Distributed PRF on a process mesh with the PyTorch port — the paper's §4
in miniature (counterpart of ``examples/prf_distributed.py``).

    python examples/prf_distributed_torch.py --nproc 8 --data 4 --model 2 --device cpu
    python examples/prf_distributed_torch.py --nproc 4 --data 2 --model 2 --device cuda
    torchrun --nproc-per-node 4 examples/prf_distributed_torch.py --data 2 --model 2
    python examples/prf_distributed_torch.py --multiproc 2 --device cpu

Vertical partitioning: features shard over ``model``, samples over
``data``; the T_GR histogram is summed over the sample axis only, the T_NS
winner merge crosses the feature axis only (paper Figs. 3-7). Each rank
is one process. ``--nproc`` spawns the world on this host
(``repro_torch.launch.mesh.run_world``); under ``torchrun`` (``RANK`` and
``WORLD_SIZE`` set) this process is one rank. The backend is NCCL when
there is a card for every rank, else gloo (several ranks on one card:
NCCL refuses that, and gloo's collectives go through host copies). Bin
edges come from per-shard quantile sketches merged over the mesh
(``fit_bins_sharded``), then ``make_prf_train_fn`` trains and
``predict_sharded`` votes; rank 0 prints the accuracy and every rank the
same forest hash.

``--multiproc N`` is the cluster layout on one machine (counterpart of
``prf_distributed.py --multiproc``): the training rows are written once
to an ``np.memmap``, N processes are spawned, and each calls
``train_prf_multiproc`` through a ``launch.multiproc.MultiHostMesh``,
reading, binning and feeding only its own rows of every sample block.
Each process reports the bytes it fed to its device and the hash of the
model (forest and edges); the example checks that the hashes agree.
"""
import argparse
import hashlib
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def rank_main(args: dict) -> dict:
    """One rank: bin, train, predict on the (data x model) mesh."""
    import numpy as np
    import torch

    from repro_torch.core.binning import apply_bins
    from repro_torch.core.distributed import fit_bins_sharded, make_prf_train_fn, predict_sharded
    from repro_torch.core.types import ForestConfig
    from repro_torch.data.tabular import make_classification, train_test_split
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((args["data"], args["model"]), ("data", "model"), device=args["device"])
    x, y = make_classification(n_samples=args["rows"], n_features=args["features"], n_classes=4,
                               seed=1)
    xtr, ytr, xte, yte = train_test_split(x, y, 0.25, 0)
    cfg = ForestConfig(n_trees=args["trees"], max_depth=6, n_bins=32, n_classes=4)
    edges = fit_bins_sharded(xtr, cfg.n_bins, mesh, sample_block=512)
    e = torch.from_numpy(edges).to(mesh.device)
    xb = apply_bins(torch.from_numpy(xtr).to(mesh.device), e).cpu().numpy()
    xbte = apply_bins(torch.from_numpy(xte).to(mesh.device), e).cpu().numpy()
    train_fn, _ = make_prf_train_fn(cfg, mesh)
    forest = train_fn(xb, ytr, 0)
    acc = float(np.mean(predict_sharded(forest, xbte, mesh) == yte))
    h = hashlib.sha256()
    for n in forest.FIELDS:
        h.update(getattr(forest, n).cpu().numpy().tobytes())
    return {"rank": mesh.rank, "coords": mesh.coords, "device": str(mesh.device),
            "backend": mesh.backend, "host_staged": mesh.host_staged, "accuracy": acc,
            "forest_sha256": h.hexdigest()}


def multiproc_rank(args: dict) -> dict:
    """One process of ``--multiproc``: ``train_prf_multiproc`` on its rows of
    the memmap."""
    import numpy as np

    from repro_torch.core.distributed import train_prf_multiproc
    from repro_torch.core.types import ForestConfig
    from repro_torch.launch.multiproc import MultiHostMesh

    runtime = MultiHostMesh(device=args["device"])
    n = args["rows"]
    x = np.memmap(args["memmap"], dtype=np.float32, mode="r", shape=(n, args["features"]))
    y = np.load(args["memmap"] + ".y.npy")
    cfg = ForestConfig(n_trees=args["trees"], max_depth=6, n_bins=32, n_classes=4,
                       feature_mode="importance", weighted_voting=True, sample_block=n // 4)
    model = train_prf_multiproc(x, y, cfg, seed=0, runtime=runtime)
    h = hashlib.sha256()
    for f in model.forest.FIELDS:
        h.update(getattr(model.forest, f).cpu().numpy().tobytes())
    h.update(np.asarray(model.bin_edges).tobytes())
    nb = cfg.sample_block
    lo, hi = runtime.local_row_range(nb + runtime.pad(nb))
    who = f"[process {runtime.process_index}/{runtime.process_count}]"
    return {"report": f"{who} sample shard {runtime.shard_lo} of {runtime.n_data_shards}: rows "
                      f"[{lo}, {hi}) of each block of {nb}, fed "
                      f"{runtime.feed_bytes / 2**20:.2f} MiB host->device on {runtime.mesh.device}",
            "hash": h.hexdigest()}


def run_multiproc(a) -> None:
    """Write the training rows to a memmap, spawn the processes, check that
    their models agree."""
    import tempfile

    import numpy as np

    from repro_torch.data.tabular import make_classification
    from repro_torch.launch.mesh import default_backend, run_world

    x, y = make_classification(n_samples=a.rows, n_features=a.features, n_classes=4, seed=1)
    with tempfile.TemporaryDirectory(prefix="prf_multiproc_") as tmp:
        path = os.path.join(tmp, "train.f32")
        mm = np.memmap(path, dtype=np.float32, mode="w+", shape=x.shape)
        mm[:] = x.astype(np.float32)
        mm.flush()
        del mm
        np.save(path + ".y.npy", y)
        args = {"memmap": path, "rows": a.rows, "features": a.features, "trees": a.trees,
                "device": a.device}
        backend = a.backend or default_backend(a.multiproc, a.device)
        outs = run_world("prf_distributed_torch:multiproc_rank", a.multiproc, args=(args,),
                         backend=backend, timeout_s=900)
    for o in outs:
        print(o["report"])
        print(f"{o['report'].split(']')[0]}] model sha256={o['hash']}")
    if len({o["hash"] for o in outs}) != 1:
        raise SystemExit(f"the processes' models differ: {[o['hash'] for o in outs]}")
    print(f"one model on all {a.multiproc} processes ({backend}, {a.device}): "
          f"{outs[0]['hash'][:16]}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nproc", type=int, default=4, help="ranks to spawn on this host")
    ap.add_argument("--data", type=int, default=2)
    ap.add_argument("--model", type=int, default=2)
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default=None,
                    help="default: nccl with a card per rank, else gloo")
    ap.add_argument("--trees", type=int, default=16)
    ap.add_argument("--rows", type=int, default=4096)
    ap.add_argument("--features", type=int, default=64)
    ap.add_argument("--multiproc", type=int, default=0,
                    help="spawn N processes, each training on its own rows of a memmap")
    a = ap.parse_args()
    if a.multiproc:
        run_multiproc(a)
        return
    args = {k: getattr(a, k) for k in ("data", "model", "device", "trees", "rows", "features")}

    from repro_torch.launch.mesh import default_backend

    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:            # under torchrun
        import torch.distributed as dist

        local = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ["WORLD_SIZE"]))
        dist.init_process_group(a.backend or default_backend(local, a.device))
        try:
            out = rank_main(args)
        finally:
            dist.destroy_process_group()
        print(out, flush=True)
        return
    from repro_torch.launch.mesh import run_world

    if a.nproc != a.data * a.model:
        raise SystemExit(f"--nproc {a.nproc} != --data {a.data} x --model {a.model}")
    backend = a.backend or default_backend(a.nproc, a.device)
    outs = run_world("prf_distributed_torch:rank_main", a.nproc, args=(args,), backend=backend,
                     timeout_s=900)
    for o in outs:
        print(o)
    if len({o["forest_sha256"] for o in outs}) != 1:
        raise SystemExit("the ranks' forests differ")
    print(f"mesh data={a.data} x model={a.model} on {a.device} ({backend}): distributed PRF "
          f"accuracy {outs[0]['accuracy']:.4f}, one forest on every rank")


if __name__ == "__main__":
    main()

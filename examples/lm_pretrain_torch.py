"""End-to-end LM training driver of the PyTorch port, with checkpoint/restart.

    python examples/lm_pretrain_torch.py --arch smollm-135m --steps 200 --scale 0.25
    python examples/lm_pretrain_torch.py --device cpu --steps 20 --seq 64
    python examples/lm_pretrain_torch.py --arch mamba2-780m --device cpu --steps 4 --seq 64

The counterpart of ``examples/lm_pretrain.py`` for ``repro_torch``, with the
same flags and cut (``--scale 1.0`` trains the full 135M-parameter config;
the default 0.25 scale is ~10M params in f32 compute), plus ``--device``
(default ``cuda``, where attention and the SSD scan run their forward
and backward kernels; ``cpu`` runs their plain versions). Every
registered arch trains, ``ssm`` (mamba2-780m) and ``hybrid`` (hymba-1.5b)
included; below scale 1 an arch with SSM heads keeps its width a multiple
of their head dim. ``TokenPipeline`` (paper §4.1.2's DSI table) feeds the
batches; checkpoints land in ``--ckpt-dir`` (default
``artifacts/lm_ckpt_torch/<arch>``) and the run resumes from the newest
valid one. The weights start from seed 0.
"""
import argparse
import dataclasses
import sys
import time

sys.path.insert(0, "src")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--scale", type=float, default=0.25)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None, help="default: artifacts/lm_ckpt_torch/<arch>")
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint.checkpoint import latest_step
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.models import build_model
    from repro_torch.training import AdamWConfig, init_state, make_train_step

    cfg = get_config(args.arch)
    ckpt_dir = args.ckpt_dir or f"artifacts/lm_ckpt_torch/{args.arch}"
    if args.scale < 1.0:
        unit = cfg.ssm_head_dim if cfg.ssm_state else 16      # SSM heads split the width evenly
        cfg = dataclasses.replace(
            cfg,
            n_layers=max(2, int(cfg.n_layers * args.scale)),
            d_model=max(64, int(cfg.d_model * args.scale) // unit * unit),
            n_heads=max(2, int(cfg.n_heads * args.scale)),
            n_kv_heads=max(1, int(cfg.n_kv_heads * args.scale)),
            d_ff=max(128, int(cfg.d_ff * args.scale) // 16 * 16),
            vocab_size=min(cfg.vocab_size, 8192),
            compute_dtype="float32",
        )
    model = build_model(cfg, args.device, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"arch={args.arch} scale={args.scale} params={n_params / 1e6:.1f}M device={model.device}")

    opt = AdamWConfig(lr=3e-3, warmup_steps=20, decay_steps=max(args.steps, 100))
    step_fn = make_train_step(model, opt)
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=args.seq, n_docs=4096, seed=0)

    mgr = CheckpointManager(ckpt_dir, keep=2, save_interval=args.save_every)
    state = init_state(model, opt)
    start = 0
    if latest_step(ckpt_dir) is not None:
        state, start = mgr.restore_latest_valid(state)
        print(f"resumed from checkpoint @ step {start}")

    t0 = time.time()
    for i, b in enumerate(pipe.batches(args.batch, args.steps, n_micro=args.accum)):
        if i < start:
            continue
        state, m = step_fn(state, b)
        mgr.maybe_save(state, i + 1)
        if (i + 1) % 10 == 0 or i == start:
            if model.device.type == "cuda":
                torch.cuda.synchronize()
            dt = (time.time() - t0) / max(i + 1 - start, 1)
            print(f"step {i + 1:4d}  loss={float(m['loss']):.4f} "
                  f"gnorm={float(m['grad_norm']):.3f} lr={float(m['lr']):.2e} "
                  f"({dt:.2f}s/step)")
    if model.device.type == "cuda":
        print(f"attention kernel launches: forward {flash_ops.launches}, backward {flash_ops.launches_bwd}; "
              f"SSD scan: forward {ssd_ops.launches}, backward {ssd_ops.launches_bwd}")
    print("done.")


if __name__ == "__main__":
    main()

"""Batched serving demo of the PyTorch port: prefill a prompt batch, decode greedily.

    python examples/serve_lm_torch.py --arch hymba-1.5b --batch 4 --prompt-len 32 --gen 16
    python examples/serve_lm_torch.py --arch deepseek-moe-16b --device cpu
    python examples/serve_lm_torch.py --arch whisper-large-v3 --device cpu

The counterpart of ``examples/serve_lm.py`` for ``repro_torch``, at the
same cut widths (4 layers, d_model 256, 4 heads, 2 KV heads, head dim 64,
f32 compute; whisper's encoder also 4 layers) with random weights from
seed 0. ``--arch`` takes every registered config: the modality frontends
are stubs, so the ``vlm`` and ``encdec`` configs get their patch or frame
embeddings (``extras``) as 0.1 x N(0, 1) from seed 0, at the config's
vision_tokens / encoder_frames. The default device is ``cuda``, where
prefill runs the attention and SSD kernels; ``--device cpu`` runs their
plain versions.
"""
import argparse
import dataclasses
import sys
import time

sys.path.insert(0, "src")


def main():
    from repro_torch.configs import all_configs, get_config

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m", choices=sorted(all_configs()))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    import numpy as np
    import torch

    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.models import build_model
    from repro_torch.serving.serve_step import greedy_generate

    base = get_config(args.arch)
    cfg = dataclasses.replace(
        base,
        n_layers=4, d_model=256, n_heads=4, n_kv_heads=2, d_ff=512,
        vocab_size=4096, head_dim=64, compute_dtype="float32",
        local_window=16 if base.local_window else 0,
        ssm_state=16 if base.ssm_state else 0,
        encoder_layers=4 if base.encoder_layers else 0,
    )
    model = build_model(cfg, args.device, seed=0)

    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len)))
    stub = {"vlm": ("vision_embeds", cfg.vision_tokens), "encdec": ("frames", cfg.encoder_frames)}
    extras = None
    if cfg.family in stub:
        key, n = stub[cfg.family]
        extras = {key: torch.from_numpy(rng.standard_normal((args.batch, n, cfg.d_model)) * 0.1).float()}
    s_max = args.prompt_len + args.gen + 1

    t0 = time.time()
    out = greedy_generate(model, prompts, extras, steps=args.gen, s_max=s_max)
    if model.device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.time() - t0
    toks = args.batch * args.gen
    print(f"arch={args.arch} batch={args.batch} prompt={args.prompt_len} gen={args.gen} "
          f"device={model.device}" + (f" {key} [{args.batch}, {n}, {cfg.d_model}]" if extras else "")
          + (f" ({torch.cuda.get_device_name(model.device)})" if model.device.type == "cuda" else ""))
    print(f"generated {toks} tokens in {dt:.2f}s ({toks / dt:.1f} tok/s incl. the first call's set-up); "
          f"kernel launches: attention {flash_ops.launches}, SSD scan {ssd_ops.launches}")
    print("sample continuations (token ids):")
    for b in range(min(args.batch, 2)):
        print(f"  [{b}]", out[b].tolist())


if __name__ == "__main__":
    main()

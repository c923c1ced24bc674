"""The attention backward on one CUDA card, for one or more checkouts of the
port, in turns: a before / after in one run.

    python3 tools/attention_bwd_ab.py [--src OTHER/src --src src --src src --src OTHER/src]

Each ``--src`` (default: this checkout's ``src``) runs in its own process,
in the order given, and builds its own kernels (under its checkout's
``build/``). At smollm-135m's training microbatch, llama-vision's
self-attention heads at hd 128, gemma3-27b's at hd 168 (padded to 192) and
a hd-32 shape, bf16 and causal, each process checks ``flash_attention_bwd`` on the
forward kernel's out and lse against ``attention_bwd_ref`` (the largest
share of ``LM_TOL``'s bf16 allowance, two calls bitwise equal), then
times it with CUDA events (10 calls), SDPA's backward beside it (kernel,
SDPA, SDPA, kernel; each SDPA backend alone too) and, from the profiler
over 10 calls, each kernel's device time. One JSON line per shape.
"""
import argparse
import contextlib
import json
import re
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = {"smollm training shape": (4, 9, 3, 2048, 64),
          "llama-vision self-attention, hd 128": (4, 64, 8, 2048, 128),
          "hd 32": (4, 8, 8, 2048, 32),
          "gemma3-27b heads, hd 168": (4, 32, 16, 2048, 168)}
LM_TOL_BF16 = (2.0 ** -7, 1e-2)    # chip_smoke.LM_TOL[torch.bfloat16]


def cuda_ms(fn, reps=10, warmup=2):
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def share(got, want):
    import torch

    got, want = got.double(), want.double()
    d = (got - want).abs()
    s = d / (LM_TOL_BF16[0] * want.abs() + LM_TOL_BF16[1] * float(want.square().mean().sqrt()))
    return float(torch.where(d == 0, 0.0, s).max())


def run(src: str) -> None:
    """One checkout's numbers, in this process."""
    warnings.filterwarnings("ignore", category=UserWarning)   # SDPA's notes on the backends it skips
    sys.path.insert(0, src)
    import torch
    import torch.nn.functional as F
    from torch.autograd import DeviceType
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as fo
    from repro_torch.kernels.flash_attention.ref import MaskSpec, attention_bwd_ref

    dev = torch.device("cuda")
    _build.library()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    for label, (B, H, KV, L, D) in SHAPES.items():
        q, do = (torch.randn((B, L, H, D), generator=gen, device=dev).to(torch.bfloat16) for _ in range(2))
        k, v = (torch.randn((B, L, KV, D), generator=gen, device=dev).to(torch.bfloat16) for _ in range(2))
        out, lse = fo.flash_attention_lse(q, k, v)
        call = lambda: fo.flash_attention_bwd(q, k, v, out, lse, do)
        got, again = call(), call()
        want = attention_bwd_ref(q, k, v, out, lse, do, MaskSpec())
        shares = [share(g, w) for g, w in zip(got, want)]
        bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
        del want, again
        qt, kt, vt = (a.transpose(1, 2).detach().requires_grad_(True) for a in (q, k, v))

        def sdpa_bwd(backends=None):
            with sdpa_kernel(backends) if backends else contextlib.nullcontext():
                o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
            return lambda: torch.autograd.grad(o, (qt, kt, vt), do.transpose(1, 2), retain_graph=True)

        lib = sdpa_bwd()
        turns = [cuda_ms(f) for f in (call, lib, lib, call)]
        backends = {}
        for be in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION, SDPBackend.CUDNN_ATTENTION):
            try:
                backends[be.name] = cuda_ms(sdpa_bwd([be]))
            except RuntimeError as e:
                backends[be.name] = f"refused: {str(e).splitlines()[0][:80]}"
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(0.05)
            for _ in range(10):
                call()
            torch.cuda.synchronize()
            time.sleep(0.05)
        kernels = {re.search(r"bwd_\w+(<[^>]*>)?", e.key).group(0): [e.self_device_time_total / 1e3 / 10, e.count]
                   for e in prof.key_averages() if e.device_type == DeviceType.CUDA and "bwd_" in e.key}
        print(json.dumps({"src": src, "shape": label, "B_H_KV_L_D": [B, H, KV, L, D], "ms_turns": turns,
                          "kernel_ms_per_call": kernels, "sdpa_bwd_ms_turns": turns[1:3],
                          "sdpa_bwd_ms_by_backend": backends, "allowance_shares_dq_dk_dv": shares,
                          "bitwise": bitwise}), flush=True)
        del q, do, k, v, out, lse, got, qt, kt, vt, lib
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", action="append", help="a checkout's src directory (repeat: run in turns)")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        run(args.one)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("attention_bwd_ab: no CUDA device available", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    for src in args.src or [str(ROOT / "src")]:
        subprocess.run([sys.executable, __file__, "--one", str(Path(src).resolve())], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

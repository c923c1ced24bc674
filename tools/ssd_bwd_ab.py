"""The SSD scan's backward on one CUDA card, for one or more checkouts of the
port, in turns: a before / after in one run.

    python3 tools/ssd_bwd_ab.py [--src OTHER/src --src src --src src --src OTHER/src]

Each ``--src`` (default: this checkout's ``src``) runs in its own process,
in the order given, and builds its own kernels (under its checkout's
``build/``). At mamba2-780m's and hymba-1.5b's training microbatches
(``SHAPES``, bf16, inputs as ``chip_smoke._ssd_inputs`` makes them) each
process checks ``ssd_scan_bwd`` against ``ssd_chunked_bwd`` (the largest
share of ``LM_TOL``'s allowance per output, d log a at f32's; two calls
bitwise equal), then times it with CUDA events (10 calls, twice), reads the
peak device memory of one call above its inputs, and, from the profiler
over 10 calls, each kernel's device time per call and launches. One JSON
line per shape.
"""
import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = {"mamba2-780m training microbatch": (4, 2048, 48, 64, 128),
          "hymba-1.5b training microbatch": (4, 2048, 50, 64, 16)}     # B, L, H, P, N
LM_TOL = {"bf16": (2.0 ** -7, 1e-2), "f32": (1e-5, 1e-4)}              # chip_smoke.LM_TOL


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


def share(got, want, tol):
    import torch

    got, want = got.double(), want.double()
    d = (got - want).abs()
    s = d / (tol[0] * want.abs() + tol[1] * float(want.square().mean().sqrt()))
    return float(torch.where(d == 0, 0.0, s).max())


def run(src: str) -> None:
    """One checkout's numbers, in this process."""
    sys.path.insert(0, src)
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import _build
    from repro_torch.kernels.ssd_scan import ops
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked_bwd

    dev = torch.device("cuda")
    _build.library()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    for label, (B, L, H, P, N) in SHAPES.items():
        x = torch.randn((B, L, H, P), generator=gen, device=dev).to(torch.bfloat16)
        loga = -torch.randn((B, L, H), generator=gen, device=dev).abs() * 0.4
        b, c = ((torch.randn((B, L, N), generator=gen, device=dev) * 0.3).to(torch.bfloat16) for _ in range(2))
        dy = torch.randn((B, L, H, P), generator=gen, device=dev).to(torch.bfloat16)
        call = lambda: ops.ssd_scan_bwd(x, loga, b, c, dy)
        got, again = call(), call()
        want = ssd_chunked_bwd(x, loga, b, c, dy, 128)
        shares = {n: share(g, w, LM_TOL["f32" if n == "dloga" else "bf16"])
                  for n, g, w in zip(("dx", "dloga", "db", "dc"), got, want)}
        bitwise = all(torch.equal(u, v) for u, v in zip(got, again))
        del got, again, want
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        call()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        turns = [cuda_ms(call), cuda_ms(call)]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(0.05)
            for _ in range(10):
                call()
            torch.cuda.synchronize()
            time.sleep(0.05)
        kernels = {re.search(r"ssd_bwd\w*(<[^>]*>)?", e.key).group(0):
                   [e.self_device_time_total / 1e3 / 10, e.count]
                   for e in prof.key_averages() if e.device_type == DeviceType.CUDA and "ssd_bwd" in e.key}
        print(json.dumps({"src": src, "shape": label, "B_L_H_P_N": [B, L, H, P, N], "ms_turns": turns,
                          "kernel_ms_per_call_and_launches": kernels, "peak_bytes_above_inputs": peak,
                          "allowance_shares": shares, "bitwise": bitwise}), flush=True)
        del x, loga, b, c, dy
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
        print("ssd_bwd_ab: no CUDA device available", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    for src in args.src or [str(ROOT / "src")]:
        subprocess.run([sys.executable, __file__, "--one", str(Path(src).resolve())], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

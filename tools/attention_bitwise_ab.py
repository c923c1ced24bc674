"""The attention kernels' outputs from one or more checkouts of the port,
compared bit for bit: a change that must leave every existing call's
numbers as they were (a new argument, a refactor) is held to that here.

    python3 tools/attention_bitwise_ab.py --src OTHER/src --src src

Each ``--src`` runs in its own process and builds its own kernels (under
its checkout's ``build/``). On seeded inputs at every attention shape of
``chip_smoke.py`` (``TRAIN_ATTENTION_SMALL``, ``TRAIN_ATTENTION_FULL``,
``LM_PATH_ATTENTION``, ``BWD_SHAPES``; small shapes in f32 and bf16, the
others in bf16) each process runs ``flash_attention``, ``flash_attention_lse``
and ``flash_attention_bwd`` with the arguments every checkout takes (no
query offset: ends aligned) and prints the SHA-256 of each output's bytes.
The first process's digests are the yardstick: the last line is one JSON
object with the shapes whose outputs differ (none: bitwise equal).
"""
import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def cases():
    """(label, dtype name, (B, H, KV, Lq, Lk, D, causal, window, prefix))."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    out = []
    for c in cs.TRAIN_ATTENTION_SMALL:
        out += [(f"small {c}", dt, c) for dt in ("float32", "bfloat16")]
    for label, c in {**cs.TRAIN_ATTENTION_FULL, **cs.LM_PATH_ATTENTION}.items():
        out.append((label, "bfloat16", c))
    for label, (B, H, KV, L, D, W) in cs.BWD_SHAPES.items():
        out.append((label, "bfloat16", (B, H, KV, L, L, D, True, W, 0)))
    return out


def run(src: str) -> None:
    """One checkout's digests, in this process: one JSON line per case."""
    import torch

    sys.path.insert(0, src)
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as fo

    dev = torch.device("cuda")
    _build.library()
    digest = lambda t: hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy().tobytes()).hexdigest()  # noqa: E731
    for i, (label, dt, (B, H, KV, Lq, Lk, D, C, W, P)) in enumerate(cases()):
        gen = torch.Generator(device=dev)
        gen.manual_seed(1000 + i)
        dtype = getattr(torch, dt)
        q, do = (torch.randn((B, Lq, H, D), generator=gen, device=dev).to(dtype) for _ in range(2))
        k, v = (torch.randn((B, Lk, KV, D), generator=gen, device=dev).to(dtype) for _ in range(2))
        kw = dict(causal=C, window=W, prefix=P)
        with torch.no_grad():
            plain = fo.flash_attention(q, k, v, **kw)
        out, lse = fo.flash_attention_lse(q, k, v, **kw)
        dq, dk, dv = fo.flash_attention_bwd(q, k, v, out, lse, do, **kw)
        print(json.dumps({"src": src, "case": label, "dtype": dt, "digests": {
            n: digest(t) for n, t in (("out", plain), ("out_lse", out), ("lse", lse), ("dq", dq), ("dk", dk),
                                      ("dv", dv))}}), flush=True)
        del q, do, k, v, plain, out, lse, dq, dk, dv
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", action="append", help="a checkout's src directory (repeat to compare)")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        run(args.one)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("attention_bitwise_ab: no CUDA device available", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    runs = []
    for src in args.src or [str(ROOT / "src")]:
        res = subprocess.run([sys.executable, __file__, "--one", str(Path(src).resolve())], check=True,
                             capture_output=True, text=True)
        lines = [json.loads(x) for x in res.stdout.splitlines() if x.startswith("{")]
        runs.append({(r["case"], r["dtype"]): r["digests"] for r in lines})
        print(f"{src}: {len(lines)} cases", flush=True)
    differ = sorted({f"{c} {d}" for r in runs[1:] for (c, d), dg in r.items() if dg != runs[0].get((c, d))})
    print(json.dumps({"cases": len(runs[0]), "checkouts": len(runs), "differ": differ}))
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())

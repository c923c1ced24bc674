"""How far three f32 forms of the SSD scan's d log a lie from its f64 value.

    PYTHONPATH=src python tools/ssd_dloga_accuracy.py

CPU only, torch only. For each shape and input kind, d log a of
``ssd_chunked``'s y against a random dy, computed

* "kept": ``ref.ssd_chunked_bwd`` in f32, the form the backward kernel
  (``csrc/ssd_scan_bwd.cu``) runs: each pair term and state term added into
  the log decays its decay factor spans, no sum subtracted from another;
* "autograd": ``torch.autograd`` of ``ref.ssd_chunked`` in f32, the plain
  path's gradient in training (``use_kernels=False``);
* "identity": sum_{s >= t} (dy_s . y_s - dx_s . x_s) over the whole
  sequence in f32 (y is linear in x, so this is exact in real numbers),

against ``ssd_chunked_bwd`` run in f64. Printed per form: max |error| of d
log a over its largest magnitude, and of the per-head sum
sum_{b,t} d log a_{b,t,h} log a_{b,t,h}, which is the model's a_log
gradient (log a = dt * -exp(a_log)) and sums d log a with cancellation.
Input kinds: "unit" (log a = -0.4 |N(0, 1)|, the kernel tests' inputs) and
"model" (log a = -softplus(N(0, 1)) * U[1, 16], the span of mamba2's
``a_log`` at init, x scaled by the same dt).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ssd_scan.ref import ssd_chunked, ssd_chunked_bwd

SHAPES = [(2, 256, 4, 64, 128, 64), (1, 2048, 4, 64, 128, 64), (1, 2048, 4, 64, 16, 128)]   # B, L, H, P, N, chunk


def inputs(gen, B, L, H, P, N, kind):
    x = torch.randn((B, L, H, P), generator=gen)
    if kind == "unit":
        loga = -torch.randn((B, L, H), generator=gen).abs() * 0.4
    else:
        dt = torch.nn.functional.softplus(torch.randn((B, L, H), generator=gen))
        loga = -dt * (1 + 15 * torch.rand((H,), generator=gen))
        x = x * dt[..., None]
    b = torch.randn((B, L, N), generator=gen) * 0.3
    c = torch.randn((B, L, N), generator=gen) * 0.3
    dy = torch.randn((B, L, H, P), generator=gen)
    return x, loga, b, c, dy


def errors(got, want, loga):
    head = lambda d: (d.double() * loga.double()).sum((0, 1))
    rel = lambda a, w: float((a.double() - w).abs().max() / w.abs().max())
    return rel(got, want), rel(head(got), head(want))


def main():
    gen = torch.Generator().manual_seed(0)
    print("shape (B, L, H, P, N, chunk), inputs: d log a error / its scale, a_log-like sum error / its scale")
    for B, L, H, P, N, Q in SHAPES:
        for kind in ("unit", "model"):
            x, loga, b, c, dy = inputs(gen, B, L, H, P, N, kind)
            truth = ssd_chunked_bwd(*(t.double() for t in (x, loga, b, c, dy)), Q)[1]
            dx, kept, _, _ = ssd_chunked_bwd(x, loga, b, c, dy, Q)
            ins = [t.clone().requires_grad_(True) for t in (x, loga, b, c)]
            auto = torch.autograd.grad(ssd_chunked(*ins, None, Q)[0], ins, dy)[1]
            y = ssd_chunked(x, loga, b, c, None, Q)[0]
            step = (dy * y).sum(-1) - (dx * x).sum(-1)                     # [B, L, H]
            ident = torch.flip(torch.cumsum(torch.flip(step, (1,)), 1), (1,))
            res = {name: errors(d, truth, loga) for name, d in (("kept", kept), ("autograd", auto),
                                                                 ("identity", ident))}
            print(f"{(B, L, H, P, N, Q)}, {kind}: " + "; ".join(
                f"{name} {e[0]:.3g}, {e[1]:.3g}" for name, e in res.items()))


if __name__ == "__main__":
    main()

"""The bf16 tensor-core SSD kernel's operand roundings, emulated on the CPU.

``csrc/ssd_scan.cu:ssd_tc_kernel`` computes the chunked SSD scan in
chunks of 64 steps with bf16 wgmma operands and f32 accumulators. Its
exact inputs (x, b, c in bf16) enter as they are; four f32 quantities do
not: the decayed scores Sd, the carried state h_prev, w * x (w the decay
to the chunk's end) and the row scale exp(lc_i), which stays in f32 on
the accumulator. ``emulate_tc`` repeats that arithmetic in PyTorch,
each rounded operand as bf16 parts hi = bf16(v) and lo = bf16(v - hi)
(or one rounding, to show why the parts are needed), rows past L read as
zeros with log a = 0, as TMA delivers them. Held to the plain version
``ssd_chunked`` and to the reference's ``_ssd_chunked`` at the LM
kernels' tolerance (``chip_smoke.LM_TOL``): y at bf16's, h_final at
f32's.

Run as a script, it repeats the emulation at mamba2-780m's prefill
shape (batch 8, L 2048, 48 heads, P 64, N 128; one batch row at a time)
and prints the largest share of each allowance per rounding choice:

    PYTHONPATH=src python tests/test_torch_ssd_tc.py
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba as jm
from repro_torch.kernels.ssd_scan.ref import ssd_chunked

RNG = np.random.default_rng(83)
LM_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (2.0 ** -7, 1e-2)}
TC_CHUNK = 64          # the kernel's own chunk: the rows of one wgmma tile


def _round(v, parts):
    """v as the kernel feeds it to a wgmma: 0 = exact, 1 = one bf16
    rounding, 2 = hi + lo bf16 parts."""
    if parts == 0:
        return v
    hi = v.to(torch.bfloat16).float()
    return hi if parts == 1 else hi + (v - hi).to(torch.bfloat16).float()


def emulate_tc(x, loga, b, c, *, sd=2, h_prev=2, wx=2):
    """x [B, L, H, P] bf16, loga [B, L, H] f32, b/c [B, L, N] bf16.
    Returns (y [B, L, H, P] bf16, h_final [B, H, N, P] f32)."""
    B, L, H, P = x.shape
    N = b.shape[-1]
    Q = TC_CHUNK
    Lp = -(-L // Q) * Q                            # rows past L: zeros, log a = 0
    pad = lambda t: torch.nn.functional.pad(t.float(), (0, 0) * (t.dim() - 2) + (0, Lp - L))
    x, loga, b, c = pad(x), pad(loga), pad(b), pad(c)
    ii = torch.arange(Q)
    mask = (ii[:, None] >= ii[None, :])[None, :, :, None]
    h = torch.zeros(B, H, N, P)
    ys = []
    for g in range(Lp // Q):
        sl = slice(g * Q, (g + 1) * Q)
        xs, bs, cs = x[:, sl], b[:, sl], c[:, sl]
        lc = torch.cumsum(loga[:, sl], 1)                          # [B, Q, H]
        s = torch.einsum("bin,bjn->bij", cs, bs)                   # exact bf16 products
        delta = lc[:, :, None, :] - lc[:, None, :, :]
        sdm = torch.where(mask, s[..., None] * torch.exp(torch.where(mask, delta, 0.0)), 0.0)
        y = torch.einsum("bin,bhnp->bihp", cs, _round(h, h_prev)) * torch.exp(lc)[..., None]
        y = y + torch.einsum("bijh,bjhp->bihp", _round(sdm, sd), xs)
        w = torch.exp(lc[:, -1:] - lc)
        h = torch.exp(lc[:, -1])[..., None, None] * h + torch.einsum(
            "bjn,bjhp->bhnp", bs, _round(w[..., None] * xs, wx))
        ys.append(y)
    return torch.cat(ys, 1)[:, :L].to(torch.bfloat16), h


def allowance_share(got, want, dtype):
    """Largest share of |got - want| <= rtol |want| + atol rms(want) used."""
    rtol, atol = LM_TOL[dtype]
    got, want = got.double(), want.double()
    d = (got - want).abs()
    share = d / (rtol * want.abs() + atol * float(want.square().mean().sqrt()))
    return float(torch.where(d == 0, 0.0, share).max())


def _inputs(gen, B, L, H, P, N):
    x = torch.randn((B, L, H, P), generator=gen).to(torch.bfloat16)
    loga = -torch.randn((B, L, H), generator=gen).abs() * 0.4
    b = (torch.randn((B, L, N), generator=gen) * 0.3).to(torch.bfloat16)
    c = (torch.randn((B, L, N), generator=gen) * 0.3).to(torch.bfloat16)
    return x, loga, b, c


@pytest.mark.parametrize("B,L,H,P,N,chunk", [
    (2, 256, 3, 64, 128, 128),    # mamba2-780m's P and N
    (2, 256, 4, 32, 64, 64),
    (1, 192, 2, 64, 16, 64),
    (1, 200, 2, 32, 32, 8),       # L not a multiple of the kernel's chunk
    (1, 512, 50, 64, 16, 128),    # hymba-1.5b's heads, P and N
])
def test_tc_roundings_within_lm_tol(B, L, H, P, N, chunk):
    gen = torch.Generator().manual_seed(int(RNG.integers(1 << 31)))
    x, loga, b, c = _inputs(gen, B, L, H, P, N)
    y, h = emulate_tc(x, loga, b, c)
    yp, hp = ssd_chunked(x, loga, b, c, None, chunk)
    assert y.shape == yp.shape and h.shape == hp.shape
    assert allowance_share(y, yp, torch.bfloat16) <= 1.0
    assert allowance_share(h, hp, torch.float32) <= 1.0
    # the reference's chunked form, on the same inputs in f32
    yj, hj = jm._ssd_chunked(*(jnp.asarray(t.float().numpy()) for t in (x, loga, b, c)),
                             jnp.zeros((B, H, N, P), jnp.float32), chunk=chunk)
    assert allowance_share(y, torch.from_numpy(np.array(yj)), torch.bfloat16) <= 1.0
    assert allowance_share(h, torch.from_numpy(np.array(hj)), torch.float32) <= 1.0


def test_one_rounding_of_w_x_breaks_the_state_tolerance():
    """Why w * x enters as two bf16 parts: with one rounding h_final
    leaves its f32 tolerance by far."""
    gen = torch.Generator().manual_seed(5)
    x, loga, b, c = _inputs(gen, 1, 256, 4, 64, 128)
    _, hp = ssd_chunked(x, loga, b, c, None, 128)
    _, h2 = emulate_tc(x, loga, b, c)
    _, h1 = emulate_tc(x, loga, b, c, wx=1)
    assert allowance_share(h2, hp, torch.float32) <= 1.0
    assert allowance_share(h1, hp, torch.float32) > 10.0


def test_chunk_length_only_changes_rounding():
    """The kernel walks 64-step chunks whatever chunk the caller names:
    without operand rounding the two chunkings agree to f32 rounding."""
    gen = torch.Generator().manual_seed(9)
    x, loga, b, c = _inputs(gen, 1, 256, 2, 32, 16)
    y0, h0 = emulate_tc(x, loga, b, c, sd=0, h_prev=0, wx=0)
    for chunk in (32, 128, 256):
        yp, hp = ssd_chunked(x, loga, b, c, None, chunk)
        assert allowance_share(h0, hp, torch.float32) <= 1.0
        assert allowance_share(y0, yp, torch.bfloat16) <= 1.0


def main():
    """mamba2-780m's prefill shape, one batch row at a time."""
    B, L, H, P, N = 8, 2048, 48, 64, 128
    choices = {"Sd, h_prev, w x as hi + lo": {}, "Sd rounded once": {"sd": 1},
               "h_prev rounded once": {"h_prev": 1}, "w x rounded once": {"wx": 1}}
    gen = torch.Generator().manual_seed(0)
    got = {k: ([], []) for k in choices}
    want = ([], [])
    for _ in range(B):
        x, loga, b, c = _inputs(gen, 1, L, H, P, N)
        yp, hp = ssd_chunked(x, loga, b, c, None, 128)
        want[0].append(yp)
        want[1].append(hp)
        for name, kw in choices.items():
            y, h = emulate_tc(x, loga, b, c, **kw)
            got[name][0].append(y)
            got[name][1].append(h)
    yp, hp = torch.cat(want[0]), torch.cat(want[1])
    for name, (ys, hs) in got.items():
        print(f"{name}: y {allowance_share(torch.cat(ys), yp, torch.bfloat16):.4f}, "
              f"h_final {allowance_share(torch.cat(hs), hp, torch.float32):.4f} of the allowance")


if __name__ == "__main__":
    main()

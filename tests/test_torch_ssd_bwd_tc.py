"""The bf16 tensor-core SSD backward's operand roundings, emulated on the CPU.

``csrc/ssd_scan_bwd.cu`` runs the bf16 backward as two kernels on the
tensor cores (bf16 operands, f32 accumulators), in chunks of 64 steps:

* the state pass (``ssd_bwd_state_tc_kernel``), one warpgroup per (batch,
  head, direction): forward, H_{g+1} = exp(lc_Q) H_g + b^T (w x); in
  reverse, dH_g = exp(lc_Q) dH_{g+1} + c^T (el dy); each state entering
  (leaving) a chunk stored as bf16 hi and lo planes;
* the chunk pass (``ssd_bwd_chunk_tc_kernel``), one block per (batch,
  chunk), walking the heads in order: S = c b^T once, then per head
  G = dy x^T, the masked decays, T = b dH (dx's and d log a's state
  term), C H (d log a's), dx = we T + (S D)^T dy, the pair terms of d log
  a as (A^T U) with U the 0 / 1 matrix [i >= t], and the state terms of
  db and dc summed over the heads as one product each, (we x) dH^T and
  (el dy) H^T (both operands hi + lo: three products); the pair terms of
  db and dc come last, from the sum of dS over the heads: sum_h dS_h^T c
  and (sum_h dS_h) b.

x, dy, b and c are exact in bf16. Every f32 quantity that meets the
tensor cores enters as one bf16 rounding or as the parts hi = bf16(v) and
lo = bf16(v - hi). ``emulate_bwd_tc`` repeats that arithmetic in PyTorch
with each operand rounded as the kernels feed it (``ROUNDED``: 2 = hi +
lo, 1 = one rounding; products of a bf16 operand with hi + lo are exact in
f32, so the emulation differs from the kernels only in summation order),
rows past L read as zeros with log a = 0, as TMA delivers them. It is
held to the plain version ``ssd_chunked_bwd`` at the LM kernels'
tolerance (``chip_smoke.LM_TOL``): dx, db, dc at bf16's, d log a (f32 in
both dtypes) at f32's.

Run as a script, it repeats the emulation at mamba2-780m's and
hymba-1.5b's training microbatches (batch 4, L 2048; 48 heads at P 64,
N 128 and 50 heads at P 64, N 16; one batch row at a time) and prints the
largest share of each allowance per rounding choice:

    PYTHONPATH=src python tests/test_torch_ssd_bwd_tc.py
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba as jm
from repro_torch.kernels.ssd_scan.ref import ssd_chunked_bwd

LM_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (2.0 ** -7, 1e-2)}
Q = 64      # the kernels' chunk: the rows of one wgmma tile
# Each f32 operand of a product, and the parts it enters with:
#   wx    w_j x_j in the state pass's forward walk (H's update)
#   eldy  el_i dy_i in its reverse walk (dH's update)
#   sd    (S D)^T in dx
#   pair  A^T = (S D G)^T in d log a's pair terms
#   h     H_g in C H (d log a)
#   dh    dH_{g+1} in T (dx, d log a)
#   hdc   H_g in dc's state term
#   dhdb  dH_{g+1} in db's state term
#   wxdb  w_j x_j in db's state term
#   eldc  el_i dy_i in dc's state term
#   ds    the sum of dS over the heads in db's and dc's pair terms
ROUNDED = {"wx": 2, "eldy": 2, "sd": 2, "pair": 2, "h": 2, "dh": 2, "ds": 2,
           "hdc": 2, "dhdb": 2, "wxdb": 2, "eldc": 2}
# one rounding of one of these puts some output past its allowance
SPLIT = ["dh", "ds", "eldy", "h", "pair", "sd", "wx"]
# the operands of db's and dc's state terms: one rounding of a pair keeps
# db or dc within its allowance only through the relative term
STATE_TERMS = {"db": ("wxdb", "dhdb"), "dc": ("hdc", "eldc")}


@pytest.fixture(autouse=True, scope="module")
def _two_cpu_threads():
    """Large einsums, but in a test run of several workers on one machine
    more intra-op threads a worker only contend (this file took 30x its
    time alone in such a run at 8)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _round(v, parts):
    """v as a kernel feeds it to a wgmma: 0 = exact, 1 = one bf16 rounding, 2 = hi + lo parts."""
    if parts == 0:
        return v
    hi = v.to(torch.bfloat16).float()
    return hi if parts == 1 else hi + (v - hi).to(torch.bfloat16).float()


def emulate_bwd_tc(x, loga, b, c, dy, out_dtype=torch.bfloat16, **parts):
    """x, dy [B, L, H, P] bf16, loga [B, L, H] f32, b, c [B, L, N] bf16.
    Returns (dx [B, L, H, P], dloga [B, L, H] f32, db, dc [B, L, N]) with
    each operand in ``ROUNDED`` (overridden by ``parts``) rounded as the
    kernels round it; dx, db and dc in ``out_dtype`` (the kernels' bf16, or
    f32 to see the error before the outputs' own rounding)."""
    r = {**ROUNDED, **parts}
    B, L, H, P = x.shape
    N = b.shape[-1]
    G = -(-L // Q)
    pad = lambda t: torch.nn.functional.pad(t.float(), (0, 0) * (t.dim() - 2) + (0, G * Q - L))
    xg, dyg = (pad(t).reshape(B, G, Q, H, P) for t in (x, dy))
    bg, cg = (pad(t).reshape(B, G, Q, N) for t in (b, c))
    lc = torch.cumsum(pad(loga).reshape(B, G, Q, H), 2)            # rows past L add 0
    el, we = torch.exp(lc), torch.exp(lc[:, :, -1:] - lc)          # exp(lc_i), exp(lc_Q - lc_j)
    decay = torch.exp(lc[:, :, -1])                                # [B, G, H]

    # the state pass: the state entering each chunk, its gradient leaving it
    wx = torch.einsum("bgjh,bgjhp->bghjp", we, xg)
    eldy = torch.einsum("bgih,bgihp->bghip", el, dyg)
    summ = torch.einsum("bgjn,bghjp->bghnp", bg, _round(wx, r["wx"]))
    dsumm = torch.einsum("bgin,bghip->bghnp", cg, _round(eldy, r["eldy"]))
    h = torch.zeros(B, H, N, P)
    hs = []
    for g in range(G):
        hs.append(h)
        h = decay[:, g, :, None, None] * h + summ[:, g]
    dh = torch.zeros(B, H, N, P)
    dhs = [None] * G
    for g in reversed(range(G)):
        dhs[g] = dh
        dh = decay[:, g, :, None, None] * dh + dsumm[:, g]
    # stored as bf16 hi and lo planes: every reader sees hi + lo at most
    hs, dhs = _round(torch.stack(hs, 1), 2), _round(torch.stack(dhs, 1), 2)   # [B, G, H, N, P]
    h_r, dh_r = _round(hs, r["h"]), _round(dhs, r["dh"])

    # the chunk pass, in the kernel's orientation: rows j (keys), columns i
    ii = torch.arange(Q)
    vis = ii[:, None] <= ii[None, :]                               # j <= i
    st = torch.einsum("bgjn,bgin->bgji", bg, cg)                   # S^T, exact products
    gt = torch.einsum("bgjhp,bgihp->bghji", xg, dyg)               # G^T
    lch = lc.permute(0, 1, 3, 2)                                   # [B, G, H, Q]
    delta = lch[..., None, :] - lch[..., :, None]                  # [j, i]: lc_i - lc_j
    d = torch.where(vis, torch.exp(torch.where(vis, delta, 0.0)), 0.0)
    sdt = st[:, :, None] * d                                       # (S D)^T
    dst = gt * d                                                   # dS^T
    at = sdt * gt                                                  # A^T

    t = torch.einsum("bgjn,bghnp->bghjp", bg, dh_r)                # T = b dH
    stx = we.permute(0, 1, 3, 2) * (xg.permute(0, 1, 3, 2, 4) * t).sum(-1)
    dx = (we.permute(0, 1, 3, 2)[..., None] * t
          + torch.einsum("bghji,bgihp->bghjp", _round(sdt, r["sd"]), dyg))
    ch = torch.einsum("bgin,bghnp->bghip", cg, h_r)                # C H
    sty = el.permute(0, 1, 3, 2) * (dyg.permute(0, 1, 3, 2, 4) * ch).sum(-1)
    u = (ii[:, None] >= ii[None, :]).float()                       # U[i, t] = [i >= t]
    qm = torch.einsum("bghji,it->bghjt", _round(at, r["pair"]), u)
    rect = torch.where(ii[:, None] < ii[None, :], qm, 0.0).sum(-2)  # sum_{j < t}
    carry = (decay[:, :, :, None, None] * hs * dhs).sum((-2, -1))[..., None]
    dloga = (rect + torch.flip(torch.cumsum(torch.flip(sty, (-1,)), -1), (-1,))
             + torch.cumsum(stx, -1) - stx + carry)                # [B, G, H, Q]

    dsum = dst.sum(2)                                              # sum_h dS_h^T [B, G, j, i]
    db = (torch.einsum("bghjp,bghnp->bgjn", _round(wx, r["wxdb"]), _round(dhs, r["dhdb"]))
          + torch.einsum("bgji,bgin->bgjn", _round(dsum, r["ds"]), cg))
    dc = (torch.einsum("bghip,bghnp->bgin", _round(eldy, r["eldc"]), _round(hs, r["hdc"]))
          + torch.einsum("bgji,bgjn->bgin", _round(dsum, r["ds"]), bg))
    return (dx.permute(0, 1, 3, 2, 4).reshape(B, G * Q, H, P)[:, :L].to(out_dtype),
            dloga.permute(0, 1, 3, 2).reshape(B, G * Q, H)[:, :L],
            db.reshape(B, G * Q, N)[:, :L].to(out_dtype),
            dc.reshape(B, G * Q, N)[:, :L].to(out_dtype))


def allowance_share(got, want, dtype):
    """Largest share of |got - want| <= rtol |want| + atol rms(want) used."""
    rtol, atol = LM_TOL[dtype]
    got, want = got.double(), want.double()
    d = (got - want).abs()
    share = d / (rtol * want.abs() + atol * float(want.square().mean().sqrt()))
    return float(torch.where(d == 0, 0.0, share).max())


def shares(got, want):
    """{name: share} of dx, d log a (f32's allowance), db, dc (bf16's)."""
    return {n: allowance_share(g, w, torch.float32 if n == "dloga" else torch.bfloat16)
            for n, g, w in zip(("dx", "dloga", "db", "dc"), got, want)}


def _inputs(gen, B, L, H, P, N):
    """chip_smoke.py's SSD inputs, in bf16: x, dy ~ N(0, 1), log a = -0.4 |N(0, 1)|, b, c ~ 0.3 N(0, 1)."""
    x = torch.randn((B, L, H, P), generator=gen).to(torch.bfloat16)
    loga = -torch.randn((B, L, H), generator=gen).abs() * 0.4
    b = (torch.randn((B, L, N), generator=gen) * 0.3).to(torch.bfloat16)
    c = (torch.randn((B, L, N), generator=gen) * 0.3).to(torch.bfloat16)
    dy = torch.randn((B, L, H, P), generator=gen).to(torch.bfloat16)
    return x, loga, b, c, dy


@pytest.mark.parametrize("B,L,H,P,N", [
    (2, 256, 3, 64, 128),     # mamba2-780m's P and N
    (1, 200, 2, 64, 128),     # L off the 64-step chunk
    (2, 40, 4, 32, 32),       # L < 64
    (1, 384, 5, 32, 64),
    (2, 128, 6, 64, 16),      # hymba-1.5b's P and N
])
def test_tc_bwd_roundings_within_lm_tol(B, L, H, P, N):
    gen = torch.Generator().manual_seed(B * 1000 + L + H + P + N)
    x, loga, b, c, dy = _inputs(gen, B, L, H, P, N)
    got = emulate_bwd_tc(x, loga, b, c, dy)
    want = ssd_chunked_bwd(x, loga, b, c, dy, np.gcd(128, L))
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
    assert max(shares(got, want).values()) <= 1.0, shares(got, want)


def test_tc_bwd_emulation_matches_jax_vjp():
    """The emulation against ``jax.vjp`` of the reference's ``_ssd_chunked`` on the same inputs in f32."""
    gen = torch.Generator().manual_seed(3)
    B, L, H, P, N = 1, 192, 3, 32, 16
    x, loga, b, c, dy = _inputs(gen, B, L, H, P, N)
    h0 = jnp.zeros((B, H, N, P), jnp.float32)
    vjp = jax.vjp(lambda *a: jm._ssd_chunked(*a, h0, 64)[0],
                  *(jnp.asarray(t.float().numpy()) for t in (x, loga, b, c)))[1]
    want = vjp(jnp.asarray(dy.float().numpy()))
    got = emulate_bwd_tc(x, loga, b, c, dy)
    for n, g, w in zip(("dx", "dloga", "db", "dc"), got, want):
        w = torch.from_numpy(np.array(w))
        w = w if n == "dloga" else w.to(torch.bfloat16)
        assert allowance_share(g, w, torch.float32 if n == "dloga" else torch.bfloat16) <= 1.0, n


# mamba2-780m's training microbatch, one batch row at a time, as main() makes it
MAMBA2_MICROBATCH = (4, 2048, 48, 64, 128)


def _rows(B, L, H, P, N, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return [_inputs(gen, 1, L, H, P, N) for _ in range(B)]


@pytest.fixture(scope="module")
def microbatch():
    rows = _rows(*MAMBA2_MICROBATCH)
    return [(ins, ssd_chunked_bwd(*ins, 128)) for ins in rows]


def _worst(case, **parts):
    return max(max(shares(emulate_bwd_tc(*ins, **parts), want).values()) for ins, want in case)


def test_kernel_roundings_hold_at_the_full_microbatch(microbatch):
    assert _worst(microbatch) <= 1.0


@pytest.mark.parametrize("operand", SPLIT)
def test_one_rounding_of_each_split_operand_breaks_its_allowance(microbatch, operand):
    """Why each operand of ``SPLIT`` enters as two bf16 parts: at mamba2's
    training microbatch one rounding of it puts some output past its allowance."""
    assert _worst(microbatch, **{operand: 1}) > 1.0


@pytest.mark.parametrize("out", sorted(STATE_TERMS))
def test_one_rounding_of_a_state_term_spends_the_rms_allowance(out):
    """Why db's and dc's state terms take both operands as hi + lo: with one
    rounding of each, the output's error before its own rounding to bf16
    reaches half the allowance's 1e-2 rms term at ``SSDScanFn``'s check
    shape in ``chip_smoke.py`` (an element near zero has no relative term to
    spare); with the splits it stays under 1e-4 rms."""
    x, loga, b, c, dy = _inputs(torch.Generator().manual_seed(1), 2, 512, 8, 64, 128)
    i = ("dx", "dloga", "db", "dc").index(out)
    exact = ssd_chunked_bwd(*(t.double() for t in (x, loga, b, c, dy)), 128)[i]
    rms = exact.square().mean().sqrt()

    def err(**parts):
        got = emulate_bwd_tc(x, loga, b, c, dy, out_dtype=torch.float32, **parts)[i]
        return float((got.double() - exact).abs().max() / rms)

    assert err() < 1e-4
    assert err(**{k: 1 for k in STATE_TERMS[out]}) > 0.5e-2


def main():
    """The full training microbatches, one batch row at a time: per rounding
    choice, the largest share of each allowance, and db's and dc's largest
    error before their own rounding to bf16, |f32 - exact| / rms(exact),
    against ``ssd_chunked_bwd`` in f64."""
    for label, shape in {"mamba2-780m": MAMBA2_MICROBATCH, "hymba-1.5b": (4, 2048, 50, 64, 16)}.items():
        B, L, H, P, N = shape
        choices = {"as the kernels": {}, **{f"{k} rounded once": {k: 1} for k in SPLIT},
                   **{f"{k} rounded once": {k: 1} for ks in STATE_TERMS.values() for k in ks},
                   **{f"{o}'s state term rounded once": {k: 1 for k in ks} for o, ks in STATE_TERMS.items()}}
        worst = {k: {} for k in choices}
        for x, loga, b, c, dy in _rows(*shape):
            want = ssd_chunked_bwd(x, loga, b, c, dy, 128)
            exact = ssd_chunked_bwd(*(t.double() for t in (x, loga, b, c, dy)), 128)
            for name, kw in choices.items():
                for n, s in shares(emulate_bwd_tc(x, loga, b, c, dy, **kw), want).items():
                    worst[name][n] = max(worst[name].get(n, 0.0), s)
                f32 = emulate_bwd_tc(x, loga, b, c, dy, out_dtype=torch.float32, **kw)
                for n, i in (("db", 2), ("dc", 3)):
                    e = exact[i]
                    err = float((f32[i].double() - e).abs().max() / e.square().mean().sqrt())
                    worst[name][f"{n} error / rms"] = max(worst[name].get(f"{n} error / rms", 0.0), err)
        print(f"{label} [{B}, {L}, {H} heads, P {P}, N {N}], largest share of each allowance:")
        for name, s in worst.items():
            print(f"  {name}: " + ", ".join(f"{n} {v:.4f}" for n, v in s.items()))


if __name__ == "__main__":
    main()

"""Port parity: the attention backward (``attention_bwd_ref``, the forward
with its log-sum-exp ``gqa_attend_lse``, and ``FlashAttentionFn``, which
``flash_attention`` runs under autograd) against ``jax.vjp`` of the
reference's ``repro.models.layers.gqa_attend``.

Inputs come from numpy with a seed and go to both sides; every mask kind
(causal, window, prefix, none), GQA, odd head dims and Lq != Lk. Gradients
agree within 1e-5 of their scale (largest magnitude) in f32: the sums run
in another order. ``torch.autograd.gradcheck`` holds ``FlashAttentionFn``
to finite differences in float64. The backward kernels themselves run only
on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 7).

``emulate_tc_bwd`` repeats, on the CPU, the arithmetic of the bf16
tensor-core backward (``csrc/flash_attention_bwd.cu``:
``bwd_dkdv_dq_tc_kernel``'s dK / dV and dQ blocks, of one warpgroup up to
a padded head dim of 128 and of two at 192 and 256): bf16 inputs, exact
products with f32 sums for S and dP, P and dS fed to their products as
bf16 parts hi = bf16(x) and lo = bf16(x - hi) (or one rounding), one
rounding of dq, dk, dv to bf16.
It is held to ``attention_bwd_ref`` on the same bf16 inputs in f32 at the
LM kernels' bf16 tolerance (``chip_smoke.LM_TOL``, ``chip_smoke.lm_close``'s
formula): per element ``|d| <= 2^-7 |want| + 1e-2 rms(want)``, one bf16
ulp and 1% of a typical value near zero. Run as a script, it repeats the
emulation at smollm-135m's training shape (one batch row of
``[4, 9 H / 3 KV, 2048, 2048, 64]``, causal) and prints the share of the
allowance used with both parts, and with P's or dS's lo part dropped:

    PYTHONPATH=src python tests/test_torch_attention_bwd.py
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jl
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import (
    MaskSpec, attention_bwd_ref, gqa_attend, gqa_attend_lse,
)

# (B, Lq, Lk, H, KV, D, causal, window, prefix)
CASES = [
    (2, 24, 24, 6, 2, 16, True, 0, 0),       # causal, GQA 3:1
    (1, 19, 31, 4, 1, 20, True, 0, 0),       # ends aligned (Lq < Lk), odd lengths, MQA
    (2, 33, 33, 4, 4, 8, True, 7, 0),        # sliding window
    (1, 21, 29, 4, 2, 12, True, 6, 5),       # window and a prefix of always-visible keys
    (1, 17, 17, 2, 2, 24, True, 0, 9),       # a prefix past the causal edge of the first queries
    (1, 23, 11, 4, 2, 16, False, 0, 0),      # unmasked, more queries than keys (cross-attention)
    (2, 9, 26, 6, 3, 56, False, 0, 0),       # unmasked, fewer queries, deepseek-v3's dense head dim
    (1, 15, 15, 2, 1, 5, False, 0, 0),       # unmasked, Lq = Lk (an encoder), an odd head dim
]


LM_TOL_BF16 = (2.0 ** -7, 1e-2)   # chip_smoke.LM_TOL[torch.bfloat16]
# CASES and four at the tensor-core kernels' tile sizes: 256 x 256, GQA 3:1,
# causal (4 query and 4 key tiles of 64: both rings wrap); 130 queries over
# 200 keys at hd 32 with a window of 40 (ragged tiles, Lq < Lk); gemma3's
# head dims, which the two-warpgroup blocks take (padded to 192 and 256):
# 27b's 168 with a window and a prefix over Lq < Lk, 12b's 240 causal.
EMULATION_CASES = CASES + [(1, 256, 256, 6, 2, 64, True, 0, 0), (1, 130, 200, 4, 2, 32, True, 40, 0),
                           (1, 100, 164, 4, 2, 168, True, 30, 64), (1, 150, 150, 4, 2, 240, True, 0, 0)]


def _rel(want, got):
    want, got = np.asarray(want, np.float64), np.asarray(got, np.float64)
    return float(np.abs(want - got).max()) / max(float(np.abs(want).max()), 1e-30)


def _inputs(case, seed):
    B, Lq, Lk, H, KV, D = case[:6]
    rng = np.random.default_rng(seed)
    q, do = (rng.standard_normal((B, Lq, H, D)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((B, Lk, KV, D)).astype(np.float32) for _ in range(2))
    return q, k, v, do


def _reference(case, q, k, v, do):
    """out and (dq, dk, dv) from jax.vjp of the reference's gqa_attend."""
    _, Lq, Lk = case[:3]
    causal, window, prefix = case[6:]
    if causal:
        spec = jl.MaskSpec(causal=True, window=window, prefix=prefix, offset=Lk - Lq)
        f = lambda q, k, v: jl.gqa_attend(q, k, v, mask_spec=spec)
    else:
        f = lambda q, k, v: jl.gqa_attend(q, k, v)
    out, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _spec(case):
    _, Lq, Lk = case[:3]
    causal, window, prefix = case[6:]
    return MaskSpec(causal=True, window=window, offset=Lk - Lq, prefix=prefix) if causal else None


@pytest.mark.parametrize("case", CASES)
def test_attention_bwd_ref_matches_jax_vjp(case):
    q, k, v, do = _inputs(case, 1)
    out_j, grads_j = _reference(case, q, k, v, do)
    q_t, k_t, v_t, do_t = map(torch.from_numpy, (q, k, v, do))
    out, lse = gqa_attend_lse(q_t, k_t, v_t, mask_spec=_spec(case))
    assert lse.shape == (case[0], case[3], case[1]) and lse.dtype == torch.float32
    assert _rel(out_j, out) < 1e-5
    # out agrees with the plain forward the prefill path runs
    assert _rel(gqa_attend(q_t, k_t, v_t, mask_spec=_spec(case)), out) < 1e-6
    grads = attention_bwd_ref(q_t, k_t, v_t, out, lse, do_t, _spec(case))
    for name, gj, gt in zip("qkv", grads_j, grads):
        assert gt.shape == gj.shape and gt.dtype == torch.float32
        assert _rel(gj, gt) < 1e-5, (case, f"d{name}")


@pytest.mark.parametrize("case", CASES)
def test_flash_attention_autograd_matches_jax_vjp(case):
    """``flash_attention`` under autograd on CPU tensors: ``FlashAttentionFn``
    with its plain halves; no kernel launch is counted."""
    q, k, v, do = _inputs(case, 2)
    out_j, grads_j = _reference(case, q, k, v, do)
    qkv = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    n0, nb0 = flash_ops.launches, flash_ops.launches_bwd
    out = flash_ops.flash_attention(*qkv, causal=case[6], window=case[7], prefix=case[8])
    assert out.grad_fn is not None and type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    assert _rel(out_j, out.detach()) < 1e-5
    out.backward(torch.from_numpy(do))
    for name, gj, t in zip("qkv", grads_j, qkv):
        assert _rel(gj, t.grad) < 1e-5, (case, f"d{name}")
    assert (flash_ops.launches, flash_ops.launches_bwd) == (n0, nb0)


def test_flash_attention_without_grad_takes_the_plain_forward():
    """Under no_grad (prefill) the same call is the plain forward, no autograd node."""
    q, k, v, _ = _inputs(CASES[0], 3)
    qkv = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    with torch.no_grad():
        out = flash_ops.flash_attention(*qkv)
    assert out.grad_fn is None
    torch.testing.assert_close(out, gqa_attend(*qkv, mask_spec=MaskSpec()).detach(), rtol=0, atol=0)


@pytest.mark.parametrize("case", [(1, 6, 6, 4, 2, 3, True, 2, 1), (1, 5, 7, 2, 1, 4, True, 0, 0),
                                  (2, 5, 3, 2, 2, 3, False, 0, 0)])
def test_flash_attention_fn_gradcheck(case):
    """Finite differences in float64 at a tiny size, every input's gradient."""
    B, Lq, Lk, H, KV, D, causal, window, prefix = case
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.standard_normal((B, Lq, H, D))).requires_grad_(True)
    k = torch.from_numpy(rng.standard_normal((B, Lk, KV, D))).requires_grad_(True)
    v = torch.from_numpy(rng.standard_normal((B, Lk, KV, D))).requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda q, k, v: flash_ops.FlashAttentionFn.apply(q, k, v, causal, window, prefix), (q, k, v))


def _parts(x, parts):
    """x as the kernels feed it to a wgmma: bf16 hi + lo parts (2) or one rounding (1)."""
    hi = x.to(torch.bfloat16).float()
    return hi if parts == 1 else hi + (x - hi).to(torch.bfloat16).float()


def emulate_tc_bwd(q, k, v, o, lse, do, mask_spec=None, *, p_parts=2, ds_parts=2):
    """The bf16 tensor-core backward's arithmetic: q, k, v, o, do bf16 in the
    model's layout, lse [B, H, Sq] f32; returns (dq, dk, dv) in bf16.
    hi + lo summed in f32 is exact, and so is its product with a bf16
    operand, so this differs from the kernels only in summation order."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.float().reshape(B, Sq, KV, G, hd)
    dog = do.float().reshape(B, Sq, KV, G, hd)
    kf, vf = k.float(), v.float()
    scale = hd ** -0.5
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, kf) * scale
    p = torch.exp(s - lse.reshape(B, KV, G, Sq)[..., None])
    if mask_spec is not None:
        p = torch.where(mask_spec.block(0, Sq, k.shape[1])[:, None, None], p, 0.0)
    dp = torch.einsum("bqkgd,bskd->bkgqs", dog, vf)
    delta = (dog * o.float().reshape(B, Sq, KV, G, hd)).sum(-1).permute(0, 2, 3, 1)
    ds = p * (dp - delta[..., None])
    pr, dsr = _parts(p, p_parts), _parts(ds, ds_parts)
    dv = torch.einsum("bkgqs,bqkgd->bskd", pr, dog)
    dk = torch.einsum("bkgqs,bqkgd->bskd", dsr, qg) * scale
    dq = torch.einsum("bkgqs,bskd->bqkgd", dsr, kf).reshape(B, Sq, H, hd) * scale
    return tuple(g.to(torch.bfloat16) for g in (dq, dk, dv))


def allowance_share(got, want):
    """Largest share of ``|got - want| <= 2^-7 |want| + 1e-2 rms(want)`` used
    (``chip_smoke.lm_close`` at bf16's tolerance)."""
    rtol, atol = LM_TOL_BF16
    got, want = got.double(), want.double()
    d = (got - want).abs()
    share = d / (rtol * want.abs() + atol * float(want.square().mean().sqrt()))
    return float(torch.where(d == 0, 0.0, share).max())


def _bf16_problem(case, seed):
    """bf16 inputs, and the forward's out (rounded to bf16, as the kernel
    writes it) and lse on them."""
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16) for a in _inputs(case, seed))
    out, lse = gqa_attend_lse(q.float(), k.float(), v.float(), mask_spec=_spec(case))
    return q, k, v, out.to(torch.bfloat16), lse, do


@pytest.mark.parametrize("case", EMULATION_CASES)
def test_tc_bwd_emulation_within_lm_tol(case):
    """The tensor-core backward's roundings (P and dS as hi + lo parts) keep
    dq, dk and dv within bf16's allowance of the f32 plain version on the
    same bf16 inputs."""
    q, k, v, out, lse, do = _bf16_problem(case, 6)
    got = emulate_tc_bwd(q, k, v, out, lse, do, _spec(case))
    want = attention_bwd_ref(q.float(), k.float(), v.float(), out.float(), lse, do.float(), _spec(case))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        assert allowance_share(g, w) <= 1.0, (case, name)


def test_flash_attention_bwd_checks_its_inputs():
    q, k, v, do = map(torch.from_numpy, _inputs(CASES[0], 5))
    out, lse = flash_ops.flash_attention_lse(q, k, v)
    with pytest.raises(ValueError):
        flash_ops.flash_attention_bwd(q, k, v, out[:, :-1], lse, do)
    with pytest.raises(ValueError):
        flash_ops.flash_attention_bwd(q, k, v, out, lse.transpose(1, 2), do)
    with pytest.raises(ValueError):
        flash_ops.flash_attention_bwd(q, k[:, :5], v[:, :5], out, lse, do)   # masked needs Lq <= Lk
    grads = flash_ops.flash_attention_bwd(q, k, v, out, lse, do)
    assert [g.shape for g in grads] == [q.shape, k.shape, v.shape]


@pytest.mark.parametrize("D", [5, 20, 56, 64, 120, 128, 130, 168, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_route_by_dtype_and_head_dim(dtype, D):
    """bf16 at every head dim up to 256 takes the tensor-core kernels at the
    head dim padded to a multiple of 8; every f32 head dim the CUDA-core
    kernels at D."""
    tc, Dk = flash_ops.bwd_route(dtype, D)
    padded = -(-D // 8) * 8
    assert tc == (dtype == torch.bfloat16)
    assert Dk == (padded if tc else D)


def _smollm_shares():
    """The emulation at one batch row of smollm-135m's training shape, causal."""
    case = (1, 2048, 2048, 9, 3, 64, True, 0, 0)
    q, k, v, out, lse, do = _bf16_problem(case, 7)
    want = attention_bwd_ref(q.float(), k.float(), v.float(), out.float(), lse, do.float(), _spec(case))
    for p_parts, ds_parts in ((2, 2), (1, 2), (2, 1)):
        got = emulate_tc_bwd(q, k, v, out, lse, do, _spec(case), p_parts=p_parts, ds_parts=ds_parts)
        shares = {n: round(allowance_share(g, w), 4) for n, g, w in zip(("dq", "dk", "dv"), got, want)}
        print(f"P {'hi + lo' if p_parts == 2 else 'one rounding'}, dS {'hi + lo' if ds_parts == 2 else 'one rounding'}: "
              f"largest share of the bf16 allowance {shares}")


if __name__ == "__main__":
    _smollm_shares()

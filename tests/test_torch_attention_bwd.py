"""Port parity: the attention backward (``attention_bwd_ref``, the forward
with its log-sum-exp ``gqa_attend_lse``, and ``FlashAttentionFn``, which
``flash_attention`` runs under autograd) against ``jax.vjp`` of the
reference's ``repro.models.layers.gqa_attend``.

Inputs come from numpy with a seed and go to both sides; every mask kind
(causal, window, prefix, none), GQA, odd head dims and Lq != Lk. Gradients
agree within 1e-5 of their scale (largest magnitude) in f32: the sums run
in another order. ``torch.autograd.gradcheck`` holds ``FlashAttentionFn``
to finite differences in float64. The backward kernel itself runs only on
the card (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 7).
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

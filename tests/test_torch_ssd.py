"""Port parity: the SSD scan's plain versions and the port's Mamba-2 block
against ``repro.models.mamba`` and ``repro.kernels.ssd_scan`` (the Pallas
kernel in interpret mode).

The chunked plain version agrees with the reference's ``_ssd_chunked`` to
1e-5 and with the Pallas kernel to 2e-4, the reference sweep's own
tolerance (sequential and chunked sums round differently). Each
tolerance is relative to the scale of the compared output (its largest
magnitude, at least 1): einsums contract in another order in each
framework, and long scans reach values of several units.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.kernels.ssd_scan.kernel import ssd_pallas_call
from repro.kernels.ssd_scan.ref import ssd_ref as j_ssd_ref
from repro.models import mamba as jm
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import ssd_chunked, ssd_ref
from repro_torch.models import mamba as tm

from conftest import reduce_cfg

RNG = np.random.default_rng(71)


def _inputs(B, S, H, P, N):
    x = RNG.standard_normal((B, S, H, P)).astype(np.float32)
    loga = (-np.abs(RNG.standard_normal((B, S, H))) * 0.4).astype(np.float32)
    b = (RNG.standard_normal((B, S, N)) * 0.3).astype(np.float32)
    c = (RNG.standard_normal((B, S, N)) * 0.3).astype(np.float32)
    return x, loga, b, c


def _close(want, got, tol):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=tol * scale)


@pytest.mark.parametrize("B,S,H,P,N,chunk,h0", [
    (1, 256, 2, 32, 16, 128, False),
    (2, 64, 3, 16, 8, 64, True),
    (1, 384, 2, 64, 32, 128, True),
])
def test_ssd_chunked_matches_reference(B, S, H, P, N, chunk, h0):
    x, loga, b, c = _inputs(B, S, H, P, N)
    h = (RNG.standard_normal((B, H, N, P)) * 0.1).astype(np.float32) if h0 else np.zeros((B, H, N, P), np.float32)
    yj, hj = jm._ssd_chunked(*map(jnp.asarray, (x, loga, b, c, h)), chunk=chunk)
    yt, ht = ssd_chunked(*map(torch.from_numpy, (x, loga, b, c)), torch.from_numpy(h) if h0 else None, chunk)
    _close(yj, yt, 1e-5)
    _close(hj, ht, 1e-5)
    assert tm._ssd_chunked is ssd_chunked


@pytest.mark.parametrize("B,S,H,P,N", [(1, 256, 2, 32, 16), (2, 128, 2, 64, 32)])
def test_ssd_plain_matches_pallas_kernel_and_oracle(B, S, H, P, N):
    x, loga, b, c = _inputs(B, S, H, P, N)
    yt, ht = ssd_ops.ssd_scan(*map(torch.from_numpy, (x, loga, b, c)))    # CPU: the plain version
    # the Pallas kernel takes b/c per (batch, head): repeat them over heads
    xk = np.moveaxis(x, 2, 1).reshape(B * H, S, P)
    lk = np.moveaxis(loga, 2, 1).reshape(B * H, S)
    bk = np.repeat(b[:, None], H, 1).reshape(B * H, S, N)
    ck = np.repeat(c[:, None], H, 1).reshape(B * H, S, N)
    yk, hk = ssd_pallas_call(*map(jnp.asarray, (xk, lk, bk, ck)), q_blk=128, interpret=True)
    y_bh = np.moveaxis(yt.numpy(), 2, 1).reshape(B * H, S, P)
    _close(yk, y_bh, 2e-4)
    _close(hk, ht.numpy().reshape(B * H, N, P), 2e-4)
    yr, hr = j_ssd_ref(*map(jnp.asarray, (xk, lk, bk, ck)))
    yo, ho = ssd_ref(*map(torch.from_numpy, (xk, lk, bk, ck)))
    _close(yr, yo, 1e-5)
    _close(hr, ho, 1e-5)
    _close(yr, y_bh, 2e-4)


def test_ssd_wrapper_checks():
    x, loga, b, c = map(torch.from_numpy, _inputs(1, 96, 2, 8, 4))
    with pytest.raises(ValueError, match="multiple of chunk"):
        ssd_ops.ssd_scan(x, loga, b, c, chunk=64)
    n0 = ssd_ops.launches
    y, h = ssd_ops.ssd_scan(x, loga, b, c, chunk=32)
    assert ssd_ops.launches == n0 and y.shape == x.shape and h.shape == (1, 2, 4, 8)
    with pytest.raises(ValueError, match="want x"):
        ssd_ops.ssd_scan(x, loga[..., :1], b, c)


def _mamba_params(cfg):
    d_inner, H, P, N = tm._dims(cfg, cfg.d_model)
    D, C = cfg.d_model, d_inner + 2 * N
    n = lambda *s, scale: (RNG.standard_normal(s) * scale).astype(np.float32)
    return {"in_proj": n(D, 2 * d_inner + 2 * N + H, scale=D ** -0.5),
            "conv_w": n(cfg.conv_width, C, scale=0.5), "conv_b": n(C, scale=0.1),
            "a_log": np.log(np.linspace(1.0, 16.0, H)).astype(np.float32),
            "dt_bias": n(H, scale=0.5), "d_skip": 1 + n(H, scale=0.1),
            "norm": {"scale": 1 + n(d_inner, scale=0.1)}, "out_proj": n(d_inner, D, scale=d_inner ** -0.5)}


def test_mamba_prefill_and_decode():
    cfg = reduce_cfg(get_config("mamba2-780m"))
    tcfg = ArchConfig(**dataclasses.asdict(cfg))
    p = _mamba_params(cfg)
    pj = {k: ({kk: jnp.asarray(vv) for kk, vv in v.items()} if isinstance(v, dict) else jnp.asarray(v))
          for k, v in p.items()}
    pt = {k: ({kk: torch.from_numpy(vv) for kk, vv in v.items()} if isinstance(v, dict) else torch.from_numpy(v))
          for k, v in p.items()}
    x = RNG.standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    oj, cj = jm.mamba_prefill(pj, jnp.asarray(x), cfg)
    for use_kernels in (True, False):
        ot, ct = tm.mamba_prefill(pt, torch.from_numpy(x), tcfg, use_kernels=use_kernels)
        _close(oj, ot, 1e-5)
        for name in ("conv", "h"):
            _close(cj[name], ct[name], 1e-5)
    for _ in range(3):
        xd = RNG.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        oj, cj = jm.mamba_decode(pj, jnp.asarray(xd), cj, cfg)
        ot, ct = tm.mamba_decode(pt, torch.from_numpy(xd), ct, tcfg)
        _close(oj, ot, 1e-5)
        for name in ("conv", "h"):
            _close(cj[name], ct[name], 1e-5)

"""Mamba-2 block (SSD, state-space duality, arXiv:2405.21060).

Counterpart of ``repro/models/mamba.py``. Prefill runs the chunked SSD
through the hand-written CUDA kernel (``kernels/ssd_scan``), training
through ``SSDScanFn`` (that kernel forward, the backward kernel
backward); the plain chunked form (``_ssd_chunked``, under autograd in
training) runs with ``use_kernels=False``, and each kernel's plain
version on the CPU. The projections, the causal conv, softplus, the gate
and the norm are plain torch under autograd, as the reference leaves them
to XLA. Decode carries (conv window, SSD state): O(1) per token.

On a mesh (DTensor activations) the scan runs on each rank's batch rows and
heads (``_scan_on_mesh``), in training and in prefill (which also returns
the final state, its heads split as the scan's). Decode reads caches placed
by ``training.cache_specs`` (``h``'s heads and ``conv``'s channels over
``model``): ``_decode_on_mesh`` gathers the small conv window, steps this
rank's heads of the state and gathers their outputs for the norm.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..kernels.ssd_scan.ops import SSDScanFn, ssd_scan
from ..kernels.ssd_scan.ref import ssd_chunked as _ssd_chunked
from .layers import _dense_init, _is_dtensor, batch_layout, init_rmsnorm, local_rows, rmsnorm


def _dims(cfg: ArchConfig, d_in: int):
    d_inner = cfg.ssm_expand * d_in
    H = max(d_inner // cfg.ssm_head_dim, 1)
    P = cfg.ssm_head_dim
    N = cfg.ssm_state
    return d_inner, H, P, N


def init_mamba(gen, cfg: ArchConfig, device, d_in: Optional[int] = None) -> dict:
    d_in = d_in or cfg.d_model
    d_inner, H, P, N = _dims(cfg, d_in)
    conv_ch = d_inner + 2 * N
    return {
        "in_proj": _dense_init(gen, (d_in, 2 * d_inner + 2 * N + H), device),
        "conv_w": _dense_init(gen, (cfg.conv_width, conv_ch), device, scale=cfg.conv_width ** -0.5),
        "conv_b": torch.zeros((conv_ch,), device=device),
        "a_log": torch.log(torch.linspace(1.0, 16.0, H, device=device)),
        "dt_bias": torch.zeros((H,), device=device),
        "d_skip": torch.ones((H,), device=device),
        "norm": init_rmsnorm(d_inner, device),
        "out_proj": _dense_init(gen, (d_inner, d_in), device),
    }


def _split_proj(p, x, cfg, d_in):
    d_inner, H, P, N = _dims(cfg, d_in)
    zxbcdt = batch_layout(x @ p["in_proj"].to(x.dtype))   # on a mesh: whole rows, which the slices below cut
    z = zxbcdt[..., :d_inner]
    xbc = zxbcdt[..., d_inner:2 * d_inner + 2 * N]
    dt = zxbcdt[..., 2 * d_inner + 2 * N:]
    return z, xbc, dt


def _causal_conv(p, xbc):
    """Depthwise causal conv, width W. xbc [B, S, C]."""
    W = p["conv_w"].shape[0]
    pad = F.pad(xbc, (0, 0, W - 1, 0))
    out = sum(pad[:, i:i + xbc.shape[1], :] * p["conv_w"][i].to(xbc.dtype) for i in range(W))
    return F.silu(out + p["conv_b"].to(xbc.dtype))


def _scan_inputs(p, x, cfg: ArchConfig, d_in: int):
    """The projections and causal conv of a full sequence: (z, the raw conv
    inputs, xs [B,S,H,P], b, c, log a [B,S,H] f32, x dt), the reference's
    steps before ``_ssd_chunked``."""
    d_inner, H, P, N = _dims(cfg, d_in)
    B, S, _ = x.shape
    z, xbc_raw, dt = _split_proj(p, x, cfg, d_in)
    if _is_dtensor(xbc_raw):       # on a mesh: each rank's rows, the conv's weights whole
        xbc = local_rows(lambda a, w, b: _causal_conv({"conv_w": w, "conv_b": b}, a), xbc_raw,
                         p["conv_w"], p["conv_b"])
    else:
        xbc = _causal_conv(p, xbc_raw)
    xs = xbc[..., :d_inner].reshape(B, S, H, P)
    b = xbc[..., d_inner:d_inner + N]
    c = xbc[..., d_inner + N:]
    dtf = F.softplus(dt.float() + p["dt_bias"])                   # [B,S,H]
    loga = dtf * -torch.exp(p["a_log"])                           # a = -exp(a_log) < 0
    return z, xbc_raw, xs, b, c, loga, xs * dtf[..., None].to(xs.dtype)


def _scan_out(p, y, xs, z):
    """The skip, gate, norm and out projection after the scan."""
    B, S, H, P = xs.shape
    y = (y + xs * p["d_skip"][None, None, :, None].to(xs.dtype)).reshape(B, S, H * P)
    names = y.device_mesh.mesh_dim_names if _is_dtensor(y) else ()
    if "model" in names and H % y.device_mesh.size(names.index("model")):
        # heads that split unevenly over "model": no view back into them can
        # follow such a split in the backward, so the rows stay whole here
        y = batch_layout(y)
    y = rmsnorm(p["norm"], y * F.silu(z))
    return batch_layout(y @ p["out_proj"].to(y.dtype))


def _train_scan(xdt, loga, b, c, chunk: int, use_kernels: bool):
    if use_kernels:
        return SSDScanFn.apply(xdt, loga, b, c, chunk)
    return _ssd_chunked(xdt, loga, b, c, None, chunk)[0]


def _prefill_scan(xdt, loga, b, c, chunk: int, use_kernels: bool):
    if use_kernels:
        return ssd_scan(xdt, loga, b, c, chunk=chunk)
    return _ssd_chunked(xdt, loga, b, c, None, chunk)


def _scan_on_mesh(xdt, loga, b, c, chunk: int, use_kernels: bool, mesh, final: bool = False):
    """The scan of DTensor inputs on each rank's shards under ``local_map``:
    the batch split over the axes but ``model`` (where it divides), and the
    heads of x dt [B, S, H, P] and log a [B, S, H] split over ``model``
    where H divides it (else replicated); b, c [B, S, N], shared by the
    heads, replicated over ``model``, their gradients partial sums there.
    ``final``: prefill's scan, (y, the final state [B, H, N, P] with its
    heads split as y's)."""
    from .layers import _batch_placements, _dtensor_api

    _, Partial, Replicate, Shard, local_map = _dtensor_api()
    bp = _batch_placements(mesh, xdt.shape[0], "model")
    heads = "model" in mesh.axis_names and xdt.shape[2] % mesh.shape["model"] == 0
    hp = [Shard(2) if a == "model" and heads else q for a, q in zip(mesh.axis_names, bp)]
    gp = [Partial() if a == "model" and heads else q for a, q in zip(mesh.axis_names, bp)]
    dm = mesh.device_mesh
    args = [xdt.redistribute(dm, hp), loga.redistribute(dm, hp), b.redistribute(dm, bp), c.redistribute(dm, bp)]
    if final:
        sp = [Shard(1) if a == "model" and heads else q for a, q in zip(mesh.axis_names, bp)]
        return local_map(lambda *a: _prefill_scan(*a, chunk, use_kernels), out_placements=(hp, sp),
                         in_placements=(hp, hp, bp, bp), device_mesh=dm)(*args)
    fn = lambda *a: _train_scan(*a, chunk, use_kernels)          # noqa: E731
    return local_map(fn, out_placements=(hp,), in_placements=(hp, hp, bp, bp),
                     in_grad_placements=(hp, hp, gp, gp), device_mesh=dm)(*args)


def mamba_train(p, x, cfg: ArchConfig, *, d_in=None, chunk: int = 128, use_kernels: bool = True, mesh=None):
    """Full-sequence pass without a cache, differentiable on both paths
    (the reference's ``mamba_train``). On a ``mesh`` (DTensor activations)
    the scan runs on each rank's batch rows and heads (``_scan_on_mesh``)."""
    z, _, xs, b, c, loga, xdt = _scan_inputs(p, x, cfg, d_in or cfg.d_model)
    chunk = min(chunk, x.shape[1])
    if mesh is not None and _is_dtensor(xdt):
        y = _scan_on_mesh(xdt, loga, b, c, chunk, use_kernels, mesh)
    else:
        y = _train_scan(xdt, loga, b, c, chunk, use_kernels)
    return _scan_out(p, y, xs, z)


def mamba_prefill(p, x, cfg: ArchConfig, *, d_in=None, chunk: int = 128, use_kernels: bool = True,
                  mesh=None):
    """Full-sequence pass that also returns (conv_state, ssd_state); on a
    ``mesh`` (DTensor activations) the scan runs through ``_scan_on_mesh``."""
    z, xbc_raw, xs, b, c, loga, xdt = _scan_inputs(p, x, cfg, d_in or cfg.d_model)
    chunk = min(chunk, x.shape[1])
    if mesh is not None and _is_dtensor(xdt):
        y, h_fin = _scan_on_mesh(xdt, loga, b, c, chunk, use_kernels, mesh, final=True)
    else:
        y, h_fin = _prefill_scan(xdt, loga, b, c, chunk, use_kernels)
    out = _scan_out(p, y, xs, z)
    # last raw inputs; a copy, so the cache does not hold the whole projection
    conv_state = xbc_raw[:, -(cfg.conv_width - 1):, :].clone()
    return out, {"conv": conv_state, "h": h_fin}


def _decode_step(window, dt, h, conv_w, conv_b, dt_bias, a_log, d_skip, d_inner: int, N: int, h0: int = 0):
    """The SSD step of heads ``h0 .. h0 + Hl`` (``h`` [B, Hl, N, P], ``dt``
    [B, 1, Hl], ``dt_bias`` / ``a_log`` / ``d_skip`` [Hl]) on the conv window
    [B, W, C] (all channels): (y [B, Hl, P] in the window's dtype, new h)."""
    B, Hl, _, P = h.shape
    conv = sum(window[:, i, :] * conv_w[i].to(window.dtype) for i in range(window.shape[1]))
    xbc = F.silu(conv + conv_b.to(window.dtype))                  # [B, C]
    xs = xbc[..., h0 * P:(h0 + Hl) * P].reshape(B, Hl, P)
    b = xbc[..., d_inner:d_inner + N]
    c = xbc[..., d_inner + N:]
    dtf = F.softplus(dt[:, 0].float() + dt_bias)                  # [B,Hl]
    decay = torch.exp(dtf * -torch.exp(a_log))                    # [B,Hl]
    h = decay[..., None, None] * h + torch.einsum(
        "bn,bhp->bhnp", b.float(), (xs * dtf[..., None].to(xs.dtype)).float())
    y = torch.einsum("bn,bhnp->bhp", c.float(), h).to(window.dtype)
    return y + xs * d_skip[None, :, None].to(xs.dtype), h


def mamba_decode(p, x, cache: dict, cfg: ArchConfig, *, d_in=None, mesh=None):
    """One token. x [B, 1, D]; cache conv [B, W-1, C], h [B, H, N, P]. On a
    ``mesh`` (DTensor caches) through ``_decode_on_mesh``."""
    d_in = d_in or cfg.d_model
    d_inner, H, P, N = _dims(cfg, d_in)
    B = x.shape[0]
    z, xbc_raw, dt = _split_proj(p, x, cfg, d_in)                 # [B,1,...]
    if mesh is not None and _is_dtensor(cache["h"]):
        y, window, h = _decode_on_mesh(p, cache, xbc_raw, dt, d_inner, N)
    else:
        window = torch.cat([cache["conv"], xbc_raw], dim=1)        # [B, W, C]
        y, h = _decode_step(window, dt, cache["h"], p["conv_w"], p["conv_b"], p["dt_bias"], p["a_log"],
                            p["d_skip"], d_inner, N)
    y = rmsnorm(p["norm"], y.reshape(B, 1, d_inner) * F.silu(z))
    out = batch_layout(y @ p["out_proj"].to(y.dtype))
    conv = window[:, 1:]
    if _is_dtensor(cache["conv"]):
        conv = conv.redistribute(conv.device_mesh, cache["conv"].placements)
    return out, {"conv": conv, "h": h}


def _decode_on_mesh(p, cache: dict, xbc_raw, dt, d_inner: int, N: int):
    """``_decode_step`` on DTensors under ``local_map``: the conv window
    gathered whole over every dim but the batch (it is [B, W, C], small),
    the state's heads as ``cache["h"]`` places them (``model`` or
    replicated) and the per-head parameters and ``dt`` split to match; y's
    heads then gathered. Returns (y [B, H, P], the window [B, W, C], h)."""
    from .layers import _dtensor_api, _global_offset

    _, _, Replicate, Shard, local_map = _dtensor_api()
    hc = cache["h"]
    dm, hpl = hc.device_mesh, list(hc.placements)
    bp = [q if isinstance(q, Shard) and q.dim == 0 else Replicate() for q in hpl]
    if any(isinstance(q, Shard) and q.dim not in (0, 1) for q in hpl):
        hc = hc.redistribute(dm, [q if isinstance(q, Shard) and q.dim in (0, 1) else Replicate() for q in hpl])
        hpl = list(hc.placements)
    hdims = [i for i, q in enumerate(hpl) if isinstance(q, Shard) and q.dim == 1]
    per_head = [Shard(0) if i in hdims else Replicate() for i in range(dm.ndim)]
    yp = [Shard(1) if i in hdims else b for i, b in enumerate(bp)]
    dtp = [Shard(2) if i in hdims else b for i, b in enumerate(bp)]
    h0 = _global_offset(hc)[1]
    window = local_map(lambda a, b: torch.cat([a, b], dim=1), out_placements=(bp,), in_placements=(bp, bp),
                       device_mesh=dm)(cache["conv"].redistribute(dm, bp), xbc_raw.redistribute(dm, bp))
    rep = [Replicate()] * dm.ndim
    fn = lambda *a: _decode_step(*a, d_inner, N, h0)           # noqa: E731
    y, h = local_map(fn, out_placements=(yp, hpl), in_placements=(bp, dtp, hpl, rep, rep, per_head, per_head,
                                                                  per_head), device_mesh=dm)(
        window, dt.redistribute(dm, dtp), hc, p["conv_w"].redistribute(dm, rep), p["conv_b"].redistribute(dm, rep),
        *(p[n].redistribute(dm, per_head) for n in ("dt_bias", "a_log", "d_skip")))
    return y.redistribute(dm, bp), window, h

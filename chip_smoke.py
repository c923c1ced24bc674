"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --traverse-ab [--src OTHER_CHECKOUT/src]

The second form only times the traversal at a 256-row batch under each
tile plan (``traverse_batch_ab``). The first:

1. the card (``nvidia-smi`` name and power limit) and the versions;
2. builds the CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc``
   per source, all started together, then one link), and checks with
   ``cuobjdump -sass`` that the bf16 attention and SSD kernels run
   ``HGMMA`` (wgmma) instructions in every instantiation;
3. holds each kernel against its plain PyTorch version at small shapes:
   the three PRF kernels (the histogram and the split scan also at
   B 256, C 300, past their shared memory's class limits, in class
   tiles; the traversal bitwise over the twelve cases of
   ``tests/test_torch_traverse_cases.py``: N 1 to 70001, trees split over
   threads, ragged tiles and tree groups, C up to 37, a wide F, F 70000
   past 16 bits of feature id (the wide node layout), chunks through the
   carry),
   then attention (odd lengths, Lq < Lk, window,
   GQA, f32 and bf16) and the SSD scan (S in {64, 200, 320, 384}, P in
   {32, 64}, N in {16, 32, 64, 128}, chunk 8, 64 or 128, f32 and bf16),
   the LM kernels at ``LM_TOL``, each dtype on its own kernel;
4. reduced end to end: the kernel path and the plain path give the same
   forest and labels, histogram reuse on gives reuse off's forest on
   both paths, growth with reuse on (where ``"auto"`` resolves on) and
   off timed in turns, and (f32, TF32 off) the same greedy LM tokens for
   smollm-135m and mamba2-780m at cut widths;
5. full size, PRF: the README quickstart configuration on 2^20 training
   rows, F = 128, through ``train_prf`` and ``PRFModel.predict``, with
   kernel launch counts read around that one run, per-stage times,
   accuracy; then histogram reuse at full size (budget 1024 MiB, the
   same weights and mask as the staged replay): forests bitwise equal to
   reuse off, growth timed in turns, its own launch counts and peak
   memory, the histogram at R = 128 rank segments; each kernel timed at
   the main path's shapes beside its plain version, its bound and (for
   the histogram) one ``index_add_``; the histogram and the split scan
   also at a deep level's shape (128 slots, ~8% parked), the histogram
   beside the time of its per-level slot ordering; the traversal also
   at N = 256 (``traverse_shapes``, not a row of the kernels line);
5b. full size, streamed (``streamed_phase``): the same configuration
   with ``sample_block = 131072`` from an ``np.memmap`` of the training
   rows: with exact bins and the replay's draws the resident model
   bitwise; then ``train_prf`` on the memmap (sketch bins) and its
   streamed ``predict``, with its own launch counts, peak memory,
   accuracy, streamed predict equal to resident; a staged replay's
   stage times, growth per level and the feed wait, growth from pageable
   and from pinned host bins in turns; the histogram added into a carry
   at the block shape, the split scan on the carry (level 0: all 8
   blocks) and the S = 1 root histogram over the blocks, bitwise;
5c. full size, checkpoints (``checkpoint_phase``, in a directory under
   ``build/`` removed at the end): resident growth with a checkpoint every
   level killed from ``on_level`` at level 4 and resumed (first resumed
   level 5, the replay's forest bitwise), the newest step corrupted and
   resumed (a walk-back warning, the same forest), the same kill and
   resume streamed (phase 5b's exact-bins forest); one step's bytes, a
   save split into device-to-host copy, CRC32 and ``np.save``, a restore,
   growth with a checkpoint every level against none in turns; a
   regression growth killed at level 4 and resumed (in phase 5d, on its
   data), bitwise the uninterrupted regression growth;
5d. full size, regression (``regression_phase``): ``make_regression``
   on 2^20 training rows, F = 128, ``train_prf`` + ``predict`` on the three
   PRF kernels with their launch counts, held-out R^2 >= ``R2_FLOOR``,
   stage times; the histogram at the level-0 regression slab (C 3, the
   ``y`` and ``y^2`` channels in fixed point) bitwise against its
   fixed-point plain version, timed beside the float-atomic form, its
   plain version, its bound and ``index_add_`` (over chunks of trees);
   the split scan on it (also as direct launches); at a reduced size the
   kernel path against the plain path; two growths with the same draws
   bitwise equal (``regression_run_to_run_equal``, checked);
5e. the mesh plane (``mesh_phase``): (a) an NCCL world of one process, mesh
   (1, 1), at phase 5's full size with its draws: ``grow_sharded`` through
   ``MeshPlane`` with ``hist_reduce`` psum and psum_scatter, each forest
   bitwise phase 5's, growth timed twice beside phase 5's, histogram and split
   scan launches; (b) a gloo world of 4 processes on ``cuda:0`` (mesh
   (2, 2), spawned by ``launch.mesh.run_world``) on the first 2^18
   training rows, 128 features, 32 trees, depth 6: resident, streamed
   (``sample_block`` 65536) and checkpointed growth each bitwise the local
   forest from the same draws, a kill at level 3 resumed on a (4, 1)
   world bitwise, ``predict_sharded`` and the OOB weights equal to the
   local ones, the histogram and the split scan launched on every rank;
6. full size, LM serving: smollm-135m (30 layers, d 576) and mamba2-780m
   (48 layers, d 1536) at their published widths, bf16 compute, f32
   params from a seed: batch 8, prompt 2048, 32 greedy tokens through
   ``greedy_generate`` with launch counts read around that run; prefill
   seconds, decode ms per token, tokens/s, peak memory, launches per
   route (all of smollm's attention and all of mamba2's SSD scans on the
   bf16 tensor-core kernels); full-width
   kernel-path vs plain-path prefill in f32 (logits and every layer's
   cache); the card's busy share under the profiler for prefill and one
   decode step; attention and the SSD scan held per element against
   their plain versions at the path's shapes (``LM_TOL``) and timed
   beside them, their bounds and (for attention)
   ``scaled_dot_product_attention``, attention also at head dims 128
   and 256 (same batch, heads and length);
7. the launch counts and one JSON line per the smoke contract, then
   the device line last. Each row's ``ms`` is CUDA events around the
   wrapper's whole call; ``kernel_ms`` is the kernel's own device time
   from the profiler, over ``launches_traced`` launches (None, "not
   measured", when no trace kept them all: it is no check). The numbers
   also go to ``artifacts/chip_smoke.json``.

Every failed check raises, so the exit code is non-zero. Exits non-zero
without a result when no CUDA device is present. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory (NVIDIA data sheet)
F32_OPS_PER_S = 67e12              # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12            # H100 SXM bf16 dense tensor cores (NVIDIA data sheet)
LM_BATCH, LM_PROMPT, LM_GEN = 8, 2048, 32


def log(*a):
    print(*a, flush=True)


def sync_time(fn):
    """(fn(), host seconds around it, ending in a synchronise of the card)."""
    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if cuda:
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def cuda_ms(fn, reps=10, warmup=2):
    """Mean milliseconds per call from CUDA events over ``reps`` calls."""
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


TRACE_MARGIN_S = 0.05     # host time the profiler's window runs before and after the traced calls


def device_ms(fn, match, reps=10, warmup=2, sessions=3):
    """Mean device milliseconds per launch of the kernels whose name holds
    ``match``, from the profiler's trace of ``reps`` calls: the kernel's own
    time, without the wrapper's host work and small copies. The profiler
    keeps only device activity that falls inside its window on the host's
    clock, so the window opens ``TRACE_MARGIN_S`` before the first call
    and closes as long after the last one has finished. A trace that holds
    other than ``reps`` launches is discarded and taken again, at most
    ``sessions`` times in all; no partial trace is ever averaged. Returns
    (ms or None when every trace was short, the sessions taken, the
    launches each trace held)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    held = []
    for taken in range(1, sessions + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(TRACE_MARGIN_S)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            time.sleep(TRACE_MARGIN_S)
        mine = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and match in e.key]
        n = sum(e.count for e in mine)
        held.append(n)
        if n == reps:
            return sum(e.self_device_time_total for e in mine) / n / 1e3, taken, held
        log(f"the profiler's trace holds {n} launches of {match}, want {reps}: trace discarded")
    return None, sessions, held


def timed(what, fn, match, record, reps=10):
    """The rows' times: ``ms``, CUDA events around ``reps`` whole calls
    (the wrapper's host work included), and ``kernel_ms``, the kernel's
    own device time from the profiler over as many launches
    (``launches_traced``), or None ("not measured", ``launches_traced``
    0) when no trace held them all. Both go to ``record[what]`` and the log."""
    ms = cuda_ms(fn, reps=reps)
    kern, sessions, held = device_ms(fn, match, reps=reps)
    t = {"ms": ms, "kernel_ms": kern, "launches_traced": reps if kern is not None else 0,
         "trace_sessions": sessions, "launches_per_trace": held}
    record[what] = t
    log(f"{what}: CUDA events around the call {ms:.4f} ms, kernel device time "
        + (f"{kern:.4f} ms (mean of {reps} traced launches, trace {sessions} of at most 3)" if kern is not None
           else f"not measured (traces of {reps} calls held {held} launches)"))
    return t


def fmt_ms(ms):
    return "not measured" if ms is None else f"{ms:.4f}"


def bound_share(bound, ms):
    return "not measured" if ms is None else f"{bound / ms:.3f}"


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def max_abs(a, b):
    a, b = a.double(), b.double()
    fin = torch.isfinite(a) & torch.isfinite(b)
    check(torch.equal(torch.isfinite(a), torch.isfinite(b)), "non-finite patterns differ")
    return float((a[fin] - b[fin]).abs().max()) if bool(fin.any()) else 0.0


def rms(t):
    return float(t.double().square().mean().sqrt())


# The LM kernels' tolerance, per element: |got - want| <= rtol |want| +
# atol rms(want). f32: sums taken in another order. bf16 output: one
# rounding may land one bf16 ulp (at most 2^-7 |want|) away; the rms term
# covers elements near zero, and at 1e-2 rms it stays well below a typical one.
LM_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (2.0 ** -7, 1e-2)}


def lm_close(got, want, dtype, what):
    """Checks ``got`` against ``want`` at LM_TOL[dtype]; returns (max |d|,
    the largest share of its allowance any element used, at most 1)."""
    rtol, atol = LM_TOL[dtype]
    got, want = got.double(), want.double()
    d = (got - want).abs()
    share = d / (rtol * want.abs() + atol * rms(want))
    share = float(torch.where(d == 0, 0.0, share).max())
    check(share <= 1.0, f"{what}: kernel != plain, max |d| {float(d.max()):.3g} is "
          f"{share:.3g} x the allowance (rtol {rtol}, atol {atol} x rms)")
    return float(d.max()), share


def drift(got, want):
    """max |got - want| over max |want|: a whole model's drift, the
    measure of the CPU parity tests."""
    want = want.double()
    return float((got.double() - want).abs().max()) / float(want.abs().max())


def device_busy_share(fn):
    """Share of ``fn``'s wall time during which the card ran a kernel: the
    profiler's device time of every kernel (one stream, no overlap) over
    the host clock around ``fn`` and a sync. The profiler slows the host
    side, so this is a lower bound. None if the profiler saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall = sync_time(fn)
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and not e.is_user_annotation)
    return busy_us / 1e6 / wall if busy_us > 0 else None


def _randn(gen, shape, dev, dtype=torch.float32, scale=1.0):
    return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)


def _ssd_inputs(gen, B, S, H, P, N, dev, dtype):
    x = _randn(gen, (B, S, H, P), dev, dtype)
    loga = -_randn(gen, (B, S, H), dev).abs() * 0.4
    b = _randn(gen, (B, S, N), dev, dtype, 0.3)
    c = _randn(gen, (B, S, N), dev, dtype, 0.3)
    return x, loga, b, c


def lm_kernel_checks(dev):
    """Attention and the SSD scan against their plain versions, small
    shapes, at LM_TOL (the f32 state h at f32's tolerance in both dtypes)."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import MaskSpec, gqa_attend
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked

    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    worst = {}
    for B, H, KV, Lq, Lk, D, causal, window in (
            (2, 9, 3, 200, 200, 64, True, 0), (1, 4, 2, 77, 301, 64, True, 0),
            (1, 4, 4, 257, 257, 32, True, 100), (1, 2, 1, 130, 250, 128, False, 0),
            (1, 2, 2, 65, 190, 256, True, 33)):
        for dtype in (torch.float32, torch.bfloat16):
            q = _randn(gen, (B, Lq, H, D), dev, dtype)
            k = _randn(gen, (B, Lk, KV, D), dev, dtype)
            v = _randn(gen, (B, Lk, KV, D), dev, dtype)
            n_bf16 = flash_ops.launches_bf16
            _, share = lm_close(flash_ops.flash_attention(q, k, v, causal=causal, window=window),
                                gqa_attend(q, k, v, mask_spec=MaskSpec(causal, window, Lk - Lq)), dtype,
                                f"attention at {(B, H, KV, Lq, Lk, D, causal, window, dtype)}")
            check(flash_ops.launches_bf16 == n_bf16 + (dtype == torch.bfloat16),
                  f"attention in {dtype} went to the wrong kernel")
            worst[f"attention {dtype}"] = max(worst.get(f"attention {dtype}", 0.0), share)
    for B, S, H, P, N, chunk in ((2, 64, 3, 64, 16, 128), (1, 384, 2, 64, 128, 128), (2, 384, 4, 32, 16, 128),
                                 (1, 64, 2, 64, 128, 128), (2, 320, 3, 32, 64, 64), (1, 200, 2, 64, 32, 8)):
        for dtype in (torch.float32, torch.bfloat16):
            x, loga, b, c = _ssd_inputs(gen, B, S, H, P, N, dev, dtype)
            n_bf16 = ssd_ops.launches_bf16
            y, h = ssd_ops.ssd_scan(x, loga, b, c, chunk=chunk)
            check(ssd_ops.launches_bf16 == n_bf16 + (dtype == torch.bfloat16),
                  f"ssd scan in {dtype} went to the wrong kernel")
            yp, hp = ssd_chunked(x, loga, b, c, None, min(chunk, S))
            what = f"ssd at {(B, S, H, P, N, chunk, dtype)}"
            share = max(lm_close(y, yp, dtype, what)[1], lm_close(h, hp, torch.float32, what + " h")[1])
            worst[f"ssd {dtype}"] = max(worst.get(f"ssd {dtype}", 0.0), share)
    torch.cuda.synchronize()
    log("LM kernels vs plain (largest share of the allowance used): "
        + ", ".join(f"{k} {v:.3g}" for k, v in worst.items()))
    return worst


def lm_reduced_end_to_end(dev):
    """Cut widths, f32, TF32 off: kernel and plain paths give the same greedy tokens."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.models import build_model
    from repro_torch.serving.serve_step import greedy_generate

    for arch in ("smollm-135m", "mamba2-780m"):
        cfg = dataclasses.replace(get_config(arch), n_layers=4, d_model=256, n_heads=4, n_kv_heads=2,
                                  d_ff=512 if arch == "smollm-135m" else 0, vocab_size=4096,
                                  head_dim=64, compute_dtype="float32")
        gen = torch.Generator(device=dev)
        gen.manual_seed(4)
        toks = torch.randint(0, cfg.vocab_size, (4, 256), generator=gen, device=dev)
        n0 = flash_ops.launches + ssd_ops.launches
        a = greedy_generate(build_model(cfg, dev, use_kernels=True, seed=1), toks, steps=8, s_max=264)
        check(flash_ops.launches + ssd_ops.launches == n0 + 4, f"{arch}: kernels not launched 4 times")
        b = greedy_generate(build_model(cfg, dev, use_kernels=False, seed=1), toks, steps=8, s_max=264)
        check(torch.equal(a, b), f"reduced LM end to end ({arch}): tokens differ between kernel and plain paths")
    log("reduced LM end to end (4 layers, d 256, f32, batch 4, prompt 256, 8 tokens): "
        "greedy tokens identical on the kernel and plain paths for smollm-135m and mamba2-780m")


def lm_full(dev, arch):
    """One published-width LM through ``greedy_generate``: counts, times, checks."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.models import build_model
    from repro_torch.serving.serve_step import greedy_generate

    cfg = get_config(arch)
    B, L, T = LM_BATCH, LM_PROMPT, LM_GEN
    s_max = L + T
    model, t_init = sync_time(lambda: build_model(cfg, dev, seed=0))
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (B, L), generator=gen, device=dev)
    greedy_generate(model, prompts[:, :128], steps=2, s_max=130)      # warm-up: first-call costs

    flash_ops.launches = flash_ops.launches_bf16 = flash_ops.launches_f32 = 0
    ssd_ops.launches = ssd_ops.launches_bf16 = ssd_ops.launches_f32 = 0
    torch.cuda.reset_peak_memory_stats()
    toks, t_gen = sync_time(lambda: greedy_generate(model, prompts, steps=T, s_max=s_max))
    counts = {"flash_attention": flash_ops.launches, "ssd_scan": ssd_ops.launches}
    kernel, ops = {"smollm-135m": ("attention", flash_ops), "mamba2-780m": ("ssd scan", ssd_ops)}[arch]
    routes = {"bf16_tensor_core": ops.launches_bf16, "f32_cuda_core": ops.launches_f32}
    log(f"{arch}: {kernel} launches per route on the main path {routes}")
    check(routes == {"bf16_tensor_core": cfg.n_layers, "f32_cuda_core": 0},
          f"{arch}: {kernel} launches per route {routes}, want all {cfg.n_layers} on bf16 tensor cores")
    peak = torch.cuda.max_memory_allocated()
    check(toks.shape == (B, T) and bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
          f"{arch}: generated tokens out of range")
    want = {"smollm-135m": "flash_attention", "mamba2-780m": "ssd_scan"}[arch]
    check(counts[want] == cfg.n_layers, f"{arch}: {want} launched {counts[want]} times, want {cfg.n_layers}")

    # the same run in two timed parts: prefill, then the decode steps
    (logits, cache), t_pre = sync_time(lambda: model.prefill(prompts, s_max=s_max))
    check(bool(torch.isfinite(logits).all()), f"{arch}: non-finite prefill logits")
    out = [logits.argmax(-1)]

    def decode():
        nonlocal cache
        for i in range(T - 1):
            lg, cache = model.decode_step(cache, out[-1], L + i)
            out.append(lg.argmax(-1))
        return lg

    lg, t_dec = sync_time(decode)
    check(bool(torch.isfinite(lg).all()), f"{arch}: non-finite decode logits")
    check(torch.equal(torch.stack(out, 1).to(torch.int32), toks), f"{arch}: the timed rerun gave other tokens")
    busy = {"prefill": device_busy_share(lambda: model.prefill(prompts, s_max=s_max)),
            "decode_step": device_busy_share(lambda: model.decode_step(cache, out[-1], L + T - 1))}

    # Full width and depth, kernel path vs plain path in f32 compute (TF32
    # off): the last token's logits and every layer's cache, which each
    # layer computes from all rows of the layer below. The kernels' own
    # outputs at these shapes are held per element in lm_kernel_rows. In
    # bf16 one-ulp differences grow through the depth of a random-weight
    # model, so the bf16 numbers are only reported.
    model.use_kernels = False
    (lp, _), t_plain = sync_time(lambda: model.prefill(prompts, s_max=s_max))
    model.compute_dtype = torch.float32
    lp32, cp32 = model.prefill(prompts, s_max=s_max)
    model.use_kernels = True
    lk32, ck32 = model.prefill(prompts, s_max=s_max)
    model.compute_dtype = torch.bfloat16
    drift32 = {"logits": drift(lk32, lp32)}
    for ck, cp in zip(ck32, cp32):
        for n in cp:
            drift32[n] = max(drift32.get(n, 0.0), drift(ck[n], cp[n]))
    err32 = max(drift32.values())
    check(err32 <= 1e-2, f"{arch}: full-width f32 kernel vs plain prefill drift {drift32}")
    del cp32, ck32
    err = drift(logits, lp)
    noise = drift(lp, lp32)
    agree = float((logits.argmax(-1) == lp.argmax(-1)).float().mean())
    res = {"arch": arch, "params": sum(p.numel() for p in model.parameters()), "init_s": t_init,
           "generate_s": t_gen, "prefill_s": t_pre, "plain_prefill_s": t_plain,
           "decode_ms_per_token": t_dec / (T - 1) * 1e3, "tokens_per_s": B * T / t_gen,
           "peak_bytes": peak, "launches": counts, "routes": routes,
           "kernel_vs_plain_f32": drift32,
           "kernel_vs_plain_logits_bf16": err, "bf16_vs_f32_plain_logits": noise,
           "kernel_vs_plain_top1_agree_bf16": agree, "device_busy_share": busy}
    log(f"{arch} (batch {B}, prompt {L}, {T} tokens, bf16): generate {t_gen:.3f} s "
        f"({res['tokens_per_s']:.1f} tok/s), prefill {t_pre:.3f} s (plain path {t_plain:.3f} s), "
        f"decode {res['decode_ms_per_token']:.2f} ms/token, peak {peak / 2**30:.2f} GiB, "
        f"launches {counts}; prefill kernel vs plain, max |d| / max |plain|: f32 "
        + ", ".join(f"{k} {v:.3g}" for k, v in drift32.items()) + f"; bf16 logits {err:.3g} "
        f"(top-1 agree {agree:.3f}; bf16 vs f32 on the plain path {noise:.3g}); "
        f"device busy share under the profiler {busy}")
    del model, cache, logits, lp, lp32, lk32
    torch.cuda.empty_cache()
    return res


def lm_kernel_rows(dev, counts, kernel_row, timings):
    """Attention at smollm-135m's prefill shapes and the SSD scan at
    mamba2-780m's, each beside its plain version and its bound."""
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import MaskSpec, gqa_attend
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked
    from repro_torch.models.mamba import _dims

    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    B, L = LM_BATCH, LM_PROMPT
    sm = get_config("smollm-135m")
    H, KV, D = sm.n_heads, sm.n_kv_heads, sm.hd
    q = _randn(gen, (B, L, H, D), dev, torch.bfloat16)
    k = _randn(gen, (B, L, KV, D), dev, torch.bfloat16)
    v = _randn(gen, (B, L, KV, D), dev, torch.bfloat16)
    plain = lambda: gqa_attend(q, k, v, mask_spec=MaskSpec())
    out = flash_ops.flash_attention(q, k, v)
    err, share = lm_close(out, plain(), torch.bfloat16, "attention at the path's shapes")
    t = timed("attention D 64", lambda: flash_ops.flash_attention(q, k, v), "flash_tc_kernel", timings)
    p_ms = cuda_ms(plain, reps=3, warmup=1)
    qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
    lib_err = float((sdpa().transpose(1, 2).double() - out.double()).abs().max())
    lib_ms = cuda_ms(sdpa)
    log(f"attention at the path's shapes: kernel vs plain max |d| {err:.3g} ({share:.3g} of the "
        f"allowance), SDPA vs kernel max |d| {lib_err:.3g}")
    kernel_row("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
               "src/repro/kernels/flash_attention/kernel.py:73", counts["flash_attention"], err, t, p_ms,
               2 * (2 * B * L * H * D + 2 * B * L * KV * D), 4 * D * B * H * L * (L + 1) // 2, lib_ms,
               BF16_OPS_PER_S)
    log(f"attention D {D}: call {t['ms']:.4f} ms, SDPA {lib_ms:.4f} ms, call / SDPA {t['ms'] / lib_ms:.3f}")
    del q, k, v, out, qt, kt, vt

    # the tensor-core kernel at the wider head dims, same batch, heads and length
    wide = {}
    for Dw in (128, 256):
        q = _randn(gen, (B, L, H, Dw), dev, torch.bfloat16)
        k = _randn(gen, (B, L, KV, Dw), dev, torch.bfloat16)
        v = _randn(gen, (B, L, KV, Dw), dev, torch.bfloat16)
        err_w, share_w = lm_close(flash_ops.flash_attention(q, k, v), gqa_attend(q, k, v, mask_spec=MaskSpec()),
                                  torch.bfloat16, f"attention at D {Dw}")
        t_w = timed(f"attention D {Dw}", lambda: flash_ops.flash_attention(q, k, v), "flash_tc_kernel", timings)
        ms_w = t_w["ms"]
        qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
        lib_w = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True))
        bound_w = 4 * Dw * B * H * L * (L + 1) // 2 / BF16_OPS_PER_S * 1e3
        wide[Dw] = {"ms": ms_w, "kernel_ms": t_w["kernel_ms"], "sdpa_ms": lib_w, "bound_ms": bound_w,
                    "max_abs_err": err_w, "allowance_share": share_w}
        log(f"attention D {Dw} [{B}, {H} H / {KV} KV, {L}, {L}] causal bf16: call {ms_w:.4f} ms "
            f"(kernel alone {fmt_ms(t_w['kernel_ms'])}), SDPA {lib_w:.4f} ms, call / SDPA {ms_w / lib_w:.3f}, bound {bound_w:.4f} ms by operations, "
            f"max |d| vs plain {err_w:.3g} ({share_w:.3g} of the allowance)")
        del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()

    mc = get_config("mamba2-780m")
    _, Hs, P, N = _dims(mc, mc.d_model)
    x, loga, b, c = _ssd_inputs(gen, B, L, Hs, P, N, dev, torch.bfloat16)
    y, h = ssd_ops.ssd_scan(x, loga, b, c)
    yp, hp = ssd_chunked(x, loga, b, c, None, 128)
    (err, share), (err_h, share_h) = (lm_close(y, yp, torch.bfloat16, "ssd at the path's shapes"),
                                      lm_close(h, hp, torch.float32, "ssd h at the path's shapes"))
    log(f"ssd scan at the path's shapes: kernel vs plain max |d| y {err:.3g} ({share:.3g} of the "
        f"allowance), h {err_h:.3g} ({share_h:.3g})")
    del yp, hp
    t = timed("ssd scan", lambda: ssd_ops.ssd_scan(x, loga, b, c), "ssd_tc_kernel", timings)
    p_ms = cuda_ms(lambda: ssd_chunked(x, loga, b, c, None, 128), reps=2, warmup=1)
    Q = 128
    tri = Q * (Q + 1) // 2
    per_chunk = 2 * tri * N + 2 * tri * P + 4 * Q * N * P
    kernel_row("ssd_scan", "src/repro_torch/csrc/ssd_scan.cu", "src/repro/kernels/ssd_scan/kernel.py:69",
               counts["ssd_scan"], max(err, err_h), t, p_ms,
               2 * B * L * Hs * P * 2 + B * L * Hs * 4 + 2 * B * L * N * 2 + B * Hs * N * P * 4,
               B * Hs * (L // Q) * per_chunk, None, BF16_OPS_PER_S)
    return wide


def traverse_checks(dev):
    """The traversal kernel against its plain version, bitwise, over the
    cases of ``tests/test_torch_traverse_cases.py`` (shared with the card
    tests), the carry threaded through every chunk: near-complete random
    trees with thresholds past the bin range on both sides."""
    from repro_torch.kernels.tree_traverse import ops as trav_ops
    from repro_torch.kernels.tree_traverse.ref import traverse_block_ref
    from test_torch_traverse_cases import TRAVERSE_CASES, traverse_case

    for name in TRAVERSE_CASES:
        x, forest, carry, tc, depth = traverse_case(name)
        xb = torch.from_numpy(x).to(dev)
        arrays = [torch.from_numpy(a).to(dev) for a in forest]
        got = want = torch.from_numpy(carry).to(dev)
        k = arrays[0].shape[0]
        n0 = trav_ops.launches
        for c0 in range(0, k, tc):
            part = [a[c0:c0 + tc] for a in arrays]
            got = trav_ops.traverse_block(xb, *part, got, depth=depth)
            want = traverse_block_ref(xb, *part, want, depth=depth)
        torch.cuda.synchronize()
        check(trav_ops.launches == n0 + -(-k // tc), f"traversal, {name}: launches")
        check(torch.equal(got, want), f"traversal kernel != plain: {name} {TRAVERSE_CASES[name]}")
    log(f"traverse: kernel bitwise equal to the plain version in all {len(TRAVERSE_CASES)} cases "
        "(N, F, k, chunk, C, depth, P): " + "; ".join(f"{n} {c}" for n, c in TRAVERSE_CASES.items()))


def traverse_work(forest, xq, depth):
    """What a traversal of ``xq`` must touch on this data: the internal
    nodes and the leaves its walks visit (distinct (tree, node) pairs)
    and its steps (internal nodes on every walk's path)."""
    k, P = forest.feature.shape
    t = torch.arange(k, device=xq.device)[:, None].expand(k, xq.shape[0])
    r = torch.arange(xq.shape[0], device=xq.device)[None, :]
    node = torch.zeros((k, xq.shape[0]), dtype=torch.long, device=xq.device)
    seen = torch.zeros((k, P), dtype=torch.bool, device=xq.device)
    steps = 0
    for _ in range(depth + 1):
        seen[t, node] = True
        f = forest.feature[t, node]
        inner = f >= 0
        steps += int(inner.sum())
        right = (xq[r, f.clamp(min=0).long()].int() > forest.threshold[t, node]).long()
        node = torch.where(inner, forest.left_child[t, node].long() + right, node)
    internal = int((seen & (forest.feature >= 0)).sum())
    return internal, int(seen.sum()) - internal, steps


def growth_turns(dev, xb, yt, wt, fmask, cfg_on, cfg_off, n):
    """Growth with histogram reuse on and off in turns (on, off, on, off,
    ...; ``n`` of each), the same weights and mask: the seconds of every
    turn and each mode's peak device memory."""
    from repro_torch.core.forest import grow_forest

    secs, peak = {"on": [], "off": []}, {}
    for i in range(2 * n):
        mode = ("on", "off")[i % 2]
        torch.cuda.reset_peak_memory_stats()
        _, t = sync_time(lambda: grow_forest(xb, yt, wt, cfg_on if mode == "on" else cfg_off, fmask, device=dev))
        secs[mode].append(t)
        peak[mode] = max(peak.get(mode, 0), torch.cuda.max_memory_allocated())
    return secs, peak


def reduced_reuse_turns(dev, x, y, cfg):
    """At the reduced size ``hist_reuse="auto"`` resolves on (its [8, 32,
    32, 64, 4] cache, 8 MiB, is under the 256 MiB default budget): growth
    with reuse on (auto) and off in five turns each, the same weights and
    mask, forests bitwise equal."""
    from repro_torch.core import engine
    from repro_torch.core.binning import bin_dataset
    from repro_torch.core.dimred import dimension_reduction
    from repro_torch.core.dsi import bootstrap_counts
    from repro_torch.core.forest import grow_forest

    F = x.shape[1]
    auto = dataclasses.replace(cfg, hist_reuse="auto").resolved(F)
    off = dataclasses.replace(auto, hist_reuse="off")
    check(engine.resolve_hist_reuse(auto, F), "reduced reuse: auto does not resolve on")
    xb, _ = bin_dataset(x, auto.n_bins, device=dev)
    yt = torch.from_numpy(y).to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    wt = bootstrap_counts(gen, auto.n_trees, x.shape[0], dev)
    fmask = dimension_reduction(xb, yt, wt, auto, torch.rand((auto.n_trees, F), generator=gen, device=dev))
    f_on, f_off = (grow_forest(xb, yt, wt, c, fmask, device=dev) for c in (auto, off))
    for name in type(f_on).FIELDS[:-1]:
        check(torch.equal(getattr(f_on, name), getattr(f_off, name)), f"reduced reuse: {name} differs")
    secs, peak = growth_turns(dev, xb, yt, wt, fmask, auto, off, 5)
    log(f"reduced reuse (N {x.shape[0]}, F {F}, k {auto.n_trees}, depth {auto.max_depth}, auto resolves on): "
        f"forests bitwise equal; growth s on {secs['on']} / off {secs['off']}; peak device memory "
        f"{peak['on'] / 2**20:.1f} MiB (off {peak['off'] / 2**20:.1f})")
    return {"growth_s": secs, "peak_bytes": peak}


def reuse_phase(dev, xbt, yt, wt, fmask, rcfg, forest_off, timings):
    """Full size, histogram reuse on (``hist_reuse_budget_mb=1024``: the
    [32, 256, 128, 64, 4] cache is exactly 1 GiB), same weights and mask
    as the reuse-off replay: Forest arrays bitwise equal to it; growth
    time in turns on, off, on, off; the histogram and split-scan launches
    of one reuse growth, counted on their own; peak memory; the
    histogram's call at R = 128 rank segments."""
    from repro_torch.core import engine
    from repro_torch.core.forest import grow_forest
    from repro_torch.core.histograms import class_channels, hist_feature_slab, sibling_segments, slot_order
    from repro_torch.kernels.gain_ratio import ops as hist_ops
    from repro_torch.kernels.gain_ratio.ref import multi_tree_hist_ref
    from repro_torch.kernels.split_scan import ops as scan_ops

    cfg_on = dataclasses.replace(rcfg, hist_reuse="on", hist_reuse_budget_mb=1024)
    cfg_off = dataclasses.replace(rcfg, hist_reuse="off")
    check(engine.resolve_hist_reuse(cfg_on, xbt.shape[1]), "reuse phase: the 1 GiB cache does not pass the gate")
    hist_ops.launches = scan_ops.launches = 0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    f_on, t_on = sync_time(lambda: grow_forest(xbt, yt, wt, cfg_on, fmask, device=dev))
    peak = torch.cuda.max_memory_allocated()
    counts = {"gain_ratio_hist": hist_ops.launches, "split_scan": scan_ops.launches}
    for name, n in counts.items():
        check(n > 0, f"reuse phase: {name} was not launched")
    for name in type(f_on).FIELDS[:-1]:        # tree_weight is set after growth
        check(torch.equal(getattr(f_on, name), getattr(forest_off, name)),
              f"full-size reuse: {name} differs from reuse off")
    del f_on
    turns, peaks = growth_turns(dev, xbt, yt, wt, fmask, cfg_on, cfg_off, 2)
    peak_off = peaks["off"]

    # the histogram at a deep level's rank segments: 128 slots (8% parked), small sides at random
    k, Ntr, F = wt.shape[0], xbt.shape[0], xbt.shape[1]
    S, B, C, R = rcfg.frontier, rcfg.n_bins, rcfg.n_classes, rcfg.max_splits_per_level
    W = hist_feature_slab(Ntr, F, S, B, C)
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    slots = torch.randint(0, 128, (k, Ntr), generator=gen, device=dev, dtype=torch.int32)
    slots[torch.rand((k, Ntr), generator=gen, device=dev) < 0.08] = -1
    seg = sibling_segments(slots, torch.randint(0, 2, (k, R), generator=gen, device=dev, dtype=torch.int32))
    base = class_channels(yt, C)
    xs = xbt[:, :W]
    order, order_ms = slot_order(seg, wt, R), cuda_ms(lambda: slot_order(seg, wt, R))
    hk = hist_ops.multi_tree_hist(xs, base, wt, seg, n_slots=R, n_bins=B, order=order)
    check(torch.equal(hk, multi_tree_hist_ref(xs, base, wt, seg, n_slots=R, n_bins=B)),
          "histogram kernel != plain at R = 128 rank segments")
    del hk
    t = timed("histogram, reuse rank segments R 128", lambda: hist_ops.multi_tree_hist(
        xs, base, wt, seg, n_slots=R, n_bins=B, order=order), "hist_kernel", timings)
    live = int(((seg >= 0) & (wt > 0)).sum())
    res = {"growth_s": turns, "growth_s_checked": t_on, "launches": counts, "peak_bytes": peak,
           "peak_bytes_off": peak_off,
           "hist_r128": {**t, "slot_order_ms": order_ms, "live_samples": live}}
    log(f"reuse phase (full size, budget 1024 MiB): forests bitwise equal to reuse off (that growth "
        f"{t_on:.4f} s); growth s in turns on "
        f"{turns['on']} / off {turns['off']}; launches {counts}; peak device memory {peak / 2**30:.2f} GiB "
        f"(off {peak_off / 2**30:.2f}); histogram at [{k}, {Ntr}, {W}], R {R}, {live} live (tree, sample) "
        f"pairs: call {t['ms']:.4f} ms, kernel {fmt_ms(t['kernel_ms'])} ms, slot ordering {order_ms:.4f} ms")
    return res


STREAM_BLOCK = 131_072          # rows per block of the streamed phase: 8 training blocks, 2 to predict


def streamed_phase(dev, xtr, ytr, xte, yte, wt, u, cfg, model, pred):
    """5b. Full size, streamed (``config.sample_block = 131072``), the
    training rows read from an ``np.memmap`` written to ``build/``:

    (a) ``fit_prf_from_draws`` with the replay's weights and ``u`` and
        ``bin_fit="exact"``: every Forest array and the edges bitwise
        equal to phase 5's resident model, its streamed prediction equal
        to the resident one;
    (b) the slice's main path, ``train_prf`` on the memmap (``"auto"``
        bins: the sketch) and the model's streamed ``predict`` of the
        test rows, with the three PRF kernels' launch counts set to 0
        just before and read just after, peak device memory, accuracy
        >= 0.90, and the streamed prediction equal to the same model's
        resident one;
    (c) a staged replay of (b) with host clocks ending in a sync: sketch,
        per-block binning (into pinned host tensors, as the trainer keeps
        them), dimension reduction, growth (per level, and the feed wait
        the growth sweeps saw), OOB, predict; its forest equals (b)'s
        bitwise; then growth from pageable numpy bins and from the pinned
        ones in turns, each with its feed wait;
    (d) the histogram at the block shape, added into a carry (``out=``),
        at level 0 and a deep level, beside its plain version and bound;
        the split scan on the carry at full F (level 0: all 8 blocks
        added; the deep level: block 0) with every field bitwise equal
        to the plain version; dimension reduction's S = 1 root histogram
        added over the 8 blocks, bitwise equal to the plain version.
    """
    from repro_torch import PRFModel, fit_prf_from_draws, train_prf
    from repro_torch.core import api
    from repro_torch.core.binning import apply_bins, fit_bins_blocked
    from repro_torch.core.dimred import dimension_reduction_streamed
    from repro_torch.core.histograms import class_channels, slot_order
    from repro_torch.core.voting import oob_accuracy_streamed
    from repro_torch.data.pipeline import sample_blocks, screen_blocks
    from repro_torch.kernels.gain_ratio import ops as hist_ops
    from repro_torch.kernels.gain_ratio.ref import multi_tree_hist_ref
    from repro_torch.kernels.split_scan import ops as scan_ops
    from repro_torch.kernels.split_scan.ref import init_carry, split_scan_block_ref
    from repro_torch.kernels.tree_traverse import ops as trav_ops

    nb, fields = STREAM_BLOCK, type(model.forest).FIELDS
    path = ROOT / "build" / "chip_smoke_train.f32"
    path.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    mm = np.memmap(path, np.float32, "w+", shape=xtr.shape)
    mm[:] = xtr
    mm.flush()
    del mm
    t_write = time.perf_counter() - t0
    x_mm = np.memmap(path, np.float32, "r", shape=xtr.shape)
    try:
        # (a) exact bins and the replay's draws: the resident model, bitwise
        cfg_x = dataclasses.replace(cfg, bin_fit="exact", sample_block=nb)
        m_x, t_exact = sync_time(lambda: fit_prf_from_draws(x_mm, ytr, cfg_x, wt, u, device=dev))
        for name in fields:
            check(torch.equal(getattr(m_x.forest, name), getattr(model.forest, name)),
                  f"streamed (exact bins) {name} differs from the resident forest")
        check(np.array_equal(m_x.bin_edges, model.bin_edges), "streamed exact edges differ")
        check(np.array_equal(m_x.predict(xte), pred), "streamed predict (exact bins) != resident predict")
        log(f"streamed, exact bins, the replay's draws: every Forest array and the edges bitwise equal to "
            f"the resident model, streamed predict equal ({t_exact:.3f} s)")
        del m_x

        # (b) the main path of the streaming plane
        cfg_s = dataclasses.replace(cfg, sample_block=nb)
        torch.cuda.empty_cache()
        base_bytes = torch.cuda.memory_allocated()
        for m in (hist_ops, scan_ops, trav_ops):
            m.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model_s = train_prf(x_mm, ytr, cfg_s, 0, device=dev)
        pred_s = model_s.predict(xte)
        torch.cuda.synchronize()
        t_main = time.perf_counter() - t0
        counts = {"gain_ratio_hist": hist_ops.launches, "split_scan": scan_ops.launches,
                  "tree_traverse": trav_ops.launches}
        peak = torch.cuda.max_memory_allocated()
        for name, n in counts.items():
            check(n > 0, f"{name} was not launched on the streamed path")
        acc = float(np.mean(pred_s == yte))
        check(acc >= 0.90, f"streamed (sketch) test accuracy {acc} < 0.90")
        resident = PRFModel(dataclasses.replace(model_s.forest, config=dataclasses.replace(
            model_s.forest.config, sample_block=0)), model_s.bin_edges)
        check(np.array_equal(resident.predict(xte), pred_s), "streamed predict != resident predict")
        log(f"streamed main path: train_prf (memmap, sample_block {nb}, sketch bins) + predict "
            f"{t_main:.3f} s, accuracy {acc:.7f}, launches {counts}, peak device memory "
            f"{peak / 2**30:.3f} GiB ({(peak - base_bytes) / 2**30:.3f} GiB above the "
            f"{base_bytes / 2**30:.3f} GiB held from earlier phases); streamed predict equal to resident")

        # (c) staged replay: the same draws as (b)
        rcfg = cfg_s.resolved(xtr.shape[1])
        stages = {"memmap_write": t_write}
        blocks = sample_blocks(x_mm, nb)
        _, stages["validation"] = sync_time(lambda: screen_blocks(
            blocks, ytr, policy="raise", n_features=xtr.shape[1], n_classes=rcfg.n_classes))
        edges, stages["sketch"] = sync_time(lambda: fit_bins_blocked(blocks, rcfg.n_bins))
        check(np.array_equal(edges, model_s.bin_edges), "staged sketch edges differ")
        edges_t = torch.from_numpy(edges).to(dev)
        # the bins in pinned host tensors, as _fit_streamed keeps them
        xb_blocks, stages["block_binning"] = sync_time(lambda: [
            torch.empty((b.shape[0], b.shape[1]), dtype=torch.uint8, pin_memory=True).copy_(
                apply_bins(torch.from_numpy(np.array(b)).to(dev), edges_t)) for b in blocks])
        fm, stages["dimension_reduction"] = sync_time(lambda: dimension_reduction_streamed(
            xb_blocks, ytr, wt, rcfg, u, device=dev))
        gstats = {}
        forest_s, stages["growth"] = sync_time(lambda: api.grow_forest_streamed(
            xb_blocks, ytr, wt, rcfg, fm, device=dev, stats=gstats))
        forest_s.tree_weight, stages["oob_weights"] = sync_time(
            lambda: oob_accuracy_streamed(forest_s, xb_blocks, ytr, wt))
        for name in fields:
            check(torch.equal(getattr(forest_s, name), getattr(model_s.forest, name)),
                  f"staged streamed replay: {name} differs from train_prf")
        _, stages["predict"] = sync_time(lambda: model_s.predict(xte))
        log("streamed stages (s): " + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))
        log(f"streamed growth per level (s): {[round(t, 4) for t in gstats['levels_s']]}; the growth "
            f"sweeps' summed wait for the feed {gstats['feed_wait_s']:.4f} s, retries {gstats['retries']}")
        # the feed from pinned bins against pageable numpy bins (each sweep
        # staging every block into the ring), growth in turns
        xb_pageable = [b.numpy().copy() for b in xb_blocks]
        feed_turns = {"pageable": [], "pinned": []}
        for turn in ("pageable", "pinned", "pageable", "pinned"):
            st = {}
            f_t, g_s = sync_time(lambda: api.grow_forest_streamed(
                xb_pageable if turn == "pageable" else xb_blocks, ytr, wt, rcfg, fm, device=dev,
                stats=st))
            for name in ("feature", "threshold", "left_child", "class_counts"):
                check(torch.equal(getattr(f_t, name), getattr(forest_s, name)),
                      f"streamed growth from {turn} bins: {name} differs")
            feed_turns[turn].append({"growth_s": g_s, "feed_wait_s": st["feed_wait_s"]})
            del f_t
        log("streamed growth in turns, pageable / pinned host bins (s, feed wait): " + "; ".join(
            f"{t} {r['growth_s']:.4f} ({r['feed_wait_s']:.4f})"
            for i in range(2) for t in ("pageable", "pinned") for r in [feed_turns[t][i]]))

        # (d) the histogram at the block shape, added into the level's carry
        # (level 0: all 8 blocks; a deep level: block 0), the split scan on
        # that carry at full F, and dimension reduction's S = 1 root
        # histogram over all 8 blocks, each against its plain version
        k, F, S, B, C = rcfg.n_trees, xtr.shape[1], rcfg.frontier, rcfg.n_bins, rcfg.n_classes
        xb_dev = [b.to(dev) for b in xb_blocks]
        base_dev = [class_channels(torch.from_numpy(ytr[o:o + nb]).to(dev), C)
                    for o in range(0, len(ytr), nb)]
        w_dev = [wt[:, o:o + nb].contiguous() for o in range(0, len(ytr), nb)]
        xb0, base0, w0 = xb_dev[0], base_dev[0], w_dev[0]
        gen = torch.Generator(device=dev)
        gen.manual_seed(8)
        deep = torch.randint(0, 128, (k, nb), generator=gen, device=dev, dtype=torch.int32)
        deep[torch.rand((k, nb), generator=gen, device=dev) < 0.08] = -1
        block_hist, carry_scan = {}, {}
        acc_t = torch.zeros((k, S, F, B, C), device=dev)
        for shape, slots in (("level 0", torch.zeros((k, nb), dtype=torch.int32, device=dev)),
                             ("deep level: 128 slots, 8% parked", deep)):
            order = slot_order(slots, w0, S)
            acc_t.zero_()
            hist_ops.multi_tree_hist(xb0, base0, w0, slots, n_slots=S, n_bins=B, order=order, out=acc_t)
            check(torch.equal(acc_t, multi_tree_hist_ref(xb0, base0, w0, slots, n_slots=S, n_bins=B)),
                  f"histogram into a carry != plain at the block shape ({shape})")
            ms = cuda_ms(lambda: hist_ops.multi_tree_hist(xb0, base0, w0, slots, n_slots=S, n_bins=B,
                                                          order=order, out=acc_t))
            p_ms = cuda_ms(lambda: multi_tree_hist_ref(xb0, base0, w0, slots, n_slots=S, n_bins=B),
                           reps=2, warmup=1)
            live = int(((slots >= 0) & (w0 > 0)).sum())
            occupied = int(torch.unique(slots[slots >= 0]).numel())
            # bins, channels, weights and slots read once; the carry's cells
            # this block can reach (its occupied slots) read and written once
            nbytes = nb * F + nb * C * 4 + 2 * k * nb * 4 + 2 * k * occupied * F * B * C * 4
            nops = 2 * live * F
            bound = max(nbytes / HBM_BYTES_PER_S, nops / F32_OPS_PER_S) * 1e3
            block_hist[shape] = {"ms": ms, "plain_ms": p_ms, "bound_ms": bound, "live": live,
                                 "occupied_slots": occupied}
            log(f"histogram into the carry at the block shape [{k}, {nb}, {F}], S {S}, {shape}: call "
                f"{ms:.4f} ms, plain {p_ms:.4f} ms, bound {bound:.4f} ms, share {bound / ms:.3f}; bitwise "
                f"equal to the plain version")
            # the carry the split scan reads: at level 0 every block added in
            acc_t.zero_()
            want = torch.zeros_like(acc_t)
            for xb_b, base_b, w_b in (zip(xb_dev, base_dev, w_dev) if shape == "level 0"
                                      else [(xb0, base0, w0)]):
                sl = slots[:, :xb_b.shape[0]]
                hist_ops.multi_tree_hist(xb_b, base_b, w_b, sl, n_slots=S, n_bins=B, out=acc_t)
                want += multi_tree_hist_ref(xb_b, base_b, w_b, sl, n_slots=S, n_bins=B)
            check(torch.equal(acc_t, want), f"carry over the blocks != plain ({shape})")
            del want
            ck = scan_ops.split_scan_block(acc_t, fm, init_carry(k, S, C, dev), 0)
            cp = split_scan_block_ref(acc_t, fm, init_carry(k, S, C, dev), 0)
            for i, field in enumerate(("gain", "feature", "threshold", "left_counts", "right_counts")):
                check(torch.equal(ck[i], cp[i]), f"split scan on the streamed carry ({shape}): {field} "
                                                 f"differs from the plain version")
            s_ms = cuda_ms(lambda: scan_ops.split_scan_block(acc_t, fm, init_carry(k, S, C, dev), 0))
            sp_ms = cuda_ms(lambda: split_scan_block_ref(acc_t, fm, init_carry(k, S, C, dev), 0),
                            reps=2, warmup=1)
            carry_scan[shape] = {"ms": s_ms, "plain_ms": sp_ms,
                                 "blocks": len(xb_dev) if shape == "level 0" else 1}
            log(f"split scan on the carry [{k}, {S}, {F}, {B}, {C}] ({shape}, "
                f"{carry_scan[shape]['blocks']} block(s) added): all five fields bitwise equal to the "
                f"plain version; call {s_ms:.4f} ms, plain {sp_ms:.4f} ms")
            del ck, cp
        del acc_t
        # dimension reduction's root histogram: S = 1, samples in index order
        root = torch.zeros((k, 1, F, B, C), device=dev)
        root_want = torch.zeros_like(root)
        for xb_b, base_b, w_b in zip(xb_dev, base_dev, w_dev):
            slot0 = torch.zeros(w_b.shape, dtype=torch.int32, device=dev)
            hist_ops.multi_tree_hist(xb_b, base_b, w_b, slot0, n_slots=1, n_bins=B, out=root)
            root_want += multi_tree_hist_ref(xb_b, base_b, w_b, slot0, n_slots=1, n_bins=B)
        check(torch.equal(root, root_want), "S = 1 root histogram over the blocks != plain")
        slot0 = torch.zeros(w0.shape, dtype=torch.int32, device=dev)
        root_ms = cuda_ms(lambda: hist_ops.multi_tree_hist(xb0, base0, w0, slot0, n_slots=1, n_bins=B,
                                                           out=root))
        block_hist["root (S = 1)"] = {"ms": root_ms}
        log(f"dimension reduction's root histogram (S = 1) added over {len(xb_dev)} blocks: bitwise equal "
            f"to the plain version; one block {root_ms:.4f} ms")
        del root, root_want, xb_dev, base_dev, w_dev, deep
        torch.cuda.empty_cache()
        return {"launches": counts, "main_path_s": t_main, "exact_replay_s": t_exact, "accuracy": acc,
                "peak_bytes": peak, "bytes_held_before": base_bytes, "stages_s": stages,
                "growth_levels_s": gstats["levels_s"], "feed_wait_s": gstats["feed_wait_s"],
                "feed_retries": gstats["retries"], "feed_turns": feed_turns, "block_hist": block_hist,
                "carry_split_scan": carry_scan, "sample_block": nb}
    finally:
        del x_mm
        path.unlink(missing_ok=True)


class _Kill(Exception):
    """The simulated crash of phase 5c, raised from ``on_level`` after the
    level's checkpoint is durable."""


def checkpoint_phase(dev, xbt, yt, wt, fmask, rcfg, forest):
    """5c. Checkpoints at full size, in a directory under ``build/`` that is
    removed at the end. The replay's binned data, weights and mask:

    (a) resident ``grow_forest_checkpointed`` (``checkpoint_every`` 1,
        keep 3) killed from ``on_level`` at level 4, then resumed: the
        resumed run's first level is 5 and the forest equals the
        replay's reuse-off forest (phase 5's) bitwise;
    (b) the newest step corrupted with ``CheckpointCorruptor(seed=0)``,
        resumed: the walk-back warns, regrows level 4, same forest;
    (c) the same kill and resume on the streamed path (``sample_block``
        131072 from the replay's exact bins in pinned host blocks): its
        forest equals phase 5b's exact-bins streamed forest, which is the
        resident one;
    (d) the bytes of one resident step, a save's seconds split into the
        device-to-host copy, CRC32 and ``np.save`` (one thread, as
        ``save_checkpoint`` does them), a whole ``save_checkpoint`` and a
        restore; growth with a checkpoint every level against none, in
        turns; the histogram and split-scan launches of one resumed
        growth.
    """
    import shutil
    import warnings
    import zlib

    from repro_torch.checkpoint import CheckpointManager, restore_checkpoint, save_checkpoint
    from repro_torch.checkpoint.checkpoint import _flatten, _to_host
    from repro_torch.core import api, engine
    from repro_torch.core.forest import grow_forest, grow_forest_checkpointed
    from repro_torch.core.histograms import class_channels
    from repro_torch.kernels.gain_ratio import ops as hist_ops
    from repro_torch.kernels.split_scan import ops as scan_ops
    from repro_torch.launch.fault import CheckpointCorruptor

    root = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    fields = type(forest).FIELDS[:-1]          # tree_weight is set after growth
    kill_at = 4

    def same(f, what):
        for name in fields:
            check(torch.equal(getattr(f, name), getattr(forest, name)), f"{what}: {name} differs")

    def killed(grow, d):
        """Run ``grow`` with a checkpoint every level until the kill; return
        the carry that the last checkpoint holds (the level-4 state)."""
        held = {}

        def boom(level, state):
            if level == kill_at:
                held["state"] = state
                raise _Kill

        try:
            grow(manager=CheckpointManager(str(d), keep=3, save_interval=1), on_level=boom)
        except _Kill:
            return held.get("state")
        raise AssertionError("checkpoint phase: the kill at level 4 did not fire")

    def resumed(grow, d):
        levels = []
        return grow(resume_from=str(d), on_level=lambda level, _: levels.append(level)), levels

    try:
        res = {}

        def grow_r(**kw):
            return grow_forest_checkpointed(xbt, yt, wt, rcfg, fmask, device=dev, **kw)

        # (a) resident kill at level 4 and resume
        d = root / "resident"
        (state, t_kill) = sync_time(lambda: killed(grow_r, d))
        hist_ops.launches = scan_ops.launches = 0
        (f, levels), t_res = sync_time(lambda: resumed(grow_r, d))
        counts = {"gain_ratio_hist": hist_ops.launches, "split_scan": scan_ops.launches}
        check(levels[0] == kill_at + 1, f"resident resume started at level {levels[0]}, want 5")
        for name, n in counts.items():
            check(n > 0, f"checkpoint phase: {name} was not launched on the resumed growth")
        same(f, "resident resume after a kill at level 4")
        del f
        log(f"checkpoint phase (a): resident growth killed at level 4 ({t_kill:.3f} s with a checkpoint a "
            f"level), resumed at level {levels[0]} ({t_res:.3f} s, launches {counts}): forest bitwise equal "
            "to the replay's")
        res.update(resident_kill_s=t_kill, resident_resume_s=t_res, resume_launches=counts)

        # (d) one step's bytes, a save split into its parts, a restore
        step_dir = d / f"step_{kill_at:08d}"
        step_bytes = sum(p.stat().st_size for p in step_dir.iterdir())
        leaves = _flatten(state)
        host, t_d2h = sync_time(lambda: [_to_host(leaf) for _, leaf in leaves])
        t0 = time.perf_counter()
        for a in host:
            zlib.crc32(np.ascontiguousarray(a).data)
        t_crc = time.perf_counter() - t0
        scratch = root / "split"
        scratch.mkdir()
        t0 = time.perf_counter()
        for i, a in enumerate(host):
            np.save(scratch / f"leaf_{i:05d}.npy", a)
        t_npsave = time.perf_counter() - t0
        del host
        _, t_save = sync_time(lambda: save_checkpoint(state, str(root / "whole"), kill_at))
        like = engine.init_growth_state(class_channels(yt, rcfg.n_classes), wt, rcfg,
                                        engine.LocalPlane(fmask), n_features=xbt.shape[1])
        _, t_restore = sync_time(lambda: restore_checkpoint(like, str(d), kill_at, device=dev))
        del like, state
        log(f"checkpoint phase (d): one resident step {step_bytes} bytes ({step_bytes / 2**20:.1f} MiB, of "
            f"which sample_slot {tuple(wt.shape)} int32 is {wt.numel() * 4 / 2**20:.0f} MiB); a save: "
            f"device-to-host {t_d2h:.4f} s, CRC32 {t_crc:.4f} s, np.save {t_npsave:.4f} s; save_checkpoint "
            f"{t_save:.4f} s; restore (verified, onto the card) {t_restore:.4f} s")
        res.update(step_bytes=step_bytes, save_d2h_s=t_d2h, save_crc32_s=t_crc, save_npsave_s=t_npsave,
                   save_checkpoint_s=t_save, restore_s=t_restore)
        del leaves

        # (b) the newest step corrupted, resumed
        check(CheckpointCorruptor(seed=0).corrupt(str(d)) == kill_at, "corruptor: not the newest step")
        with warnings.catch_warnings(record=True) as warned:
            warnings.simplefilter("always")
            (f, levels), t_bad = sync_time(lambda: resumed(grow_r, d))
        check(any("skipping corrupt checkpoint" in str(w.message) for w in warned),
              "corrupted resume: no walk-back warning")
        check(levels[0] == kill_at, f"corrupted resume started at level {levels[0]}, want 4")
        same(f, "resident resume after corrupting the newest step")
        del f
        log(f"checkpoint phase (b): newest step corrupted, the walk-back warned and resumed at level "
            f"{levels[0]} ({t_bad:.3f} s): forest bitwise equal")
        res["corrupted_resume_s"] = t_bad

        # growth with a checkpoint every level against none, in turns
        turns = {"checkpoint": [], "none": []}
        for i in range(4):
            mode = ("checkpoint", "none")[i % 2]
            dd = root / f"turn{i}"
            _, t = sync_time(lambda: grow_forest_checkpointed(
                xbt, yt, wt, rcfg, fmask, device=dev,
                manager=CheckpointManager(str(dd), keep=3, save_interval=1) if mode == "checkpoint" else None))
            turns[mode].append(t)
            shutil.rmtree(dd, ignore_errors=True)
        _, t_plain = sync_time(lambda: grow_forest(xbt, yt, wt, rcfg, fmask, device=dev))
        log(f"checkpoint phase: growth in turns, a checkpoint every level / none (s): {turns['checkpoint']} / "
            f"{turns['none']}; grow_forest {t_plain:.4f} s")
        res.update(growth_turns_s=turns, grow_forest_s=t_plain)

        # (c) streamed: the replay's exact bins in pinned host blocks
        nb = STREAM_BLOCK
        scfg = dataclasses.replace(rcfg, sample_block=nb)
        blocks = [torch.empty((min(nb, xbt.shape[0] - o), xbt.shape[1]), dtype=torch.uint8,
                              pin_memory=True).copy_(xbt[o:o + nb]) for o in range(0, xbt.shape[0], nb)]
        y_host, w_host = yt.cpu().numpy(), wt.cpu().numpy()

        def grow_s(**kw):
            return api.grow_forest_streamed(blocks, y_host, w_host, scfg, fmask, device=dev, **kw)

        ds = root / "streamed"
        _, t_kill_s = sync_time(lambda: killed(grow_s, ds))
        step_bytes_s = sum(p.stat().st_size for p in (ds / f"step_{kill_at:08d}").iterdir())
        (f, levels), t_res_s = sync_time(lambda: resumed(grow_s, ds))
        check(levels[0] == kill_at + 1, f"streamed resume started at level {levels[0]}, want 5")
        same(f, "streamed resume after a kill at level 4 (phase 5b's exact-bins forest)")
        del f, blocks
        log(f"checkpoint phase (c): streamed growth (sample_block {nb}) killed at level 4 ({t_kill_s:.3f} s), "
            f"one step {step_bytes_s / 2**20:.1f} MiB, resumed at level {levels[0]} ({t_res_s:.3f} s): forest "
            "bitwise equal to phase 5b's exact-bins streamed forest")
        res.update(streamed_kill_s=t_kill_s, streamed_resume_s=t_res_s, streamed_step_bytes=step_bytes_s)
        return res
    finally:
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()


# Held-out R^2 floor of phase 5d: the JAX reference's 0.8168435 on the CPU,
# trained on 40,000 of the phase's training rows with the same configuration
# and scored on its test rows (tools/reference_r2_floor.py), less a margin of
# 0.04, as phase 5's accuracy floor is set.
R2_FLOOR = 0.78


def _r2(pred, y):
    return 1.0 - float(np.mean((pred.astype(np.float64) - y) ** 2) / np.var(y.astype(np.float64)))


def tied_divergences(fa, fb, xb, y, w, what):
    """Two regression forests from the same draws, compared on the host
    (``tests/test_torch_regression_ties.py``): every split where they
    diverge is a tie to float rounding (float64 gains within
    ``TIE_TOL * sqrt(m)`` of the node's sum of ``w y^2``, m its in-bag
    rows) and matched leaves agree to rounding; fails otherwise."""
    from test_torch_regression_ties import compare_regression_forests

    names = ("feature", "threshold", "left_child", "value")
    host = [{n: getattr(f, n).cpu().numpy() for n in names} for f in (fa, fb)]
    out = compare_regression_forests(*host, np.asarray(xb.cpu() if torch.is_tensor(xb) else xb), np.asarray(y),
                                     w.cpu().numpy())
    check(not out["untied"], f"{what}: divergences that are not ties to float rounding: {out['untied'][:4]}")
    check(not out["leaves_off"], f"{what}: matched leaves differ: {out['leaves_off'][:4]}")
    gaps = [abs(ga - gb) / allowed for _, _, _, ga, gb, allowed in out["divergences"] if allowed > 0]
    out.update(diverged_trees=int(out["divergent"].any(1).sum()), tie_gap_share=max(gaps, default=0.0))
    return out


def regression_phase(dev, timings):
    """5d. Regression at full size: ``make_regression(1,310,720 x 128,
    n_informative=12, noise=0.1, seed=0)`` split 80/20,
    ``ForestConfig(n_trees=32, max_depth=8, n_bins=64, regression=True)``
    (``hist_reuse`` "auto" resolves off):

    (a) ``train_prf`` + ``predict`` on the kernels, the three PRF kernels'
        launch counts set to 0 just before and read just after, held-out
        R^2 >= ``R2_FLOOR``; a staged replay's stage times (binning,
        bootstrap, growth, OOB R^2, predict);
    (b) the histogram at the level-0 regression slab (C 3: ``[1, y, y^2]``
        channels, ``y`` and ``y^2`` in the growth's fixed point) bitwise
        equal to ``multi_tree_hist_fixed_ref``, within 1e-5 of the float
        plain version's largest entry; timed beside the float-atomic form
        (no fixed point), both plain versions, ``index_add_`` over chunks
        of 8 trees and its bound;
    (c) the split scan on that carry (variance gains), winners equal to the
        plain version's, gains within 1e-5; timed also as direct launches;
    (d) reduced (N 65536, F 32, 8 trees, depth 6): the kernel path against
        the plain path (on CUDA the same fixed point): trees equal
        (checked), every divergence a tie (``tied_divergences``),
        predictions within rtol 1e-5 and 1e-5 of their scale; tree weights
        within 1e-6;
    (e) two growths with the replay's draws bitwise equal
        (``regression_run_to_run_equal``, checked), every divergence a
        tie (checked), the replay's trees equal ``train_prf``'s; then
        phase 5c on regression: the growth killed at level 4 and resumed,
        bitwise equal to the uninterrupted one.
    """
    from repro_torch import ForestConfig, train_prf
    from repro_torch.core import engine
    from repro_torch.core.binning import apply_bins, bin_dataset
    from repro_torch.core.dsi import bootstrap_counts
    from repro_torch.core.forest import grow_forest
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core.forest import grow_forest_checkpointed
    from repro_torch.core.histograms import (
        hist_feature_slab, regression_channels, regression_fixed_point, slot_order,
    )
    from repro_torch.core.voting import oob_r2, predict_regression
    from repro_torch.data.tabular import make_regression, train_test_split
    from repro_torch.kernels import _build
    from repro_torch.kernels.gain_ratio import ops as hist_ops
    from repro_torch.kernels.gain_ratio.ref import multi_tree_hist_fixed_ref, multi_tree_hist_ref
    from repro_torch.kernels.split_scan import ops as scan_ops
    from repro_torch.kernels.split_scan.ref import init_carry, split_scan_block_ref
    from repro_torch.kernels.tree_traverse import ops as trav_ops

    (x, y), t_data = sync_time(lambda: make_regression(
        n_samples=1_310_720, n_features=128, n_informative=12, noise=0.1, seed=0))
    xtr, ytr, xte, yte = train_test_split(x, y, 0.2, 0)
    del x, y
    cfg = ForestConfig(n_trees=32, max_depth=8, n_bins=64, regression=True)
    rcfg = cfg.resolved(xtr.shape[1])
    check(not engine.resolve_hist_reuse(rcfg, xtr.shape[1]), "regression: hist_reuse auto did not resolve off")

    # (a) the main path
    for m in (hist_ops, scan_ops, trav_ops):
        m.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = train_prf(xtr, ytr, cfg, 0, device=dev)
    pred = model.predict(xte)
    torch.cuda.synchronize()
    t_main = time.perf_counter() - t0
    counts = {"gain_ratio_hist": hist_ops.launches, "split_scan": scan_ops.launches,
              "tree_traverse": trav_ops.launches}
    peak = torch.cuda.max_memory_allocated()
    for name, n in counts.items():
        check(n > 0, f"{name} was not launched on the regression path")
    check(pred.dtype == np.float32 and pred.shape == yte.shape and np.isfinite(pred).all(),
          "regression predictions: not finite float32 of the test rows' shape")
    r2 = _r2(pred, yte)
    check(r2 >= R2_FLOOR, f"full-size regression held-out R^2 {r2} < {R2_FLOOR}")
    log(f"regression main path (data {t_data:.2f} s, host): train_prf + predict {t_main:.3f} s, held-out R^2 "
        f"{r2:.7f} (floor {R2_FLOOR}), launches {counts}, levels run {engine.levels_run(model.forest)}, peak "
        f"device memory {peak / 2**30:.2f} GiB")

    stages = {}
    (xbt, edges), stages["binning"] = sync_time(lambda: bin_dataset(xtr, rcfg.n_bins, device=dev))
    check(np.array_equal(edges, model.bin_edges), "regression replay: edges differ")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    wt, stages["bootstrap"] = sync_time(lambda: bootstrap_counts(gen, rcfg.n_trees, xtr.shape[0], dev))
    yt = torch.from_numpy(ytr).to(dev)
    fa, stages["growth"] = sync_time(lambda: grow_forest(xbt, yt, wt, rcfg, None, device=dev))
    fa.tree_weight, stages["oob_r2"] = sync_time(lambda: oob_r2(fa, xbt, yt, wt))
    xbe = apply_bins(torch.from_numpy(xte).to(dev), torch.from_numpy(edges).to(dev))
    _, stages["predict"] = sync_time(lambda: predict_regression(fa, xbe))
    log("regression stages (s): " + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))

    # (e) two growths with the same draws: bitwise equal (the histogram sums
    # y and y^2 in fixed point); every split where they diverge would be a
    # tie to float rounding, which is checked too
    fb, t_b = sync_time(lambda: grow_forest(xbt, yt, wt, rcfg, None, device=dev))
    structure = ("feature", "threshold", "left_child")
    run_to_run = all(torch.equal(getattr(fa, n), getattr(fb, n)) for n in type(fa).FIELDS[:-1])
    trees_equal = all(torch.equal(getattr(fa, n), getattr(fb, n)) for n in structure)
    main_trees_equal = all(torch.equal(getattr(fa, n), getattr(model.forest, n)) for n in structure)
    n_split = int((fa.feature[:, :rcfg.max_nodes] >= 0).sum())
    cmp, t_cmp = sync_time(lambda: tied_divergences(fa, fb, xbt, ytr, wt, "two regression growths"))
    log(f"regression_run_to_run_equal: {run_to_run} (two growths with the same draws, {t_b:.3f} s the second); "
        f"trees equal {trees_equal}; {len(cmp['divergences'])} divergent splits of {n_split}, in "
        f"{cmp['diverged_trees']} of {rcfg.n_trees} trees, every one a tie to float rounding (largest gap "
        f"{cmp['tie_gap_share']:.3g} of its allowance; checked in {t_cmp:.1f} s on the host); matched leaves max "
        f"|d value| {cmp['leaf_value_max_abs']:.3g}; the replay's trees equal train_prf's: {main_trees_equal}")
    check(run_to_run, "regression_run_to_run_equal: two regression growths with the same draws differ")
    check(main_trees_equal, "regression: the staged replay's trees differ from train_prf's")
    del fb

    # 5c on regression: a growth checkpointed every level, killed at level 4
    # and resumed, bitwise the uninterrupted growth fa
    ck_dir = ROOT / "build" / "chip_smoke_ckpt_regression"
    import shutil
    shutil.rmtree(ck_dir, ignore_errors=True)

    def boom(level, _):
        if level == 4:
            raise _Kill

    try:
        try:
            grow_forest_checkpointed(xbt, yt, wt, rcfg, None, device=dev, on_level=boom,
                                     manager=CheckpointManager(str(ck_dir), keep=3, save_interval=1))
            raise AssertionError("regression checkpoint: the kill at level 4 did not fire")
        except _Kill:
            pass
        resumed_at = []
        fr, t_res = sync_time(lambda: grow_forest_checkpointed(
            xbt, yt, wt, rcfg, None, device=dev, resume_from=str(ck_dir),
            on_level=lambda level, _: resumed_at.append(level)))
    finally:
        shutil.rmtree(ck_dir, ignore_errors=True)
    check(resumed_at[0] == 5, f"regression resume started at level {resumed_at[0]}, want 5")
    for n in type(fa).FIELDS[:-1]:
        check(torch.equal(getattr(fr, n), getattr(fa, n)), f"regression resume: {n} differs")
    log(f"checkpoint phase (regression): growth killed at level 4, resumed at level {resumed_at[0]} "
        f"({t_res:.3f} s): forest bitwise equal to the uninterrupted regression growth")
    del fr

    # (b) the histogram at the level-0 regression slab
    k, Ntr, Fall = rcfg.n_trees, xtr.shape[0], xtr.shape[1]
    S, B, C = rcfg.frontier, rcfg.n_bins, 3
    W = hist_feature_slab(Ntr, Fall, S, B, C)
    xs = xbt[:, :W]
    base = regression_channels(yt)
    slot0 = torch.zeros((k, Ntr), dtype=torch.int32, device=dev)
    order = slot_order(slot0, wt, S)
    fp = regression_fixed_point(ytr, wt)          # the growth's own fixed point (host y, device w)
    hk = hist_ops.multi_tree_hist(xs, base, wt, slot0, n_slots=S, n_bins=B, order=order, fixed=fp)
    hf = multi_tree_hist_fixed_ref(xs, base, wt, slot0, n_slots=S, n_bins=B, fixed=fp)
    check(torch.equal(hk, hf), f"regression histogram (fixed point {fp}) != its fixed-point plain version")
    del hf
    hp = multi_tree_hist_ref(xs, base, wt, slot0, n_slots=S, n_bins=B)
    h_err, h_scale = max_abs(hk, hp), float(hp.abs().max())
    check(h_err <= 1e-5 * h_scale, f"regression histogram: max |d| {h_err} > 1e-5 x {h_scale}")
    t = timed("histogram, regression level 0", lambda: hist_ops.multi_tree_hist(
        xs, base, wt, slot0, n_slots=S, n_bins=B, order=order, fixed=fp), "hist_kernel", timings)
    t_float = timed("histogram, regression level 0, float atomics", lambda: hist_ops.multi_tree_hist(
        xs, base, wt, slot0, n_slots=S, n_bins=B, order=order), "hist_kernel", timings)
    p_ms = cuda_ms(lambda: multi_tree_hist_fixed_ref(xs, base, wt, slot0, n_slots=S, n_bins=B, fixed=fp),
                   reps=2, warmup=1)
    pf_ms = cuda_ms(lambda: multi_tree_hist_ref(xs, base, wt, slot0, n_slots=S, n_bins=B), reps=2, warmup=1)
    del hp
    # the yardstick: index_add_ of the float channels' values over the flat
    # index ((((t*S + s)*W + f)*B + b)*C + c), 8 trees at a time (the whole
    # index would take 34 GB), summed over the chunks
    lib_ms, tcn = 0.0, 8
    for t0 in range(0, k, tcn):
        wc = wt[t0:t0 + tcn]
        ts_ = (torch.arange(wc.shape[0], device=dev)[:, None, None] * S) * W + torch.arange(W, device=dev)
        flat = (ts_.expand(-1, Ntr, -1).mul(B).add(xs.long()[None]).mul(C)[..., None]
                + torch.arange(C, device=dev)).reshape(-1)
        vals = (wc[:, :, None, None] * base[None, :, None, :]).expand(-1, -1, W, -1).reshape(-1)
        lib_ms += cuda_ms(lambda: torch.zeros(k * S * W * B * C, device=dev).index_add_(0, flat, vals),
                          reps=3, warmup=1)
        del ts_, flat, vals
    live = int((wt > 0).sum())
    nbytes = Ntr * W + Ntr * C * 4 + 2 * k * Ntr * 4 + hk.numel() * 4
    nops = 2 * live * W * C
    bound = max(nbytes / HBM_BYTES_PER_S, nops / F32_OPS_PER_S) * 1e3
    hist_r = {**t, "plain_ms": p_ms, "plain_float_ms": pf_ms, "library_ms": lib_ms,
              "float_atomics": t_float, "fixed_point": list(fp), "bound_ms": bound,
              "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= nops / F32_OPS_PER_S else "operations",
              "max_abs_err_vs_float": h_err, "scale": h_scale, "W": W}
    log(f"regression histogram at [{k}, {Ntr}, {W}], S {S}, C {C}, level 0, fixed point {fp}: call "
        f"{t['ms']:.4f} ms, kernel {fmt_ms(t['kernel_ms'])} ms (float atomics, as before: call "
        f"{t_float['ms']:.4f} ms, kernel {fmt_ms(t_float['kernel_ms'])} ms), plain {p_ms:.4f} ms (float plain "
        f"{pf_ms:.4f} ms), index_add_ {lib_ms:.4f} ms over {k // tcn} chunks, bound {bound:.4f} ms by "
        f"{hist_r['bound_by']}, share {bound / t['ms']:.3f}; bitwise its fixed-point plain version, max |d| "
        f"{h_err:.3g} of {h_scale:.4g} from the float version")

    # (c) the split scan on the regression carry
    mask = torch.ones((k, W), dtype=torch.bool, device=dev)
    carry0 = init_carry(k, S, C, dev)
    sk = scan_ops.split_scan_block(hk, mask, carry0, 0, regression=True)
    sp = split_scan_block_ref(hk, mask, carry0, 0, regression=True)
    check(torch.equal(sk[1], sp[1]) and torch.equal(sk[2], sp[2]),
          "regression split scan: winners differ from the plain version")
    g_err = max_abs(sk[0], sp[0])
    torch.testing.assert_close(sk[0], sp[0], rtol=1e-5, atol=1e-5)
    ts = timed("split scan, regression level 0", lambda: scan_ops.split_scan_block(
        hk, mask, carry0, 0, regression=True), "split_scan_kernel", timings)
    # the kernel alone without the profiler: CUDA events around direct
    # launches of the C entry point on preallocated outputs
    mask_u8, outs = mask.to(torch.uint8), [c.clone() for c in carry0]
    ts["direct_ms"] = cuda_ms(lambda: _build.launch(
        "prf_split_scan", hk.data_ptr(), mask_u8.data_ptr(), 0, *(o.data_ptr() for o in outs),
        k, S, W, B, C, 1, scan_ops.class_tile(B, C)))
    sp_ms = cuda_ms(lambda: split_scan_block_ref(hk, mask, carry0, 0, regression=True), reps=1, warmup=1)
    scored = int((hk != 0).flatten(3).any(-1).sum())
    ops_per_candidate = 20               # two sums of squares, three subtractions, compares
    nbytes = k * W * S * B * C * 4 + mask.numel() + 2 * k * S * (3 * 4 + 2 * C * 4)
    nops = scored * ((B - 1) * ops_per_candidate + B * C)
    bound_s = max(nbytes / HBM_BYTES_PER_S, nops / F32_OPS_PER_S) * 1e3
    scan_r = {**ts, "plain_ms": sp_ms, "bound_ms": bound_s, "max_abs_err": g_err, "scored_features": scored}
    log(f"regression split scan at [{k}, {S}, {W}, {B}, {C}], level 0: call {ts['ms']:.4f} ms, kernel "
        f"{fmt_ms(ts['kernel_ms'])} ms (direct launches {ts['direct_ms']:.4f} ms), plain {sp_ms:.4f} ms, bound "
        f"{bound_s:.4f} ms, winners equal to the plain version, gain max |d| {g_err:.3g}")
    del hk, sk, sp, xbt, xbe

    # (d) reduced: kernel path against plain path (on CUDA the plain path
    # sums the float channels in the same fixed point: trees equal)
    xr, yr = make_regression(n_samples=65_536, n_features=32, n_informative=8, noise=0.1, seed=2)
    cfg_k = ForestConfig(n_trees=8, max_depth=6, n_bins=64, regression=True)
    cfg_p = dataclasses.replace(cfg_k, hist_backend="segment_sum", split_backend="xla", predict_backend="xla")
    mk, mp = train_prf(xr, yr, cfg_k, 5, device=dev), train_prf(xr, yr, cfg_p, 5, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)                       # train_prf's own draw of the DSI weights
    wr = bootstrap_counts(gen, cfg_k.n_trees, xr.shape[0], dev)
    red = tied_divergences(mk.forest, mp.forest, mk._binned(xr), yr, wr, "reduced regression, kernel vs plain")
    same = ~red["divergent"].any(1)
    w_err = max_abs(mk.forest.tree_weight[same], mp.forest.tree_weight[same]) if same.any() else 0.0
    check(w_err <= 1e-6, f"reduced regression: tree weights differ by {w_err}")
    pk, pp = mk.predict(xr), mp.predict(xr)
    scale, p_err = float(np.abs(pp).max()), float(np.abs(pk - pp).max())
    if not red["divergences"]:
        check(np.allclose(pk, pp, rtol=1e-5, atol=1e-5 * scale),
              f"reduced regression: predictions differ by {p_err}")
    red_trees = all(torch.equal(getattr(mk.forest, n), getattr(mp.forest, n)) for n in structure)
    check(red_trees, "reduced regression: kernel path and plain path grew different trees")
    log(f"reduced regression (N 65536, F 32, k 8, depth 6), kernel path vs plain path: trees equal {red_trees} "
        f"({len(red['divergences'])} tied divergences), predictions max |d| {p_err:.3g} (scale {scale:.4g}"
        f"{', within rtol 1e-5' if not red['divergences'] else ', not compared: trees diverge at a tie'}), tree "
        f"weights of the {int(same.sum())} trees that did not diverge max |d| {w_err:.3g}")
    torch.cuda.empty_cache()
    return {"launches": counts, "main_path_s": t_main, "r2": r2, "r2_floor": R2_FLOOR, "peak_bytes": peak,
            "stages_s": stages, "run_to_run_equal": run_to_run, "run_to_run_trees_equal": trees_equal,
            "run_to_run_divergences": len(cmp["divergences"]), "run_to_run_diverged_trees": cmp["diverged_trees"],
            "run_to_run_tie_gap_share": cmp["tie_gap_share"], "splits": n_split,
            "run_to_run_leaf_value_max_abs": cmp["leaf_value_max_abs"],
            "replay_trees_equal_main": main_trees_equal, "hist_level0": hist_r, "split_scan_level0": scan_r,
            "resume_s": t_res,
            "reduced": {"pred_max_abs": p_err, "scale": scale, "tree_weight_max_abs": w_err,
                        "trees_equal": red_trees, "divergences": len(red["divergences"])}}


MESH_ROWS = 1 << 18             # phase 5e(b): training rows of the gloo world
MESH_BLOCK = 65_536             # its streamed growth's sample_block
MESH_TEST_ROWS = 65_536         # test rows it predicts


def mesh_rank(shape, xb, y, w, fmask, cfg_kw, xte, ckpt_dir, kill_at, device="cuda"):
    """One rank of phase 5e(b), in its own process on ``cuda:0`` (gloo,
    host-staged collectives): resident, streamed and checkpointed mesh
    growth (the last killed after level ``kill_at`` on every rank),
    ``predict_sharded`` and the OOB weights; numpy results."""
    from repro_torch import ForestConfig
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import distributed as dist_prf
    from repro_torch.kernels.gain_ratio import ops as hist_ops
    from repro_torch.kernels.split_scan import ops as scan_ops
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh(shape, device=device)
    cfg = ForestConfig(**cfg_kw)
    out = {"mesh": repr(mesh), "growth_s": {}, "launches": {}}

    def run(tag, fn):
        hist_ops.launches = scan_ops.launches = 0
        f, t = sync_time(fn)
        out["growth_s"][tag] = t
        out["launches"][tag] = {"gain_ratio_hist": hist_ops.launches, "split_scan": scan_ops.launches}
        return f

    def arrays(f):
        return {n: getattr(f, n).cpu().numpy() for n in type(f).FIELDS}

    f = run("resident", lambda: dist_prf.grow_sharded(xb, y, w, cfg, mesh, fmask))
    out["resident"] = arrays(f)
    out["predict"] = dist_prf.predict_sharded(f, xte, mesh)
    out["oob"] = dist_prf.oob_accuracy_sharded(f, xb, y, w, mesh).cpu().numpy()
    scfg = dataclasses.replace(cfg, sample_block=MESH_BLOCK, hist_reduce="psum_scatter")
    out["streamed"] = arrays(run("streamed", lambda: dist_prf.grow_forest_streamed_sharded(
        xb, y, w, scfg, mesh, fmask)))

    class Kill(Exception):
        pass

    def boom(level, _):
        if level == kill_at:
            raise Kill

    try:
        run("checkpointed", lambda: dist_prf.grow_sharded_checkpointed(
            xb, y, w, cfg, mesh, fmask, on_level=boom,
            manager=CheckpointManager(ckpt_dir, keep=3, save_interval=1)))
        raise AssertionError(f"mesh phase: the kill at level {kill_at} did not fire")
    except Kill:
        pass
    return out


def mesh_resume_rank(shape, xb, y, w, fmask, cfg_kw, ckpt_dir, device="cuda"):
    """One rank of phase 5e(b)'s elastic resume: the checkpoint a (2, 2)
    world wrote, resumed on this world's mesh shape."""
    from repro_torch import ForestConfig
    from repro_torch.core import distributed as dist_prf
    from repro_torch.kernels.gain_ratio import ops as hist_ops
    from repro_torch.kernels.split_scan import ops as scan_ops
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh(shape, device=device)
    levels = []
    f, t = sync_time(lambda: dist_prf.grow_sharded_checkpointed(
        xb, y, w, ForestConfig(**cfg_kw), mesh, fmask, resume_from=ckpt_dir,
        on_level=lambda level, _: levels.append(level)))
    return {"mesh": repr(mesh), "forest": {n: getattr(f, n).cpu().numpy() for n in type(f).FIELDS},
            "first_level": levels[0], "resume_s": t,
            "launches": {"gain_ratio_hist": hist_ops.launches, "split_scan": scan_ops.launches}}


def mesh_phase(dev, xbt, yt, wt, fmask, rcfg, forest, t_growth, xbe, backend="nccl"):
    """5e. The mesh plane (``core/distributed.py`` over ``torch.distributed``).

    (a) Full size, an NCCL world of one process (mesh (1, 1), a
        ``FileStore`` under ``build/``), phase 5's binned data, weights and
        mask: ``grow_sharded`` goes through ``MeshPlane`` (the histogram
        built whole, combined by NCCL, then scored) with ``hist_reduce``
        psum and psum_scatter; each forest bitwise phase 5's; growth timed twice
        beside phase 5's (``t_growth``), the histogram and split-scan
        launches counted.
    (b) Several ranks on the one card: a gloo world of 4 processes on
        ``cuda:0`` (mesh (2, 2); NCCL refuses two ranks on one GPU), on the
        first ``MESH_ROWS`` training rows, all 128 features, 32 trees,
        depth 6, the same draws: resident (psum), streamed (``sample_block``
        ``MESH_BLOCK``, psum_scatter) and checkpointed growth each bitwise
        the local forest; the checkpointed run killed after level 3 on every
        rank and resumed by a gloo world of 4 on a (4, 1) mesh, bitwise;
        ``predict_sharded`` of ``MESH_TEST_ROWS`` test rows and the OOB
        weights equal to the local ones; the histogram and the split scan
        launched on every rank. A failed rank fails the phase.
    """
    import shutil

    import torch.distributed as tdist

    from repro_torch.core import distributed as dist_prf
    from repro_torch.core.forest import grow_forest
    from repro_torch.core.voting import oob_accuracy, predict
    from repro_torch.kernels.gain_ratio import ops as hist_ops
    from repro_torch.kernels.split_scan import ops as scan_ops
    from repro_torch.launch.mesh import make_mesh, run_world

    root = ROOT / "build" / "chip_smoke_mesh"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    fields = type(forest).FIELDS[:-1]
    res = {}
    try:
        # (a) NCCL, one rank, full size
        tdist.init_process_group(backend, store=tdist.FileStore(str(root / "store"), 1), rank=0,
                                 world_size=1, timeout=datetime.timedelta(seconds=300))
        try:
            mesh = make_mesh((1, 1), device=dev)
            y_host, w_host, m_host = yt.cpu().numpy(), wt.cpu().numpy(), fmask.cpu().numpy()
            for hr in ("psum", "psum_scatter"):
                cfg = dataclasses.replace(rcfg, hist_reduce=hr)
                _, xl, base, wl, ml, fx = dist_prf._local_inputs(
                    xbt, y_host, w_host, m_host, cfg, mesh, ("data",), "model")
                hist_ops.launches = scan_ops.launches = 0
                f, t = sync_time(lambda: dist_prf._grow_sharded(xl, base, wl, ml, cfg, mesh,
                                                                hist_fixed=fx))
                launches = {"gain_ratio_hist": hist_ops.launches, "split_scan": scan_ops.launches}
                _, t2 = sync_time(lambda: dist_prf._grow_sharded(xl, base, wl, ml, cfg, mesh, hist_fixed=fx))
                for name in fields:
                    check(torch.equal(getattr(f, name), getattr(forest, name)),
                          f"mesh phase (a), NCCL (1, 1), {hr}: {name} differs from phase 5's forest")
                for name, n in launches.items():
                    check(n > 0 or dev.type != "cuda", f"mesh phase (a), {hr}: {name} was not launched")
                f2 = dist_prf.grow_sharded(xbt, y_host, w_host, cfg, mesh, m_host)
                check(all(torch.equal(getattr(f2, n), getattr(forest, n)) for n in fields),
                      f"mesh phase (a), {hr}: grow_sharded on the global arrays differs")
                res[f"nccl_{hr}"] = {"growth_s": [t, t2], "launches": launches}
                log(f"mesh phase (a): {backend} world of 1, mesh {mesh.shape}, {hr}: growth {t:.3f} s, again "
                    f"{t2:.3f} s (phase 5's fused single-device growth {t_growth:.3f} s), launches {launches}; "
                    "forest bitwise equal to phase 5's")
                del f, f2, xl, base, wl
        finally:
            tdist.destroy_process_group()
        if dev.type == "cuda":
            torch.cuda.empty_cache()

        # (b) gloo, 4 ranks on cuda:0, reduced size
        n = MESH_ROWS
        cfg_kw = {**dataclasses.asdict(rcfg), "max_depth": 6}
        cfg6 = type(rcfg)(**cfg_kw)
        xb_h = xbt[:n].cpu().numpy()
        y_h, w_h, m_h = yt[:n].cpu().numpy(), wt[:, :n].cpu().numpy(), fmask.cpu().numpy()
        xte_h = xbe[:MESH_TEST_ROWS].cpu().numpy()
        local = grow_forest(xb_h, y_h, w_h, cfg6, m_h, device=dev)
        want = {n_: getattr(local, n_).cpu().numpy() for n_ in fields}
        want_pred = predict(local, torch.from_numpy(xte_h).to(dev), backend="xla").cpu().numpy()
        want_oob = oob_accuracy(local, torch.from_numpy(xb_h).to(dev), torch.from_numpy(y_h).to(dev),
                                torch.from_numpy(w_h).to(dev)).cpu().numpy()
        ckpt = str(root / "ckpt")
        kill_at = 3
        (ranks, t_world) = sync_time(lambda: run_world(
            "chip_smoke:mesh_rank", 4, backend="gloo", timeout_s=420, collective_timeout_s=300,
            args=((2, 2), xb_h, y_h, w_h, m_h, cfg_kw, xte_h, ckpt, kill_at, dev.type)))
        for r, out in enumerate(ranks):
            for tag in ("resident", "streamed"):
                for name in fields:
                    check(np.array_equal(out[tag][name], want[name]),
                          f"mesh phase (b), rank {r}, {tag}: {name} differs from the local forest")
            check(np.array_equal(out["predict"], want_pred), f"mesh phase (b), rank {r}: labels differ")
            check(np.array_equal(out["oob"], want_oob), f"mesh phase (b), rank {r}: OOB weights differ")
            for tag, counts in out["launches"].items():
                for name, c in counts.items():
                    check(c > 0 or dev.type != "cuda",
                          f"mesh phase (b), rank {r}, {tag}: {name} was not launched")
        (moved, t_world2) = sync_time(lambda: run_world(
            "chip_smoke:mesh_resume_rank", 4, backend="gloo", timeout_s=420, collective_timeout_s=300,
            args=((4, 1), xb_h, y_h, w_h, m_h, cfg_kw, ckpt, dev.type)))
        for r, out in enumerate(moved):
            check(out["first_level"] == kill_at + 1,
                  f"mesh phase (b), rank {r}: the resume started at level {out['first_level']}")
            for name in fields:
                check(np.array_equal(out["forest"][name], want[name]),
                      f"mesh phase (b), rank {r}: the (4, 1) resume of the (2, 2) checkpoint differs ({name})")
        res["gloo"] = {"ranks": [{k_: v for k_, v in o.items() if k_ in ("mesh", "growth_s", "launches")}
                                 for o in ranks],
                       "resume": [{k_: v for k_, v in o.items() if k_ in ("mesh", "resume_s", "launches",
                                                                         "first_level")} for o in moved],
                       "world_s": t_world, "resume_world_s": t_world2}
        log(f"mesh phase (b): gloo world of 4 on {dev} (mesh (2, 2), {ranks[0]['mesh']}), {n} rows, "
            f"{xb_h.shape[1]} features, {cfg6.n_trees} trees, depth {cfg6.max_depth}: resident, streamed "
            f"(sample_block {MESH_BLOCK}) and checkpointed "
            f"growth bitwise the local forest on every rank, labels and OOB weights equal; a kill at level "
            f"{kill_at} resumed by a (4, 1) world bitwise; rank 0 growth s {ranks[0]['growth_s']}, launches "
            f"{ranks[0]['launches']}; worlds {t_world:.1f} s and {t_world2:.1f} s")
        return res
    finally:
        shutil.rmtree(root, ignore_errors=True)


def traverse_batch_ab(src: str) -> int:
    """``--traverse-ab``: the traversal at a 256-row request batch, alone
    (F 128, 32 trees, depth 8, P 2050, C 4: the smoke forest's shape, a
    random forest from seed 0), with ``repro_torch`` imported from
    ``src`` (``--src``: another checkout's, whose kernels build there,
    e.g. the parent commit's, for a before / after in one call). Times
    the wrapper under its own tile plan and, where the wrapper plans
    tiles (``traverse_plan``), at the other block heights of 32, 64 and
    128 rows; each variant is held bitwise to the plain version. Call
    times: CUDA events around 10 calls, in five rounds over the variants;
    kernel alone: three profiler traces. Prints one JSON line."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path[:0] = [str(Path(src).resolve()), str(ROOT / "tests")]
    from repro_torch.kernels.tree_traverse import ops as trav_ops
    from repro_torch.kernels.tree_traverse.ref import traverse_block_ref
    from test_torch_traverse_cases import random_forest

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    rng = np.random.default_rng(0)
    N, F, k, C, depth, P = 256, 128, 32, 4, 8, 2050
    arrays = [torch.from_numpy(a).to(dev) for a in random_forest(rng, k, depth, F, C, P)]
    xq = torch.from_numpy(rng.integers(0, 256, (N, F), dtype=np.uint8)).to(dev)
    zq = torch.zeros((N, C), device=dev)
    want = traverse_block_ref(xq, *arrays, zq, depth=depth)

    def call():
        return trav_ops.traverse_block(xq, *arrays, zq, depth=depth)

    planner = getattr(trav_ops, "traverse_plan", None)
    variants = {"own plan": None}
    if planner is not None:
        own = planner(F)
        variants["own plan"] = own
        for tn in (32, 64, 128):
            if tn != own["TN"]:
                variants[f"TN {tn}"] = {**own, "TN": tn, "smem_bytes": trav_ops._smem(tn, own["Fs"])}
    res = {name: {"plan": plan, "ms": [], "kernel_ms": []} for name, plan in variants.items()}

    def under(plan, fn):
        if plan is not None:
            trav_ops.traverse_plan = lambda *a: plan
        try:
            return fn()
        finally:
            if planner is not None:
                trav_ops.traverse_plan = planner

    for name, plan in variants.items():
        check(torch.equal(under(plan, call), want), f"traversal, {name}: kernel != plain")
    for _ in range(5):
        for name, plan in variants.items():
            res[name]["ms"].append(under(plan, lambda: cuda_ms(call)))
    for _ in range(3):
        for name, plan in variants.items():
            res[name]["kernel_ms"].append(under(plan, lambda: device_ms(call, "traverse_kernel")[0]))
    log(json.dumps({"traverse_ab": res, "src": src, "card": smi}))
    return 0


def tensor_core_sass():
    """The bf16 tensor-core kernels' SASS holds HGMMA (wgmma) instructions:
    every instantiation of flash_tc_kernel (4) and ssd_tc_kernel (8); the
    listings go to ``artifacts/{name}.sass``. Returns HGMMA lines per
    instantiation, per kernel."""
    from repro_torch.kernels import _build

    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(_build.BUILD_DIR / _build.LIB_NAME)],
                          capture_output=True, text=True, check=True, timeout=300).stdout
    out_dir = ROOT / "artifacts"
    out_dir.mkdir(exist_ok=True)
    counts = {}
    for kernel, n_inst, show in (("flash_tc_kernel", 4, "ILi64E"), ("ssd_tc_kernel", 8, "ILi64ELi128E")):
        funcs = {blk.split("\n", 1)[0].strip(): blk for blk in sass.split("Function : ")[1:]
                 if kernel in blk.split("\n", 1)[0]}
        check(len(funcs) == n_inst, f"want {n_inst} instantiations of {kernel} in the SASS, found {list(funcs)}")
        (out_dir / f"{kernel}.sass").write_text("".join(f"Function : {b}" for b in funcs.values()))
        hgmma = {}
        for name, blk in funcs.items():
            lines = [ln.strip() for ln in blk.splitlines() if "HGMMA" in ln]
            check(lines, f"{name}: no HGMMA in its SASS")
            hgmma[name] = len(lines)
        main = next(blk for name, blk in funcs.items() if show in name)
        log(f"cuobjdump -sass, {kernel} ({show}), its HGMMA lines:\n" +
            "\n".join(ln.strip() for ln in main.splitlines() if "HGMMA" in ln))
        log(f"{kernel}: HGMMA instructions per instantiation: {hgmma}")
        counts[kernel] = hgmma
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests")]
    from repro_torch import ForestConfig, train_prf
    from repro_torch.core import engine
    from repro_torch.core.binning import apply_bins, bin_dataset
    from repro_torch.core.dimred import dimension_reduction
    from repro_torch.core.dsi import bootstrap_counts
    from repro_torch.core.forest import fused_vote_scores, grow_forest
    from repro_torch.core.histograms import class_channels, hist_feature_slab, slot_order
    from repro_torch.core.voting import build_payload, oob_accuracy, predict
    from repro_torch.data.pipeline import screen_blocks
    from repro_torch.data.tabular import make_classification, train_test_split
    from repro_torch.kernels import _build
    from repro_torch.kernels.gain_ratio import ops as hist_ops
    from repro_torch.kernels.gain_ratio.ref import (
        FixedPoint, fixed_shift, multi_tree_hist_fixed_ref, multi_tree_hist_ref,
    )
    from repro_torch.kernels.split_scan import ops as scan_ops
    from repro_torch.kernels.split_scan.ref import init_carry, split_scan_block_ref
    from repro_torch.kernels.tree_traverse import ops as trav_ops
    from repro_torch.kernels.tree_traverse.ref import traverse_block_ref

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. the card ------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    # 2. build -----------------------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    log(f"build: {time.perf_counter() - t0:.2f} s (nvcc {_build.build_seconds} s) -> {_build.BUILD_DIR}")
    hgmma = tensor_core_sass()

    rng = np.random.default_rng(0)

    # 3. kernels against their plain versions, small shapes --------------------
    tc, N, F, S, B, C = 8, 100_003, 37, 64, 64, 4
    xb = torch.from_numpy(rng.integers(0, B, (N, F)).astype(np.uint8)).to(dev)
    y = torch.from_numpy(rng.integers(0, C, N)).to(dev)
    base = class_channels(y, C)
    w = torch.from_numpy(rng.integers(0, 4, (tc, N)).astype(np.float32)).to(dev)
    slot_np = rng.integers(0, S, (tc, N)).astype(np.int32)
    slot_np[rng.random((tc, N)) < 0.1] = -1
    slot = torch.from_numpy(slot_np).to(dev)
    for packed in (False, True):
        hk = hist_ops.multi_tree_hist(xb, base, w, slot, n_slots=S, n_bins=B, packed=packed)
        hp = multi_tree_hist_ref(xb, base, w, slot, n_slots=S, n_bins=B, packed=packed)
        check(torch.equal(hk, hp), f"histogram kernel != plain (packed={packed})")
    yr = torch.from_numpy(rng.normal(size=N).astype(np.float32)).to(dev)
    base_r = torch.stack([torch.ones_like(yr), yr, yr * yr], -1)
    hk_r = hist_ops.multi_tree_hist(xb, base_r, w, slot, n_slots=S, n_bins=B)
    hp_r = multi_tree_hist_ref(xb, base_r, w, slot, n_slots=S, n_bins=B)
    torch.testing.assert_close(hk_r, hp_r, rtol=1e-5, atol=1e-3)
    fp_r = FixedPoint(1, fixed_shift(N, 3.0, float((yr * yr).max())))
    check(torch.equal(hist_ops.multi_tree_hist(xb, base_r, w, slot, n_slots=S, n_bins=B, fixed=fp_r),
                      multi_tree_hist_fixed_ref(xb, base_r, w, slot, n_slots=S, n_bins=B, fixed=fp_r)),
          "regression histogram in fixed point != its fixed-point plain version")
    log(f"hist: bitwise (packed and unpacked; regression in fixed point {fp_r}), regression with float "
        f"atomics max|d| {max_abs(hk_r, hp_r):.3g}")

    mask = torch.from_numpy(rng.random((tc, F)) > 0.3).to(dev)
    ck, cp = init_carry(tc, S, C, dev), init_carry(tc, S, C, dev)
    for f0, f1 in ((0, 12), (12, 25), (25, 37)):
        ck = scan_ops.split_scan_block(hp[:, :, f0:f1], mask[:, f0:f1], ck, f0)
        cp = split_scan_block_ref(hp[:, :, f0:f1], mask[:, f0:f1], cp, f0)
    for i in (1, 2, 3, 4):
        check(torch.equal(ck[i], cp[i]), f"split scan carry field {i} differs")
    torch.testing.assert_close(ck[0], cp[0], rtol=1e-6, atol=0)
    log(f"split scan: winners and counts identical over 3 slabs, gain max|d| {max_abs(ck[0], cp[0]):.3g}")
    # past shared memory's class limits: both kernels take the class axis in tiles
    Nw, Fw, Sw, Bw, Cw = 20_011, 6, 5, 256, 300
    xw = torch.from_numpy(rng.integers(0, Bw, (Nw, Fw)).astype(np.uint8)).to(dev)
    basew = class_channels(torch.from_numpy(rng.integers(0, Cw, Nw)).to(dev), Cw)
    ww = torch.from_numpy(rng.integers(0, 4, (tc, Nw)).astype(np.float32)).to(dev)
    slotw = torch.from_numpy(rng.integers(-1, Sw, (tc, Nw)).astype(np.int32)).to(dev)
    hpw = multi_tree_hist_ref(xw, basew, ww, slotw, n_slots=Sw, n_bins=Bw)
    check(torch.equal(hist_ops.multi_tree_hist(xw, basew, ww, slotw, n_slots=Sw, n_bins=Bw), hpw),
          f"class-tiled histogram (B {Bw}, C {Cw}) != plain")
    maskw = torch.from_numpy(rng.random((tc, Fw)) > 0.2).to(dev)
    ckw = cpw = init_carry(tc, Sw, Cw, dev)
    for f0, f1 in ((0, 4), (4, Fw)):
        ckw = scan_ops.split_scan_block(hpw[:, :, f0:f1], maskw[:, f0:f1], ckw, f0)
        cpw = split_scan_block_ref(hpw[:, :, f0:f1], maskw[:, f0:f1], cpw, f0)
    for i in range(5):
        check(torch.equal(ckw[i], cpw[i]), f"class-tiled split scan (B {Bw}, C {Cw}): field {i} differs")
    log(f"class tiles at B {Bw}, C {Cw}: histogram (tiles of {hist_ops.class_tile(Bw, Cw)} classes) "
        f"and split scan (tiles of {scan_ops.class_tile(Bw, Cw)}, every carry field) bitwise equal to "
        f"the plain versions")

    xf = make_classification(n_samples=N, n_features=F, n_classes=C, seed=1)
    small = train_prf(xf[0], xf[1], ForestConfig(n_trees=32, max_depth=8, n_bins=B, n_classes=C,
                                                 tree_chunk=12, hist_reuse="off"), 0, device=dev)
    xbs, _ = bin_dataset(xf[0], B, device=dev)
    payload = build_payload(small.forest).contiguous()
    sk = fused_vote_scores(small.forest, xbs, payload)
    sp = None
    fo = small.forest
    for c0 in range(0, 32, 12):
        c1 = min(c0 + 12, 32)
        sp = traverse_block_ref(xbs, fo.feature[c0:c1], fo.threshold[c0:c1], fo.left_child[c0:c1],
                                payload[c0:c1], sp if sp is not None else torch.zeros_like(sk),
                                depth=8)
    check(torch.equal(sk, sp), "traversal of a trained forest (chunks of 12) != plain")
    log("traverse: a trained forest of 32 trees in chunks of 12, scores bitwise equal to the plain version")
    traverse_checks(dev)
    lm_small = lm_kernel_checks(dev)

    # 4. reduced end to end: kernel path == plain path --------------------------
    xr, yr_ = make_classification(n_samples=65_536, n_features=32, n_classes=4, seed=2)
    cfg_k = ForestConfig(n_trees=8, max_depth=6, n_bins=64, n_classes=4, hist_reuse="off")
    cfg_p = dataclasses.replace(cfg_k, hist_backend="segment_sum", split_backend="xla",
                                predict_backend="xla")
    mk = train_prf(xr, yr_, cfg_k, 5, device=dev)
    mp = train_prf(xr, yr_, cfg_p, 5, device=dev)
    for name in ("feature", "threshold", "left_child", "class_counts", "tree_weight"):
        check(torch.equal(getattr(mk.forest, name), getattr(mp.forest, name)),
              f"reduced end to end: {name} differs between kernel and plain paths")
    check(np.array_equal(mk.predict(xr), mp.predict(xr)), "reduced end to end: labels differ")
    log("reduced end to end (N=65536, F=32, k=8, depth 6): forests and labels identical")
    for path, off_model, c in (("kernel", mk, cfg_k), ("plain", mp, cfg_p)):
        n0 = hist_ops.launches
        on_model = train_prf(xr, yr_, dataclasses.replace(c, hist_reuse="on"), 5, device=dev)
        check((hist_ops.launches > n0) == (path == "kernel"), f"reduced reuse, {path} path: histogram launches")
        for name in type(on_model.forest).FIELDS:
            check(torch.equal(getattr(on_model.forest, name), getattr(off_model.forest, name)),
                  f"reduced end to end, {path} path: reuse on != reuse off ({name})")
    log("reduced end to end: histogram reuse on gives the reuse-off forests bitwise, kernel and plain paths")
    reuse_reduced = reduced_reuse_turns(dev, xr, yr_, cfg_k)
    lm_reduced_end_to_end(dev)

    # 5. full size --------------------------------------------------------------
    cfg = ForestConfig(n_trees=32, max_depth=8, n_bins=64, n_classes=4)
    (x, yl), t_data = sync_time(lambda: make_classification(
        n_samples=1_310_720, n_features=128, n_classes=4, n_informative=12, n_redundant=8,
        class_sep=1.6, label_noise=0.05, seed=0))
    xtr, ytr, xte, yte = train_test_split(x, yl, 0.2, 0)
    log(f"data: train {xtr.shape} test {xte.shape} ({t_data:.2f} s, host)")

    for m in (hist_ops, scan_ops, trav_ops):
        m.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = train_prf(xtr, ytr, cfg, 0, device=dev)
    pred = model.predict(xte)
    torch.cuda.synchronize()
    t_main = time.perf_counter() - t0
    counts = {"gain_ratio_hist": hist_ops.launches, "split_scan": scan_ops.launches,
              "tree_traverse": trav_ops.launches}
    peak = torch.cuda.max_memory_allocated()
    acc = float(np.mean(pred == yte))
    levels = engine.levels_run(model.forest)
    log(f"main path: train_prf + predict {t_main:.3f} s, levels run {levels}, "
        f"peak device memory {peak / 2**30:.2f} GiB, test accuracy {acc:.7f}")
    check(acc >= 0.90, f"full-size test accuracy {acc} < 0.90")
    for name, n in counts.items():
        check(n > 0, f"{name} was not launched on the main path")

    # per-stage replay of the same pipeline, with host clocks ending in a sync
    rcfg = cfg.resolved(xtr.shape[1])
    stages = {}
    _, stages["validation"] = sync_time(lambda: screen_blocks(
        [xtr], ytr, policy="raise", n_features=xtr.shape[1], n_classes=rcfg.n_classes))
    (xbt, edges), stages["binning"] = sync_time(lambda: bin_dataset(xtr, rcfg.n_bins, device=dev))
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    (wt, u), stages["bootstrap"] = sync_time(lambda: (
        bootstrap_counts(gen, rcfg.n_trees, xtr.shape[0], dev),
        torch.rand((rcfg.n_trees, xtr.shape[1]), generator=gen, device=dev)))
    yt = torch.from_numpy(ytr).to(dev)
    fmask, stages["dimension_reduction"] = sync_time(lambda: dimension_reduction(xbt, yt, wt, rcfg, u))
    forest, stages["growth"] = sync_time(lambda: grow_forest(xbt, yt, wt, rcfg, fmask, device=dev))
    forest.tree_weight, stages["oob_weights"] = sync_time(lambda: oob_accuracy(forest, xbt, yt, wt))
    check(all(torch.equal(getattr(forest, n), getattr(model.forest, n)) for n in type(forest).FIELDS),
          "staged replay differs from train_prf")
    edges_t = torch.from_numpy(edges).to(dev)
    xbe, stages["predict_binning"] = sync_time(lambda: apply_bins(torch.from_numpy(xte).to(dev), edges_t))
    _, stages["predict"] = sync_time(lambda: predict(forest, xbe))
    log("stages (s): " + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))
    rows, timings = [], {}
    reuse = reuse_phase(dev, xbt, yt, wt, fmask, rcfg, forest, timings)

    # kernels at the main path's shapes: the first growth level's slab
    k, Ntr, Fall = rcfg.n_trees, xtr.shape[0], xtr.shape[1]
    S, B, C = rcfg.frontier, rcfg.n_bins, rcfg.n_classes
    W = hist_feature_slab(Ntr, Fall, S, B, C)
    xs = xbt[:, :W]
    base = class_channels(yt, C)
    slot0 = torch.zeros((k, Ntr), dtype=torch.int32, device=dev)
    fmask_s = fmask[:, :W].contiguous()

    def kernel_row(name, src, replaces, launches, err, t, plain_ms, nbytes, nops, library_ms,
                   ops_per_s=F32_OPS_PER_S):
        """One row of the kernels line; ``t`` from ``timed``."""
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = nops / ops_per_s * 1e3
        row = {"name": name, "route": "cuda", "source": src, "replaces": replaces,
               "launches": launches, "max_abs_err": err, "ms": t["ms"], "plain_ms": plain_ms,
               "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "library_ms": library_ms, "kernel_ms": t["kernel_ms"], "launches_traced": t["launches_traced"]}
        rows.append(row)
        log(f"{name}: {row['ms']:.4f} ms (kernel alone {fmt_ms(row['kernel_ms'])}; plain {plain_ms:.4f} ms, bound "
            f"{row['bound_ms']:.4f} ms by {row['bound_by']}, share {row['bound_ms'] / row['ms']:.3f}, of the "
            f"kernel alone {bound_share(row['bound_ms'], row['kernel_ms'])}, library {library_ms}) max|d| {err:.3g}")

    # The kernel's time excludes the per-level slot ordering, timed beside it.
    hist_shapes, level_hists = {}, {}
    deep_np = rng.integers(0, 128, (k, Ntr)).astype(np.int32)
    deep_np[rng.random((k, Ntr)) < 0.08] = -1
    for shape, slots in (("deep level: 128 slots, 8% parked", torch.from_numpy(deep_np).to(dev)),
                         ("level 0: all in slot 0", slot0)):
        order, order_ms = slot_order(slots, wt, S), cuda_ms(lambda: slot_order(slots, wt, S))
        hk = hist_ops.multi_tree_hist(xs, base, wt, slots, n_slots=S, n_bins=B, order=order)
        hp = multi_tree_hist_ref(xs, base, wt, slots, n_slots=S, n_bins=B)
        check(torch.equal(hk, hp), f"full-size histogram kernel != plain ({shape})")
        t = timed(f"histogram, {shape}", lambda: hist_ops.multi_tree_hist(
            xs, base, wt, slots, n_slots=S, n_bins=B, order=order), "hist_kernel", timings)
        hist_shapes[shape] = {**t, "slot_order_ms": order_ms}
        level_hists[shape] = hk
        log(f"histogram at [{k}, {Ntr}, {W}], S {S}, {shape}: call {t['ms']:.4f} ms, slot ordering "
            f"{order_ms:.4f} ms per level, bitwise equal to the plain version")
    p_ms = cuda_ms(lambda: multi_tree_hist_ref(xs, base, wt, slot0, n_slots=S, n_bins=B), reps=2, warmup=1)
    live = int(((wt > 0) & (slot0 >= 0)).sum())
    cls = base.argmax(-1)
    # the yardstick's flat index, built in place: ((((t*S + s)*W + f)*B + b)*C + c)
    ts = torch.arange(k, device=dev)[:, None, None] * S + slot0.long()[:, :, None]
    flat = ts * W + torch.arange(W, device=dev)
    del ts
    flat.mul_(B).add_(xs.long()[None]).mul_(C).add_(cls[None, :, None])
    flat = flat.reshape(-1)
    vals = (wt[:, :, None] * base.max(-1).values[None, :, None]).expand(k, Ntr, W).reshape(-1)
    lib_ms = cuda_ms(lambda: torch.zeros(k * S * W * B * C, device=dev).index_add_(0, flat, vals),
                     reps=3, warmup=1)
    lib_out = torch.zeros(k * S * W * B * C, device=dev).index_add_(0, flat, vals)
    check(torch.equal(lib_out.view_as(hk), hk), "index_add_ yardstick != kernel")
    del flat, vals, lib_out
    kernel_row("gain_ratio_hist", "src/repro_torch/csrc/gain_ratio_hist.cu",
               "src/repro/kernels/gain_ratio/kernel.py:156", counts["gain_ratio_hist"],
               max_abs(hk, hp), t, p_ms,
               Ntr * W + Ntr * C * 4 + 2 * k * Ntr * 4 + hk.numel() * 4, 2 * live * W, lib_ms)
    del hp

    # The split scan at both levels' histograms. It never reads a masked
    # feature's histogram and skips the scoring of an all-zero one, so its
    # bound counts the admitted features' bytes and the scoring of the
    # admitted features with any count.
    carry0 = init_carry(k, S, C, dev)
    ops_per_candidate = 57 * C + 60      # sums, divisions, 6 logs of 22 float ops each
    scan_shapes = {}
    for shape, hs in level_hists.items():
        sk = scan_ops.split_scan_block(hs, fmask_s, carry0, 0)
        sp = split_scan_block_ref(hs, fmask_s, carry0, 0)
        for i in range(5):
            check(torch.equal(sk[i], sp[i]), f"full-size split scan field {i} differs ({shape})")
        t = timed(f"split scan, {shape}", lambda: scan_ops.split_scan_block(hs, fmask_s, carry0, 0),
                  "split_scan_kernel", timings)
        p_ms = cuda_ms(lambda: split_scan_block_ref(hs, fmask_s, carry0, 0), reps=1, warmup=1)
        admitted = int(fmask_s.sum())
        scored = int(((hs != 0).flatten(3).any(-1) & fmask_s[:, None, :]).sum())
        nbytes = admitted * S * B * C * 4 + fmask_s.numel() + 2 * k * S * (3 * 4 + 2 * C * 4)
        nops = scored * ((B - 1) * ops_per_candidate + B * C)
        bound = max(nbytes / HBM_BYTES_PER_S, nops / F32_OPS_PER_S) * 1e3
        scan_shapes[shape] = {**t, "plain_ms": p_ms, "bound_ms": bound, "admitted_features": admitted,
                              "scored_features": scored, "bytes": nbytes, "ops": nops}
        log(f"split scan at [{k}, {S}, {W}, {B}, {C}], {shape}: call {t['ms']:.4f} ms, kernel "
            f"{fmt_ms(t['kernel_ms'])} ms, plain {p_ms:.4f} ms, bound {bound:.4f} ms ({admitted} admitted "
            f"(tree, feature) pairs of {k * W}, {scored} (tree, slot, feature) scored), share "
            f"{bound / t['ms']:.3f} (kernel alone {bound_share(bound, t['kernel_ms'])}); carry bitwise equal to "
            f"the plain version")
        if shape.startswith("level 0"):
            kernel_row("split_scan", "src/repro_torch/csrc/split_scan.cu",
                       "src/repro/kernels/split_scan/kernel.py:147", counts["split_scan"],
                       max_abs(sk[0], sp[0]), t, p_ms, nbytes, nops, None)
    del hk, sk, sp, level_hists, hs

    fo = model.forest
    pay = build_payload(fo).contiguous()
    P = fo.feature.shape[1]
    zeros = torch.zeros((xbe.shape[0], C), device=dev)
    traverse_shapes = {}
    for Nt in (xbe.shape[0], 256):          # the smoke shape, then a small request batch
        xq, zq = xbe[:Nt], zeros[:Nt]
        tk = trav_ops.traverse_block(xq, fo.feature, fo.threshold, fo.left_child, pay, zq, depth=cfg.max_depth)
        tp = traverse_block_ref(xq, fo.feature, fo.threshold, fo.left_child, pay, zq, depth=cfg.max_depth)
        check(torch.equal(tk, tp), f"traversal at N {Nt}: kernel != plain")
        t = timed(f"traversal N {Nt}", lambda: trav_ops.traverse_block(
            xq, fo.feature, fo.threshold, fo.left_child, pay, zq, depth=cfg.max_depth), "traverse_kernel", timings)
        pack_ms = device_ms(lambda: trav_ops.traverse_block(
            xq, fo.feature, fo.threshold, fo.left_child, pay, zq, depth=cfg.max_depth), "pack_nodes_kernel")[0]
        p_ms = cuda_ms(lambda: traverse_block_ref(xq, fo.feature, fo.threshold, fo.left_child, pay,
                                                  zq, depth=cfg.max_depth), reps=3, warmup=1)
        # bins, carry and output once; of the forest only what this data's
        # walks reach: the three words of each internal node visited, the
        # payload row of each leaf reached
        internal, leaves, steps = traverse_work(fo, xq, cfg.max_depth)
        nbytes = Nt * Fall + internal * 3 * 4 + leaves * C * 4 + 2 * Nt * C * 4
        nops = 2 * steps + Nt * k * C
        bound = max(nbytes / HBM_BYTES_PER_S, nops / F32_OPS_PER_S) * 1e3
        plan = trav_ops.traverse_plan(Fall)
        traverse_shapes[Nt] = {**t, "pack_kernel_ms": pack_ms, "plain_ms": p_ms, "bound_ms": bound, "plan": plan,
                               "internal_nodes_visited": internal, "leaves_reached": leaves, "steps": steps}
        log(f"traversal at N {Nt} (F {Fall}, {k} trees, depth {cfg.max_depth}, P {P}, plan {plan}): call "
            f"{t['ms']:.4f} ms, kernel {fmt_ms(t['kernel_ms'])} ms + node packing {fmt_ms(pack_ms)} ms, plain "
            f"{p_ms:.4f} ms, bound {bound:.5f} ms ({internal} internal nodes visited, {leaves} leaves reached, {steps} "
            f"steps), share {bound / t['ms']:.3f}; bitwise equal to the plain version")
        if Nt == xbe.shape[0]:
            kernel_row("tree_traverse", "src/repro_torch/csrc/tree_traverse.cu",
                       "src/repro/kernels/tree_traverse/kernel.py:124", counts["tree_traverse"],
                       max_abs(tk, tp), t, p_ms, nbytes, nops, None)

    # 5b. full size, streamed -----------------------------------------------------
    streamed = streamed_phase(dev, xtr, ytr, xte, yte, wt, u, rcfg, model, pred)
    for row in rows:
        row["launches_streamed"] = streamed["launches"].get(row["name"])

    # 5c. checkpoints at full size; 5d. regression at full size -----------------
    checkpoints = checkpoint_phase(dev, xbt, yt, wt, fmask, rcfg, forest)
    regression = regression_phase(dev, timings)

    # 5e. the mesh plane ---------------------------------------------------------
    mesh = mesh_phase(dev, xbt, yt, wt, fmask, rcfg, forest, stages["growth"], xbe)

    # 6. full size, LM serving ----------------------------------------------------
    lm = [lm_full(dev, arch) for arch in ("smollm-135m", "mamba2-780m")]
    lm_counts = {"flash_attention": lm[0]["launches"]["flash_attention"],
                 "ssd_scan": lm[1]["launches"]["ssd_scan"]}
    counts.update(lm_counts)
    attention_wide = lm_kernel_rows(dev, lm_counts, kernel_row, timings)

    # 7. results ------------------------------------------------------------------
    result = {"kernels": rows, "stages_s": stages, "main_path_s": t_main, "levels_run": levels,
              "peak_bytes": peak, "accuracy": acc, "card": smi, "build_s": _build.build_seconds,
              "lm": lm, "lm_small_checks": lm_small, "attention_wide_d": attention_wide,
              "hgmma": hgmma, "hist_shapes": hist_shapes, "split_scan_shapes": scan_shapes,
              "traverse_shapes": traverse_shapes, "reuse": reuse, "reuse_reduced": reuse_reduced,
              "streamed": streamed, "checkpoints": checkpoints, "regression": regression, "mesh": mesh,
              "timings": timings}
    out_dir = ROOT / "artifacts"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(result, indent=1))
    log("launch counts on the main path: " + json.dumps(counts))
    log("launch counts on the streamed path: " + json.dumps(streamed["launches"]))
    log("launch counts on the resumed growth (5c): " + json.dumps(checkpoints["resume_launches"]))
    log("launch counts on the regression path (5d): " + json.dumps(regression["launches"]))
    log("launch counts on the mesh (5e): " + json.dumps({k: v["launches"] for k, v in mesh.items()
                                                        if k.startswith("nccl")}))
    log(json.dumps({"kernels": rows}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="Smoke run of the PyTorch port on one CUDA card.")
    ap.add_argument("--traverse-ab", action="store_true",
                    help="only time the traversal at a 256-row batch under each tile plan (see traverse_batch_ab)")
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="with --traverse-ab: the src directory to import repro_torch from")
    args = ap.parse_args()
    sys.exit(traverse_batch_ab(args.src) if args.traverse_ab else main())

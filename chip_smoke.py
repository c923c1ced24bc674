"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --traverse-ab [--src OTHER_CHECKOUT/src]
    python3 chip_smoke.py --train-only
    python3 chip_smoke.py --mesh-only

The second form only times the traversal at a 256-row batch under each
tile plan (``traverse_batch_ab``); the third runs 1, 2 and 7 below and
prints no result line (its numbers go to ``artifacts/chip_smoke_train.json``);
the fourth runs 1, 2, 7c (no resume, no profiled step) and 8, no result
line (``artifacts/chip_smoke_mesh.json``).
The first:

1. the card (``nvidia-smi`` name and power limit) and the versions;
2. builds the CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc``
   per source, all started together, then one link), and checks with
   ``cuobjdump -sass`` that the bf16 attention kernels (the forward, and
   the backward's dK / dV + dQ kernel), the SSD kernel and the SSD
   backward's two tensor-core kernels run ``HGMMA`` (wgmma) instructions
   in every instantiation;
3. holds each kernel against its plain PyTorch version at small shapes:
   the three PRF kernels (the histogram and the split scan also at
   B 256, C 300, past their shared memory's class limits, in class
   tiles; the traversal bitwise over the twelve cases of
   ``tests/test_torch_traverse_cases.py``: N 1 to 70001, trees split over
   threads, ragged tiles and tree groups, C up to 37, a wide F, F 70000
   past 16 bits of feature id (the wide node layout), chunks through the
   carry),
   then attention (odd lengths, Lq < Lk, window,
   GQA, head dims 20 to 256, prefixes, unmasked with more queries than
   keys, f32 and bf16; then at the full shapes of phase 6's configs,
   ``LM_PATH_ATTENTION``: gemma3's hd 240 and 168 with window 1024 and
   none, deepseek-v3's dense hd 56 at 128 heads, hymba's 64-token meta
   prefix, whisper's unmasked encoder (1500 frames, a ragged key tile),
   its decoder's causal self-attention and unmasked cross-attention (440
   queries over 1500 frames), llama-vision's causal self-attention and
   unmasked cross-attention (2048 queries over 1024 vision tokens)) and
   the SSD scan (S in {64,
   200, 320, 384}, P in {32, 64}, N in {16, 32, 64, 128}, chunk 8, 64 or
   128, f32 and bf16; and hymba's [8, 2048, 50 heads, P 64, N 16]),
   the LM kernels at ``LM_TOL``, each dtype on its own kernel;
4. reduced end to end: the kernel path and the plain path give the same
   forest and labels, histogram reuse on gives reuse off's forest on
   both paths, growth with reuse on (where ``"auto"`` resolves on) and
   off timed in turns, and (f32, TF32 off) the same greedy LM tokens for
   smollm-135m, mamba2-780m, hymba-1.5b, whisper-large-v3 (2 encoder
   layers over 300 frames) and llama-3.2-vision-90b (2 cross layers over
   100 vision tokens, gates at ``LM_XGATE``) at cut widths;
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
   world bitwise, ``predict_sharded``, the OOB weights and the labels of
   ``serving.make_sharded_vote_fn`` (the trees split over ``"data"``, one
   host-staged ``all_reduce`` of the ``[N, C]`` partials) equal to the
   local ones, the histogram, the split scan and (in the vote) the
   traversal launched on every rank;
5f. the multi-process plane (``multiproc_phase``): a gloo world of 2
   processes on ``cuda:0`` (mesh (2, 1)), each calling ``train_prf`` (the
   dispatch to ``train_prf_multiproc``) on phase 5's 2^20 x 128 training
   rows written once to an ``np.memmap`` under ``build/``, phase 5's
   configuration streamed (``sample_block`` 131072), importance mode,
   weighted voting: both ranks' models bitwise equal; the edges the
   shard-ordered merge of the two shards' sketches made in this process;
   the forest a single-device streamed growth here on those edges with
   the same draws; accuracy >= 0.90; the histogram and the split scan
   launched on each rank; each rank fed half the binned bytes a sweep; a
   kill at level 4 under ``MultiprocCheckpointManager`` resumed bitwise;
   that directory restored in this one process raises
   ``CheckpointTopologyError``; per rank a staged replay's stage times
   (screen, sketch, binning, dimension reduction, growth, OOB), the
   launches, the host memory (resident set at entry, around each run and
   sampled every 2 ms, each stage's peak, the pinned allocator, the
   largest host-staged collective) against the file's bytes, and the
   world's time;
5g. serving (``serving_phase``) on phase 5's model through ``"auto"`` (the
   traversal kernel): ``PRFService(max_batch=1024, min_bucket=8)`` answers
   batches of 1-33, 255-257, 1000, 1024, 1025 and 4096 rows, labels
   bitwise equal to ``model.predict`` and to a ``backend="xla"`` service,
   one traversal launch per bucket-chunk (``launches_serving`` on the
   traversal row); buckets 8, 64, 256, 1024 timed (median host clock of
   200 calls, the card's busy share, binning and the forward pass apart,
   the traversal in it from the profiler, rows/s); 4 threads x 64
   requests of 1-32 rows,
   every future equal to ``model.predict`` of its rows; a
   ``ModelRegistry`` hot-swap to phase 5b's model under a concurrent
   submitter, every future resolved; ``train_rf`` and
   ``train_mlrf_like(sample_budget=2000)`` on phase 5's data, time and
   accuracy beside PRF's;
6. full size, LM serving: smollm-135m (30 layers, d 576) and mamba2-780m
   (48 layers, d 1536), and ``LM_CONFIGS``' eight more (hymba-1.5b,
   qwen1.5-4b, gemma3-12b and -27b at 12 layers, deepseek-moe-16b and
   deepseek-v3-671b at 4, whisper-large-v3 at full depth (32 encoder +
   32 decoder layers), llama-3.2-vision-90b at 10, each cut named there)
   at their published widths, bf16 compute, the config's params (f32; v3
   bf16) from seed 0, llama-vision's ``xgate`` set to ``LM_XGATE`` (its
   init of zeros would shut every cross-attention): batch 8, prompt 2048
   (whisper 440, to its 448-token decoder context), 32 greedy tokens
   (the eight: 8), frames and patch embeddings 0.1 x N(0, 1) from a
   seeded generator, through ``greedy_generate`` with launch counts read
   around that run; init seconds, prefill seconds, decode ms per token,
   tokens/s, peak memory, launches per route (every attention layer but
   MLA's, and every SSD layer, once a prefill on the bf16 tensor-core
   kernels; an encoder or cross layer once, a decoder layer twice); full-width
   kernel-path vs plain-path prefill in f32 (logits and every layer's
   cache; MoE: on the batch rows whose routing agrees on both paths, the
   share of agreeing tokens reported); the card's busy share under the
   profiler for prefill and one decode step; attention and the SSD scan
   held per element against their plain versions at the path's shapes
   (``LM_TOL``) and timed beside them, their bounds and (for attention)
   ``scaled_dot_product_attention``, attention also at head dims 128
   and 256 (same batch, heads and length) and at ``LM_PATH_ATTENTION``'s
   shapes, the SSD scan at hymba's;
7. LM training (``lm_train_phase``): (a) the attention backward kernels
   (``csrc/flash_attention_bwd.cu``) on the forward kernel's out and lse
   against ``attention_bwd_ref`` per element at ``LM_TOL``, f32 and bf16
   each on its route (bf16 on the tensor-core kernels at every head dim,
   f32 on the CUDA-core ones), two calls bitwise equal, the lse against
   ``gqa_attend_lse``: ``TRAIN_ATTENTION_SMALL`` (every mask kind, GQA,
   head dims 20 to 256, lengths off the tiles) and ``TRAIN_ATTENTION_FULL``
   (smollm's self-attention, whisper's encoder and cross-attention,
   gemma3-12b's and 27b's heads at one microbatch, window 1024 and causal);
   (b) at
   reduced widths in f32, ``loss_fn`` and every gradient leaf on the kernel
   path against the plain path for smollm-135m, gemma3-12b, qwen1.5-4b,
   deepseek-moe-16b, deepseek-v3-671b (MLA), whisper-large-v3 and
   llama-3.2-vision-90b, launches per route counted, MoE routing equal;
   (c) smollm-135m at published widths and depth, bf16 compute:
   ``TokenPipeline`` batches of 8 x 2048 in 2 microbatches, 10 steps of
   ``make_train_step`` with launch counts read around them (forward and
   backward per route, every backward on the tensor cores), the loss at
   each step, s/step, tokens/s and peak memory; a checkpoint at step 5
   restored and run to step 10 bitwise the uninterrupted run; one
   microbatch's loss and gradients in f32 on the kernel path against the
   plain path within 1e-2 of the scale; (d) the
   backward kernels at ``BWD_SHAPES`` (the training shape, the kernels
   line's ``flash_attention_bwd`` row, llama-vision's self-attention heads
   at hd 128, gemma3-27b's at hd 168 and gemma3-12b's at hd 240, causal and
   with a window of 1024) beside their plain version, their bound (10 D
   flops a visible pair) and SDPA's backward (under a window its explicit
   mask), the forward with and without its lse in turns at the training
   shape and at phase 6's prefill shape;
   (e) the SSD backward kernels (``csrc/ssd_scan_bwd.cu``) against
   ``ssd_chunked_bwd`` per element at ``LM_TOL``, f32 (the CUDA cores) and
   bf16 (the tensor cores) each counted on its route, two calls bitwise equal, at ``SSD_BWD_SMALL`` (L off the
   64-step chunk and below it, P 32 / 64, N 16 to 128) and ``SSD_BWD_FULL``
   (mamba2's and hymba's training microbatches), and ``SSDScanFn``'s
   backward against autograd of ``ssd_chunked``; (f) mamba2-780m and
   hymba-1.5b in (b)'s list, SSD launches counted per route; (g)
   mamba2-780m at published widths and full depth (48 layers), (c)'s
   recipe: 10 steps, 960 SSD backward calls and 1920 forward launches (remat
   recomputes each layer), all bf16 on the kernels (every backward call on
   the tensor cores), resume from step 5
   bitwise, f32 kernel vs plain within 1e-2, s/step, tokens/s, peak and a
   profiled step; (h) hymba-1.5b at published widths and
   ``HYMBA_TRAIN_DEPTH`` layers, ``HYMBA_TRAIN_STEPS`` steps, attention
   (window 1024, prefix 64) and the SSD scan forward and backward all on
   kernels, counted, f32 kernel vs plain within 1e-2; then the SSD
   backward at both training shapes beside its plain version and its bound
   (``ssd_bwd_work``; mamba2's is the kernels line's ``ssd_scan_bwd`` row);
   (i) gemma3-12b at published widths and ``GEMMA_TRAIN_DEPTH["gemma3-12b"]``
   layers (one period of its pattern: five local layers, window 1024, and
   one global; hd 240), ``GEMMA_TRAIN_STEPS`` steps of 8 x 2048 in
   ``GEMMA_TRAIN_MICRO`` microbatches, every attention backward on the
   tensor cores, a profiled step; (j) gemma3-27b the same way at 2 layers
   (local, hd 168), no profile;
8. the LM mesh glue (``lm_mesh_phase``): (a) the attention forward (with
   its lse) and backward kernels at a query offset, one shard of
   smollm-135m's training microbatch on a 16-wide ``model`` axis
   (``MESH_Q``: q [4, 128, 9, 64] at offsets 0, 896 and 1920 over k / v
   [4, 2048, 3, 64]; then hymba's mask, window 1024 and a 64-key prefix,
   over [4, 2112, 3, 64]), bf16 and f32, against ``gqa_attend_lse`` and
   ``attention_bwd_ref`` with that ``MaskSpec`` offset per element at
   ``LM_TOL``, two calls bitwise equal, one shard timed beside its bound
   and beside SDPA's forward and backward under the offset's explicit mask;
   (b) ``make_sharded_train_step`` in an NCCL world of one
   (``make_mesh((1, 1))``) on 7c's smollm-135m, 3 steps from
   ``make_train_step``'s initial state: losses and every gathered leaf
   within 1e-2 of ``make_train_step``'s (bitwise reported), the attention
   kernels launched as often a step as in 7c, s/step and peak beside 7c's;
   (c) the dry run (``launch/dryrun.py``) of every LM cell (the ten
   configs' ``train_4k``, ``prefill_32k``, ``decode_32k`` and ``long_500k``
   cells) but ``DRYRUN_LEFT_OUT``'s seven on the 16 x 16 mesh and
   ``DRYRUN_MULTI``'s eight ``train_4k`` cells on 2 x 16 x 16, each a
   process of its own (no card)
   started after the build and run beside phases 3-7 (``DryRunPool``, half
   the host's cores), every cell ``OK`` (``long_500k`` of a config that is
   not sub-quadratic ``SKIP(full-attn)``), its per-device FLOPs, bytes,
   collectives, peak memory, ``fits_hbm`` and roofline terms logged, the
   JSON under ``artifacts/dryrun_torch``; (d) ``serving.make_serve_fns`` in
   an NCCL world of one (``make_mesh((1, 1))``, ``MESH_SERVE``), bf16,
   batch 8, prompt 2048: smollm-135m at full width and depth, 32 tokens,
   ``flash_decode`` off and on; deepseek-moe-16b at phase 6's cut
   (``ep_mode="shard_map"``, 8 tokens); hymba-1.5b (8 tokens): greedy tokens
   identical to ``greedy_generate`` on the same weights in this run (and to
   phase 6's), every step's logits bitwise the one-device run's (over one
   length shard the LSE combine is the plain softmax bit for bit),
   attention and SSD launches a prefill as phase 6 counts them, 2
   ``all_to_all`` calls a MoE layer a step, prefill s, decode ms/token and
   peak memory beside the one-device run's; (e) the dry run's PRF cell on
   both meshes on the card in a process of its own (rank 0's shard of seeded
   bins, 2^18 / 2^17 rows x 256 features, 64 trees to depth 12, through
   ``ReplicaMesh``): ``OK``, 12 levels, its collectives, bytes, peak and
   kernel launches logged;
9. the launch counts and one JSON line per the smoke contract, then
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
import contextlib
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
LM_XGATE = 1.0     # llama-vision's cross-attention gates (tanh 0.76); the config's init of zeros shuts them


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


def device_ms(fn, match, reps=10, warmup=2, sessions=3, per_call=1):
    """Mean device milliseconds per call of the kernels whose name holds
    ``match`` (``per_call`` launches a call), from the profiler's trace of
    ``reps`` calls: the kernels' own time, without the wrapper's host work
    and small copies. The profiler
    keeps only device activity that falls inside its window on the host's
    clock, so the window opens ``TRACE_MARGIN_S`` before the first call
    and closes as long after the last one has finished. A trace that holds
    other than ``reps * per_call`` launches is discarded and taken again, at most
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
        if n == reps * per_call:
            return sum(e.self_device_time_total for e in mine) / reps / 1e3, taken, held
        every = sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA)
        log(f"the profiler's trace holds {n} launches of {match}, want {reps * per_call}: trace discarded "
            f"(per kernel: {[(e.key[:90], e.count) for e in mine]}; device records of any kernel: {every})")
    return None, sessions, held


def timed(what, fn, match, record, reps=10, per_call=1):
    """The rows' times: ``ms``, CUDA events around ``reps`` whole calls
    (the wrapper's host work included), and ``kernel_ms``, the kernel's
    own device time from the profiler over as many launches
    (``launches_traced``), or None ("not measured", ``launches_traced``
    0) when no trace held them all. Both go to ``record[what]`` and the log."""
    ms = cuda_ms(fn, reps=reps)
    kern, sessions, held = device_ms(fn, match, reps=reps, per_call=per_call)
    t = {"ms": ms, "kernel_ms": kern, "launches_traced": reps * per_call if kern is not None else 0,
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
    measure of the CPU parity tests (0 where both are all zeros)."""
    want = want.double()
    d = float((got.double() - want).abs().max())
    return d / float(want.abs().max()) if d else 0.0


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


# Attention at the shapes phase 6's configs give the kernel: (B, H, KV, Lq,
# Lk, D, causal, window, prefix), ends aligned.
LM_PATH_ATTENTION = {
    "gemma3-12b local (hd 240)": (8, 16, 8, 2048, 2048, 240, True, 1024, 0),
    "gemma3-12b global (hd 240)": (8, 16, 8, 2048, 2048, 240, True, 0, 0),
    "gemma3-27b local (hd 168)": (8, 32, 16, 2048, 2048, 168, True, 1024, 0),
    "gemma3-27b global (hd 168)": (8, 32, 16, 2048, 2048, 168, True, 0, 0),
    "deepseek-v3 dense (hd 56)": (8, 128, 128, 2048, 2048, 56, True, 0, 0),
    "hymba meta prefix (hd 64)": (8, 25, 5, 2048, 2112, 64, True, 1024, 64),
    "whisper encoder (unmasked)": (8, 20, 20, 1500, 1500, 64, False, 0, 0),
    "whisper cross-attention (unmasked)": (8, 20, 20, 440, 1500, 64, False, 0, 0),
    "whisper decoder self-attention": (8, 20, 20, 440, 440, 64, True, 0, 0),
    "llama-vision cross-attention (unmasked)": (8, 64, 8, 2048, 1024, 128, False, 0, 0),
    "llama-vision self-attention": (8, 64, 8, 2048, 2048, 128, True, 0, 0),
}
LM_PATH_SSD = {"hymba (P 64, N 16, 50 heads)": (8, 2048, 50, 64, 16)}   # (B, L, H, P, N)


def lm_kernel_checks(dev):
    """Attention and the SSD scan against their plain versions at LM_TOL
    (the f32 state h at f32's tolerance in both dtypes): small shapes, then
    the shapes of phase 6's new configs at full size."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import MaskSpec, gqa_attend
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked
    from repro_torch.models.layers import _auto_q_chunk

    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    worst = {}
    attention_cases = [
        (2, 9, 3, 200, 200, 64, True, 0, 0), (1, 4, 2, 77, 301, 64, True, 0, 0),
        (1, 4, 4, 257, 257, 32, True, 100, 0), (1, 2, 1, 130, 250, 128, False, 0, 0),
        (1, 2, 2, 65, 190, 256, True, 33, 0),
        # head dims off the swizzle spans (20: padded to 24 by the wrapper), prefixes of
        # one tile, of two tiles with a window, and past the causal edge of the first queries
        (1, 4, 2, 77, 141, 24, True, 0, 5), (1, 3, 1, 70, 200, 20, True, 50, 100),
        (2, 2, 2, 130, 130, 40, True, 0, 70), (1, 4, 2, 100, 164, 168, True, 30, 64),
        # unmasked with more queries than keys (cross-attention), GQA 8:1 at hd 128 with
        # Lq = 2 Lk, and an encoder's Lq = Lk with a ragged key tile
        (1, 4, 2, 300, 77, 64, False, 0, 0), (2, 16, 2, 256, 128, 128, False, 0, 0),
        (2, 4, 4, 150, 150, 64, False, 0, 0),
    ] + list(LM_PATH_ATTENTION.values())
    for B, H, KV, Lq, Lk, D, causal, window, prefix in attention_cases:
        for dtype in (torch.float32, torch.bfloat16):
            q = _randn(gen, (B, Lq, H, D), dev, dtype)
            k = _randn(gen, (B, Lk, KV, D), dev, dtype)
            v = _randn(gen, (B, Lk, KV, D), dev, dtype)
            n_bf16 = flash_ops.launches_bf16
            got = flash_ops.flash_attention(q, k, v, causal=causal, window=window, prefix=prefix)
            want = gqa_attend(q, k, v, mask_spec=MaskSpec(causal, window, Lk - Lq, prefix),
                              q_chunk=_auto_q_chunk(Lq, Lk, B * H))
            _, share = lm_close(got, want, dtype, f"attention at {(B, H, KV, Lq, Lk, D, causal, window, prefix, dtype)}")
            check(flash_ops.launches_bf16 == n_bf16 + (dtype == torch.bfloat16),
                  f"attention in {dtype} went to the wrong kernel")
            worst[f"attention {dtype}"] = max(worst.get(f"attention {dtype}", 0.0), share)
            del q, k, v, got, want
    for B, S, H, P, N, chunk in ((2, 64, 3, 64, 16, 128), (1, 384, 2, 64, 128, 128), (2, 384, 4, 32, 16, 128),
                                 (1, 64, 2, 64, 128, 128), (2, 320, 3, 32, 64, 64), (1, 200, 2, 64, 32, 8),
                                 *((B, S, H, P, N, 128) for B, S, H, P, N in LM_PATH_SSD.values())):
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


def lm_extras(cfg, B, dev, gen):
    """The stub frontends' output for ``cfg`` (``Model.prefill``'s ``extras``):
    frames or patch embeddings, 0.1 x N(0, 1) in f32; None for the other families."""
    stub = {"vlm": ("vision_embeds", cfg.vision_tokens), "encdec": ("frames", cfg.encoder_frames)}
    if cfg.family not in stub:
        return None
    key, n = stub[cfg.family]
    return {key: _randn(gen, (B, n, cfg.d_model), dev, scale=0.1)}


def open_gates(model):
    """Sets every ``xgate`` (llama-vision's cross layers) to LM_XGATE; returns how many."""
    gates = [p["xgate"] for p in model.layers if "xgate" in p]
    with torch.no_grad():
        for g in gates:
            g.fill_(LM_XGATE)
    return len(gates)


def attention_launches(kinds, use_mla=False):
    """Attention kernel launches of one prefill: once an attention, encoder
    or cross layer (MoE without MLA too), twice a decoder layer."""
    once = ("dense", "local", "global", "hybrid", "enc", "cross") + (() if use_mla else ("moe",))
    return sum(2 if k == "dec" else k in once for k in kinds)


def lm_reduced_end_to_end(dev):
    """Cut widths, f32, TF32 off: kernel and plain paths give the same greedy tokens."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import _layer_kinds
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.models import build_model
    from repro_torch.serving.serve_step import greedy_generate

    archs = ("smollm-135m", "mamba2-780m", "hymba-1.5b", "whisper-large-v3", "llama-3.2-vision-90b")
    for arch in archs:
        cfg = dataclasses.replace(get_config(arch), n_layers=4, d_model=256, n_heads=4, n_kv_heads=2,
                                  d_ff=0 if arch == "mamba2-780m" else 512, vocab_size=4096,
                                  head_dim=64, compute_dtype="float32",
                                  local_window=100 if arch == "hymba-1.5b" else 0,
                                  encoder_layers=2 if arch == "whisper-large-v3" else 0, encoder_frames=300,
                                  vision_tokens=100 if arch == "llama-3.2-vision-90b" else 0,
                                  cross_attn_every=2 if arch == "llama-3.2-vision-90b" else 0)
        kinds = _layer_kinds(cfg)
        want = attention_launches(kinds) + sum(k in ("ssm", "hybrid") for k in kinds)
        gen = torch.Generator(device=dev)
        gen.manual_seed(4)
        toks = torch.randint(0, cfg.vocab_size, (4, 256), generator=gen, device=dev)
        extras = lm_extras(cfg, 4, dev, gen)
        kern, plain = (build_model(cfg, dev, use_kernels=u, seed=1) for u in (True, False))
        for model in (kern, plain):
            open_gates(model)
        n0 = flash_ops.launches + ssd_ops.launches
        a = greedy_generate(kern, toks, extras, steps=8, s_max=264)
        check(flash_ops.launches + ssd_ops.launches == n0 + want, f"{arch}: kernels not launched {want} times")
        b = greedy_generate(plain, toks, extras, steps=8, s_max=264)
        check(torch.equal(a, b), f"reduced LM end to end ({arch}): tokens differ between kernel and plain paths")
        del kern, plain
    log("reduced LM end to end (4 layers, d 256, f32, batch 4, prompt 256, 8 tokens): greedy tokens "
        f"identical on the kernel and plain paths for {', '.join(archs)} (hymba: 64 meta tokens, window 100; "
        f"whisper: 2 encoder layers over 300 frames; llama-vision: 2 cross layers over 100 vision tokens, "
        f"xgate {LM_XGATE})")


# Phase 6's configurations: (arch, layers run or None for all, tokens generated,
# the reason for a cut, prompt length). Widths are the published ones; weights
# random from seed 0.
LM_CONFIGS = (
    ("smollm-135m", None, LM_GEN, "", LM_PROMPT),
    ("mamba2-780m", None, LM_GEN, "", LM_PROMPT),
    ("hymba-1.5b", None, 8, "", LM_PROMPT),
    ("qwen1.5-4b", None, 8, "", LM_PROMPT),
    ("gemma3-12b", 12, 8, "2 cycles of 5 local + 1 global of 8: chip time (48 layers in f32 are ~46 GB)", LM_PROMPT),
    ("gemma3-27b", 12, 8, "2 cycles of 5 local + 1 global of ~10: 62 layers in f32 are ~108 GB", LM_PROMPT),
    ("deepseek-moe-16b", 4, 8, "1 dense + 3 moe of 28 layers: 28 in f32 are ~66 GB", LM_PROMPT),
    ("deepseek-v3-671b", 4, 8, "its 3 dense (GQA, hd 56) + 1 moe layer with MLA of 61: one card", LM_PROMPT),
    # 440 + 8 tokens: the 448 positions of whisper's decoder context (arXiv:2212.04356)
    ("whisper-large-v3", None, 8, "", 440),
    ("llama-3.2-vision-90b", 10, 8, "2 cycles of 4 dense + 1 cross of 20: 100 layers in f32 are ~327 GiB",
     LM_PROMPT),
)


@contextlib.contextmanager
def routing_recorded():
    """The experts each MoE layer picks ([T, K] per call of ``moe._route``), in call order."""
    from repro_torch.models import moe

    calls, route = [], moe._route

    def recorded(p, x2d, cfg):
        out = route(p, x2d, cfg)
        calls.append(out[0].sort(-1).values)
        return out

    moe._route = recorded
    try:
        yield calls
    finally:
        moe._route = route


def _leaves(tree, path=""):
    """(dotted name, tensor) of a nested dict's leaves."""
    for n, t in tree.items():
        yield from _leaves(t, f"{path}{n}.") if isinstance(t, dict) else [(path + n, t)]


def lm_full(dev, arch, depth=None, T=LM_GEN, cut="", L=LM_PROMPT):
    """One published-width LM through ``greedy_generate``: counts, times, checks."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import _layer_kinds
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.models import build_model
    from repro_torch.serving.serve_step import greedy_generate

    cfg = get_config(arch)
    if depth:
        cfg = dataclasses.replace(cfg, n_layers=depth)
    kinds = _layer_kinds(cfg)
    want = {"flash_attention": attention_launches(kinds, cfg.use_mla),
            "ssd_scan": sum(k in ("ssm", "hybrid") for k in kinds)}
    B = LM_BATCH
    s_max = L + T
    torch.cuda.reset_peak_memory_stats()
    model, t_init = sync_time(lambda: build_model(cfg, dev, seed=0))
    peak_init = torch.cuda.max_memory_allocated()
    gates = open_gates(model)
    if gates:
        log(f"{arch}: the {gates} cross layers' xgate set to {LM_XGATE} (tanh {np.tanh(LM_XGATE):.4f}): the "
            "config's init of zeros would multiply every cross-attention by 0")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (B, L), generator=gen, device=dev)
    extras = lm_extras(cfg, B, dev, gen)
    greedy_generate(model, prompts[:, :128], extras, steps=2, s_max=130)      # warm-up: first-call costs

    flash_ops.launches = flash_ops.launches_bf16 = flash_ops.launches_f32 = 0
    ssd_ops.launches = ssd_ops.launches_bf16 = ssd_ops.launches_f32 = 0
    torch.cuda.reset_peak_memory_stats()
    toks, t_gen = sync_time(lambda: greedy_generate(model, prompts, extras, steps=T, s_max=s_max))
    counts = {"flash_attention": flash_ops.launches, "ssd_scan": ssd_ops.launches}
    routes = {name: {"bf16_tensor_core": ops.launches_bf16, "f32_cuda_core": ops.launches_f32}
              for name, ops in (("flash_attention", flash_ops), ("ssd_scan", ssd_ops))}
    log(f"{arch}: launches per route on the main path {routes}")
    for name, n in want.items():
        check(routes[name] == {"bf16_tensor_core": n, "f32_cuda_core": 0} and counts[name] == n,
              f"{arch}: {name} launches per route {routes[name]}, want all {n} on bf16 tensor cores")
    peak = torch.cuda.max_memory_allocated()
    check(toks.shape == (B, T) and bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
          f"{arch}: generated tokens out of range")

    # the same run in two timed parts: prefill, then the decode steps
    (logits, cache), t_pre = sync_time(lambda: model.prefill(prompts, extras, s_max=s_max))
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
    busy = {"prefill": device_busy_share(lambda: model.prefill(prompts, extras, s_max=s_max)),
            "decode_step": device_busy_share(lambda: model.decode_step(cache, out[-1], L + T - 1))}
    del cache

    # Full width, kernel path vs plain path in f32 compute (TF32 off): the
    # last token's logits and every layer's cache, which each layer
    # computes from all rows of the layer below. The kernels' own outputs
    # at these shapes are held per element in phase 3 and lm_kernel_rows.
    # In bf16 one-ulp differences grow through the depth of a random-weight
    # model, so the bf16 numbers are only reported. MoE: a near-tie can
    # send a token to other experts on the two paths, and attention then
    # carries that into every later token of its row; so the rule holds the
    # batch rows in which every token's routing agrees in every MoE layer
    # (at least one row), and reports the share of tokens that agree.
    model.use_kernels = False
    (lp, _), t_plain = sync_time(lambda: model.prefill(prompts, extras, s_max=s_max))
    model.compute_dtype = torch.float32
    with routing_recorded() as route_p:
        lp32, cp32 = model.prefill(prompts, extras, s_max=s_max)
    model.use_kernels = True
    with routing_recorded() as route_k:
        lk32, ck32 = model.prefill(prompts, extras, s_max=s_max)
    model.compute_dtype = torch.bfloat16
    rows = torch.ones(B, dtype=torch.bool, device=dev)
    agree_share = None
    if route_p:
        same = torch.stack([(a == b).all(-1) for a, b in zip(route_p, route_k)]).all(0).view(B, L)
        agree_share = float(same.float().mean())
        rows = same.all(1)
        check(bool(rows.any()), f"{arch}: no batch row whose routing agrees on the kernel and plain paths")
    drift32 = {"logits": drift(lk32[rows], lp32[rows])}

    for ck, cp in zip(ck32, cp32):
        for (n, a), (_, b) in zip(_leaves(ck), _leaves(cp)):   # every leaf is [B, ...]
            drift32[n] = max(drift32.get(n, 0.0), drift(a[rows], b[rows]))
    err32 = max(drift32.values())
    check(err32 <= 1e-2, f"{arch}: full-width f32 kernel vs plain prefill drift {drift32}")
    del cp32, ck32
    err = drift(logits, lp)
    noise = drift(lp, lp32)
    agree = float((logits.argmax(-1) == lp.argmax(-1)).float().mean())
    res = {"arch": arch, "layers": cfg.n_layers, "encoder_layers": cfg.encoder_layers, "cut": cut, "tokens": T,
           "prompt": L, "xgate": LM_XGATE if gates else None,
           "params": sum(p.numel() for p in model.parameters()),
           "param_bytes": sum(p.numel() * p.element_size() for p in model.parameters()), "init_s": t_init,
           "init_peak_bytes": peak_init, "generate_s": t_gen, "prefill_s": t_pre, "plain_prefill_s": t_plain,
           "decode_ms_per_token": t_dec / (T - 1) * 1e3, "tokens_per_s": B * T / t_gen,
           "peak_bytes": peak, "launches": counts, "routes": routes,
           "kernel_vs_plain_f32": drift32, "routing_agree_share_f32": agree_share,
           "rows_held_f32": int(rows.sum()),
           "kernel_vs_plain_logits_bf16": err, "bf16_vs_f32_plain_logits": noise,
           "kernel_vs_plain_top1_agree_bf16": agree, "device_busy_share": busy, "tokens": toks.tolist()}
    log(f"{arch} ({cfg.n_layers} layers{f' + {cfg.encoder_layers} encoder' if cfg.encoder_layers else ''}"
        f"{', cut: ' + cut if cut else ''}; {res['params']} params, "
        f"{res['param_bytes'] / 2**30:.2f} GiB; batch {B}, prompt {L}, {T} tokens, bf16): init {t_init:.3f} s, "
        f"generate {t_gen:.3f} s ({res['tokens_per_s']:.1f} tok/s), prefill {t_pre:.3f} s (plain path "
        f"{t_plain:.3f} s), decode {res['decode_ms_per_token']:.2f} ms/token, peak {peak / 2**30:.2f} GiB "
        f"(init {peak_init / 2**30:.2f}), launches {counts}; prefill kernel vs plain, max |d| / max |plain|: f32 "
        + ", ".join(f"{k} {v:.3g}" for k, v in drift32.items())
        + (f" (routing agrees on {agree_share:.6f} of tokens, {int(rows.sum())} of {B} rows held)"
           if agree_share is not None else "")
        + f"; bf16 logits {err:.3g} (top-1 agree {agree:.3f}; bf16 vs f32 on the plain path {noise:.3g}); "
        f"device busy share under the profiler {busy}")
    del model, logits, lp, lp32, lk32, extras
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
    path = lm_path_shape_rows(dev, gen, timings)

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
    kernel_row("ssd_scan", "src/repro_torch/csrc/ssd_scan.cu", "src/repro/kernels/ssd_scan/kernel.py:69",
               counts["ssd_scan"], max(err, err_h), t, p_ms, *ssd_work(B, L, Hs, P, N), None, BF16_OPS_PER_S)
    return {"wide_d": wide, "path_shapes": path}


def visible_pairs(Lq, Lk, window, prefix, causal=True, offset=None):
    """(query, key) pairs the mask admits, query i at key position i +
    ``offset`` (default Lk - Lq, ends aligned): all Lq x Lk unmasked, else
    the causal mask with ``window`` and ``prefix``."""
    if not causal:
        return Lq * Lk
    qpos = np.arange(Lq, dtype=np.int64) + (Lk - Lq if offset is None else offset)
    prefix = min(prefix, Lk)
    lo = np.maximum(0, qpos - window + 1) if window > 0 else np.zeros_like(qpos)
    # [lo, qpos] and the prefix keys outside it
    n = qpos - lo + 1 + np.minimum(prefix, lo) + np.maximum(0, prefix - qpos - 1)
    return int(n.sum())


def ssd_work(B, L, H, P, N, Q=128):
    """(bytes, operations) of the chunked SSD scan on bf16 x, b, c, f32 log a and state."""
    tri = Q * (Q + 1) // 2
    per_chunk = 2 * tri * N + 2 * tri * P + 4 * Q * N * P
    return (2 * B * L * H * P * 2 + B * L * H * 4 + 2 * B * L * N * 2 + B * H * N * P * 4,
            B * H * (L // Q) * per_chunk)


def lm_path_shape_rows(dev, gen, timings):
    """Attention and the SSD scan at the shapes of phase 6's configs
    (``LM_PATH_ATTENTION``, ``LM_PATH_SSD``), bf16: the call, the kernel
    alone, the plain version, the bound, and SDPA where one call takes the
    shape (unmasked: no mask, ``is_causal=False``; causal without a window:
    ``is_causal``; a window or a prefix: its boolean mask; the KV heads
    repeated)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import MaskSpec, gqa_attend
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked
    from repro_torch.models.layers import _auto_q_chunk

    out = {}
    for what, (B, H, KV, Lq, Lk, D, C, W, P) in LM_PATH_ATTENTION.items():
        q = _randn(gen, (B, Lq, H, D), dev, torch.bfloat16)
        k = _randn(gen, (B, Lk, KV, D), dev, torch.bfloat16)
        v = _randn(gen, (B, Lk, KV, D), dev, torch.bfloat16)
        call = lambda: flash_ops.flash_attention(q, k, v, causal=C, window=W, prefix=P)
        spec = MaskSpec(C, W, Lk - Lq, P)
        plain = lambda: gqa_attend(q, k, v, mask_spec=spec, q_chunk=_auto_q_chunk(Lq, Lk, B * H))
        err, share = lm_close(call(), plain(), torch.bfloat16, f"attention at {what}")
        t = timed(f"attention, {what}", call, "flash_tc_kernel", timings)
        p_ms = cuda_ms(plain, reps=2, warmup=1)
        qt = q.transpose(1, 2)
        kt, vt = (a.repeat_interleave(H // KV, dim=2).transpose(1, 2) for a in (k, v))
        if not C and W == 0 and P == 0:
            sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=False)
        elif W == 0 and P == 0 and Lq == Lk:
            sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        else:
            mask = spec.block(0, Lq, Lk, dev)[None]
            sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
        lib_err = float((sdpa().transpose(1, 2).double() - call().double()).abs().max())
        lib_ms = cuda_ms(sdpa, reps=3, warmup=1)
        pairs = visible_pairs(Lq, Lk, W, P, C)
        nbytes, nops = 2 * (2 * B * Lq * H * D + 2 * B * Lk * KV * D), 4 * D * B * H * pairs
        bound = max(nbytes / HBM_BYTES_PER_S, nops / BF16_OPS_PER_S) * 1e3
        out[what] = {**t, "plain_ms": p_ms, "sdpa_ms": lib_ms, "sdpa_vs_kernel_max_abs": lib_err,
                     "bound_ms": bound, "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S > nops / BF16_OPS_PER_S
                     else "operations", "max_abs_err": err, "allowance_share": share, "shape": [B, H, KV, Lq, Lk, D],
                     "causal": C, "window": W, "prefix": P}
        log(f"attention, {what} [{B}, {H} H / {KV} KV, {Lq}, {Lk}, {D}], {'causal' if C else 'unmasked'}, "
            f"window {W}, prefix {P}, bf16: call "
            f"{t['ms']:.4f} ms (kernel alone {fmt_ms(t['kernel_ms'])}), plain {p_ms:.4f} ms, SDPA {lib_ms:.4f} ms "
            f"(max |d| vs the kernel {lib_err:.3g}), bound {bound:.4f} ms ({pairs} visible pairs a head), share "
            f"{bound / t['ms']:.3f}; max |d| vs plain {err:.3g} ({share:.3g} of the allowance)")
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    for what, (B, L, H, P, N) in LM_PATH_SSD.items():
        x, loga, b, c = _ssd_inputs(gen, B, L, H, P, N, dev, torch.bfloat16)
        y, h = ssd_ops.ssd_scan(x, loga, b, c)
        yp, hp = ssd_chunked(x, loga, b, c, None, 128)
        (err, share), (err_h, share_h) = (lm_close(y, yp, torch.bfloat16, f"ssd at {what}"),
                                          lm_close(h, hp, torch.float32, f"ssd h at {what}"))
        t = timed(f"ssd scan, {what}", lambda: ssd_ops.ssd_scan(x, loga, b, c), "ssd_tc_kernel", timings)
        p_ms = cuda_ms(lambda: ssd_chunked(x, loga, b, c, None, 128), reps=2, warmup=1)
        nbytes, nops = ssd_work(B, L, H, P, N)
        bound = max(nbytes / HBM_BYTES_PER_S, nops / BF16_OPS_PER_S) * 1e3
        out[what] = {**t, "plain_ms": p_ms, "bound_ms": bound, "max_abs_err": max(err, err_h),
                     "allowance_share": max(share, share_h), "shape": [B, L, H, P, N]}
        log(f"ssd scan, {what} [{B}, {L}, {H} heads, P {P}, N {N}] bf16: call {t['ms']:.4f} ms (kernel alone "
            f"{fmt_ms(t['kernel_ms'])}), plain {p_ms:.4f} ms, bound {bound:.4f} ms, share {bound / t['ms']:.3f}; "
            f"max |d| vs plain y {err:.3g} ({share:.3g}), h {err_h:.3g} ({share_h:.3g})")
        del x, loga, b, c, y, h, yp, hp
    return out


# Phase 7: LM training. The attention backward against its plain version at
# (B, H, KV, Lq, Lk, D, causal, window, prefix), ends aligned: small shapes
# (every mask kind, GQA, head dims 24 to 256, lengths off the 64-row tiles),
# then the full shapes of the training path and of whisper's attentions.
TRAIN_ATTENTION_SMALL = [
    (2, 9, 3, 200, 200, 64, True, 0, 0), (1, 4, 2, 77, 301, 32, True, 0, 0),
    (1, 4, 4, 257, 257, 56, True, 100, 0), (1, 4, 2, 100, 164, 168, True, 30, 64),
    (2, 2, 2, 130, 130, 128, True, 0, 70), (1, 4, 2, 300, 77, 64, False, 0, 0),
    (1, 2, 1, 130, 250, 240, False, 0, 0), (1, 2, 2, 65, 190, 256, True, 33, 0),
    (2, 16, 2, 150, 150, 24, False, 0, 0), (1, 3, 1, 70, 200, 20, True, 50, 100),
]
TRAIN_ATTENTION_FULL = {
    "smollm-135m self-attention": (8, 9, 3, 2048, 2048, 64, True, 0, 0),
    "whisper encoder (unmasked)": LM_PATH_ATTENTION["whisper encoder (unmasked)"],
    "whisper cross-attention (unmasked)": LM_PATH_ATTENTION["whisper cross-attention (unmasked)"],
    "gemma3-12b local (window 1024)": (4, 16, 8, 2048, 2048, 240, True, 1024, 0),
    "gemma3-12b global": (4, 16, 8, 2048, 2048, 240, True, 0, 0),
    "gemma3-27b local (window 1024)": (4, 32, 16, 2048, 2048, 168, True, 1024, 0),
    "gemma3-27b global": (4, 32, 16, 2048, 2048, 168, True, 0, 0),
}
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO, TRAIN_STEPS, TRAIN_RESUME_AT = 8, 2048, 2, 10, 5


BWD_COUNTERS = ("launches_bwd", "launches_bwd_bf16", "launches_bwd_tc", "launches_bwd_f32")
SSD_COUNTERS = ("launches", "launches_bf16", "launches_f32", "launches_bwd", "launches_bwd_bf16", "launches_bwd_tc",
                "launches_bwd_f32")
# Phase 7e: the SSD backward against its plain version at (B, L, H, P, N):
# small shapes (L off the 64-step chunk, L < chunk, P 32 / 64, N 16 to 128,
# several B x H), then the training microbatches of phases 7g and 7h.
SSD_BWD_SMALL = [(2, 64, 3, 64, 16), (1, 200, 2, 64, 128), (2, 40, 4, 32, 32), (1, 384, 5, 32, 64),
                 (3, 130, 7, 64, 128), (2, 256, 50, 64, 16)]
SSD_BWD_FULL = {"mamba2-780m training microbatch": (TRAIN_BATCH // TRAIN_MICRO, TRAIN_SEQ, 48, 64, 128),
                "hymba-1.5b training microbatch": (TRAIN_BATCH // TRAIN_MICRO, TRAIN_SEQ, 50, 64, 16)}
HYMBA_TRAIN_DEPTH, HYMBA_TRAIN_STEPS = 8, 4     # phase 7h: 8 of hymba-1.5b's 32 layers, 4 steps
# phases 7i, 7j: gemma3-12b at one period of its pattern (6 of 48 layers),
# gemma3-27b at 2 of 62 (both local), 4 steps each, the batch of 8 x 2048 in
# 4 microbatches: in 2, one microbatch's f32 log-sum-exp over the 262,144-word
# vocabulary ([4, 2048, 262144], 8 GiB a temporary) ran out of the card's
# memory beside the 2.3 B parameters' model, state and accumulators. Peak lr
# 1e-4 after 100 warmup steps (the 4 steps run at 1e-6 to 4e-6): AdamW's first
# steps move each weight by about lr, a product's output by about lr x d_in, and
# after 2 warmup steps gemma3-12b's d 3840 diverged at 1e-3 and 1e-4 on the
# kernel path and the plain path alike (1e-4: losses 13.10, 19.98, 13.79, 18.24)
GEMMA_TRAIN_DEPTH, GEMMA_TRAIN_STEPS, GEMMA_TRAIN_MICRO, GEMMA_TRAIN_LR, GEMMA_TRAIN_WARMUP = (
    {"gemma3-12b": 6, "gemma3-27b": 2}, 4, 4, 1e-4, 100)


def ssd_bwd_work(B, L, H, P, N, Q=64, elem=2):
    """(bytes, operations) of the SSD backward in Q-step chunks: x, dy, dx, b,
    c, db, dc of ``elem`` bytes and log a, d log a in f32, each once. Over
    the causal triangle, once a (batch, chunk): the products over N, c b^T
    and (sum_h dS) b, (sum_h dS)^T c (S is shared over the heads, and db's
    and dc's pair terms are linear in dS); once a head: dy x^T and dx (over
    P), and the six Q N P products (the state's recompute, c H_g, b dH, dH x,
    H dy and the dH update)."""
    tri = Q * (Q + 1) // 2
    per_head = 4 * tri * P + 12 * Q * N * P
    return (3 * B * L * H * P * elem + 4 * B * L * N * elem + 2 * B * L * H * 4,
            B * -(-L // Q) * (6 * tri * N + H * per_head))


def worst_element(outs, wants, exacts):
    """Of the outputs ``outs`` (dx, d log a, db, dc) against the plain
    version's ``wants`` at LM_TOL of their dtypes, the element that uses
    the largest share of its allowance: its output, flat index, share, the
    kernel's, the plain version's and the exact value (``exacts``, f64), and
    the distances kernel - plain, kernel - exact and plain - exact in ulps of
    the output's dtype at the plain value's binade."""
    import math

    best = None
    for name, g, w, e in zip(("dx", "dloga", "db", "dc"), outs, wants, exacts):
        rtol, atol = LM_TOL[g.dtype]
        eps = torch.finfo(g.dtype).eps
        g, w = g.double().flatten(), w.double().flatten()
        d = (g - w).abs()
        share = torch.where(d == 0, 0.0, d / (rtol * w.abs() + atol * rms(w)))
        k = int(share.argmax())
        if best is None or float(share[k]) > best["share"]:
            gk, wk, ek = float(g[k]), float(w[k]), float(e.flatten()[k])
            ulp = eps * 2.0 ** math.floor(math.log2(abs(wk) or abs(ek) or 1.0))
            best = {"output": name, "index": k, "share": float(share[k]), "kernel": gk, "plain": wk, "exact": ek,
                    "ulps_kernel_plain": (gk - wk) / ulp, "ulps_kernel_exact": (gk - ek) / ulp,
                    "ulps_plain_exact": (wk - ek) / ulp}
    return best


def ssd_route_counts(ssd_ops):
    """(backward calls, of which bf16, of which on the tensor cores, of which f32) so far."""
    return ssd_ops.launches_bwd, ssd_ops.launches_bwd_bf16, ssd_ops.launches_bwd_tc, ssd_ops.launches_bwd_f32


def lm_ssd_backward_checks(dev):
    """7e: the SSD backward kernels against ``ssd_chunked_bwd`` per element at
    LM_TOL (d log a, f32 in both dtypes, at f32's), f32 (the CUDA cores) and
    bf16 (the tensor cores) each counted on its route, two calls bitwise
    equal, at SSD_BWD_SMALL and SSD_BWD_FULL;
    then ``SSDScanFn``'s whole backward (``torch.autograd.grad`` through the
    forward and backward kernels) against autograd of ``ssd_chunked``.
    Returns the largest allowance share per dtype and the full shapes', and
    the element behind each share beside the exact (f64) value
    (``worst_element``)."""
    import math

    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked, ssd_chunked_bwd

    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    worst, full, fn, elements = {}, {}, {}, {}
    cases = [(None, c) for c in SSD_BWD_SMALL] + list(SSD_BWD_FULL.items())
    for label, (B, L, H, P, N) in cases:
        for dtype in (torch.float32, torch.bfloat16):
            what = f"ssd backward at {label or (B, L, H, P, N)}, {dtype}"
            x, loga, b, c = _ssd_inputs(gen, B, L, H, P, N, dev, dtype)
            dy = _randn(gen, (B, L, H, P), dev, dtype)
            n0 = ssd_route_counts(ssd_ops)
            got = ssd_ops.ssd_scan_bwd(x, loga, b, c, dy)
            bf16 = dtype == torch.bfloat16
            check(ssd_route_counts(ssd_ops) == (n0[0] + 1, n0[1] + bf16, n0[2] + bf16, n0[3] + (not bf16)),
                  f"{what}: launched on the wrong route (bf16 on the tensor cores, f32 on the CUDA cores)")
            want = ssd_chunked_bwd(x, loga, b, c, dy, math.gcd(128, L))
            share = 0.0
            for name, g, w in zip(("dx", "dloga", "db", "dc"), got, want):
                check(g.dtype == w.dtype and g.shape == w.shape, f"{what}: {name} {g.dtype} {tuple(g.shape)}")
                share = max(share, lm_close(g, w, g.dtype, f"{what}: {name}")[1])
            again = ssd_ops.ssd_scan_bwd(x, loga, b, c, dy)
            check(all(torch.equal(u, v) for u, v in zip(got, again)), f"{what}: two calls differ")
            if share > worst.get(str(dtype), 0.0) or label:
                exact = ssd_chunked_bwd(*(u.double() for u in (x, loga, b, c, dy)), math.gcd(128, L))
                el = dict(worst_element(got, want, exact), case=what)
                del exact
                if share > worst.get(str(dtype), 0.0):
                    worst[str(dtype)], elements[str(dtype)] = share, el
                if label:
                    full[f"{label} {dtype}"], elements[f"{label} {dtype}"] = share, el
            del x, loga, b, c, dy, got, want, again
        torch.cuda.empty_cache()
    for dtype in (torch.float32, torch.bfloat16):
        ins = [t.requires_grad_(True) for t in _ssd_inputs(gen, 2, 512, 8, 64, 128, dev, dtype)]
        dy = _randn(gen, (2, 512, 8, 64), dev, dtype)
        n0 = (ssd_ops.launches, ssd_ops.launches_bwd)
        got = torch.autograd.grad(ssd_ops.SSDScanFn.apply(*ins, 128), ins, dy)
        check((ssd_ops.launches, ssd_ops.launches_bwd) == (n0[0] + 1, n0[1] + 1),
              f"SSDScanFn, {dtype}: one forward and one backward launch")
        want = torch.autograd.grad(ssd_chunked(*ins, None, 128)[0], ins, dy)
        fn[str(dtype)] = max(lm_close(g, w, g.dtype, f"SSDScanFn backward vs autograd of ssd_chunked, {dtype}: {n}")[1]
                             for n, g, w in zip(("dx", "dloga", "db", "dc"), got, want))
        exact = ssd_chunked_bwd(*(u.detach().double() for u in (*ins, dy)), 128)
        elements[f"SSDScanFn {dtype}"] = worst_element(got, want, exact)
    log("ssd backward vs plain (largest share of the allowance used; every shape two calls bitwise equal): "
        f"{worst}; full shapes {full}; SSDScanFn's backward vs autograd of ssd_chunked at [2, 512, 8, 64, N 128] {fn}")
    for what, el in elements.items():
        log(f"ssd backward, worst element ({what}): {el}")
    return {"worst_share": worst, "full_shapes": full, "ssd_scan_fn_share": fn, "worst_elements": elements}


def lm_ssd_backward_rows(dev, launches_bwd, kernel_row, timings):
    """The SSD backward at SSD_BWD_FULL (bf16) beside its plain version and
    its bound (``ssd_bwd_work``); mamba2's shape is the kernels line's row.
    ``direct_ms``: CUDA events around direct launches of the C entry point on
    preallocated outputs and scratch, the two kernels alone without the
    profiler. ``kernel_ms`` is the profiler's where a trace held every
    launch, which late in this process traces of any kernel often do not
    (``device_ms``); each of the two kernels' own time is
    ``tools/ssd_bwd_ab.py``'s."""
    from repro_torch.kernels._build import launch
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked_bwd

    gen = torch.Generator(device=dev)
    gen.manual_seed(12)
    out = {}
    for label, (B, L, H, P, N) in SSD_BWD_FULL.items():
        x, loga, b, c = _ssd_inputs(gen, B, L, H, P, N, dev, torch.bfloat16)
        dy = _randn(gen, (B, L, H, P), dev, torch.bfloat16)
        call = lambda: ssd_ops.ssd_scan_bwd(x, loga, b, c, dy)
        plain = lambda: ssd_chunked_bwd(x, loga, b, c, dy, 128)
        err = max(max_abs(g, w) for g, w in zip(call(), plain()))
        t = timed(f"ssd backward ({label})", call, "ssd_bwd", timings, per_call=2)
        bufs = (x, loga, b, c, dy, torch.empty_like(x), torch.empty_like(loga), torch.empty_like(b),
                torch.empty_like(c), *ssd_ops.bwd_scratch(B, L, H, P, N, True, dev))
        args = [u.data_ptr() if u is not None else 0 for u in bufs] + [B, L, H, P, N, 1]
        t["direct_ms"] = cuda_ms(lambda: launch("lm_ssd_scan_bwd", *args))
        del bufs
        p_ms = cuda_ms(plain, reps=2, warmup=1)
        nbytes, nops = ssd_bwd_work(B, L, H, P, N)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, nops / BF16_OPS_PER_S * 1e3
        bound = max(t_bytes, t_ops)
        out[label] = {"shape": [B, L, H, P, N], "t": t, "plain_ms": p_ms, "bound_ms": bound,
                      "bound_by": "bytes" if t_bytes >= t_ops else "operations", "nbytes": nbytes, "nops": nops,
                      "max_abs_err": err}
        log(f"ssd backward [{B}, {L}, {H} heads, P {P}, N {N}] bf16 ({label}): call {t['ms']:.4f} ms (kernels alone "
            f"{t['direct_ms']:.4f} by direct launches, {fmt_ms(t['kernel_ms'])} from the profiler), plain {p_ms:.4f} ms, bound {bound:.4f} ms by {out[label]['bound_by']} "
            f"({nbytes} bytes, {nops} operations), share {bound / t['ms']:.4f}; kernel vs plain max |d| {err:.3g}")
        del x, loga, b, c, dy
        torch.cuda.empty_cache()
    r = out["mamba2-780m training microbatch"]
    kernel_row("ssd_scan_bwd", "src/repro_torch/csrc/ssd_scan_bwd.cu",
               "none: no TPU kernel; the reference differentiates its chunked SSD scan with XLA "
               "(src/repro/models/mamba.py:67)", launches_bwd, r["max_abs_err"], r["t"], r["plain_ms"],
               r["nbytes"], r["nops"], None, BF16_OPS_PER_S)
    return out


def bwd_route_counts(flash_ops):
    """(bf16, of which tensor cores, f32) backward calls so far."""
    return flash_ops.launches_bwd_bf16, flash_ops.launches_bwd_tc, flash_ops.launches_bwd_f32


def lm_backward_checks(dev):
    """The backward kernels against ``attention_bwd_ref`` per element at
    LM_TOL (f32 and bf16, each on its own route: bf16 on the tensor cores at
    every head dim, f32 on the CUDA cores), on the forward kernel's
    out and lse (lse also against ``gqa_attend_lse`` at f32's tolerance),
    and two calls bitwise equal. Returns the largest allowance share per
    dtype and the full shapes' shares."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import MaskSpec, attention_bwd_ref, gqa_attend_lse

    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    worst, full = {}, {}
    cases = [(None, c) for c in TRAIN_ATTENTION_SMALL] + list(TRAIN_ATTENTION_FULL.items())
    for label, (B, H, KV, Lq, Lk, D, C, W, P) in cases:
        spec = MaskSpec(C, W, Lk - Lq, P)
        for dtype in (torch.float32, torch.bfloat16):
            what = f"attention backward at {label or (B, H, KV, Lq, Lk, D, C, W, P)}, {dtype}"
            q, do = (_randn(gen, (B, Lq, H, D), dev, dtype) for _ in range(2))
            k, v = (_randn(gen, (B, Lk, KV, D), dev, dtype) for _ in range(2))
            out, lse = flash_ops.flash_attention_lse(q, k, v, causal=C, window=W, prefix=P)
            share = lm_close(lse, gqa_attend_lse(q, k, v, mask_spec=spec)[1], torch.float32, what + " lse")[1]
            n0 = bwd_route_counts(flash_ops)
            got = flash_ops.flash_attention_bwd(q, k, v, out, lse, do, causal=C, window=W, prefix=P)
            bf16 = dtype == torch.bfloat16
            tc = flash_ops.bwd_route(dtype, D)[0]
            check(tc == bf16, f"{what}: head dim {D} routed {'to' if tc else 'off'} the tensor cores")
            check(bwd_route_counts(flash_ops) == (n0[0] + bf16, n0[1] + bf16, n0[2] + (not bf16)),
                  f"{what}: launched on the wrong route")
            want = attention_bwd_ref(q, k, v, out, lse, do, spec)
            for name, g, w in zip(("dq", "dk", "dv"), got, want):
                check(g.dtype == dtype and g.shape == w.shape, f"{what}: {name} {g.dtype} {tuple(g.shape)}")
                share = max(share, lm_close(g, w, dtype, f"{what}: {name}")[1])
            again = flash_ops.flash_attention_bwd(q, k, v, out, lse, do, causal=C, window=W, prefix=P)
            check(all(torch.equal(a, b) for a, b in zip(got, again)), f"{what}: two calls differ")
            worst[str(dtype)] = max(worst.get(str(dtype), 0.0), share)
            if label:
                full[f"{label} {dtype}"] = share
            del q, do, k, v, out, lse, got, want, again
        torch.cuda.empty_cache()
    log("attention backward vs plain (largest share of the allowance used; every shape two calls bitwise "
        f"equal): {worst}; full shapes {full}")
    return {"worst_share": worst, "full_shapes": full}


def train_ssd_launches(cfg):
    """(forward, backward) SSD kernel launches of one ``loss_fn`` and its
    backward: each ``ssm`` or ``hybrid`` layer once each way, and once more
    forward where ``cfg.remat`` recomputes the layer."""
    from repro_torch.configs.base import _layer_kinds

    n = sum(k in ("ssm", "hybrid") for k in _layer_kinds(cfg))
    return n * (1 if cfg.remat == "none" else 2), n


def train_attention_launches(cfg):
    """(forward, backward) attention kernel launches of one ``loss_fn`` and its
    backward: each decoder-side attention once forward and once backward, and
    once more forward where ``cfg.remat`` recomputes the layer; each encoder
    layer (never recomputed) once each way."""
    from repro_torch.configs.base import _layer_kinds

    kinds = _layer_kinds(cfg)
    enc = sum(k == "enc" for k in kinds)
    dec = attention_launches([k for k in kinds if k != "enc"], cfg.use_mla)
    return dec * (1 if cfg.remat == "none" else 2) + enc, dec + enc


def _train_batch(cfg, B, S, dev, gen):
    toks = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=gen, device=dev)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:].clone()}
    batch["targets"][0, :5] = -1
    return {**batch, **(lm_extras(cfg, B, dev, gen) or {})}


def lm_train_reduced(dev):
    """Reduced widths, f32 (TF32 off): ``loss_fn`` and every gradient leaf on
    the kernel path (attention's and the SSD scan's forward and backward
    kernels, f32 routes) against the plain path (``gqa_attend`` and
    ``ssd_chunked`` under autograd). MoE: the experts each path routes to
    are recorded; rows where they differ would be masked."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.models import build_model
    from repro_torch.training import AdamWConfig, init_state

    out = {}
    for arch in ("smollm-135m", "gemma3-12b", "qwen1.5-4b", "deepseek-moe-16b", "deepseek-v3-671b",
                 "whisper-large-v3", "llama-3.2-vision-90b", "mamba2-780m", "hymba-1.5b"):
        base = get_config(arch)
        kw = dict(n_layers=len(base.pattern) or 4, d_model=256, n_heads=4, n_kv_heads=2, head_dim=64, d_ff=512,
                  vocab_size=4096, compute_dtype="float32", param_dtype="float32",
                  local_window=100 if base.local_window else 0)
        if base.n_experts:
            kw.update(n_experts=8, experts_per_token=2, moe_d_ff=128, dense_d_ff=512, capacity_factor=8.0)
        if base.use_mla:
            kw.update(q_lora_rank=64, kv_lora_rank=32, qk_rope_dim=16, qk_nope_dim=32, v_head_dim=32)
        if base.encoder_layers:
            kw.update(encoder_layers=2, encoder_frames=300)
        if base.vision_tokens:
            kw.update(vision_tokens=100, cross_attn_every=2)
        cfg = dataclasses.replace(base, **kw)
        model = build_model(cfg, dev, seed=1)
        open_gates(model)
        init_state(model, AdamWConfig())
        gen = torch.Generator(device=dev)
        gen.manual_seed(8)
        batch = _train_batch(cfg, 2, 256, dev, gen)
        params = [p for _, p in model.named_parameters()]

        def run(use_kernels):
            model.use_kernels = use_kernels
            for name in ("launches", "launches_bf16", "launches_f32", *BWD_COUNTERS):
                setattr(flash_ops, name, 0)
            for name in SSD_COUNTERS:
                setattr(ssd_ops, name, 0)
            with routing_recorded() as route:
                loss, _ = model.loss_fn(batch)
                grads = torch.autograd.grad(loss, params, allow_unused=True)
            counts = (flash_ops.launches_f32, flash_ops.launches_bwd_f32, flash_ops.launches_bf16,
                      flash_ops.launches_bwd_bf16, ssd_ops.launches_f32, ssd_ops.launches_bwd_f32,
                      ssd_ops.launches_bf16, ssd_ops.launches_bwd_bf16)
            return float(loss.detach()), grads, route, counts

        lk, gk, rk, ck = run(True)
        lp, gp, rp, cp = run(False)
        fwd, bwd = train_attention_launches(cfg)
        sfwd, sbwd = train_ssd_launches(cfg)
        check(ck == (fwd, bwd, 0, 0, sfwd, sbwd, 0, 0),
              f"{arch}: kernel path launches (attention f32 fwd, f32 bwd, bf16 fwd, bf16 bwd; the same of the SSD scan) "
              f"{ck}, want ({fwd}, {bwd}, 0, 0, {sfwd}, {sbwd}, 0, 0)")
        check(cp == (0,) * 8, f"{arch}: the plain path launched kernels {cp}")
        agree = all(torch.equal(a, b) for a, b in zip(rk, rp))
        check(agree, f"{arch}: MoE routing differs between the kernel and plain paths")
        loss_rel = abs(lk - lp) / abs(lp)
        leaves = {n: drift(a, b) for (n, _), a, b in zip(model.named_parameters(), gk, gp) if a is not None}
        check(all((a is None) == (b is None) for a, b in zip(gk, gp)), f"{arch}: unused leaves differ")
        worst = max(leaves, key=leaves.get)
        check(loss_rel <= 1e-5 and leaves[worst] <= 1e-3,
              f"{arch}: kernel vs plain loss {lk} / {lp}, worst leaf {worst} {leaves[worst]:.3g}")
        out[arch] = {"loss_kernel": lk, "loss_plain": lp, "loss_rel": loss_rel, "worst_leaf": worst,
                     "worst_leaf_drift": leaves[worst], "leaves": len(leaves), "launches_fwd_bwd": [fwd, bwd],
                     "ssd_launches_fwd_bwd": [sfwd, sbwd], "moe_layers_routed": len(rk)}
        del model, gk, gp, params
        torch.cuda.empty_cache()
    log("reduced LM training (4-6 layers, d 256, f32, batch 2 x 256; mamba2 and hymba at P 64, N 128 / 16): "
        "kernel vs plain loss_fn and gradients, "
        "max |d| / max |plain| per leaf: " + ", ".join(
            f"{a} loss {r['loss_rel']:.2g}, worst leaf {r['worst_leaf']} {r['worst_leaf_drift']:.3g}"
            for a, r in out.items()))
    return out


def lm_train_full(dev, arch="smollm-135m", depth=None, steps=TRAIN_STEPS, resume=True, profile=True,
                  n_micro=TRAIN_MICRO, lr=1e-3, warmup=2):
    """``arch`` at published widths (``depth`` of its layers, default all),
    bf16 compute, f32 params, AdamW at peak ``lr`` after ``warmup`` steps:
    ``TokenPipeline`` batches of 8 x 2048 in ``n_micro`` microbatches,
    ``steps`` steps with launch counts read around them
    (attention and the SSD scan, forward and backward, per route); with
    ``resume``, the steps after TRAIN_RESUME_AT run again from a checkpoint,
    bitwise; with ``profile``, one more step under the profiler (its trace
    takes seconds to read back); one microbatch's loss and gradients on the
    kernel path against the plain path in f32."""
    import shutil

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.models import build_model
    from repro_torch.training import AdamWConfig, init_state, make_train_step

    cfg = get_config(arch)
    if depth:
        cfg = dataclasses.replace(cfg, n_layers=depth)
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, dev, seed=0)
    opt = AdamWConfig(lr=lr, warmup_steps=warmup, decay_steps=100)
    state = init_state(model, opt)
    state0 = state if resume else None      # the form a resume restores into; else not kept alive
    step = make_train_step(model, opt)
    pipe, t_data = sync_time(lambda: TokenPipeline(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ, n_docs=512, seed=0))
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in b.items()}
               for b in pipe.batches(TRAIN_BATCH, steps, n_micro=n_micro)]
    ckpt_dir = ROOT / "build" / "lm_train_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    mgr = CheckpointManager(str(ckpt_dir), keep=1, save_interval=TRAIN_RESUME_AT)

    for n in ("launches", "launches_bf16", "launches_f32", *BWD_COUNTERS):
        setattr(flash_ops, n, 0)
    for n in SSD_COUNTERS:
        setattr(ssd_ops, n, 0)
    torch.cuda.reset_peak_memory_stats()
    losses, step_s, save_s = [], [], None
    for i, b in enumerate(batches):
        (state, m), t = sync_time(lambda: step(state, b))
        losses.append(float(m["loss"]))
        step_s.append(t)
        if resume and i + 1 == TRAIN_RESUME_AT:
            _, save_s = sync_time(lambda: mgr.maybe_save(state, i + 1))
    peak = torch.cuda.max_memory_allocated()
    routes = {"fwd_bf16": flash_ops.launches_bf16, "fwd_f32": flash_ops.launches_f32,
              "bwd_bf16": flash_ops.launches_bwd_bf16, "bwd_tc": flash_ops.launches_bwd_tc,
              "bwd_f32": flash_ops.launches_bwd_f32, "ssd_fwd_bf16": ssd_ops.launches_bf16,
              "ssd_fwd_f32": ssd_ops.launches_f32, "ssd_bwd_bf16": ssd_ops.launches_bwd_bf16,
              "ssd_bwd_tc": ssd_ops.launches_bwd_tc, "ssd_bwd_f32": ssd_ops.launches_bwd_f32}
    fwd, bwd = train_attention_launches(cfg)
    sfwd, sbwd = train_ssd_launches(cfg)
    n_calls = steps * n_micro
    want = {"fwd_bf16": fwd * n_calls, "fwd_f32": 0, "bwd_bf16": bwd * n_calls, "bwd_tc": bwd * n_calls,
            "bwd_f32": 0, "ssd_fwd_bf16": sfwd * n_calls, "ssd_fwd_f32": 0, "ssd_bwd_bf16": sbwd * n_calls,
            "ssd_bwd_tc": sbwd * n_calls, "ssd_bwd_f32": 0}
    check(routes == want and flash_ops.launches == fwd * n_calls and flash_ops.launches_bwd == bwd * n_calls
          and ssd_ops.launches == sfwd * n_calls and ssd_ops.launches_bwd == sbwd * n_calls,
          f"{arch} training: launches per route {routes}, want {want} (every call bf16 on a kernel, "
          "attention's and the SSD scan's backward on the tensor cores)")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0], f"{arch} training: the loss did not fall {losses}")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    steady = step_s[1:]
    log(f"{arch} training ({cfg.n_layers} layers, d {cfg.d_model}, bf16 compute, batch {TRAIN_BATCH} x {TRAIN_SEQ} in "
        f"{n_micro} microbatches, remat {cfg.remat}, peak lr {lr:g} after {warmup} warmup steps): losses {[round(x, 4) for x in losses]}, s/step "
        f"{[round(x, 4) for x in step_s]} (first step with its warm-up), steady {np.mean(steady):.4f} s/step, "
        f"{tokens / np.mean(steady):.1f} tokens/s, peak {peak / 2**30:.2f} GiB, launches {routes}"
        + (f", checkpoint save {save_s:.3f} s" if resume else ""))

    # where one step's device time goes: the step once more under the profiler
    breakdown = train_step_breakdown(lambda: step(state, batches[0])) if profile else None

    t_resume = time.perf_counter()
    if resume:      # restore step TRAIN_RESUME_AT into the state's form, run on to the end
        restored, at = mgr.restore_latest_valid(state0)
        check(at == TRAIN_RESUME_AT and restored.step == at, f"restored step {at}")
        resumed = restored
        resumed_losses = []
        for b in batches[at:]:
            resumed, m = step(resumed, b)
            resumed_losses.append(float(m["loss"]))
        same = resumed_losses == losses[at:] and resumed.step == state.step
        for n in state.params:
            same &= torch.equal(resumed.params[n], state.params[n]) and torch.equal(
                resumed.opt["m"][n], state.opt["m"][n]) and torch.equal(resumed.opt["v"][n], state.opt["v"][n])
        check(same, f"{arch} training resumed at step {at}: not bitwise the uninterrupted run "
              f"(losses {resumed_losses} vs {losses[at:]})")
        log(f"{arch} training: restored at step {at} and run to step {steps} in {time.perf_counter() - t_resume:.1f} s: "
            "losses, params and moments bitwise the uninterrupted run")
        del restored, resumed
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    t_f32 = time.perf_counter()

    # kernel path vs plain path, one microbatch in f32 (TF32 off), on the last
    # step's parameters (the state freed first: at gemma3's widths it is 37 GB)
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(state.params[n])
    del state, state0
    torch.cuda.empty_cache()
    mb = {k: v[0] for k, v in batches[0].items()}
    params = [p for _, p in model.named_parameters()]
    model.compute_dtype = torch.float32
    res = {}
    for use_kernels in (True, False):
        model.use_kernels = use_kernels
        n0 = flash_ops.launches_bwd_f32 + ssd_ops.launches_bwd_f32
        loss, _ = model.loss_fn(mb)
        res[use_kernels] = (float(loss.detach()), torch.autograd.grad(loss, params))
        check((flash_ops.launches_bwd_f32 + ssd_ops.launches_bwd_f32 > n0) == use_kernels,
              f"{arch} f32 comparison: backward launches")
    model.compute_dtype, model.use_kernels = torch.bfloat16, True
    (lk, gk), (lp, gp) = res[True], res[False]
    leaves = {n: drift(a, b) for (n, _), a, b in zip(model.named_parameters(), gk, gp)}
    worst = max(leaves, key=leaves.get)
    loss_drift = abs(lk - lp) / abs(lp)
    check(loss_drift <= 1e-2 and leaves[worst] <= 1e-2,
          f"{arch} f32 kernel vs plain: loss {lk} / {lp}, worst leaf {worst} {leaves[worst]:.3g}")
    log(f"{arch} full width ({cfg.n_layers} layers), f32, one microbatch of {TRAIN_BATCH // n_micro} x {TRAIN_SEQ}: "
        f"kernel vs plain loss {lk:.6f} / {lp:.6f} (rel {loss_drift:.3g}), worst gradient leaf {worst} "
        f"{leaves[worst]:.3g} ({time.perf_counter() - t_f32:.1f} s)")
    result = {"arch": cfg.name, "layers": cfg.n_layers, "of_layers": get_config(arch).n_layers, "batch": TRAIN_BATCH,
              "seq": TRAIN_SEQ, "n_micro": n_micro, "lr": lr, "warmup": warmup, "remat": cfg.remat, "losses": losses, "step_s": step_s,
              "steady_s_per_step": float(np.mean(steady)), "tokens_per_s": tokens / float(np.mean(steady)),
              "peak_bytes": peak, "launches": routes, "checkpoint_save_s": save_s, "data_s": t_data,
              "step_breakdown": breakdown, "resumed_bitwise": resume, "resumed_at": TRAIN_RESUME_AT if resume else None,
              "f32_kernel_vs_plain": {"loss_rel": loss_drift, "worst_leaf": worst, "worst_leaf_drift": leaves[worst]}}
    del model, res, gk, gp, params
    torch.cuda.empty_cache()
    return result


# Kernel-name substrings of a training step's device time, by group (the rest is "other").
STEP_GROUPS = {"attention backward": ("bwd_delta", "bwd_dkdv", "bwd_dq"), "attention forward": ("flash_tc_kernel",),
               "ssd backward": ("ssd_bwd",), "ssd forward": ("ssd_tc_kernel",),
               "matmul": ("gemm", "Gemm", "nvjet", "xmma", "cutlass")}


def train_step_breakdown(fn):
    """One call of ``fn`` (a train step) under the profiler: its host seconds,
    the card's busy share, device ms per ``STEP_GROUPS`` group and the eight
    kernels with the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall = sync_time(fn)
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and not e.is_user_annotation and e.self_device_time_total > 0]
    groups = {g: 0.0 for g in (*STEP_GROUPS, "other")}
    for name, ms, _ in kernels:
        g = next((g for g, keys in STEP_GROUPS.items() if any(k in name for k in keys)), "other")
        groups[g] += ms
    busy = sum(groups.values())
    top = [{"kernel": n[:90], "ms": ms, "launches": c} for n, ms, c in sorted(kernels, key=lambda k: -k[1])[:8]]
    log(f"one training step under the profiler: {wall:.4f} s on the host clock, the card busy {busy / 1e3 / wall:.3f} "
        "of it; device ms by group " + ", ".join(f"{g} {ms:.1f}" for g, ms in groups.items())
        + "; top kernels " + "; ".join(f"{t['kernel'][:60]} {t['ms']:.1f} ms x{t['launches']}" for t in top))
    return {"host_s": wall, "busy_share": busy / 1e3 / wall, "device_ms": groups, "top": top}


# The backward timed beside SDPA's (phase 7d): smollm-135m's training microbatch,
# llama-3.2-vision-90b's self-attention heads at hd 128, gemma3-27b's at hd 168
# and gemma3-12b's at hd 240 (padded to 192 and 256: the two-warpgroup blocks),
# global and local (B, H, KV, L, D, window), causal.
BWD_SHAPES = {"smollm training shape": (TRAIN_BATCH // TRAIN_MICRO, 9, 3, TRAIN_SEQ, 64, 0),
              "llama-vision self-attention, hd 128": (TRAIN_BATCH // TRAIN_MICRO, 64, 8, TRAIN_SEQ, 128, 0),
              "gemma3-27b heads, hd 168": (TRAIN_BATCH // TRAIN_MICRO, 32, 16, TRAIN_SEQ, 168, 0),
              "gemma3-27b local heads, hd 168, window 1024": (TRAIN_BATCH // TRAIN_MICRO, 32, 16, TRAIN_SEQ, 168, 1024),
              "gemma3-12b heads, hd 240": (TRAIN_BATCH // TRAIN_MICRO, 16, 8, TRAIN_SEQ, 240, 0),
              "gemma3-12b local heads, hd 240, window 1024": (TRAIN_BATCH // TRAIN_MICRO, 16, 8, TRAIN_SEQ, 240, 1024)}


def backward_timing(dev, gen, label, shape, timings):
    """The backward kernels at ``shape`` (bf16, causal, the window if any) on
    the forward kernel's out and lse: checked against ``attention_bwd_ref``
    at LM_TOL, timed in turns with SDPA's backward (kernel, SDPA, SDPA,
    kernel; under a window SDPA takes its explicit mask; SDPA's
    ``library_ms`` the mean of its two), then by ``timed`` (the call and the
    kernels alone), beside the plain version and the bound (10 D flops a
    visible pair)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import MaskSpec, attention_bwd_ref

    B, H, KV, L, D, W = shape
    q, do = (_randn(gen, (B, L, H, D), dev, torch.bfloat16) for _ in range(2))
    k, v = (_randn(gen, (B, L, KV, D), dev, torch.bfloat16) for _ in range(2))
    out, lse = flash_ops.flash_attention_lse(q, k, v, window=W)
    call = lambda: flash_ops.flash_attention_bwd(q, k, v, out, lse, do, window=W)
    spec = MaskSpec(window=W)
    plain = lambda: attention_bwd_ref(q, k, v, out, lse, do, spec)
    got, want = call(), plain()
    err = max(max_abs(g, w) for g, w in zip(got, want))
    share = max(lm_close(g, w, torch.bfloat16, f"attention backward at the {label}: {n}")[1]
                for n, g, w in zip(("dq", "dk", "dv"), got, want))
    del want
    qt, kt, vt = (a.transpose(1, 2).detach().requires_grad_(True) for a in (q, k, v))
    if W:
        o_lib = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=spec.block(0, L, L, dev)[None], enable_gqa=True)
    else:
        o_lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
    lib = lambda: torch.autograd.grad(o_lib, (qt, kt, vt), do.transpose(1, 2), retain_graph=True)
    lib_err = max(float((a.transpose(1, 2).double() - b.double()).abs().max()) for a, b in zip(lib(), got))
    turns = [cuda_ms(f) for f in (call, lib, lib, call)]     # in turns: kernel, SDPA, SDPA, kernel
    lib_ms = (turns[1] + turns[2]) / 2
    # "bwd_d" matches both launches of a call: delta and the fused dK / dV + dQ kernel
    t = timed(f"attention backward ({label})", call, "bwd_d", timings, per_call=2)
    p_ms = cuda_ms(plain, reps=2, warmup=1)
    pairs = visible_pairs(L, L, W, 0)
    nbytes = 2 * (4 * B * L * H * D + 4 * B * L * KV * D) + 4 * B * H * L   # q, o, do, dq; k, v, dk, dv; lse
    nops = 10 * D * B * H * pairs
    bound = max(nbytes / HBM_BYTES_PER_S, nops / BF16_OPS_PER_S) * 1e3
    log(f"attention backward [{B}, {H} H / {KV} KV, {L}, {L}, {D}] bf16 causal, window {W} ({label}): call "
        f"{t['ms']:.4f} ms "
        f"(kernels alone {fmt_ms(t['kernel_ms'])}), bound {bound:.4f} ms (share {bound / t['ms']:.3f}, of the "
        f"kernels alone {bound_share(bound, t['kernel_ms'])}), SDPA backward {lib_ms:.4f} ms (max |d| vs the kernel "
        f"{lib_err:.3g}; in turns kernel / SDPA / SDPA / kernel {' / '.join(f'{x:.4f}' for x in turns)} ms), "
        f"plain {p_ms:.4f} ms; kernel vs plain max |d| {err:.3g} ({share:.3g} of the allowance)")
    del q, do, k, v, out, lse, got, qt, kt, vt, o_lib
    torch.cuda.empty_cache()
    return {"shape": list(shape), "t": t, "plain_ms": p_ms, "sdpa_bwd_ms": lib_ms, "turns_ms": turns, "bound_ms": bound,
            "nbytes": nbytes, "nops": nops, "max_abs_err": err, "allowance_share": share,
            "sdpa_bwd_vs_kernel_max_abs": lib_err}


def lm_backward_rows(dev, launches_bwd, kernel_row, timings):
    """The backward kernels at ``BWD_SHAPES`` beside their plain version,
    their bound and SDPA's backward (the smollm shape is the kernels line's
    row); the forward kernel with and without its lse, in turns, at the
    training shape and at phase 6's prefill shape."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as flash_ops

    sm = get_config("smollm-135m")
    H, KV, D = sm.n_heads, sm.n_kv_heads, sm.hd
    check(BWD_SHAPES["smollm training shape"][1:] == (H, KV, TRAIN_SEQ, D, 0), "smollm's heads and head dim")
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    fwd_lse = {}
    for B in (TRAIN_BATCH // TRAIN_MICRO, LM_BATCH):
        q = _randn(gen, (B, TRAIN_SEQ, H, D), dev, torch.bfloat16)
        k, v = (_randn(gen, (B, TRAIN_SEQ, KV, D), dev, torch.bfloat16) for _ in range(2))
        with torch.no_grad():
            plain_fwd = lambda: flash_ops.flash_attention(q, k, v)
            with_lse = lambda: flash_ops.flash_attention_lse(q, k, v)
            turns = [cuda_ms(f) for f in (plain_fwd, with_lse, with_lse, plain_fwd)]
        fwd_lse[B] = {"without_lse_ms": [turns[0], turns[3]], "with_lse_ms": [turns[1], turns[2]]}
        log(f"attention forward [{B}, {H} H / {KV} KV, {TRAIN_SEQ}, {TRAIN_SEQ}, {D}] bf16 causal, in turns: without "
            f"lse {turns[0]:.4f} / {turns[3]:.4f} ms, with lse {turns[1]:.4f} / {turns[2]:.4f} ms")
        del q, k, v

    shapes = {label: backward_timing(dev, gen, label, shape, timings) for label, shape in BWD_SHAPES.items()}
    r = shapes["smollm training shape"]
    kernel_row("flash_attention_bwd", "src/repro_torch/csrc/flash_attention_bwd.cu",
               "none: no TPU kernel; the reference differentiates its einsum attention with XLA "
               "(src/repro/models/layers.py:277)", launches_bwd, r["max_abs_err"], r["t"], r["plain_ms"],
               r["nbytes"], r["nops"], r["sdpa_bwd_ms"], BF16_OPS_PER_S)
    return {"forward_lse_turns": fwd_lse, "shapes": shapes, "sdpa_bwd_vs_kernel_max_abs": r["sdpa_bwd_vs_kernel_max_abs"],
            "allowance_share": r["allowance_share"]}


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
        return {"model": model_s, "launches": counts, "main_path_s": t_main, "exact_replay_s": t_exact,
                "accuracy": acc,
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
    ``predict_sharded``, the OOB weights and the tree-sharded vote of the
    resident forest (``serving.make_sharded_vote_fn`` over ``"data"``,
    the traversal launches counted around it); numpy results."""
    from repro_torch import ForestConfig
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import distributed as dist_prf
    from repro_torch.kernels.gain_ratio import ops as hist_ops
    from repro_torch.kernels.split_scan import ops as scan_ops
    from repro_torch.kernels.tree_traverse import ops as trav_ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serving import make_sharded_vote_fn

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
    vote = make_sharded_vote_fn(f, mesh, tree_axis="data")
    trav_ops.launches = 0
    labels, out["vote_s"] = sync_time(lambda: vote(xte))
    out["sharded_vote"] = labels.cpu().numpy()
    out["vote_launches"] = trav_ops.launches
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
            check(np.array_equal(out["sharded_vote"], want_pred),
                  f"mesh phase (b), rank {r}: tree-sharded vote labels differ from the single-device labels")
            check(out["vote_launches"] > 0 or dev.type != "cuda",
                  f"mesh phase (b), rank {r}: the sharded vote did not launch the traversal")
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
        res["gloo"] = {"ranks": [{k_: v for k_, v in o.items()
                                  if k_ in ("mesh", "growth_s", "launches", "vote_s", "vote_launches")}
                                 for o in ranks],
                       "resume": [{k_: v for k_, v in o.items() if k_ in ("mesh", "resume_s", "launches",
                                                                         "first_level")} for o in moved],
                       "world_s": t_world, "resume_world_s": t_world2}
        log(f"mesh phase (b): gloo world of 4 on {dev} (mesh (2, 2), {ranks[0]['mesh']}), {n} rows, "
            f"{xb_h.shape[1]} features, {cfg6.n_trees} trees, depth {cfg6.max_depth}: resident, streamed "
            f"(sample_block {MESH_BLOCK}) and checkpointed "
            f"growth bitwise the local forest on every rank, labels, OOB weights and the tree-sharded vote's "
            f"labels ({cfg6.n_trees // 2} trees a rank, {ranks[0]['vote_launches']} traversal launch(es), "
            f"{ranks[0]['vote_s']:.3f} s on rank 0) equal; a kill at level "
            f"{kill_at} resumed by a (4, 1) world bitwise; rank 0 growth s {ranks[0]['growth_s']}, launches "
            f"{ranks[0]['launches']}; worlds {t_world:.1f} s and {t_world2:.1f} s")
        return res
    finally:
        shutil.rmtree(root, ignore_errors=True)


MP_BLOCK = STREAM_BLOCK          # phase 5f: the streamed phase's sample_block (8 training blocks)
MP_KILL_AT = 4                   # phase 5f: the level after which the checkpointed run is killed


def multiproc_rank(mm_path, y_path, shape, cfg_kw, ckpt_dir, kill_at, device="cuda"):
    """One process of phase 5f, on ``cuda:0`` in a gloo world of 2: the
    training rows from the memmap at ``mm_path``. (1) ``train_prf`` (the
    dispatch to ``train_prf_multiproc``) with the histogram and split-scan
    launch counts set to 0 just before and read just after; (2) a staged
    replay (``train_prf_multiproc`` with ``stats``: stage times and fed
    bytes); (3) a run checkpointed every level through
    ``MultiprocCheckpointManager``, killed after level ``kill_at``, then
    its resume. The host memory: the resident set at entry (with
    ``ru_maxrss``, which a spawned process inherits from its parent, so it
    is not this rank's peak) and after the CUDA context, around each run
    (``_host_memory``: the resident set and the pinned allocator), and the
    resident set sampled every 2 ms by a thread during each run, whose
    maximum is the run's peak and, split at the replay's stage times, each
    stage's. Numpy results and host clocks."""
    import resource
    import threading

    from repro_torch import ForestConfig, train_prf
    from repro_torch.core import distributed as dist_prf
    from repro_torch.kernels.gain_ratio import ops as hist_ops
    from repro_torch.kernels.split_scan import ops as scan_ops
    from repro_torch.launch.multiproc import MultiHostMesh

    x = np.memmap(mm_path, dtype=np.float32, mode="r", shape=tuple(shape))
    y = np.load(y_path)
    cfg = ForestConfig(**cfg_kw)
    dev = torch.device(device)
    out = {"launches": {}, "host_memory": {},
           "rss_at_entry": dist_prf._host_memory(dev).get("VmRSS"),
           "maxrss_at_entry": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024}
    torch.zeros(1, device=dev)
    out["rss_with_context"] = dist_prf._host_memory(dev).get("VmRSS")
    samples = {}

    def memory(tag, fn):
        trace, stop = [], threading.Event()

        def sample():
            while not stop.is_set():
                trace.append((time.perf_counter(), dist_prf._host_memory(dev).get("VmRSS", 0)))
                stop.wait(0.002)

        before = dist_prf._host_memory(dev)
        sampler = threading.Thread(target=sample, daemon=True)
        sampler.start()
        try:
            return fn()
        finally:
            stop.set()
            sampler.join()
            samples[tag] = trace
            out["host_memory"][tag] = {
                "before": before, "after": dist_prf._host_memory(dev),
                "sampled_peak": max(r for _, r in trace), "samples": len(trace)}

    def arrays(model):
        return {**{n: getattr(model.forest, n).cpu().numpy() for n in type(model.forest).FIELDS},
                "edges": np.asarray(model.bin_edges)}

    def counted(tag, fn):
        hist_ops.launches = scan_ops.launches = 0
        result, t = sync_time(fn)
        out["launches"][tag] = {"gain_ratio_hist": hist_ops.launches, "split_scan": scan_ops.launches}
        return result, t

    model, out["train_s"] = memory("train_prf", lambda: counted(
        "train_prf", lambda: train_prf(x, y, cfg, 0, device=device)))
    out["model"] = arrays(model)
    del model
    runtime = MultiHostMesh(device=device)
    stats = {}
    replay, out["replay_s"] = memory("replay", lambda: counted(
        "replay", lambda: dist_prf.train_prf_multiproc(x, y, cfg, 0, runtime=runtime, stats=stats)))
    out["replay"] = arrays(replay)
    del replay
    out["feed_bytes"] = stats.pop("feed_bytes")
    out["stage_host_memory"] = stats.pop("host_memory")
    end, peaks = samples["replay"][-1][0], {}
    for stage in reversed(["screen", "sketch", "binning", "dimension_reduction", "growth", "oob"]):
        start = end - stats[stage]
        peaks[stage] = max((r for t, r in samples["replay"] if start <= t <= end), default=0)
        end = start
    out["stage_sampled_peak"] = peaks
    out["host_tensor_bytes"] = stats.pop("host_tensor_bytes")
    out["staged_bytes"] = runtime.mesh.staged_bytes
    out["draws_bytes"] = cfg.n_trees * x.shape[0] * 4
    out["stages_s"], out["runtime"] = stats, repr(runtime)

    def boom(level, _):
        if level == kill_at:
            raise _Kill

    def killed():
        t0 = time.perf_counter()
        try:
            train_prf(x, y, cfg, 0, device=device, checkpoint_dir=ckpt_dir, on_level=boom)
            raise AssertionError(f"multi-process phase: the kill at level {kill_at} did not fire")
        except _Kill:
            out["killed_run_s"] = time.perf_counter() - t0

    memory("killed", killed)
    levels = []
    resumed, out["resume_s"] = memory("resume", lambda: counted("resume", lambda: train_prf(
        x, y, cfg, 0, device=device, resume_from=ckpt_dir,
        on_level=lambda level, _: levels.append(level))))
    out["resumed"], out["first_resumed_level"] = arrays(resumed), levels[0]
    out["peak_rss_bytes"] = max(m["sampled_peak"] for m in out["host_memory"].values())
    return out


def multiproc_phase(dev, xtr, ytr, xte, yte, wt, u, cfg):
    """5f. The multi-process plane (``launch/multiproc.py``,
    ``train_prf_multiproc``) at full width and size: a gloo world of 2
    processes on ``cuda:0`` (mesh (2, 1); NCCL refuses two ranks on one
    card, so every collective is staged through the host: a test of the
    plane, not of its speed), each calling ``train_prf`` on the 2^20 x 128
    training rows written once to an ``np.memmap`` under ``build/``, with
    phase 5's configuration streamed (``sample_block`` ``MP_BLOCK``),
    importance mode, weighted voting (``multiproc_rank``). Fails unless:
    both ranks' models (forest and edges) are bitwise equal, and equal to
    each rank's staged replay and to its kill-at-level-4 resume (first
    resumed level 5); the edges equal the shard-ordered merge of the two
    shards' sketches made here; the forest equals a single-device
    streamed growth here on those edges with the same draws (``wt``,
    ``u``: ``train_prf``'s for seed 0), its dimension reduction and OOB
    weights included; test accuracy >= 0.90; the histogram and the split
    scan were launched on each rank; each rank fed about half the binned
    bytes in a sweep; restoring the world's checkpoint directory in this
    one process raises ``CheckpointTopologyError``. Logs per rank the
    stage times, launches, the host-memory breakdown (``multiproc_rank``)
    against the file's bytes, and the world's wall time. ``run_world``'s
    deadline bounds a hang."""
    import resource
    import shutil

    from repro_torch import PRFModel
    from repro_torch.checkpoint import CheckpointTopologyError
    from repro_torch.core import api
    from repro_torch.core import distributed as dist_prf
    from repro_torch.core.binning import StreamingQuantileSketch, apply_bins
    from repro_torch.core.dimred import dimension_reduction_streamed
    from repro_torch.core.types import Forest
    from repro_torch.core.voting import oob_accuracy_streamed
    from repro_torch.data.pipeline import sample_blocks
    from repro_torch.launch.mesh import run_world

    root = ROOT / "build" / "chip_smoke_multiproc"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    nb, (N, F) = MP_BLOCK, xtr.shape
    mcfg = dataclasses.replace(cfg, sample_block=nb)
    fields = Forest.FIELDS
    try:
        mm_path, y_path, ckpt = root / "train.f32", root / "train_y.npy", root / "ckpt"
        mm = np.memmap(mm_path, np.float32, "w+", shape=xtr.shape)
        mm[:] = xtr
        mm.flush()
        del mm
        np.save(y_path, ytr)
        file_bytes = mm_path.stat().st_size
        parent_rss = {"VmRSS": dist_prf._host_memory(dev).get("VmRSS"),
                      "maxrss": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024}
        ranks, t_world = sync_time(lambda: run_world(
            "chip_smoke:multiproc_rank", 2, backend="gloo", timeout_s=900, collective_timeout_s=600,
            args=(str(mm_path), str(y_path), xtr.shape, dataclasses.asdict(mcfg), str(ckpt),
                  MP_KILL_AT, dev.type)))
        want = ranks[0]["model"]
        for r, out in enumerate(ranks):
            for tag in ("model", "replay", "resumed"):
                for name, a in out[tag].items():
                    check(np.array_equal(a, want[name]),
                          f"multi-process phase, rank {r}: {tag} {name} differs from rank 0's model")
            check(out["first_resumed_level"] == MP_KILL_AT + 1,
                  f"multi-process phase, rank {r}: the resume started at level {out['first_resumed_level']}")
            for tag, counts in out["launches"].items():
                for name, c in counts.items():
                    check(c > 0 or dev.type != "cuda",
                          f"multi-process phase, rank {r}, {tag}: {name} was not launched")
            fed = out["feed_bytes"]["dimension_reduction"]
            check(abs(fed - N * F / 2) <= F * (N // nb + 1),
                  f"multi-process phase, rank {r}: one sweep fed {fed} bytes, not half of {N * F}")

        x_mm = np.memmap(mm_path, np.float32, "r", shape=xtr.shape)
        blocks = sample_blocks(x_mm, nb)
        parts = np.array_split(np.arange(len(blocks)), 2)

        def shard_sketch(part):
            sk = StreamingQuantileSketch(F)
            for i in part:
                sk.update(blocks[int(i)])
            return sk

        merged, t_sketch = sync_time(lambda: shard_sketch(parts[0]).merge(shard_sketch(parts[1])))
        edges = merged.edges(mcfg.n_bins)
        check(np.array_equal(edges, want["edges"]),
              "multi-process phase: the edges differ from the shard-ordered merge of the shards' sketches")
        edges_t = torch.from_numpy(edges).to(dev)
        xb_blocks = [torch.empty((b.shape[0], F), dtype=torch.uint8, pin_memory=dev.type == "cuda").copy_(
            apply_bins(torch.from_numpy(np.array(b)).to(dev), edges_t)) for b in blocks]
        fm = dimension_reduction_streamed(xb_blocks, ytr, wt, mcfg, u, device=dev)
        local, t_local = sync_time(lambda: api.grow_forest_streamed(xb_blocks, ytr, wt, mcfg, fm,
                                                                   device=dev))
        local.tree_weight = oob_accuracy_streamed(local, xb_blocks, ytr, wt)
        for name in fields:
            check(np.array_equal(getattr(local, name).cpu().numpy(), want[name]),
                  f"multi-process phase: {name} differs from the single-device streamed growth")
        world_forest = Forest(**{n: torch.from_numpy(want[n]).to(dev) for n in fields}, config=mcfg)
        acc = float(np.mean(PRFModel(world_forest, edges).predict(xte) == yte))
        check(acc >= 0.90, f"multi-process phase: test accuracy {acc} < 0.90")
        try:
            api.grow_forest_streamed(xb_blocks, ytr, wt, mcfg, fm, device=dev, resume_from=str(ckpt))
            raise AssertionError("multi-process phase: a world of one restored the 2-process checkpoint")
        except CheckpointTopologyError as e:
            refused = str(e)
        del x_mm, xb_blocks, local, world_forest

        per_rank = [{k_: v for k_, v in o.items() if k_ not in ("model", "replay", "resumed")}
                    for o in ranks]
        gib = lambda b: f"{(b or 0) / 2**30:.3f}"    # noqa: E731
        log(f"multi-process phase, parent before the world: RSS {gib(parent_rss['VmRSS'])} GiB, "
            f"ru_maxrss {gib(parent_rss['maxrss'])} GiB")
        for r, o in enumerate(per_rank):
            log(f"multi-process phase, rank {r}: RSS at entry {gib(o['rss_at_entry'])} GiB "
                f"(ru_maxrss {gib(o['maxrss_at_entry'])}), with the CUDA context "
                f"{gib(o['rss_with_context'])} GiB")
            for tag, m in o["host_memory"].items():
                b, a = m["before"], m["after"]
                log(f"multi-process phase, rank {r}, {tag}: RSS {gib(b.get('VmRSS'))} -> "
                    f"{gib(a.get('VmRSS'))} GiB, sampled peak {gib(m['sampled_peak'])} GiB "
                    f"({m['samples']} samples); pinned allocator "
                    f"{gib(a.get('pinned_allocated_bytes.current'))} GiB")
            log(f"multi-process phase, rank {r}, replay stages' RSS at the end / sampled peak (GiB): "
                + ", ".join(f"{st} {gib(m.get('VmRSS'))} / {gib(o['stage_sampled_peak'][st])}"
                            for st, m in o["stage_host_memory"].items())
                + f"; binned windows {gib(o['host_tensor_bytes'])} GiB, draws {gib(o['draws_bytes'])} "
                f"GiB, largest host-staged collective {gib(o['staged_bytes'])} GiB")
            log(f"multi-process phase, rank {r} ({o['runtime']}): train_prf {o['train_s']:.3f} s, staged "
                "replay stages (s) " + ", ".join(f"{k_} {v:.3f}" for k_, v in o["stages_s"].items())
                + f"; fed bytes {o['feed_bytes']}; killed run {o['killed_run_s']:.3f} s, resume from level "
                f"{o['first_resumed_level']} {o['resume_s']:.3f} s; launches {o['launches']}; sampled peak RSS "
                f"{o['peak_rss_bytes'] / 2**30:.3f} GiB against the file's {file_bytes / 2**30:.3f} GiB")
        log(f"multi-process phase: gloo world of 2 on {dev} (mesh (2, 1)), {N} x {F} rows from a memmap, "
            f"sample_block {nb}: both ranks' models bitwise equal, equal to their staged replays and "
            f"kill-at-level-{MP_KILL_AT} resumes; edges = the shard-ordered sketch merge ({t_sketch:.3f} s "
            f"here); forest = the single-device streamed growth on them ({t_local:.3f} s); accuracy "
            f"{acc:.7f}; a world of one refused the checkpoint ({refused[:80]}...); world {t_world:.1f} s")
        return {"ranks": per_rank, "parent_memory": parent_rss, "world_s": t_world, "accuracy": acc, "file_bytes": file_bytes,
                "sample_block": nb, "kill_at": MP_KILL_AT, "parent_sketch_s": t_sketch,
                "parent_streamed_growth_s": t_local}
    finally:
        shutil.rmtree(root, ignore_errors=True)


SERVE_SIZES = list(range(1, 34)) + [255, 256, 257, 1000, 1024, 1025, 4096]   # phase 5g's batches
SERVE_BUCKETS = (8, 64, 256, 1024)      # the buckets timed
SERVE_CALLS = 200                       # host-clock calls per timed bucket
SERVE_THREADS, SERVE_REQUESTS = 4, 64   # the thread drill: threads, requests a thread


def serving_phase(dev, model, model_b, xtr, ytr, xte, yte, cfg, prf, timings):
    """5g. Serving (``repro_torch.serving``) on phase 5's full-size model
    (32 trees, depth 8, F 128, C 4, ``"auto"``: the traversal kernel).

    (a) ``PRFService(model, max_batch=1024, min_bucket=8)`` answers each
        batch of ``SERVE_SIZES``, the traversal's launch count set to 0
        just before and read just after: one launch per bucket-chunk (and
        tree chunk); labels bitwise equal to ``model.predict`` of the same
        rows and to a ``backend="xla"`` service (the plain path, no launch);
    (b) buckets ``SERVE_BUCKETS``: the median host clock of
        ``SERVE_CALLS`` ``svc.predict`` calls (and their 90th percentile),
        CUDA events around 10 calls, the card's busy share of 20 calls
        (profiler), binning alone, the bucket's forward pass alone (binned
        rows in, labels out) and in it the traversal kernel and the node
        packing (profiler; and CUDA events around direct launches of the
        C entry point, its scores equal to the wrapper's); rows/s;
    (c) ``SERVE_THREADS`` threads submit ``SERVE_REQUESTS`` requests each
        of 1-32 rows (a seeded numpy generator), auto-draining as they go,
        then one drain: every future resolves to ``model.predict`` of its
        rows;
    (d) ``ModelRegistry`` hot-swap from phase 5's model to phase 5b's
        under a concurrent submitter: every future it got resolves,
        to one of the two models' labels for its rows;
    (e) the paper's baselines on phase 5's data and configuration:
        ``train_rf`` and ``train_mlrf_like(sample_budget=2000)``, time and
        test accuracy beside PRF's (``prf``), the histogram and the split
        scan launched by each.
    """
    import threading

    from repro_torch.core.baselines import train_mlrf_like, train_rf
    from repro_torch.core.binning import apply_bins
    from repro_torch.core.forest import fused_vote_scores
    from repro_torch.device import as_tensor
    from repro_torch.kernels import _build
    from repro_torch.kernels.gain_ratio import ops as hist_ops
    from repro_torch.kernels.split_scan import ops as scan_ops
    from repro_torch.kernels.tree_traverse import ops as trav_ops
    from repro_torch.serving import ModelRegistry, PRFService, ServiceClosedError

    res = {}
    svc = PRFService(model, max_batch=1024, min_bucket=8)
    k = model.forest.n_trees
    tree_chunks = -(-k // (cfg.tree_chunk if cfg.tree_chunk > 0 else k))

    # (a) the served batches
    trav_ops.launches = 0
    got, t_served = sync_time(lambda: [svc.predict(xte[:n]) for n in SERVE_SIZES])
    launches = trav_ops.launches
    want_launches = tree_chunks * sum(-(-n // 1024) for n in SERVE_SIZES)
    check(launches == want_launches,
          f"serving: {launches} traversal launches for {len(SERVE_SIZES)} batches, want {want_launches} "
          "(one a bucket-chunk)")
    svc_x = PRFService(model, max_batch=1024, min_bucket=8, backend="xla")
    n0 = trav_ops.launches
    plain = [svc_x.predict(xte[:n]) for n in SERVE_SIZES]
    check(trav_ops.launches == n0, "serving: the xla service launched the traversal")
    for n, g, p in zip(SERVE_SIZES, got, plain):
        check(np.array_equal(g, model.predict(xte[:n])), f"serving: {n} rows: labels != model.predict")
        check(np.array_equal(g, p), f"serving: {n} rows: labels != the xla service's")
    buckets = svc.stats()["buckets_compiled"]
    check(buckets == [8, 16, 32, 64, 256, 512, 1024], f"serving: buckets {buckets}")
    res.update(launches=launches, served_s=t_served, buckets=buckets, sizes=SERVE_SIZES)
    log(f"serving (a): {len(SERVE_SIZES)} batches of 1-33, 255-257, 1000, 1024, 1025, 4096 rows "
        f"({sum(SERVE_SIZES)} rows, {t_served:.3f} s): labels bitwise equal to model.predict and to the "
        f"xla service; {launches} traversal launches (one a bucket-chunk), buckets {buckets}")

    # (b) per-bucket times
    per_bucket = {}
    for b in SERVE_BUCKETS:
        xq = xte[:b]
        for _ in range(3):
            svc.predict(xq)
        secs = []
        for _ in range(SERVE_CALLS):
            t0 = time.perf_counter()
            svc.predict(xq)
            secs.append(time.perf_counter() - t0)
        med = float(np.median(secs))
        bins = []
        for _ in range(SERVE_CALLS):
            _, t = sync_time(lambda: apply_bins(as_tensor(xq, dev), svc._edges))
            bins.append(t)
        # the bucket's forward pass on device-resident bins (what a call runs
        # between binning and the copy out); the traversal and the node
        # packing inside it from the profiler (a trace of svc.predict calls
        # held 9 of 10 launches in every session of the first run)
        xb = apply_bins(as_tensor(xq, dev), svc._edges)
        valid = torch.ones(b, dtype=torch.bool, device=dev)
        fwd = cuda_ms(lambda: svc._bucket_predict(xb, valid))
        kern, sessions, held = device_ms(lambda: svc._bucket_predict(xb, valid), "traverse_kernel")
        pack = device_ms(lambda: svc._bucket_predict(xb, valid), "pack_nodes_kernel")[0]
        # the launch alone without the profiler (whose traces lose launches
        # late in this run): CUDA events around direct launches of the C
        # entry point (node packing + walk) on preallocated outputs
        fo, pay = svc._forest, svc._payload
        feat, thr, left = (getattr(fo, n).contiguous() for n in ("feature", "threshold", "left_child"))
        kt, P = feat.shape
        plan = trav_ops.traverse_plan(xb.shape[1])
        carry = torch.zeros((b, pay.shape[-1]), device=dev)
        scores = torch.empty_like(carry)
        packed = torch.empty((kt, P + (P & 1), 4 if plan["wide"] else 2), dtype=torch.int32, device=dev)

        def direct():
            _build.launch("prf_traverse", xb.data_ptr(), b, xb.shape[1], feat.data_ptr(), thr.data_ptr(),
                          left.data_ptr(), pay.data_ptr(), carry.data_ptr(), scores.data_ptr(),
                          packed.data_ptr(), kt, P, pay.shape[-1], fo.config.max_depth, plan["Fs"],
                          plan["TN"], plan["smem_bytes"], int(plan["wide"]))

        direct_ms = cuda_ms(direct)
        check(torch.equal(scores, fused_vote_scores(fo, xb, pay)),
              f"serving (b), bucket {b}: the direct launch's scores != the wrapper's")
        busy = device_busy_share(lambda: [svc.predict(xq) for _ in range(20)])
        per_bucket[b] = {"call_ms_median": med * 1e3, "call_ms_p90": float(np.percentile(secs, 90)) * 1e3,
                         "call_ms_events": cuda_ms(lambda: svc.predict(xq)), "traverse_kernel_ms": kern,
                         "traverse_launches_per_trace": held, "pack_kernel_ms": pack,
                         "traverse_direct_ms": direct_ms,
                         "binning_ms_median": float(np.median(bins)) * 1e3, "forward_ms": fwd,
                         "device_busy_share": busy, "rows_per_s": b / med}
        log(f"serving (b), bucket {b}: svc.predict median {med * 1e3:.4f} ms over {SERVE_CALLS} calls (p90 "
            f"{per_bucket[b]['call_ms_p90']:.4f}), CUDA events {per_bucket[b]['call_ms_events']:.4f} ms, the "
            f"card busy {'not measured' if busy is None else f'{busy:.3f}'} of it; binning "
            f"{per_bucket[b]['binning_ms_median']:.4f} ms; forward pass {fwd:.4f} ms, of it the traversal "
            f"kernel {fmt_ms(kern)} ms + node packing {fmt_ms(pack)} ms (direct launches, both: "
            f"{direct_ms:.4f} ms); {b / med:,.0f} rows/s")
    res["per_bucket"] = per_bucket
    timings["serving"] = per_bucket

    # (c) the thread drill
    svc_t = PRFService(model, max_batch=1024, min_bucket=8)
    rng = np.random.default_rng(20)
    plans = [[(int(o), int(n)) for o, n in zip(rng.integers(0, len(xte) - 32, SERVE_REQUESTS),
                                               rng.integers(1, 33, SERVE_REQUESTS))]
             for _ in range(SERVE_THREADS)]
    futures = [[] for _ in plans]
    errors = []

    def client(i):
        try:
            for o, n in plans[i]:
                futures[i].append((o, n, svc_t.submit(xte[o:o + n])))
        except Exception as e:          # noqa: BLE001 - reported below
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(SERVE_THREADS)]
    _, t_drill = sync_time(lambda: ([t.start() for t in threads], [t.join(timeout=120) for t in threads]))
    check(not errors and not any(t.is_alive() for t in threads), f"serving (c): threads failed {errors}")
    svc_t.drain()
    n_futs = sum(len(f) for f in futures)
    check(n_futs == SERVE_THREADS * SERVE_REQUESTS, f"serving (c): {n_futs} futures")
    for fl in futures:
        for o, n, fut in fl:
            check(fut.done() and fut.exception() is None, f"serving (c): a future of rows {o}:{o + n} unresolved")
            check(np.array_equal(fut.result(), model.predict(xte[o:o + n])),
                  f"serving (c): rows {o}:{o + n}: labels != model.predict")
    res["thread_drill"] = {"threads": SERVE_THREADS, "requests": n_futs, "s": t_drill,
                           "served": svc_t.stats()["requests_served"]}
    log(f"serving (c): {SERVE_THREADS} threads x {SERVE_REQUESTS} requests of 1-32 rows ({t_drill:.3f} s): "
        f"every future resolved to model.predict of its rows")

    # (d) the registry's hot-swap under a concurrent submitter
    reg = ModelRegistry(max_batch=1024, min_bucket=8)
    reg.publish(model)
    span = min(4096, len(xte) - 2)
    want_a, want_b = model.predict(xte[:span + 2]), model_b.predict(xte[:span + 2])
    futs, stop, raced = [], threading.Event(), [0]

    def submitter():
        i = 0
        try:
            while not stop.is_set():
                o = (2 * i) % span
                try:
                    futs.append((o, reg.submit(xte[o:o + 2])))
                except ServiceClosedError:
                    raced[0] += 1
                i += 1
        except Exception as e:          # noqa: BLE001 - reported below
            errors.append(repr(e))

    t = threading.Thread(target=submitter)
    t.start()
    time.sleep(0.2)
    version = reg.publish(model_b)
    time.sleep(0.2)
    stop.set()
    t.join(timeout=60)
    check(not t.is_alive() and not errors, f"serving (d): the submitter failed or did not stop {errors}")
    reg.drain()
    by = {"old": 0, "new": 0, "either": 0}          # "either": the two models agree on the rows
    for o, fut in futs:
        check(fut.done() and fut.exception() is None, "serving (d): the hot-swap dropped a future")
        r = fut.result()
        old, new = np.array_equal(r, want_a[o:o + 2]), np.array_equal(r, want_b[o:o + 2])
        check(old or new, f"serving (d): rows {o}:{o + 2} answered by neither model")
        by["either" if old and new else "old" if old else "new"] += 1
    reg.shutdown()
    res["hot_swap"] = {"futures": len(futs), "raced_the_flip": raced[0], "version": version,
                       "answered_like": by}
    log(f"serving (d): hot-swap to version {version} under a concurrent submitter: {len(futs)} futures, "
        f"every one resolved ({by} by labels), {raced[0]} submits raced the flip (typed)")

    # (e) the paper's baselines on phase 5's data
    base = {"prf": prf}
    for name, fn in (("rf", lambda: train_rf(xtr, ytr, cfg, 0, device=dev)),
                     ("mlrf_like", lambda: train_mlrf_like(xtr, ytr, cfg, 0, sample_budget=2000,
                                                           device=dev))):
        hist_ops.launches = scan_ops.launches = 0
        m, t_train = sync_time(fn)
        counts = {"gain_ratio_hist": hist_ops.launches, "split_scan": scan_ops.launches}
        for kname, c in counts.items():
            check(c > 0, f"serving (e): {name}: {kname} was not launched")
        base[name] = {"train_s": t_train, "accuracy": m.accuracy(xte, yte), "launches": counts}
        del m
    res["baselines"] = base
    log(f"serving (e), test accuracy and training time on phase 5's data: PRF {prf['accuracy']:.7f} "
        f"({prf['train_s']:.3f} s train + predict), RF {base['rf']['accuracy']:.7f} "
        f"({base['rf']['train_s']:.3f} s), MLRF-like (budget 2000) {base['mlrf_like']['accuracy']:.7f} "
        f"({base['mlrf_like']['train_s']:.3f} s)")
    return res


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
    every instantiation of flash_tc_kernel (5), ssd_tc_kernel (8), the
    attention backward's bwd_dkdv_dq_tc_kernel (5) and the SSD backward's
    ssd_bwd_state_tc_kernel and ssd_bwd_chunk_tc_kernel (8 each, one
    listing); the listings go to ``artifacts/{name}.sass``. Returns HGMMA
    lines per instantiation, per listing."""
    from repro_torch.kernels import _build

    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(_build.BUILD_DIR / _build.LIB_NAME)],
                          capture_output=True, text=True, check=True, timeout=300).stdout
    out_dir = ROOT / "artifacts"
    out_dir.mkdir(exist_ok=True)
    counts = {}
    for kernel, names, n_inst, show in (
            ("flash_tc_kernel", ("flash_tc_kernel",), 5, "ILi64E"),
            ("ssd_tc_kernel", ("ssd_tc_kernel",), 8, "ILi64ELi128E"),
            ("bwd_dkdv_dq_tc_kernel", ("bwd_dkdv_dq_tc_kernel",), 5, "ILi64E"),
            ("ssd_bwd_tc_kernel", ("ssd_bwd_state_tc_kernel", "ssd_bwd_chunk_tc_kernel"), 16, None)):
        funcs = {blk.split("\n", 1)[0].strip(): blk for blk in sass.split("Function : ")[1:]
                 if any(n in blk.split("\n", 1)[0] for n in names)}
        check(len(funcs) == n_inst, f"want {n_inst} instantiations of {kernel} in the SASS, found {list(funcs)}")
        (out_dir / f"{kernel}.sass").write_text("".join(f"Function : {b}" for b in funcs.values()))
        hgmma = {}
        for name, blk in funcs.items():
            lines = [ln.strip() for ln in blk.splitlines() if "HGMMA" in ln]
            check(lines, f"{name}: no HGMMA in its SASS")
            hgmma[name] = len(lines)
        if show:
            main = next(blk for name, blk in funcs.items() if show in name)
            log(f"cuobjdump -sass, {kernel} ({show}), its HGMMA lines:\n" +
                "\n".join(ln.strip() for ln in main.splitlines() if "HGMMA" in ln))
        log(f"{kernel}: HGMMA instructions per instantiation: {hgmma}")
        counts[kernel] = hgmma
    return counts


# Phase 8: the LM mesh glue. 8a: the attention kernels at a query offset: one
# shard of smollm-135m's training microbatch on a 16-wide "model" axis, q
# (B, Lq, H, KV, D), against k / v of the whole sequence, at the first, a middle
# and the last shard's offsets; causal, then hymba's mask (k / v the meta prefix
# longer, each offset with it).
MESH_Q = (TRAIN_BATCH // TRAIN_MICRO, TRAIN_SEQ // 16, 9, 3, 64)
MESH_OFFSETS = (0, 896, 1920)
MESH_MASKS = {"causal": (0, 0), "window 1024, prefix 64 (hymba's mask)": (1024, 64)}
MESH_TIMED = ("causal", 896)                     # the shard timed beside its bound
MESH_STEPS = 3                                   # 8b: sharded steps against make_train_step's
DRYRUN_LIMIT_S = 900                             # 8c: wall-clock limit of one dry-run cell
DRYRUN_OUT = ROOT / "artifacts" / "dryrun_torch"
# 8c: every LM cell on 16 x 16 and the eight dense, SSM and multimodal configs' train_4k on 2 x 16 x 16,
# but DRYRUN_LEFT_OUT: the slowest serving cells to count (on the host, 38-161 s each), so that the pool
# ends about when phase 8 does; those, the MoE configs' train_4k on 2 x 16 x 16 and the other serving
# cells on 2 x 16 x 16 run through the CLI in a call of their own
DRYRUN_LEFT_OUT = tuple((a, "prefill_32k") for a in (
    "llama-3.2-vision-90b", "deepseek-v3-671b", "gemma3-27b", "gemma3-12b", "hymba-1.5b", "mamba2-780m",
    "qwen1.5-4b"))
DRYRUN_MULTI = ("smollm-135m", "mamba2-780m", "hymba-1.5b", "qwen1.5-4b", "gemma3-12b", "gemma3-27b",
                "whisper-large-v3", "llama-3.2-vision-90b")


def dryrun_jobs():
    """8c's (arch, shape, mesh) cells, the slower shapes first (prefill, then
    train), so that the pool's last cells are short."""
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch.dryrun import TRAIN_ARCHS

    jobs = [(a, sh, "single") for a in TRAIN_ARCHS for sh in SHAPES if (a, sh) not in DRYRUN_LEFT_OUT]
    jobs += [(a, "train_4k", "multi") for a in DRYRUN_MULTI]
    order = ("prefill_32k", "train_4k", "decode_32k", "long_500k")
    return sorted(jobs, key=lambda j: order.index(j[1]))


def mesh_offset_checks(dev, timings):
    """8a: ``flash_attention_lse`` and ``flash_attention_bwd`` at ``MESH_OFFSETS``
    against ``gqa_attend_lse`` and ``attention_bwd_ref`` with that
    ``MaskSpec`` offset, per element at LM_TOL (lse at f32's), bf16 (the
    tensor cores) and f32, two calls bitwise equal; then the forward and the
    backward at ``MESH_TIMED`` timed beside their bounds (their visible pairs
    at that offset)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import MaskSpec, attention_bwd_ref, gqa_attend_lse

    B, Lq, H, KV, D = MESH_Q
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    worst, out_rows = {}, {}
    for label, (W, P) in MESH_MASKS.items():
        Lk = TRAIN_SEQ + P
        for dtype in (torch.bfloat16, torch.float32):
            q, do = (_randn(gen, (B, Lq, H, D), dev, dtype) for _ in range(2))
            k, v = (_randn(gen, (B, Lk, KV, D), dev, dtype) for _ in range(2))
            for off0 in MESH_OFFSETS:
                off = off0 + P
                what = f"attention at query offset {off} ({label}), {dtype}"
                spec = MaskSpec(True, W, off, P)
                kw = dict(causal=True, window=W, prefix=P, offset=off)
                n0 = (flash_ops.launches, flash_ops.launches_bwd)
                out, lse = flash_ops.flash_attention_lse(q, k, v, **kw)
                want_out, want_lse = gqa_attend_lse(q, k, v, mask_spec=spec)
                share = max(lm_close(out, want_out, dtype, what + " out")[1],
                            lm_close(lse, want_lse, torch.float32, what + " lse")[1])
                got = flash_ops.flash_attention_bwd(q, k, v, out, lse, do, **kw)
                want = attention_bwd_ref(q, k, v, out, lse, do, spec)
                for name, g, w in zip(("dq", "dk", "dv"), got, want):
                    share = max(share, lm_close(g, w, dtype, f"{what}: {name}")[1])
                out2, lse2 = flash_ops.flash_attention_lse(q, k, v, **kw)
                again = flash_ops.flash_attention_bwd(q, k, v, out, lse, do, **kw)
                check(torch.equal(out, out2) and torch.equal(lse, lse2)
                      and all(torch.equal(a, b) for a, b in zip(got, again)), f"{what}: two calls differ")
                check((flash_ops.launches, flash_ops.launches_bwd) == (n0[0] + 2, n0[1] + 2),
                      f"{what}: launches {flash_ops.launches}, {flash_ops.launches_bwd}")
                worst[f"{label} {dtype}"] = max(worst.get(f"{label} {dtype}", 0.0), share)
                if (label, off0) == MESH_TIMED and dtype == torch.bfloat16:
                    fwd = lambda: flash_ops.flash_attention_lse(q, k, v, **kw)          # noqa: E731
                    bwd = lambda: flash_ops.flash_attention_bwd(q, k, v, out, lse, do, **kw)  # noqa: E731
                    # SDPA on the same function: the shard's queries under an explicit mask at the offset
                    mask = spec.block(0, Lq, Lk, dev)[None]
                    qt, kt, vt = (a.transpose(1, 2).detach().requires_grad_(True) for a in (q, k, v))
                    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True)  # noqa: E731
                    o_lib = sdpa()
                    lib_bwd = lambda: torch.autograd.grad(o_lib, (qt, kt, vt), do.transpose(1, 2),  # noqa: E731
                                                          retain_graph=True)
                    lib_err = {"fwd": max_abs(o_lib.detach().transpose(1, 2), out),
                               "bwd": max(max_abs(a.transpose(1, 2), b) for a, b in zip(lib_bwd(), got))}
                    pairs = visible_pairs(Lq, Lk, W, P, offset=off)
                    io = 2 * (B * Lq * H * D + B * Lk * KV * D)             # bf16 q, o; k, v
                    rows = {"fwd": (cuda_ms(fwd), cuda_ms(sdpa), io + 4 * B * H * Lq, 4 * D * B * H * pairs),
                            "bwd": (cuda_ms(bwd), cuda_ms(lib_bwd), 2 * io + 4 * B * H * Lq, 10 * D * B * H * pairs)}
                    for part, (ms, lib_ms, nbytes, nops) in rows.items():
                        bound = max(nbytes / HBM_BYTES_PER_S, nops / BF16_OPS_PER_S) * 1e3
                        out_rows[part] = {"ms": ms, "bound_ms": bound, "bytes": nbytes, "ops": nops,
                                          "pairs": pairs, "offset": off, "library_ms": lib_ms,
                                          "library_vs_kernel_max_abs": lib_err[part]}
                        log(f"attention {part} at query offset {off} ([{B}, {Lq} of {Lk}, {H} H / {KV} KV, {D}], "
                            f"bf16, causal): {ms:.4f} ms, bound {bound:.4f} ms (share {bound / ms:.3f}; {pairs} "
                            f"visible pairs); SDPA with the offset's mask {lib_ms:.4f} ms (max |d| vs the kernel "
                            f"{lib_err[part]:.3g})")
                    del qt, kt, vt, o_lib
                del out, lse, got, want, again, out2, lse2, want_out, want_lse
            del q, do, k, v
            torch.cuda.empty_cache()
    log(f"8a: the attention kernels at query offsets {MESH_OFFSETS} (+ prefix) within LM_TOL, bitwise run to run; "
        f"largest share of the allowance {worst}")
    return {"worst_share": worst, "timed": out_rows}


def mesh_train(dev, smollm_7c):
    """8b: ``make_sharded_train_step`` in an NCCL world of one on the card
    (``make_mesh((1, 1))``): smollm-135m as 7c (full width and depth, f32
    params, batch 8 x 2048 in 2 microbatches), ``MESH_STEPS`` steps from
    ``make_train_step``'s initial state; losses and every gathered leaf
    against ``make_train_step``'s within 1e-2 of the scale (bitwise
    reported), the attention kernels launched as often a step as in 7c,
    s/step and peak beside 7c's."""
    import shutil

    import torch.distributed as tdist

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.launch.mesh import init_rank, make_mesh
    from repro_torch.models import build_model
    from repro_torch.training import AdamWConfig, init_state, make_sharded_train_step, make_train_step
    from repro_torch.training.sharding import gather

    store = ROOT / "build" / "mesh_world_of_one"
    shutil.rmtree(store, ignore_errors=True)
    store.mkdir(parents=True)
    init_rank(0, 1, f"file://{store / 'store'}", "nccl")
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device=dev)
        cfg = get_config("smollm-135m")
        opt = AdamWConfig(lr=1e-3, warmup_steps=2, decay_steps=100)
        pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ, n_docs=512, seed=0)
        batches = [{k: torch.from_numpy(v).to(dev) for k, v in b.items()}
                   for b in pipe.batches(TRAIN_BATCH, MESH_STEPS, n_micro=TRAIN_MICRO)]
        model = build_model(cfg, dev, seed=0)
        state0 = init_state(model, opt)
        step = make_train_step(model, opt)
        want, want_losses = state0, []
        for b in batches:
            want, m = step(want, b)
            want_losses.append(float(m["loss"]))
        del model, step
        smodel = build_model(cfg, dev, mesh=mesh, seed=0)
        smodel.requires_grad_(True)
        sstep, shardings, _ = make_sharded_train_step(smodel, opt, mesh, donate=False)
        for n in ("launches", "launches_bf16", "launches_f32", *BWD_COUNTERS):
            setattr(flash_ops, n, 0)
        torch.cuda.reset_peak_memory_stats()
        state, losses, step_s = state0, [], []
        for b in batches:
            (state, m), t = sync_time(lambda: sstep(state, b))
            loss = m["loss"].full_tensor() if hasattr(m["loss"], "full_tensor") else m["loss"]
            losses.append(float(loss))
            step_s.append(t)
        peak = torch.cuda.max_memory_allocated()
        launches = {"fwd_bf16": flash_ops.launches_bf16, "fwd_f32": flash_ops.launches_f32,
                    "bwd_bf16": flash_ops.launches_bwd_bf16, "bwd_tc": flash_ops.launches_bwd_tc,
                    "bwd_f32": flash_ops.launches_bwd_f32}
        fwd, bwd = train_attention_launches(cfg)
        n_calls = MESH_STEPS * TRAIN_MICRO
        per_step_7c = {k: v * MESH_STEPS // TRAIN_STEPS for k, v in smollm_7c["launches"].items()
                       if k in launches}
        check(launches == {"fwd_bf16": fwd * n_calls, "fwd_f32": 0, "bwd_bf16": bwd * n_calls,
                           "bwd_tc": bwd * n_calls, "bwd_f32": 0} and launches == per_step_7c,
              f"8b: attention launches {launches}, want {fwd * n_calls} forward and {bwd * n_calls} backward, "
              f"all bf16 on the kernels, as 7c's {per_step_7c}")
        got = gather(state.params)
        gm, gv = gather(state.opt["m"]), gather(state.opt["v"])
        leaves = {}
        for n in want.params:
            leaves[n] = max(drift(got[n], want.params[n]), drift(gm[n], want.opt["m"][n]),
                            drift(gv[n], want.opt["v"][n]))
        worst = max(leaves, key=leaves.get)
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, want_losses))
        bitwise = losses == want_losses and all(
            torch.equal(got[n], want.params[n]) and torch.equal(gm[n], want.opt["m"][n])
            and torch.equal(gv[n], want.opt["v"][n]) for n in want.params)
        check(loss_rel <= 1e-2 and leaves[worst] <= 1e-2,
              f"8b: sharded vs make_train_step: losses {losses} / {want_losses}, worst leaf {worst} {leaves[worst]:.3g}")
        steady = float(np.mean(step_s[1:]))
        log(f"8b: make_sharded_train_step on make_mesh((1, 1)) (NCCL world of one), smollm-135m as 7c, "
            f"{MESH_STEPS} steps: losses {losses} vs make_train_step's {want_losses} (max rel {loss_rel:.3g}), "
            f"worst leaf {worst} {leaves[worst]:.3g}, bitwise {bitwise}; s/step {[round(x, 4) for x in step_s]}, "
            f"steady {steady:.4f} (7c: {smollm_7c['steady_s_per_step']:.4f}), peak {peak / 2**30:.2f} GiB (7c: "
            f"{smollm_7c['peak_bytes'] / 2**30:.2f}); attention launches {launches}")
        result = {"losses": losses, "want_losses": want_losses, "loss_rel": loss_rel, "worst_leaf": worst,
                  "worst_leaf_drift": leaves[worst], "bitwise": bitwise, "step_s": step_s,
                  "steady_s_per_step": steady, "peak_bytes": peak, "launches": launches,
                  "placements": {n: [str(p) for p in pl] for n, pl in list(shardings.params.items())[:4]},
                  "7c_steady_s_per_step": smollm_7c["steady_s_per_step"], "7c_peak_bytes": smollm_7c["peak_bytes"]}
        del smodel, sstep, state, state0, want, got, gm, gv
        torch.cuda.empty_cache()
        return result
    finally:
        tdist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)


class DryRunPool:
    """8c: the dry run's LM cells (``launch/dryrun.py``: ``jobs``, each an
    (arch, shape, mesh), the mesh "single" for 16 x 16 or "multi" for
    2 x 16 x 16), each cell a process of its own (``python -m repro_torch.launch.dryrun``, no card:
    ``CUDA_VISIBLE_DEVICES`` empty, one thread, ``nice`` 10), ``workers`` at
    a time (half the host's cores by default), started early so they run
    beside phases 3-7 on the host's spare cores; each cell has a wall-clock
    limit, and every process is killed by ``kill`` (also at exit)."""

    def __init__(self, jobs, workers=None):
        import atexit
        import os
        import threading

        workers = workers or max(1, (os.cpu_count() or 2) // 2)
        self.jobs = list(jobs)
        self.workers, self.procs, self.done = workers, {}, {}
        self.env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
        self.t0 = time.perf_counter()
        self._stop = False
        self._thread = threading.Thread(target=self._run, daemon=True)
        atexit.register(self.kill)
        self._thread.start()

    def _run(self):
        import os

        pending = list(self.jobs)
        while (pending or self.procs) and not self._stop:
            while pending and len(self.procs) < self.workers:
                arch, shape, m = pending.pop(0)
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
                       "--mesh", m, "--out", str(DRYRUN_OUT)]
                proc = subprocess.Popen(cmd, env=self.env, cwd=str(ROOT), stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True, preexec_fn=lambda: os.nice(10))
                self.procs[(arch, shape, m)] = (proc, time.perf_counter())
            for key, (proc, t) in list(self.procs.items()):
                if proc.poll() is None and time.perf_counter() - t < DRYRUN_LIMIT_S:
                    continue
                timed_out = proc.poll() is None
                if timed_out:
                    proc.kill()
                out, err = proc.communicate()
                self.done[key] = {"rc": None if timed_out else proc.returncode, "wall_s": time.perf_counter() - t,
                                  "stdout": out, "stderr": err[-3000:], "timed_out": timed_out}
                del self.procs[key]
            time.sleep(0.5)

    def results(self, timeout_s):
        self._thread.join(timeout_s)
        check(not self._thread.is_alive(), f"8c: the dry run did not finish within {timeout_s} s more "
              f"({len(self.done)} of {len(self.jobs)} cells done)")
        return self.done, time.perf_counter() - self.t0

    def kill(self):
        self._stop = True
        for proc, _ in list(self.procs.values()):
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def mesh_dryrun(pool):
    """8c: every cell of ``pool`` must reach OK (``long_500k`` of a config that
    is not sub-quadratic: ``SKIP(full-attn)``): its wall time, FLOPs, bytes,
    collective counts and bytes and peak memory per device, ``fits_hbm``
    and the roofline terms, from the JSON each cell writes under
    ``artifacts/dryrun_torch``."""
    from repro_torch.configs import get_config

    done, wall = pool.results(DRYRUN_LIMIT_S)
    cells, skipped = {}, []
    for (arch, shape, m), r in sorted(done.items()):
        mesh_name = "2x16x16" if m == "multi" else "16x16"
        path = DRYRUN_OUT / f"{arch}__{shape}__{mesh_name}.json"
        cell = json.loads(path.read_text()) if path.exists() else {"status": "no result"}
        want = "SKIP(full-attn)" if shape == "long_500k" and not get_config(arch).sub_quadratic else "OK"
        check(r["rc"] == 0 and cell.get("status") == want,
              f"8c: {arch} {shape} on {mesh_name}: rc {r['rc']} (timed out {r['timed_out']}), status "
              f"{cell.get('status')}, want {want}; {cell.get('traceback', '')[-1500:]} {r['stderr'][-1500:]}")
        if want != "OK":
            skipped.append(f"{arch} {shape} {mesh_name}")
            continue
        cell["process_s"] = r["wall_s"]
        cells[f"{arch} {shape} {mesh_name}"] = cell
        log(f"8c: {arch:22s} {shape:11s} {mesh_name:8s} OK in {r['wall_s']:.1f} s (cell {cell['wall_s']} s): flops/dev "
            f"{cell['flops_per_device']:.4e}, bytes/dev {cell['bytes_per_device']:.4e}, collectives "
            + ", ".join(f"{k} {v['count']} x {v['operand_bytes']:.4e} B" for k, v in sorted(cell["collectives"].items()))
            + f" (wire {cell['collective_bytes']:.4e} B), peak {cell['hbm_per_device_gb']:.3f} GiB, fits_hbm "
            f"{cell['fits_hbm']}; compute {cell['compute_s']:.4f} s, memory {cell['memory_s']:.4f} s, collective "
            f"{cell['collective_s']:.4f} s, dominant {cell['dominant']}, useful {cell['useful_flops_ratio']:.3f}, "
            f"roofline fraction {cell['roofline_fraction']:.4f}")
    log(f"8c: {len(cells)} dry-run cells OK and {len(skipped)} SKIP(full-attn), {wall:.1f} s from the pool's "
        f"start ({pool.workers} workers)")
    return {"cells": cells, "skipped": skipped, "pool_s": wall, "workers": pool.workers}


# 8d: serving on an NCCL world of one through make_serve_fns: (arch, layers run or
# None for all, tokens, the flash_decode settings run), at phase 6's cuts.
MESH_SERVE = (("smollm-135m", None, LM_GEN, (False, True)),
              ("deepseek-moe-16b", 4, 8, (False,)),
              ("hymba-1.5b", None, 8, (False,)))
PRF_CELL_LIMIT_S = 600                           # 8e: wall-clock limit of the PRF cells' process


def _serve_loop(prefill, decode, prompts, extras, T, full=lambda t: t):
    """Prefill, then T - 1 greedy decode steps: (tokens [B, T], logits per
    step, prefill s, decode s)."""
    (logits, caches), t_pre = sync_time(lambda: prefill(prompts, extras))
    out = [full(logits)]
    toks = [out[0].argmax(-1)]

    def run():
        nonlocal caches
        for i in range(T - 1):
            lg, caches = decode(caches, toks[-1], prompts.shape[1] + i)
            out.append(full(lg))
            toks.append(out[-1].argmax(-1))

    _, t_dec = sync_time(run)
    return torch.stack(toks, 1).to(torch.int32), out, t_pre, t_dec


def lse_combine_checks(dev):
    """8d: flash decoding's LSE combine over several length shards, which a
    world of one never holds: smollm-135m's decode query [8, 1, 9, 64] over
    k / v [8, 2080, 3, 64] at position 2079 (and 1000: the later shards all
    masked), cut by hand into 16 even shards (the production ``model``
    axis) and 3 uneven ones, each shard's softmax and lse
    (``layers.lse_part``), the max and ``lse_weigh`` summed over shards,
    ``lse_finish``; against ``grouped_attend_one`` at LM_TOL, bf16 and f32.
    Returns the worst share of the allowance per case."""
    from repro_torch.models.layers import (
        MASKED, _grouped_scores, _grouped_weigh, decode_mask, grouped_attend_one, lse_finish, lse_part, lse_weigh,
    )

    B, L, H, KV, hd = LM_BATCH, LM_PROMPT + LM_GEN, 9, 3, 64
    gen = torch.Generator(device=dev).manual_seed(5)
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        q = _randn(gen, (B, 1, H, hd), dev, dtype)
        k, v = (_randn(gen, (B, L, KV, hd), dev, dtype) for _ in range(2))
        for cut, bounds in (("16 even", [i * L // 16 for i in range(17)]), ("3 uneven", [0, 700, 1500, L])):
            for pos in (L - 1, 1000):
                parts = []
                for a, b in zip(bounds[:-1], bounds[1:]):
                    lg = _grouped_scores(q, k[:, a:b], v[:, a:b])
                    lg = torch.where(torch.arange(a, b, device=dev) <= pos, lg, MASKED)
                    parts.append(lse_part(lg, _grouped_weigh(torch.softmax(lg, dim=-1), k[:, a:b], v[:, a:b])))
                m = torch.stack([lse for _, lse in parts]).amax(0)
                got = lse_finish(sum(lse_weigh(o, m) for o, _ in parts), dtype)
                want = grouped_attend_one(q, k, v, mask=decode_mask(pos, L, 0, dev))
                what = f"8d: the LSE combine over {cut} length shards, {str(dtype)[6:]}, position {pos}"
                out[f"{cut}, {str(dtype)[6:]}, pos {pos}"] = lm_close(got.float(), want.float(), dtype, what)[1]
    log("8d: the LSE combine over 16 / 3 length shards against grouped_attend_one, worst share of LM_TOL "
        + ", ".join(f"{k} {v:.3f}" for k, v in out.items()))
    return out


def mesh_serving(dev, lm_phase6=None):
    """8d: ``serving.make_serve_fns`` on an NCCL world of one
    (``make_mesh((1, 1))``), bf16, batch 8, prompt 2048, for ``MESH_SERVE``:
    the same weights and prompts as phase 6 through ``greedy_generate`` on one
    device first (its tokens, logits and times), then the model's parameters
    placed on the mesh and the meshed prefill and decode (caches placed by
    ``cache_specs``, their length over ``model``; under ``flash_decode`` the
    LSE combine, which over one length shard is the plain softmax bit for
    bit). Checks: greedy tokens identical to the one-device run (and to phase
    6's when it ran); every step's logits bitwise the one-device run's (so
    within LM_TOL); attention and SSD kernel launches a prefill as phase 6
    counts them; 2 ``all_to_all`` calls a MoE layer a step (deepseek-moe-16b
    runs ``ep_mode="shard_map"``); prefill s, decode ms/token and peak memory
    beside the one-device run's. First ``lse_combine_checks``: the combine
    over 16 and 3 length shards, cut by hand."""
    import shutil

    import torch.distributed as tdist

    from repro_torch.configs import get_config
    from repro_torch.configs.base import _layer_kinds
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.launch.mesh import init_rank, make_mesh
    from repro_torch.models import build_model
    from repro_torch.serving import greedy_generate, make_serve_fns

    phase6 = {r["arch"]: r for r in lm_phase6 or ()}
    store = ROOT / "build" / "serve_world_of_one"
    shutil.rmtree(store, ignore_errors=True)
    store.mkdir(parents=True)
    init_rank(0, 1, f"file://{store / 'store'}", "nccl")
    results = {"lse_combine": lse_combine_checks(dev)}
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device=dev)
        for arch, depth, T, variants in MESH_SERVE:
            cfg = get_config(arch)
            if depth:
                cfg = dataclasses.replace(cfg, n_layers=depth)
            kinds = _layer_kinds(cfg)
            want = {"flash_attention": attention_launches(kinds, cfg.use_mla),
                    "ssd_scan": sum(k in ("ssm", "hybrid") for k in kinds)}
            n_moe = sum(k == "moe" for k in kinds) if cfg.ep_mode == "shard_map" else 0
            B, L = LM_BATCH, LM_PROMPT
            s_max = L + T
            model = build_model(cfg, dev, seed=0)
            gen = torch.Generator(device=dev)
            gen.manual_seed(1)                   # phase 6's prompts
            prompts = torch.randint(0, cfg.vocab_size, (B, L), generator=gen, device=dev)
            extras = lm_extras(cfg, B, dev, gen)
            one = (lambda t, e: model.prefill(t, e, s_max=s_max)), model.decode_step
            greedy_generate(model, prompts[:, :128], extras, steps=2, s_max=130)      # warm-up
            ref_toks = greedy_generate(model, prompts, extras, steps=T, s_max=s_max)
            torch.cuda.reset_peak_memory_stats()
            toks1, logits1, pre1, dec1 = _serve_loop(*one, prompts, extras, T)
            peak1 = torch.cuda.max_memory_allocated()
            check(torch.equal(toks1, ref_toks), f"8d {arch}: the one-device loop's tokens differ from greedy_generate's")
            if arch in phase6 and "tokens" in phase6[arch]:
                check(ref_toks.tolist() == phase6[arch]["tokens"], f"8d {arch}: tokens differ from phase 6's")
            prefill, decode, shardings = make_serve_fns(model, mesh, s_max=s_max)
            prefill(prompts[:, :128], extras)                                        # warm-up
            res = {"layers": cfg.n_layers, "tokens": T, "one_device": {
                "prefill_s": pre1, "decode_ms_per_token": dec1 / (T - 1) * 1e3, "peak_bytes": peak1}}
            full = lambda t: t.full_tensor()                                          # noqa: E731
            for flash in variants:
                model.cfg = dataclasses.replace(cfg, flash_decode=flash)
                for ops in (flash_ops, ssd_ops):
                    ops.launches = ops.launches_bf16 = ops.launches_f32 = 0
                a2a0 = mesh.all_to_all_calls
                (_, caches), _ = sync_time(lambda: prefill(prompts, extras))
                per_prefill = {"flash_attention": flash_ops.launches_bf16, "ssd_scan": ssd_ops.launches_bf16}
                a2a_prefill = mesh.all_to_all_calls - a2a0
                pl = {n: [str(q) for q in t.placements] for n, t in _leaves(caches[0])}
                del caches
                torch.cuda.reset_peak_memory_stats()
                a2a0 = mesh.all_to_all_calls
                toks, logits, pre, dec = _serve_loop(prefill, decode, prompts, extras, T, full=full)
                peak = torch.cuda.max_memory_allocated()
                a2a_steps = mesh.all_to_all_calls - a2a0 - a2a_prefill
                shares = [lm_close(g, w, torch.bfloat16, f"8d {arch} flash_decode={flash}: step {i} logits")[1]
                          for i, (g, w) in enumerate(zip(logits, logits1))]
                bitwise = all(torch.equal(g, w) for g, w in zip(logits, logits1))
                check(torch.equal(toks, ref_toks), f"8d {arch} flash_decode={flash}: meshed tokens differ from "
                      f"greedy_generate's (first rows {toks[:2].tolist()} vs {ref_toks[:2].tolist()})")
                check(bitwise, f"8d {arch} flash_decode={flash}: the meshed logits are not bitwise the one-device "
                      f"run's (largest share of LM_TOL {max(shares):.3g})")
                check(per_prefill == want, f"8d {arch}: kernel launches a meshed prefill {per_prefill}, want {want}")
                check(a2a_prefill == 2 * n_moe and a2a_steps == 2 * n_moe * (T - 1),
                      f"8d {arch}: all_to_all calls {a2a_prefill} in prefill, {a2a_steps} in {T - 1} steps; want "
                      f"{2 * n_moe} and {2 * n_moe * (T - 1)}")
                key = f"flash_decode={flash}"
                res[key] = {"prefill_s": pre, "decode_ms_per_token": dec / (T - 1) * 1e3, "peak_bytes": peak,
                            "launches_per_prefill": per_prefill, "all_to_all_prefill": a2a_prefill,
                            "all_to_all_per_step": a2a_steps / (T - 1), "logits_worst_share": max(shares),
                            "logits_bitwise": bitwise,
                            "cache_placements_layer0": pl}
                log(f"8d: {arch} ({cfg.n_layers} layers, batch {B}, prompt {L}, {T} tokens, bf16) on make_mesh((1, 1)), "
                    f"flash_decode {flash}: tokens identical to greedy_generate, logits bitwise {bitwise}; prefill "
                    f"{pre:.3f} s (one device {pre1:.3f}), decode "
                    f"{res[key]['decode_ms_per_token']:.2f} ms/token (one device {res['one_device']['decode_ms_per_token']:.2f}), "
                    f"peak {peak / 2**30:.2f} GiB (one device {peak1 / 2**30:.2f}); launches a prefill {per_prefill}; "
                    f"all_to_all {a2a_prefill} in prefill, {a2a_steps / (T - 1):.1f} a step; layer 0's caches {pl}")
            results[arch] = res
            del model, prefill, decode, shardings
            torch.cuda.empty_cache()
        return results
    finally:
        tdist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)


def prf_cells():
    """8e: the dry run's PRF cell on both production meshes on the card, in a
    process of its own (``python -m repro_torch.launch.dryrun --arch prf``:
    a fake world of 256 / 512, rank 0's real shard, 2^18 / 2^17 rows x 256
    features, through ``ReplicaMesh``): each ``OK``, ``max_depth`` levels,
    its collectives, bytes, peak memory, kernel launches and growth time."""
    import os

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "prf", "--mesh", "both", "--device", "cuda",
           "--out", str(DRYRUN_OUT)]
    r, t = sync_time(lambda: subprocess.run(cmd, env=env, cwd=str(ROOT), capture_output=True, text=True,
                                            timeout=PRF_CELL_LIMIT_S))
    cells = {}
    for mesh_name in ("16x16", "2x16x16"):
        path = DRYRUN_OUT / f"prf__train_4k__{mesh_name}.json"
        cell = json.loads(path.read_text()) if path.exists() else {"status": "no result"}
        check(r.returncode == 0 and cell.get("status") == "OK" and cell.get("levels") == cell["config"]["max_depth"],
              f"8e: the PRF cell on {mesh_name}: rc {r.returncode}, status {cell.get('status')}, levels "
              f"{cell.get('levels')}; {cell.get('traceback', '')[-1500:]} {r.stderr[-1500:]}")
        cells[mesh_name] = cell
        log(f"8e: the PRF cell on {mesh_name} OK on the card: {cell['levels']} levels, growth {cell['grow_s']:.2f} s "
            f"(cell {cell['wall_s']} s), kernel launches {cell['kernel_launches']}, collectives "
            + ", ".join(f"{k} {v['count']} x {v['operand_bytes']:.4e} B" for k, v in sorted(cell["collectives"].items()))
            + f" (wire {cell['collective_bytes']:.4e} B), torch-op bytes {cell['bytes_per_device']:.4e}, peak "
            f"{cell['hbm_per_device_gb']:.3f} GiB; memory {cell['memory_s']:.4f} s, collective "
            f"{cell['collective_s']:.4f} s, dominant {cell['dominant']}")
    return {"cells": cells, "process_s": t}


def lm_mesh_phase(dev, smollm_7c, pool, timings, lm_phase6=None):
    """Phase 8: the LM mesh glue. 8a the attention kernels at a query
    offset, 8b ``make_sharded_train_step`` on the card, 8c the dry run's LM
    cells, 8d ``make_serve_fns`` on the card, 8e the PRF cells on the card."""
    part_s = {}

    def part(name, fn):
        out, part_s[name] = sync_time(fn)
        return out

    offsets = part("8a", lambda: mesh_offset_checks(dev, timings))
    train = part("8b", lambda: mesh_train(dev, smollm_7c))
    serving = part("8d", lambda: mesh_serving(dev, lm_phase6))
    prf = part("8e", prf_cells)
    dry = part("8c", lambda: mesh_dryrun(pool))
    log("phase 8 parts (s): " + ", ".join(f"{k} {v:.1f}" for k, v in part_s.items()))
    return {"offsets": offsets, "sharded_train": train, "serving": serving, "prf_cells": prf, "dryrun": dry,
            "part_s": part_s}


def lm_train_phase(dev, kernel_row, timings):
    """Phase 7: the attention backward kernel's checks, reduced
    kernel-vs-plain training (7b, 7f), smollm-135m at full width (its launch
    counts read around its TRAIN_STEPS steps), the attention backward's row
    of the kernels line; the SSD backward kernel's checks (7e), mamba2-780m
    at full width and depth (7g) and hymba-1.5b at published widths,
    HYMBA_TRAIN_DEPTH layers (7h), and the SSD backward's row; gemma3-12b
    (7i) and gemma3-27b (7j) at published widths, GEMMA_TRAIN_DEPTH layers."""
    part_s = {}

    def part(name, fn):
        out, part_s[name] = sync_time(fn)
        return out

    checks = part("7a", lambda: lm_backward_checks(dev))
    reduced = part("7b, 7f", lambda: lm_train_reduced(dev))
    full = part("7c", lambda: lm_train_full(dev))
    rows = part("7d", lambda: lm_backward_rows(dev, full["launches"]["bwd_tc"], kernel_row, timings))
    ssd_checks = part("7e", lambda: lm_ssd_backward_checks(dev))
    mamba = part("7g", lambda: lm_train_full(dev, "mamba2-780m"))
    hymba = part("7h", lambda: lm_train_full(dev, "hymba-1.5b", depth=HYMBA_TRAIN_DEPTH, steps=HYMBA_TRAIN_STEPS,
                                             resume=False, profile=False))
    ssd_rows = part("7e rows", lambda: lm_ssd_backward_rows(dev, mamba["launches"]["ssd_bwd_bf16"], kernel_row,
                                                            timings))
    gemma = {arch: part(name, lambda: lm_train_full(dev, arch, depth=GEMMA_TRAIN_DEPTH[arch], steps=GEMMA_TRAIN_STEPS,
                                                    resume=False, profile=arch == "gemma3-12b",
                                                    n_micro=GEMMA_TRAIN_MICRO, lr=GEMMA_TRAIN_LR,
                                                    warmup=GEMMA_TRAIN_WARMUP))
             for name, arch in (("7i", "gemma3-12b"), ("7j", "gemma3-27b"))}
    log("phase 7 parts (s): " + ", ".join(f"{k} {v:.1f}" for k, v in part_s.items()))
    return {"backward_checks": checks, "reduced": reduced, "smollm": full, "backward": rows,
            "ssd_backward_checks": ssd_checks, "mamba2": mamba, "hymba": hymba, "ssd_backward": ssd_rows,
            "gemma3_12b": gemma["gemma3-12b"], "gemma3_27b": gemma["gemma3-27b"], "part_s": part_s}


def main(train_only: bool = False, mesh_only: bool = False) -> int:
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
    rows, timings = [], {}
    pool = None if train_only else DryRunPool(dryrun_jobs())     # 8c, beside phases 3-7

    def kernel_row(name, src, replaces, launches, err, t, plain_ms, nbytes, nops, library_ms,
                   ops_per_s=F32_OPS_PER_S):
        """One row of the kernels line; ``t`` from ``timed``."""
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = nops / ops_per_s * 1e3
        row = {"name": name, "route": "cuda", "source": src, "replaces": replaces,
               "launches": launches, "max_abs_err": err, "ms": t["ms"], "plain_ms": plain_ms,
               "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "library_ms": library_ms, "kernel_ms": t["kernel_ms"], "launches_traced": t["launches_traced"],
               **({"direct_ms": t["direct_ms"]} if "direct_ms" in t else {})}
        rows.append(row)
        log(f"{name}: {row['ms']:.4f} ms (kernel alone {fmt_ms(row['kernel_ms'])}; plain {plain_ms:.4f} ms, bound "
            f"{row['bound_ms']:.4f} ms by {row['bound_by']}, share {row['bound_ms'] / row['ms']:.3f}, of the "
            f"kernel alone {bound_share(row['bound_ms'], row['kernel_ms'])}, library {library_ms}) max|d| {err:.3g}")

    if mesh_only:
        smollm = lm_train_full(dev, resume=False, profile=False)
        mesh_res = lm_mesh_phase(dev, smollm, pool, timings)
        (ROOT / "artifacts").mkdir(exist_ok=True)
        (ROOT / "artifacts" / "chip_smoke_mesh.json").write_text(json.dumps(
            {"lm_mesh": mesh_res, "smollm_7c": smollm, "card": smi}, indent=1, default=str))
        log(smi)
        return 0

    if train_only:
        train = lm_train_phase(dev, kernel_row, timings)
        (ROOT / "artifacts").mkdir(exist_ok=True)
        (ROOT / "artifacts" / "chip_smoke_train.json").write_text(json.dumps(
            {"kernels": rows, "lm_train": train, "card": smi, "timings": timings}, indent=1))
        log(json.dumps({"kernels": rows}))
        log(smi)
        return 0

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
    reuse = reuse_phase(dev, xbt, yt, wt, fmask, rcfg, forest, timings)

    # kernels at the main path's shapes: the first growth level's slab
    k, Ntr, Fall = rcfg.n_trees, xtr.shape[0], xtr.shape[1]
    S, B, C = rcfg.frontier, rcfg.n_bins, rcfg.n_classes
    W = hist_feature_slab(Ntr, Fall, S, B, C)
    xs = xbt[:, :W]
    base = class_channels(yt, C)
    slot0 = torch.zeros((k, Ntr), dtype=torch.int32, device=dev)
    fmask_s = fmask[:, :W].contiguous()

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

    # 5f. the multi-process plane -------------------------------------------------
    multiproc = multiproc_phase(dev, xtr, ytr, xte, yte, wt, u, rcfg)
    for row in rows:
        if row["name"] in ("gain_ratio_hist", "split_scan"):
            row["launches_multiproc"] = [o["launches"]["train_prf"][row["name"]]
                                         for o in multiproc["ranks"]]

    # 5g. serving on phase 5's model, hot-swapped to phase 5b's; the baselines ---
    serving, t_serving = sync_time(lambda: serving_phase(
        dev, model, streamed.pop("model"), xtr, ytr, xte, yte, cfg, {"accuracy": acc, "train_s": t_main},
        timings))
    serving["phase_s"] = t_serving
    log(f"serving phase (5g): {t_serving:.1f} s")
    for row in rows:
        if row["name"] == "tree_traverse":
            row["launches_serving"] = serving["launches"]

    # 6. full size, LM serving ----------------------------------------------------
    lm = [lm_full(dev, arch, depth, T, cut, L) for arch, depth, T, cut, L in LM_CONFIGS]
    lm_counts = {name: sum(r["launches"][name] for r in lm) for name in ("flash_attention", "ssd_scan")}
    counts.update(lm_counts)
    lm_shapes = lm_kernel_rows(dev, lm_counts, kernel_row, timings)
    for row in rows:
        if row["name"] in lm_counts:
            row["launches_per_config"] = {r["arch"]: r["launches"][row["name"]] for r in lm}

    # 7. LM training --------------------------------------------------------------
    train, t_train = sync_time(lambda: lm_train_phase(dev, kernel_row, timings))
    train["phase_s"] = t_train
    log(f"LM training phase (7): {t_train:.1f} s")
    counts["flash_attention_bwd"] = train["smollm"]["launches"]["bwd_tc"]
    counts["ssd_scan_bwd"] = train["mamba2"]["launches"]["ssd_bwd_bf16"]
    for row in rows:
        if row["name"] == "flash_attention":
            row["launches_train"] = train["smollm"]["launches"]["fwd_bf16"]
        if row["name"] == "ssd_scan":
            row["launches_train"] = train["mamba2"]["launches"]["ssd_fwd_bf16"]

    # 8. the LM mesh glue -----------------------------------------------------------
    lm_mesh, t_mesh = sync_time(lambda: lm_mesh_phase(dev, train["smollm"], pool, timings, lm))
    lm_mesh["phase_s"] = t_mesh
    log(f"LM mesh glue phase (8): {t_mesh:.1f} s")

    # 9. results ------------------------------------------------------------------
    result = {"kernels": rows, "stages_s": stages, "main_path_s": t_main, "levels_run": levels,
              "peak_bytes": peak, "accuracy": acc, "card": smi, "build_s": _build.build_seconds,
              "lm": lm, "lm_small_checks": lm_small, "attention_wide_d": lm_shapes["wide_d"],
              "lm_path_shapes": lm_shapes["path_shapes"],
              "hgmma": hgmma, "hist_shapes": hist_shapes, "split_scan_shapes": scan_shapes,
              "traverse_shapes": traverse_shapes, "reuse": reuse, "reuse_reduced": reuse_reduced,
              "streamed": streamed, "checkpoints": checkpoints, "regression": regression, "mesh": mesh,
              "multiproc": multiproc, "serving": serving, "lm_train": train, "lm_mesh": lm_mesh,
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
    log("launch counts per rank on the multi-process path (5f): " + json.dumps(
        [o["launches"]["train_prf"] for o in multiproc["ranks"]]))
    log("traversal launches on the served batches (5g): " + json.dumps(serving["launches"]))
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
    ap.add_argument("--train-only", action="store_true",
                    help="only the card, the build and phase 7 (LM training); no result line")
    ap.add_argument("--mesh-only", action="store_true",
                    help="only the card, the build, 7c without its resume and phase 8 (the LM mesh glue); "
                         "no result line")
    args = ap.parse_args()
    sys.exit(traverse_batch_ab(args.src) if args.traverse_ab else main(args.train_only, args.mesh_only))

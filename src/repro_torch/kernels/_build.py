"""Build and load the port's CUDA kernels (``src/repro_torch/csrc/*.cu``).

Each source is compiled to an object by its own ``nvcc``, all started
together, and one more ``nvcc`` links the objects into one shared
library with a plain C interface, ``build/repro_torch/libprf_kernels.so``
at the root of the checkout (listed in ``.gitignore``); ``ctypes`` loads
it. The build runs at the first kernel launch of a process and is reused
while it is newer than every source. Nothing here runs at import time,
so the CPU tests import every module without a toolkit. ``ptxas``
reports each kernel's registers, shared memory and spills into
``build/repro_torch/nvcc.log``.

Flags: the PRF sources build with ``-fmad=false`` and no
``--use_fast_math``, so the split-scan kernel's ``logf`` and divisions
round op for op like the plain PyTorch version on the card. The LM
sources (``FMAD_SOURCES``) let the compiler contract multiply-adds:
they are held to their plain versions by a tolerance.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = ROOT / "build" / "repro_torch"
LIB_NAME = "libprf_kernels.so"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
FMAD_SOURCES = ("flash_attention.cu", "ssd_scan.cu")

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C signature of every exported launcher (all return cudaGetLastError()).
SIGNATURES = {
    # x, ld, base, w, slot, order, seg, out, N, W, tc, S, B, C, packed, class_tile,
    # fx_out, fx_c0, fx_shift, stream
    "prf_hist": [_P, _LL, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                 _P, _I, _I, _P],
    # hist, mask, f_base, gain, feat, thr, left, right, tc, S, W, B, C, regression,
    # class_tile, stream
    "prf_split_scan": [_P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # x, N, F, feature, threshold, left_child, payload, carry, out, packed, tc, P, C, depth,
    # Fs, TN, smem_bytes, wide, stream
    "prf_traverse": [_P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                     _I, _I, _I, _I, _P],
    # q, k, v, out, B, Lq, Lk, H, KV, D, causal, window, scale, bf16, stream
    "lm_flash_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _I, _P],
    # x, loga, b, c, y, h, B, L, H, P, N, chunk, bf16, stream
    "lm_ssd_scan": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
}

_lib = None
build_seconds = None      # wall time of this process's nvcc calls (None: reused / not built)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _run(cmds: list) -> list:
    """Run the commands concurrently; raise with the log of the first failure."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    for cmd, proc, out in zip(cmds, procs, logs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")
    return logs


def build() -> Path:
    """Compile every ``csrc/*.cu`` into one library; returns its path."""
    global build_seconds
    lib = BUILD_DIR / LIB_NAME
    srcs = sources() + sorted(CSRC.glob("*.cuh"))
    if (lib.exists()
            and lib.stat().st_mtime >= max(s.stat().st_mtime for s in srcs)):
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in sources()]
        logs = _run([
            [nvcc, *NVCC_FLAGS, *([] if src.name in FMAD_SOURCES else ["-fmad=false"]),
             "-c", "-o", str(obj), str(src)]
            for src, obj in zip(sources(), objs)
        ])
        fd, out = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            _run([[nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", out,
                   *map(str, objs)]])
        except RuntimeError:
            os.unlink(out)
            raise
        os.replace(out, lib)
    (BUILD_DIR / "nvcc.log").write_text("".join(logs))
    build_seconds = time.perf_counter() - t0
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def launch(name: str, *args) -> None:
    """Call one C launcher on PyTorch's current stream; raise on a CUDA error."""
    import torch

    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(library(), name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")

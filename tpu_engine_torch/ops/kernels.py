"""The port's one library of hand-written CUDA kernels: build, load,
launch, and the launch counts of the wrappers that call it.

Every source in ``tpu_engine_torch/csrc/`` (``*.cu``) is compiled with
``nvcc`` for ``sm_90a`` at first use, one nvcc per source, all started
together, and linked into one shared library in ``build/torch_kernels/``
under the repository root, keyed by a hash of the sources, the headers and
the flags, and loaded with ``ctypes``. Each entry point has a plain C
interface: device pointers, sizes and PyTorch's current stream in, a
``cudaError_t`` out. Importing this module needs neither ``nvcc`` nor a
card.

The op modules (``ops.paged_attention``, ``ops.flash``, ``ops.ssd``)
register their wrappers here, one per kernel: ``launches`` counts kernel launches,
``plain_calls`` calls served by the plain PyTorch version (CPU tensors
only). A run that resets both to 0 and reads them after shows which
path it went through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import torch

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = tuple(sorted(_CSRC.glob("*.cu")))
HEADERS = tuple(sorted(_CSRC.glob("*.cuh")))
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
_L, _F = ctypes.c_int64, ctypes.c_float
# Entry point -> argument types (the stream comes last, appended by
# `launch`).
ENTRY_POINTS = {
    # q, k_pool, v_pool, tables, pos0, qlen, out, part_acc, part_ml; B, W,
    # H, H_kv, D, bs, nb, split, kv_dtype.
    "ragged_paged_attention": [_P] * 9 + [_I] * 9,
    # q, k_pool, v_pool, tables, pos, out, part_acc, part_ml; B, H, H_kv,
    # D, bs, nb, split, kv_dtype.
    "paged_attention": [_P] * 8 + [_I] * 8,
    # q, k_pool, v_pool, k_scale, v_scale, tables, pos, out, part_acc,
    # part_ml; B, H, H_kv, D, bs, nb, split.
    "quant_paged_attention": [_P] * 10 + [_I] * 7,
    # q, k_pool, v_pool, k_scale, v_scale, tables, pos0, qlen, out,
    # part_acc, part_ml; B, W, H, H_kv, D, bs, nb, split.
    "quant_ragged_paged_attention": [_P] * 11 + [_I] * 8,
    # q, k, v, mask, out, lse; B, Sq, Sk, H, D; the (b, s, h) element
    # strides of q, k, v; causal, window; scale; dtype.
    "flash_attention": [_P] * 6 + [_I] * 5 + [_L] * 9 + [_I] * 2 + [_F]
                       + [_I],
    # q, k, v, mask, do, lse, delta, dq; B, Sq, Sk, H, D; the (b, s, h)
    # element strides of q, k, v, do; causal, window; scale; dtype.
    "flash_attention_bwd_dq": [_P] * 8 + [_I] * 5 + [_L] * 12 + [_I] * 2
                              + [_F] + [_I],
    # The same with dk, dv in place of dq.
    "flash_attention_bwd_dkv": [_P] * 9 + [_I] * 5 + [_L] * 12 + [_I] * 2
                               + [_F] + [_I],
    # proj, state, row_ids, qlen, conv_w, conv_b, dt_bias, A_log, D, y; B,
    # W, di, N, H, K, state_dim.
    "ssd_scan": [_P] * 10 + [_I] * 7,
}

_build_lock = threading.Lock()
_library: Optional[ctypes.CDLL] = None
build_log = ""  # nvcc's report (registers, shared memory, spills) of the build


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH) — the port's kernels are built from "
                           "source at first use")
    return found


def kernel_library_path() -> Path:
    """Path of the shared library for the current sources and flags."""
    h = hashlib.sha256()
    for src in SOURCES + HEADERS:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"torch_kernels_{h.hexdigest()[:16]}.so"


def build_kernel_library() -> Path:
    """Compile every kernel source with nvcc (one process per source, all
    started together) and link one library, unless a library for exactly
    these sources and flags is already built. Returns its path."""
    global build_log
    out = kernel_library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    work = out.with_suffix(f".{os.getpid()}.build")
    work.mkdir(parents=True, exist_ok=True)
    try:
        jobs = []
        for src in SOURCES:
            obj = work / f"{src.stem}.o"
            jobs.append((src, obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        logs, failed = [], []
        for src, _, proc in jobs:
            so, se = proc.communicate()
            logs.append(f"== {src.name}\n{so}{se}")
            if proc.returncode != 0:
                failed.append(f"{src.name} ({proc.returncode}):\n{so}\n{se}")
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        tmp = work / out.name
        proc = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp), *(str(o) for _, o, _ in jobs)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        build_log = "\n".join(logs)
        os.replace(tmp, out)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


def kernel_library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use (thread-safe)."""
    global _library
    with _build_lock:
        if _library is None:
            lib = ctypes.CDLL(str(build_kernel_library()))
            for name, argtypes in ENTRY_POINTS.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes + [_P]
                fn.restype = ctypes.c_int
            lib.kernel_error_string.argtypes = [ctypes.c_int]
            lib.kernel_error_string.restype = ctypes.c_char_p
            _library = lib
        return _library


def launch(name: str, device, *args) -> None:
    """Call entry point ``name`` on ``device``'s current stream; raise on a
    refused launch (it never runs, and a synchronise would not show it)."""
    lib = kernel_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, name)(*args, stream)
    if rc != 0:
        msg = lib.kernel_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} ({msg})")


# -- launch counts --------------------------------------------------------------

WRAPPERS = []


def counted(fn):
    """Register a kernel wrapper: it gets ``launches`` and ``plain_calls``
    counts, both reset by ``reset_counts``."""
    fn.launches = 0
    fn.plain_calls = 0
    WRAPPERS.append(fn)
    return fn


def reset_counts() -> None:
    for fn in WRAPPERS:
        fn.launches = 0
        fn.plain_calls = 0


def plain_or_cuda(fn, t: torch.Tensor) -> bool:
    """True for CPU tensors (count a plain call on ``fn``); False for CUDA
    tensors, which must launch the kernel; raise on other devices."""
    if t.device.type == "cpu":
        fn.plain_calls += 1
        return True
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return False

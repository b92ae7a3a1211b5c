"""Ragged paged attention over the block-pooled KV cache (counterpart of
the ragged half of ``tpu_engine/ops/paged_attention.py``).

The mixed scheduler serves decode rows (one new token) and admitting rows
(a prefill chunk) in one ragged batch: row b's query slot i sits at
logical position pos0[b] + i and attends keys kpos <= pos0[b] + i, read
through the row's block table (logical column c lives in pool block
``tables[b, c // bs]`` at offset ``c % bs``). Slots i >= qlen[b] are
padding whose output the caller ignores.

- ``ragged_paged_attention_reference`` is the plain PyTorch version: it
  gathers each row's blocks into a dense view and runs the grouped
  ``dot_product_attention``.
- ``ragged_paged_attention`` is the wrapper. For CUDA tensors it launches
  the hand-written kernel of ``csrc/ragged_paged_attention.cu`` (the port
  of the TPU kernel ``_ragged_kernel``); for CPU tensors, and only for
  them, it takes the plain version. It never falls back: a kernel that
  does not build or launch raises.

The kernel library is compiled with ``nvcc`` for ``sm_90a`` at first use
into ``build/torch_kernels/`` under the repository root, keyed by a hash
of its sources and flags, and loaded with ``ctypes``. Importing this
module needs neither ``nvcc`` nor a card.
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

from tpu_engine_torch.ops.attention import dot_product_attention

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = (_CSRC / "ragged_paged_attention.cu",)
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SUPPORTED_HEAD_DIMS = (8, 16, 32, 64, 128)
_KV_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def ragged_paged_attention_reference(q, k_pool, v_pool, tables, pos0, qlen):
    """Plain version. q: (B, W, H, D); k_pool/v_pool: (NB, bs, H_kv, D);
    tables: (B, nb) int block ids; pos0: (B,) logical position of each
    row's first query slot; qlen: (B,) valid slots (padding slots give
    values the caller ignores). Returns (B, W, H, D)."""
    del qlen  # padding slots are ignored by contract, not masked
    bs = k_pool.shape[1]
    b, w = q.shape[:2]
    nb = tables.shape[1]
    idx = tables.long()
    kk = k_pool[idx].reshape(b, nb * bs, k_pool.shape[2], k_pool.shape[3])
    vv = v_pool[idx].reshape(b, nb * bs, v_pool.shape[2], v_pool.shape[3])
    kpos = torch.arange(nb * bs, device=q.device)
    qpos = pos0.long()[:, None] + torch.arange(w, device=q.device)[None, :]
    valid = (kpos[None, None, :] <= qpos[:, :, None]).to(torch.int32)
    return dot_product_attention(q, kk, vv, mask=valid)


# -- the CUDA kernel: build, load, launch -------------------------------------

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
                           "PATH) — the ragged paged-attention kernel is "
                           "built from source at first use")
    return found


def kernel_library_path() -> Path:
    """Path of the shared library for the current sources and flags."""
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"ragged_paged_attention_{h.hexdigest()[:16]}.so"


def build_kernel_library() -> Path:
    """Compile the kernel sources with nvcc unless a library for exactly
    these sources and flags is already built. Returns its path."""
    global build_log
    out = kernel_library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    build_log = proc.stdout + proc.stderr
    os.replace(tmp, out)
    return out


def kernel_library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use (thread-safe)."""
    global _library
    with _build_lock:
        if _library is None:
            lib = ctypes.CDLL(str(build_kernel_library()))
            fn = lib.ragged_paged_attention
            fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            lib.ragged_paged_attention_error_string.argtypes = [ctypes.c_int]
            lib.ragged_paged_attention_error_string.restype = ctypes.c_char_p
            _library = lib
        return _library


def _check_cuda_args(q, k_pool, v_pool, tables, pos0, qlen) -> None:
    dev = q.device
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool),
                    ("tables", tables), ("pos0", pos0), ("qlen", qlen)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dim() != 4 or k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)}, k_pool "
                         f"{tuple(k_pool.shape)}, v_pool "
                         f"{tuple(v_pool.shape)}")
    b, _, h, d = q.shape
    _, bs, h_kv, d_kv = k_pool.shape
    if d_kv != d or h % h_kv:
        raise ValueError(f"q heads {h}/dim {d} do not match the pool's "
                         f"{h_kv}/{d_kv}")
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {SUPPORTED_HEAD_DIMS}")
    if not 1 <= bs <= 128:
        raise ValueError(f"block size {bs} outside 1..128")
    if k_pool.dtype not in _KV_DTYPES or v_pool.dtype != k_pool.dtype:
        raise ValueError(f"pool dtype {k_pool.dtype}/{v_pool.dtype} not "
                         f"supported (float32 or bfloat16)")
    if tables.dim() != 2 or tables.shape[0] != b:
        raise ValueError(f"tables {tuple(tables.shape)} for batch {b}")
    for name, t in (("tables", tables), ("pos0", pos0), ("qlen", qlen)):
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
    if tuple(pos0.shape) != (b,) or tuple(qlen.shape) != (b,):
        raise ValueError("pos0 and qlen must be (B,)")


def ragged_paged_attention(q, k_pool, v_pool, tables, pos0, qlen):
    """Same contract as ``ragged_paged_attention_reference``. CUDA tensors
    launch the kernel (q is taken in f32; the output has the pool's
    dtype); CPU tensors take the plain version."""
    if q.device.type == "cpu":
        ragged_paged_attention.plain_calls += 1
        return ragged_paged_attention_reference(q, k_pool, v_pool, tables,
                                                pos0, qlen)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check_cuda_args(q, k_pool, v_pool, tables, pos0, qlen)
    b, w, h, d = q.shape
    _, bs, h_kv, _ = k_pool.shape
    qf = q.to(torch.float32).contiguous()
    out = torch.empty((b, w, h, d), dtype=k_pool.dtype, device=q.device)
    lib = kernel_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.ragged_paged_attention(
            qf.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            tables.data_ptr(), pos0.data_ptr(), qlen.data_ptr(),
            out.data_ptr(), b, w, h, h_kv, d, bs, tables.shape[1],
            _KV_DTYPES[k_pool.dtype], stream)
    if rc != 0:
        msg = lib.ragged_paged_attention_error_string(rc).decode()
        raise RuntimeError(f"ragged paged-attention launch failed: CUDA "
                           f"error {rc} ({msg})")
    ragged_paged_attention.launches += 1
    return out


# Launch counts: `launches` counts kernel launches, `plain_calls` counts
# calls served by the plain version (CPU tensors). A run that resets both
# to 0 and reads them after shows which path it went through.
ragged_paged_attention.launches = 0
ragged_paged_attention.plain_calls = 0


def ragged_parity_inputs(q_lens=(1, 7, 16, 17), n_heads: int = 4,
                         n_kv_heads: int = 2, d_head: int = 8,
                         block_size: int = 16, n_blocks: int = 33,
                         table_len: int = 6, seed: int = 0):
    """A random ragged workload as numpy arrays, one row per entry of
    ``q_lens`` (the shapes of the JAX package's ``ragged_parity_check``):
    (q, k_pool, v_pool, tables, pos0, qlen), f32 unit normals and int32.
    Rows get distinct shuffled tables and a random history that, with the
    chunk, fits the table."""
    import numpy as np

    rng = np.random.default_rng(seed)
    batch, w = len(q_lens), max(q_lens)
    q = rng.standard_normal((batch, w, n_heads, d_head), np.float32)
    shape = (n_blocks, block_size, n_kv_heads, d_head)
    k_pool = rng.standard_normal(shape, np.float32)
    v_pool = rng.standard_normal(shape, np.float32)
    tables = np.zeros((batch, table_len), np.int32)
    pos0 = np.zeros((batch,), np.int32)
    for r, ql in enumerate(q_lens):
        tables[r] = 1 + rng.permutation(n_blocks - 1)[:table_len]
        pos0[r] = int(rng.integers(0, table_len * block_size - ql + 1))
    return q, k_pool, v_pool, tables, pos0, np.asarray(q_lens, np.int32)

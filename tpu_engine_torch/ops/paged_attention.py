"""Paged attention over the block-pooled KV cache (counterpart of
``tpu_engine/ops/paged_attention.py``): the decode read of the two-path
paged scheduler, the ragged read of the mixed step, and both over the
int8 pool.

- Decode (``paged_attention``): q (B, 1, H, D); row b attends logical
  columns kpos <= pos[b], column c read from pool block
  ``tables[b, c // bs]`` at offset ``c % bs``.
- Ragged (``ragged_paged_attention``): the mixed scheduler serves decode
  rows (one new token) and admitting rows (a prefill chunk) in one ragged
  batch: row b's query slot i sits at logical position pos0[b] + i and
  attends keys kpos <= pos0[b] + i. Slots i >= qlen[b] are padding whose
  output the caller ignores.
- ``quant_*``: the same reads over the int8 pool, whose (NB, bs, H_kv)
  f32 scale arrays hold one scale per (block slot, kv-head). They return
  q's dtype (f32 on the serving path), not the pool's.

Each read has a plain PyTorch version (``*_reference``: gather the row's
blocks into a dense view, dequantized to f32 for int8, and run the grouped
``dot_product_attention``) and a wrapper. For CUDA tensors the wrapper
launches the hand-written kernel that ports the TPU kernel (``csrc/``:
``_paged_kernel`` and ``_quant_paged_kernel`` in ``paged_attention.cu``,
``_ragged_kernel`` in ``ragged_paged_attention.cu``,
``_quant_ragged_kernel`` in ``quant_ragged_paged_attention.cu``); for CPU
tensors, and only for them, it takes the plain version. It never falls
back: a kernel that does not build or launch raises. Each wrapper counts
its kernel launches (``launches``) and its plain calls (``plain_calls``).
None of the reads has a backward, here or in the JAX package: a wrapper
called with grad mode on and a floating input that requires grad raises
(on either device) rather than return an output detached from its inputs.
The kernels are built and launched through ``ops.kernels``, the port's one
kernel library; importing this module needs neither ``nvcc`` nor a card.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_engine_torch.ops.attention import dot_product_attention
from tpu_engine_torch.ops.kernels import counted, launch, plain_or_cuda
from tpu_engine_torch.ops.quant import dequantize_kv, quantize_kv

SUPPORTED_HEAD_DIMS = (8, 16, 32, 64, 128)
MAX_DECODE_GROUP_DIMS = 2048   # G * D a decode thread block accumulates
_KV_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


# -- plain versions ------------------------------------------------------------

def _gather_rows(pool, tables):
    """(NB, bs, ...) pool + (B, nb) tables -> (B, nb * bs, ...)."""
    b, nb = tables.shape
    g = pool[tables.long()]
    return g.reshape(b, nb * pool.shape[1], *pool.shape[2:])


def _decode_mask(q, tables, bs, pos_vec):
    kpos = torch.arange(tables.shape[1] * bs, device=q.device)
    return (kpos[None, :] <= pos_vec.long()[:, None]).to(torch.int32)


def _ragged_mask(q, tables, bs, pos0):
    kpos = torch.arange(tables.shape[1] * bs, device=q.device)
    qpos = (pos0.long()[:, None]
            + torch.arange(q.shape[1], device=q.device)[None, :])
    return (kpos[None, None, :] <= qpos[:, :, None]).to(torch.int32)


def paged_attention_reference(q, k_pool, v_pool, tables, pos_vec):
    """Plain version of the decode read. q: (B, 1, H, D); k_pool/v_pool:
    (NB, bs, H_kv, D); tables: (B, nb) block ids (0 = the null block, its
    columns masked by ``pos_vec``); pos_vec: (B,) last valid logical
    column per row. Returns (B, 1, H, D)."""
    mask = _decode_mask(q, tables, k_pool.shape[1], pos_vec)
    return dot_product_attention(q, _gather_rows(k_pool, tables),
                                 _gather_rows(v_pool, tables), mask=mask)


def ragged_paged_attention_reference(q, k_pool, v_pool, tables, pos0, qlen):
    """Plain version of the ragged read. q: (B, W, H, D); k_pool/v_pool:
    (NB, bs, H_kv, D); tables: (B, nb) int block ids; pos0: (B,) logical
    position of each row's first query slot; qlen: (B,) valid slots
    (padding slots give values the caller ignores). Returns (B, W, H, D)."""
    del qlen  # padding slots are ignored by contract, not masked
    mask = _ragged_mask(q, tables, k_pool.shape[1], pos0)
    return dot_product_attention(q, _gather_rows(k_pool, tables),
                                 _gather_rows(v_pool, tables), mask=mask)


def quant_paged_attention_reference(q, k_pool, v_pool, k_scale, v_scale,
                                    tables, pos_vec):
    """``paged_attention_reference`` over the int8 pool: k_pool/v_pool
    (NB, bs, H_kv, D) int8, k_scale/v_scale (NB, bs, H_kv) f32. The
    gathered view dequantizes to f32, then the same attention runs."""
    kk = dequantize_kv(_gather_rows(k_pool, tables),
                       _gather_rows(k_scale, tables))
    vv = dequantize_kv(_gather_rows(v_pool, tables),
                       _gather_rows(v_scale, tables))
    mask = _decode_mask(q, tables, k_pool.shape[1], pos_vec)
    return dot_product_attention(q, kk, vv, mask=mask)


def quant_ragged_paged_attention_reference(q, k_pool, v_pool, k_scale,
                                           v_scale, tables, pos0, qlen):
    """``ragged_paged_attention_reference`` over the int8 pool (same
    contract; padding slots give values the caller ignores)."""
    del qlen
    kk = dequantize_kv(_gather_rows(k_pool, tables),
                       _gather_rows(k_scale, tables))
    vv = dequantize_kv(_gather_rows(v_pool, tables),
                       _gather_rows(v_scale, tables))
    mask = _ragged_mask(q, tables, k_pool.shape[1], pos0)
    return dot_product_attention(q, kk, vv, mask=mask)


# -- the CUDA kernels -----------------------------------------------------------

def _check_cuda_args(q, k_pool, v_pool, tables, rows, *, quant=False,
                     scales=()) -> None:
    """Device, contiguity, shape and dtype checks before a launch.
    ``rows``: the (B,) int32 position vectors."""
    dev = q.device
    named = (("k_pool", k_pool), ("v_pool", v_pool), ("tables", tables),
             *rows, *scales)
    for name, t in named:
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
    if quant:
        if k_pool.dtype != torch.int8 or v_pool.dtype != torch.int8:
            raise ValueError(f"pool dtype {k_pool.dtype}/{v_pool.dtype}: "
                             f"the quantized read takes int8")
        for name, s in scales:
            if s.dtype != torch.float32 or s.shape != k_pool.shape[:3]:
                raise ValueError(f"{name} must be float32 of shape "
                                 f"{tuple(k_pool.shape[:3])}, got "
                                 f"{s.dtype} {tuple(s.shape)}")
    elif k_pool.dtype not in _KV_DTYPES or v_pool.dtype != k_pool.dtype:
        raise ValueError(f"pool dtype {k_pool.dtype}/{v_pool.dtype} not "
                         f"supported (float32 or bfloat16)")
    if tables.dim() != 2 or tables.shape[0] != b:
        raise ValueError(f"tables {tuple(tables.shape)} for batch {b}")
    for name, t in (("tables", tables), *rows):
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
    for name, t in rows:
        if tuple(t.shape) != (b,):
            raise ValueError(f"{name} must be (B,) = ({b},), got "
                             f"{tuple(t.shape)}")


def _refuse_grad(fn, *tensors) -> None:
    """Raise if autograd would expect a gradient through ``fn``: the paged
    reads have no backward (serving calls them on tensors that do not
    require grad)."""
    if torch.is_grad_enabled() and any(
            t.is_floating_point() and t.requires_grad for t in tensors):
        raise RuntimeError(f"{fn.__name__} has no backward: call it under "
                           f"torch.no_grad() or on tensors that do not "
                           f"require grad")


def _check_decode(q, k_pool) -> None:
    if q.shape[1] != 1:
        raise ValueError(f"the decode read takes one query slot, got "
                         f"q {tuple(q.shape)}")
    g = q.shape[2] // k_pool.shape[2]
    if g * q.shape[3] > MAX_DECODE_GROUP_DIMS:
        raise ValueError(f"G * D = {g * q.shape[3]} exceeds "
                         f"{MAX_DECODE_GROUP_DIMS}")


@counted
def ragged_paged_attention(q, k_pool, v_pool, tables, pos0, qlen):
    """Same contract as ``ragged_paged_attention_reference``. CUDA tensors
    launch the port of ``_ragged_kernel`` (q is taken in f32; the output
    has the pool's dtype); CPU tensors take the plain version. It has no
    backward: inputs that require grad raise."""
    _refuse_grad(ragged_paged_attention, q, k_pool, v_pool)
    if plain_or_cuda(ragged_paged_attention, q):
        return ragged_paged_attention_reference(q, k_pool, v_pool, tables,
                                                pos0, qlen)
    _check_cuda_args(q, k_pool, v_pool, tables,
                     (("pos0", pos0), ("qlen", qlen)))
    b, w, h, d = q.shape
    _, bs, h_kv, _ = k_pool.shape
    qf = q.to(torch.float32).contiguous()
    out = torch.empty((b, w, h, d), dtype=k_pool.dtype, device=q.device)
    launch("ragged_paged_attention", q.device, qf.data_ptr(),
            k_pool.data_ptr(), v_pool.data_ptr(), tables.data_ptr(),
            pos0.data_ptr(), qlen.data_ptr(), out.data_ptr(), b, w, h, h_kv,
            d, bs, tables.shape[1], _KV_DTYPES[k_pool.dtype])
    ragged_paged_attention.launches += 1
    return out


@counted
def paged_attention(q, k_pool, v_pool, tables, pos_vec):
    """Same contract as ``paged_attention_reference``. CUDA tensors launch
    the port of ``_paged_kernel`` (q is taken in f32; the output has the
    pool's dtype); CPU tensors take the plain version. It has no
    backward: inputs that require grad raise."""
    _refuse_grad(paged_attention, q, k_pool, v_pool)
    if plain_or_cuda(paged_attention, q):
        return paged_attention_reference(q, k_pool, v_pool, tables, pos_vec)
    _check_cuda_args(q, k_pool, v_pool, tables, (("pos_vec", pos_vec),))
    _check_decode(q, k_pool)
    b, _, h, d = q.shape
    _, bs, h_kv, _ = k_pool.shape
    qf = q.to(torch.float32).contiguous()
    out = torch.empty((b, 1, h, d), dtype=k_pool.dtype, device=q.device)
    launch("paged_attention", q.device, qf.data_ptr(), k_pool.data_ptr(),
            v_pool.data_ptr(), tables.data_ptr(), pos_vec.data_ptr(),
            out.data_ptr(), b, h, h_kv, d, bs, tables.shape[1],
            _KV_DTYPES[k_pool.dtype])
    paged_attention.launches += 1
    return out


@counted
def quant_paged_attention(q, k_pool, v_pool, k_scale, v_scale, tables,
                          pos_vec):
    """Same contract as ``quant_paged_attention_reference``. CUDA tensors
    launch the port of ``_quant_paged_kernel`` (the output has q's dtype);
    CPU tensors take the plain version. It has no
    backward: inputs that require grad raise."""
    _refuse_grad(quant_paged_attention, q, k_scale, v_scale)
    if plain_or_cuda(quant_paged_attention, q):
        return quant_paged_attention_reference(q, k_pool, v_pool, k_scale,
                                               v_scale, tables, pos_vec)
    _check_cuda_args(q, k_pool, v_pool, tables, (("pos_vec", pos_vec),),
                     quant=True, scales=(("k_scale", k_scale),
                                         ("v_scale", v_scale)))
    _check_decode(q, k_pool)
    b, _, h, d = q.shape
    _, bs, h_kv, _ = k_pool.shape
    qf = q.to(torch.float32).contiguous()
    out = torch.empty((b, 1, h, d), dtype=torch.float32, device=q.device)
    launch("quant_paged_attention", q.device, qf.data_ptr(),
            k_pool.data_ptr(), v_pool.data_ptr(), k_scale.data_ptr(),
            v_scale.data_ptr(), tables.data_ptr(), pos_vec.data_ptr(),
            out.data_ptr(), b, h, h_kv, d, bs, tables.shape[1])
    quant_paged_attention.launches += 1
    return out.to(q.dtype)


@counted
def quant_ragged_paged_attention(q, k_pool, v_pool, k_scale, v_scale,
                                 tables, pos0, qlen):
    """Same contract as ``quant_ragged_paged_attention_reference``. CUDA
    tensors launch the port of ``_quant_ragged_kernel`` (the output has
    q's dtype); CPU tensors take the plain version. It has no
    backward: inputs that require grad raise."""
    _refuse_grad(quant_ragged_paged_attention, q, k_scale, v_scale)
    if plain_or_cuda(quant_ragged_paged_attention, q):
        return quant_ragged_paged_attention_reference(
            q, k_pool, v_pool, k_scale, v_scale, tables, pos0, qlen)
    _check_cuda_args(q, k_pool, v_pool, tables,
                     (("pos0", pos0), ("qlen", qlen)), quant=True,
                     scales=(("k_scale", k_scale), ("v_scale", v_scale)))
    b, w, h, d = q.shape
    _, bs, h_kv, _ = k_pool.shape
    qf = q.to(torch.float32).contiguous()
    out = torch.empty((b, w, h, d), dtype=torch.float32, device=q.device)
    launch("quant_ragged_paged_attention", q.device, qf.data_ptr(),
            k_pool.data_ptr(), v_pool.data_ptr(), k_scale.data_ptr(),
            v_scale.data_ptr(), tables.data_ptr(), pos0.data_ptr(),
            qlen.data_ptr(), out.data_ptr(), b, w, h, h_kv, d, bs,
            tables.shape[1])
    quant_ragged_paged_attention.launches += 1
    return out.to(q.dtype)


# -- numpy-seeded parity inputs ------------------------------------------------

def _random_tables(rng, rows, n_blocks, table_len):
    """Distinct shuffled tables, one per row, never the null block."""
    tables = np.zeros((rows, table_len), np.int32)
    for r in range(rows):
        tables[r] = 1 + rng.permutation(n_blocks - 1)[:table_len]
    return tables


def _random_pools(rng, n_blocks, block_size, n_kv_heads, d_head, quant):
    """(k_pool, v_pool) f32 unit normals, or with ``quant`` the int8 pools
    and f32 scales that the port's ``quantize_kv`` (the serving write path)
    makes of them: (k_pool, v_pool, k_scale, v_scale)."""
    shape = (n_blocks, block_size, n_kv_heads, d_head)
    k = rng.standard_normal(shape, np.float32)
    v = rng.standard_normal(shape, np.float32)
    if not quant:
        return k, v
    qk, sk = quantize_kv(torch.from_numpy(k))
    qv, sv = quantize_kv(torch.from_numpy(v))
    return qk.numpy(), qv.numpy(), sk.numpy(), sv.numpy()


def parity_inputs(batch: int = 2, n_heads: int = 4, n_kv_heads: int = 2,
                  d_head: int = 8, block_size: int = 16, n_blocks: int = 9,
                  table_len: int = 4, seed: int = 0, quant: bool = False):
    """A random decode workload as numpy arrays at the shapes of the JAX
    package's ``parity_check`` (``quant_parity_check`` with ``quant``):
    (q, k_pool, v_pool, tables, pos), or (q, k_pool, v_pool, k_scale,
    v_scale, tables, pos) over an int8 pool. Rows get distinct shuffled
    tables and ragged lengths."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((batch, 1, n_heads, d_head), np.float32)
    pools = _random_pools(rng, n_blocks, block_size, n_kv_heads, d_head,
                          quant)
    tables = _random_tables(rng, batch, n_blocks, table_len)
    pos = rng.integers(0, table_len * block_size, batch).astype(np.int32)
    return (q, *pools, tables, pos)


def ragged_parity_inputs(q_lens=(1, 7, 16, 17), n_heads: int = 4,
                         n_kv_heads: int = 2, d_head: int = 8,
                         block_size: int = 16, n_blocks: int = 33,
                         table_len: int = 6, seed: int = 0,
                         quant: bool = False):
    """A random ragged workload as numpy arrays, one row per entry of
    ``q_lens``, at the shapes of the JAX package's ``ragged_parity_check``
    (``quant_ragged_parity_check`` with ``quant``): (q, k_pool, v_pool,
    tables, pos0, qlen), with k_scale and v_scale after the pools over an
    int8 pool. Rows get distinct shuffled tables and a random history that,
    with the chunk, fits the table."""
    rng = np.random.default_rng(seed)
    batch, w = len(q_lens), max(q_lens)
    q = rng.standard_normal((batch, w, n_heads, d_head), np.float32)
    pools = _random_pools(rng, n_blocks, block_size, n_kv_heads, d_head,
                          quant)
    tables = _random_tables(rng, batch, n_blocks, table_len)
    pos0 = np.array([rng.integers(0, table_len * block_size - ql + 1)
                     for ql in q_lens], np.int32)
    return (q, *pools, tables, pos0, np.asarray(q_lens, np.int32))

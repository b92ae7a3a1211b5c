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
``dot_product_attention``) and a wrapper. The ragged read's kernel cuts
each (row, query tile)'s causal key range into splits of
``ragged_split_len(bs)`` keys and merges their partials by log-sum-exp
(``ragged_split_plan`` gives the split counts, a function of each row's own
pos0 and qlen; ``ragged_paged_attention_split_reference`` repeats the
split and merge arithmetic in plain PyTorch, with q's f32 product against
a bf16 pool taken as the kernel takes it, three bf16 terms of q from
``split_bf16_terms``). For CUDA tensors the wrapper
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

import math
from typing import Optional

import numpy as np
import torch

from tpu_engine_torch.ops.attention import dot_product_attention
from tpu_engine_torch.ops.kernels import counted, launch, plain_or_cuda
from tpu_engine_torch.ops.quant import dequantize_kv, quantize_kv

SUPPORTED_HEAD_DIMS = (8, 16, 32, 64, 128)
MAX_DECODE_GROUP_DIMS = 2048   # G * D a decode thread block accumulates
_KV_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# The ragged kernel: query rows per thread block (row r of a (row, kv head)
# is query slot r // G, group head r % G) and keys per split.
RAGGED_TILE_ROWS = 64
SPLIT_KEYS = 512


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


# -- the ragged read's split and merge ----------------------------------------

def ragged_split_len(block_size: int) -> int:
    """Keys per split of the ragged kernel: SPLIT_KEYS rounded down to whole
    blocks (at least one)."""
    return max(1, SPLIT_KEYS // block_size) * block_size


def ragged_split_plan(pos0, qlen, w: int, g: int, block_size: int,
                      table_len: int, split: Optional[int] = None):
    """(B, tiles) int numpy array: how many splits the ragged kernel takes
    for each (row, tile of RAGGED_TILE_ROWS query rows), 0 for a tile of
    padding slots. A tile's keys are [0, kend), kend = pos0 + the slot of
    its last valid row + 1 (at most table_len * block_size), cut every
    ``split`` keys: a function of the row's own pos0 and qlen only."""
    split = ragged_split_len(block_size) if split is None else int(split)
    p0 = np.asarray(pos0, np.int64)[:, None]
    ql = np.minimum(np.asarray(qlen, np.int64), w)[:, None]
    tiles = -(-w * g // RAGGED_TILE_ROWS)
    row0 = RAGGED_TILE_ROWS * np.arange(tiles, dtype=np.int64)[None, :]
    n_valid = np.minimum(RAGGED_TILE_ROWS, ql * g - row0)
    kend = np.minimum(p0 + (row0 + np.maximum(n_valid, 1) - 1) // g + 1,
                      table_len * block_size)
    return np.where(n_valid > 0, -(-kend // split), 0)


def split_bf16_terms(x):
    """f32 x as three bf16 terms hi + mid + lo, each the bf16 rounding of
    what the terms before it leave: their sum carries x's 24-bit
    significand, so their products with an exact bf16 operand, summed in
    f32, give x's f32 product."""
    hi = x.to(torch.bfloat16)
    rest = x - hi.float()
    mid = rest.to(torch.bfloat16)
    lo = (rest - mid.float()).to(torch.bfloat16)
    return hi, mid, lo


def ragged_paged_attention_split_reference(q, k_pool, v_pool, tables, pos0,
                                           qlen, split: Optional[int] = None):
    """The ragged kernel's arithmetic in plain PyTorch, for the tests: per
    (row, kv head, query tile) and split, the partial (base-2 maximum m,
    sum l of the unrounded weights, f32 sum of the weights rounded to the
    pool's dtype times V), merged in split order by log-sum-exp. Over a
    bf16 pool q's product is the sum of its
    three bf16 terms' products. Same contract as
    ``ragged_paged_attention_reference``; padding slots give 0."""
    b, w, h, d = q.shape
    _, bs, h_kv, _ = k_pool.shape
    g = h // h_kv
    nb = tables.shape[1]
    split = ragged_split_len(bs) if split is None else int(split)
    plan = ragged_split_plan(pos0.cpu().numpy(), qlen.cpu().numpy(), w, g,
                             bs, nb, split)
    scale2 = 1.0 / math.sqrt(d) * math.log2(math.e)
    kk = _gather_rows(k_pool, tables)           # (B, nb * bs, H_kv, D)
    vv = _gather_rows(v_pool, tables)
    qr = (q.float().reshape(b, w, h_kv, g, d).transpose(1, 2)
          .reshape(b, h_kv, w * g, d))          # row r: slot r // g, head r % g
    out = torch.zeros((b, h_kv, w * g, d), dtype=torch.float32,
                      device=q.device)
    bf16 = k_pool.dtype == torch.bfloat16
    for bi in range(b):
        for t, ns in enumerate(plan[bi]):
            if ns == 0:
                continue
            r0 = t * RAGGED_TILE_ROWS
            n_valid = min(RAGGED_TILE_ROWS,
                          min(int(qlen[bi]), w) * g - r0)
            kend = int(min(int(pos0[bi]) + (r0 + n_valid - 1) // g + 1,
                           nb * bs))
            rows = torch.arange(r0, r0 + n_valid, device=q.device)
            qpos = int(pos0[bi]) + rows // g
            for kv in range(h_kv):
                qt = qr[bi, kv, r0:r0 + n_valid]
                parts = []
                for sp in range(int(ns)):
                    k0, k1 = sp * split, min(kend, (sp + 1) * split)
                    kt = kk[bi, k0:k1, kv].float()
                    if bf16:
                        s = sum(t_.float() @ kt.T
                                for t_ in reversed(split_bf16_terms(qt)))
                    else:
                        s = qt @ kt.T
                    kpos = torch.arange(k0, k1, device=q.device)
                    s = torch.where(kpos[None, :] <= qpos[:, None],
                                    s * scale2, float("-inf"))
                    m = s.amax(-1)
                    m_use = torch.where(m == float("-inf"),
                                        torch.zeros_like(m), m)
                    p = torch.exp2(s - m_use[:, None])
                    acc = (p.to(v_pool.dtype).float()
                           @ vv[bi, k0:k1, kv].float())
                    parts.append((m, p.sum(-1), acc))
                # The merge (one split: weight 1, the partial normalised).
                mx = torch.stack([m for m, _, _ in parts]).amax(0)
                mx = torch.where(mx == float("-inf"), torch.zeros_like(mx),
                                 mx)
                wts = [torch.exp2(m - mx) for m, _, _ in parts]
                den = sum(wt * l for wt, (_, l, _) in zip(wts, parts))
                num = sum(wt[:, None] * acc
                          for wt, (_, _, acc) in zip(wts, parts))
                out[bi, kv, r0:r0 + n_valid] = num / torch.where(
                    den > 0, den, torch.ones_like(den))[:, None]
    out = (out.reshape(b, h_kv, w, g, d).transpose(1, 2)
           .reshape(b, w, h, d))
    return out.to(k_pool.dtype)


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
    nb = tables.shape[1]
    qf = q.to(torch.float32).contiguous()
    out = torch.empty((b, w, h, d), dtype=k_pool.dtype, device=q.device)
    # Scratch for the partials of tiles that take more than one split.
    split = ragged_split_len(bs)
    n_split = -(-nb * bs // split)
    rows_pad = -(-w * (h // h_kv) // RAGGED_TILE_ROWS) * RAGGED_TILE_ROWS
    part_acc = part_ml = None
    if n_split > 1:
        rows = b * h_kv * n_split * rows_pad
        part_acc = torch.empty(rows * d, dtype=torch.float32, device=q.device)
        part_ml = torch.empty(rows * 2, dtype=torch.float32, device=q.device)
    launch("ragged_paged_attention", q.device, qf.data_ptr(),
           k_pool.data_ptr(), v_pool.data_ptr(), tables.data_ptr(),
           pos0.data_ptr(), qlen.data_ptr(), out.data_ptr(),
           None if part_acc is None else part_acc.data_ptr(),
           None if part_ml is None else part_ml.data_ptr(), b, w, h, h_kv,
           d, bs, nb, split, _KV_DTYPES[k_pool.dtype])
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

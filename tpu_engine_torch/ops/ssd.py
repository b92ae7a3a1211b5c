"""State Space Duality (SSD) primitives, the Mamba-2 selective scan
(counterpart of ``tpu_engine/ops/ssd.py``), and the window-scan wrapper
the state_slab family serves through.

One recurrence, two dual forms, with the JAX package's shapes and
layouts at the public functions:

    s_t = exp(dt_t * A) * s_{t-1} + dt_t * x_t ⊗ B_t        (state update)
    y_t = C_t · s_t                                          (readout)

    x (b, t, h, p) · dt (b, t, h) · A (h,) · B (b, t, n) · C (b, t, n)
    -> y (b, t, h, p), final state (b, h, p, n).

- ``ssd_step`` / ``ssd_recurrent``: the O(1) recurrence, one step per
  token. Partition-invariant: any windowing of a sequence through repeated
  steps gives the same state bits, which the serving path's byte identity
  across two-path, mixed and replay resumes rests on.
- ``ssd_chunked``: the chunked matmul form (an attention-like masked
  product inside each chunk, one recurrence per chunk), equal to the
  recurrence up to float association (``ssd_parity_check``).

``ssd_scan`` is one layer's masked window recurrence, everything of the
mixer between its two dense products (``models.ssd``): the depthwise short
conv over the cached tail and silu, ``softplus(dt + dt_bias)``,
``A = -exp(A_log)``, the state update and readout, ``+ D·x`` and the gate
``· silu(z)``, for B rows over W slots, updating each row's flat state
(conv tail ⧺ SSM state, the slab's row layout) in place. For CUDA tensors
it launches the hand-written kernel of ``csrc/ssd_scan.cu``; for CPU
tensors, and only for them, it takes the plain version
(``ssd_scan_reference``, a loop over the slots). It never falls back: a
kernel that does not build or launch raises. The JAX package has no Pallas
kernel here (XLA compiles its ``lax.scan`` into one device loop per
dispatch); the kernel exists because an eager loop over the window would
issue W x layers x about 15 small launches per dispatch.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from tpu_engine_torch.ops.kernels import counted, launch, plain_or_cuda


def ssd_step(state, x, dt, A, B, C):
    """One recurrence step for a batch of rows, the O(1) decode form.

    state (b, h, p, n) · x (b, h, p) · dt (b, h) · A (h,) · B (b, n) ·
    C (b, n) -> (y (b, h, p), new_state). The caller owns masking and the
    D·x skip term."""
    dA = torch.exp(dt * A)                                  # (b, h) decay
    dBx = (dt[..., None] * x)[..., None] * B[:, None, None, :]
    new_state = state * dA[..., None, None] + dBx           # (b, h, p, n)
    y = torch.einsum("bhpn,bn->bhp", new_state, C)
    return y, new_state


def ssd_recurrent(x, dt, A, B, C, initial_state=None):
    """Sequential reference: ``ssd_step`` over t. The serving decode
    computation unrolled, the parity anchor ``ssd_chunked`` must match."""
    b, t, h, p = x.shape
    n = B.shape[-1]
    state = (torch.zeros((b, h, p, n), dtype=x.dtype, device=x.device)
             if initial_state is None else initial_state)
    ys = []
    for i in range(t):
        y, state = ssd_step(state, x[:, i], dt[:, i], A, B[:, i], C[:, i])
        ys.append(y)
    return torch.stack(ys, 1), state


def _segsum(a):
    """Lower-triangular pairwise decay sums: out[..., i, j] =
    sum_{j < m <= i} a[..., m] for i >= j, -inf above the diagonal."""
    T = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    s = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=a.device))
    return torch.where(mask, s, torch.full_like(s, float("-inf")))


def ssd_chunked(x, dt, A, B, C, chunk: int = 16, initial_state=None):
    """Chunked matmul form, the prefill-throughput dual of
    ``ssd_recurrent``. A length that is not a chunk multiple is zero-padded
    (dt 0 is the identity step). Returns (y (b, t, h, p), final state
    (b, h, p, n)), equal to the recurrence up to float association."""
    b, t, h, p = x.shape
    n = B.shape[-1]
    c = max(1, int(chunk))
    pad = (-t) % c
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    T = t + pad
    k = T // c
    xd = x * dt[..., None]                                  # dt-weighted input
    a = dt * A[None, None, :]                               # (b, T, h)
    xd_c = xd.reshape(b, k, c, h, p)
    a_c = torch.movedim(a.reshape(b, k, c, h), -1, 1)       # (b, h, k, c)
    B_c = B.reshape(b, k, c, n)
    C_c = C.reshape(b, k, c, n)

    # Intra-chunk: L[i, j] carries the decay from step j's injection to
    # step i's readout.
    L = torch.exp(_segsum(a_c))                             # (b, h, k, c, c)
    scores = torch.einsum("bkin,bkjn->bkij", C_c, B_c)      # (b, k, c, c)
    y_diag = torch.einsum("bhkij,bkij,bkjhp->bkihp", L, scores, xd_c)

    # Each chunk's contribution to the state at its own end.
    a_cum = torch.cumsum(a_c, dim=-1)                       # (b, h, k, c)
    decay_to_end = torch.exp(a_cum[..., -1:] - a_cum)
    chunk_states = torch.einsum("bkjn,bhkj,bkjhp->bkhpn", B_c, decay_to_end,
                                xd_c)

    # One recurrence per chunk carries state across chunk boundaries.
    chunk_decay = torch.exp(a_cum[..., -1])                 # (b, h, k)
    carry = (torch.zeros((b, h, p, n), dtype=x.dtype, device=x.device)
             if initial_state is None else initial_state)
    entering = []
    for i in range(k):
        entering.append(carry)                              # ENTERING state
        carry = carry * chunk_decay[:, :, i, None, None] + chunk_states[:, i]
    entering = torch.stack(entering, 1)                     # (b, k, h, p, n)

    # Off-diagonal: the entering state decayed through each step i
    # (inclusive: the update runs before the readout).
    state_decay = torch.exp(a_cum)                          # (b, h, k, c)
    y_off = torch.einsum("bkin,bkhpn,bhki->bkihp", C_c, entering,
                         state_decay)
    y = (y_diag + y_off).reshape(b, T, h, p)[:, :t]
    return y, carry


def ssd_parity_check(batch: int = 2, seq: int = 37, heads: int = 3,
                     head_dim: int = 8, d_state: int = 5, chunk: int = 8,
                     seed: int = 0, tol: float = 1e-4) -> dict:
    """Duality check: the chunked form and the recurrence give the same
    outputs and final state within ``tol`` (float association is the only
    difference), on the JAX function's numpy-seeded inputs. The sequence
    length is not a chunk multiple, so the padding path runs."""
    rng = np.random.default_rng(seed)
    f32 = torch.float32
    x = torch.as_tensor(rng.standard_normal((batch, seq, heads, head_dim)),
                        dtype=f32)
    dt = torch.as_tensor(rng.uniform(0.01, 0.4, (batch, seq, heads)),
                         dtype=f32)
    A = -torch.exp(torch.as_tensor(rng.uniform(-1.0, 1.0, (heads,)),
                                   dtype=f32))
    B = torch.as_tensor(rng.standard_normal((batch, seq, d_state)), dtype=f32)
    C = torch.as_tensor(rng.standard_normal((batch, seq, d_state)), dtype=f32)
    y_rec, s_rec = ssd_recurrent(x, dt, A, B, C)
    y_chk, s_chk = ssd_chunked(x, dt, A, B, C, chunk=chunk)
    dy = float(torch.max(torch.abs(y_rec - y_chk)))
    ds = float(torch.max(torch.abs(s_rec - s_chk)))
    return {"max_abs_diff_y": dy, "max_abs_diff_state": ds,
            "tol": float(tol), "chunk": int(chunk), "seq": int(seq),
            "ok": bool(dy < tol and ds < tol)}


# -- the window scan ---------------------------------------------------------

def softplus(x):
    """``jax.nn.softplus``'s formula: log1p(exp(-|x|)) + max(x, 0)."""
    return torch.log1p(torch.exp(-torch.abs(x))) + torch.clamp(x, min=0.0)


def scan_geometry(proj, state, conv_w, d_state: int, n_heads: int):
    """(di, N, H, P, K) of a window scan, checked against the tensors:
    proj (B, W, 2·di + 2·N + H), conv_w (K, di), state (R, (K-1)·di +
    H·P·N)."""
    K, di = conv_w.shape
    N, H = int(d_state), int(n_heads)
    if di % H:
        raise ValueError(f"d_inner={di} must divide by n_heads={H}")
    P = di // H
    if proj.dim() != 3 or proj.shape[-1] != 2 * di + 2 * N + H:
        raise ValueError(f"proj {tuple(proj.shape)} is not (B, W, "
                         f"{2 * di + 2 * N + H})")
    if state.dim() != 2 or state.shape[1] != (K - 1) * di + H * P * N:
        raise ValueError(f"state {tuple(state.shape)} is not (rows, "
                         f"{(K - 1) * di + H * P * N})")
    return di, N, H, P, K


def mixer_slot(proj_j, conv_s, ssm_s, conv_w, conv_b, dt_bias, A_log, D,
               d_state: int, n_heads: int):
    """One slot of the mixer between its dense products (JAX
    ``models.ssd._mixer_step``): proj_j (b, 2·di + 2·N + H), conv_s
    (b, K-1, di), ssm_s (b, H, P, N) -> (gated y (b, di), new conv tail,
    new SSM state)."""
    di = conv_w.shape[1]
    N, H = int(d_state), int(n_heads)
    z = proj_j[:, :di]
    xr = proj_j[:, di:2 * di]
    Bv = proj_j[:, 2 * di:2 * di + N]
    Cv = proj_j[:, 2 * di + N:2 * di + 2 * N]
    dt = proj_j[:, 2 * di + 2 * N:]
    window = torch.cat([conv_s, xr[:, None, :]], dim=1)     # (b, K, di)
    xc = F.silu(torch.einsum("bkd,kd->bd", window, conv_w) + conv_b)
    dtp = softplus(dt + dt_bias)                            # (b, H)
    A = -torch.exp(A_log)
    xh = xc.reshape(-1, H, di // H)
    y_h, new_ssm = ssd_step(ssm_s, xh, dtp, A, Bv, Cv)
    y = (y_h + D[None, :, None] * xh).reshape(-1, di)
    return y * F.silu(z), window[:, 1:], new_ssm


def ssd_scan_reference(proj, state, row_ids, qlen, conv_w, conv_b, dt_bias,
                       A_log, D, d_state: int, n_heads: int):
    """Plain version of the window scan: a loop over the W slots, each one
    ``mixer_slot`` for every row, a row's state advancing only at slots
    j < qlen[r]. state (R, state_dim) f32 is updated in place at rows
    ``row_ids`` (B,); rows with qlen 0 are not written. Returns y
    (B, W, di) f32, 0 at slots j >= qlen[r]."""
    di, N, H, P, K = scan_geometry(proj, state, conv_w, d_state, n_heads)
    b, w, _ = proj.shape
    ids = row_ids.long()
    split = (K - 1) * di
    rows = state[ids]
    conv = rows[:, :split].reshape(b, K - 1, di)
    ssm = rows[:, split:].reshape(b, H, P, N)
    ql = qlen.to(device=proj.device).long()
    y = torch.zeros((b, w, di), dtype=torch.float32, device=proj.device)
    for j in range(w):
        valid = j < ql
        if not bool(valid.any()):
            break
        yj, conv2, ssm2 = mixer_slot(proj[:, j].float(), conv, ssm, conv_w,
                                     conv_b, dt_bias, A_log, D, N, H)
        y[:, j] = torch.where(valid[:, None], yj, torch.zeros_like(yj))
        conv = torch.where(valid[:, None, None], conv2, conv)
        ssm = torch.where(valid[:, None, None, None], ssm2, ssm)
    live = ql > 0
    if bool(live.any()):
        flat = torch.cat([conv.reshape(b, -1), ssm.reshape(b, -1)], dim=1)
        state[ids[live]] = flat[live]
    return y


def _check_scan_cuda(proj, state, row_ids, qlen, weights) -> None:
    dev = proj.device
    for name, t in (("proj", proj), ("state", state), *weights):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, proj on {dev}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("row_ids", row_ids), ("qlen", qlen)):
        if t.device != dev or t.dtype != torch.int32 or t.dim() != 1 \
                or t.shape[0] != proj.shape[0]:
            raise ValueError(f"{name} must be a ({proj.shape[0]},) int32 "
                             f"tensor on {dev}")


# The kernel keeps each thread's share of a head's (P, N) state in 16
# registers, N split over a power-of-two group of lanes, and the conv tail
# in registers of at most MAX_CONV - 1 values.
SCAN_STATE_PER_THREAD = 16
MAX_CONV = 8
MAX_SCAN_THREADS = 256


def scan_threads(P: int, N: int) -> int:
    """Threads of one (row, head) block: P channels times the lanes that
    split a channel's N state values, rounded up to whole warps."""
    lanes = 1
    while lanes * SCAN_STATE_PER_THREAD < N:
        lanes *= 2
    return -(-P * lanes // 32) * 32


@counted
def ssd_scan(proj, state, row_ids, qlen, conv_w, conv_b, dt_bias, A_log, D,
             d_state: int, n_heads: int):
    """Same contract as ``ssd_scan_reference``. CUDA tensors launch the
    kernel of ``csrc/ssd_scan.cu`` (one launch per call); CPU tensors take
    the plain version. Serving calls it under ``torch.no_grad()``: it has
    no backward, and inputs that require grad raise."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (proj, state, conv_w)):
        raise RuntimeError("ssd_scan has no backward: call it under "
                           "torch.no_grad()")
    if plain_or_cuda(ssd_scan, proj):
        return ssd_scan_reference(proj, state, row_ids, qlen, conv_w, conv_b,
                                  dt_bias, A_log, D, d_state, n_heads)
    weights = (("conv_w", conv_w), ("conv_b", conv_b), ("dt_bias", dt_bias),
               ("A_log", A_log), ("D", D))
    _check_scan_cuda(proj, state, row_ids, qlen, weights)
    di, N, H, P, K = scan_geometry(proj, state, conv_w, d_state, n_heads)
    if not 2 <= K <= MAX_CONV:
        raise ValueError(f"d_conv={K} outside the kernel's [2, {MAX_CONV}]")
    if scan_threads(P, N) > MAX_SCAN_THREADS:
        raise ValueError(f"head_dim={P} x d_state={N} needs more than "
                         f"{MAX_SCAN_THREADS} threads a block")
    b, w, _ = proj.shape
    y = torch.empty((b, w, di), dtype=torch.float32, device=proj.device)
    launch("ssd_scan", proj.device, proj.data_ptr(), state.data_ptr(),
           row_ids.data_ptr(), qlen.data_ptr(), conv_w.data_ptr(),
           conv_b.data_ptr(), dt_bias.data_ptr(), A_log.data_ptr(),
           D.data_ptr(), y.data_ptr(), b, w, di, N, H, K, state.shape[1])
    ssd_scan.launches += 1
    return y


def scan_parity_inputs(batch: int, width: int, d_inner: int, d_state: int,
                       n_heads: int, d_conv: int = 4,
                       rows: Optional[int] = None, seed: int = 0):
    """A random window-scan workload as numpy arrays: (proj, state,
    row_ids, conv_w, conv_b, dt_bias, A_log, D) at the model's scales
    (unit-normal projections and states, conv_w N(0, 1/K), A_log =
    log(1..H), dt_bias N(0, 0.01), D ones), ``rows`` slab rows (default
    batch + 1, row 0 the null row) and distinct shuffled row ids."""
    rng = np.random.default_rng(seed)
    H, N, K = n_heads, d_state, d_conv
    rows = batch + 1 if rows is None else rows
    sd = (K - 1) * d_inner + d_inner * N
    f = np.float32
    proj = rng.standard_normal((batch, width, 2 * d_inner + 2 * N + H)
                               ).astype(f)
    state = rng.standard_normal((rows, sd)).astype(f)
    row_ids = (1 + rng.permutation(rows - 1)[:batch]).astype(np.int32)
    conv_w = (rng.standard_normal((K, d_inner)) / np.sqrt(K)).astype(f)
    conv_b = np.zeros((d_inner,), f)
    dt_bias = (0.1 * rng.standard_normal((H,))).astype(f)
    A_log = np.log(np.arange(1, H + 1, dtype=f))
    D = np.ones((H,), f)
    return proj, state, row_ids, conv_w, conv_b, dt_bias, A_log, D

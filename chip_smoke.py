"""On-card smoke test of the PyTorch/CUDA port (``tpu_engine_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. device   — the card's name and power limit (nvidia-smi);
2. build    — nvcc builds the seven kernels of tpu_engine_torch/csrc
              (five sources, one process per source, all started together)
              into one library;
3. parity   — each kernel against its plain PyTorch version on the card:
              f32 at the JAX package's parity-check and flash-test shapes
              and the flash forward at the train phase's shape (tolerance
              1e-5), bf16 at the main path's shapes (2e-2 on unit
              normals; for the flash forward on out and lse), int8 pools at
              both (2e-4, the JAX package's bound for its int8 kernels); the
              flash forward and the ragged read bit-identical over two
              runs, and each ragged row bit-identical alone and in its
              batch (its split plan depends on its own data only); the
              flash backward (#6 dq, #7 dk and dv) at
              tests/test_flash_backward.py's shapes, its window case and
              the train phase's shape in f32 (1e-4 of the gradient's
              largest magnitude; also the
              FlashAttention autograd Function as a whole) and at TinyLlama
              prefill rows in bf16 (2e-2), each bit-identical over two runs;
              then a small llama (f32, TF32 off) served on the card through
              a mixed, a two-path, two int8 and a dense lane, and a small
              mistral (sliding window) through a dense lane, agrees token
              for token with the same weights served on the CPU through the
              plain versions; three training steps of the small llama on
              the card give the CPU's losses (f32 1e-4 relative; bf16
              compute 2e-2); the train
              command trains it with --out, --resume continues the step
              count, and the port's worker serving <out>/params gives the
              in-process generator's greedy tokens;
4. server   — the port's worker over HTTP on localhost serving
              TinyLlama-1.1B geometry (random weights from seed 0, bf16,
              shared by every lane, 256-token prefill chunks) in five lanes,
              each driven with the launch counts set to 0 just before it
              and read just after: over 16-token KV blocks, mixed stepping
              over the bf16 pool (the ragged kernel), two-path with 16-step
              decode chunks (the decode kernel), mixed over the int8 pool
              (the int8 ragged kernel) and two-path over the int8 pool (the
              int8 decode kernel); each answers a burst of concurrent
              /generate requests and one /generate/stream, a shared-prefix
              request and a greedy repeat: every request completes, the
              repeat is token-identical, ticks == dispatches (mixed) or
              chunks > 0 (two-path), no block leaks once idle. The fifth,
              the worker's default lane (dense cache, 16-step chunks, a
              64 MB prefix cache), answers six prompts of at most 256 tokens
              (one flash prefill each), a 600-token prompt (prefill windows,
              no flash), an exact repeat (a prefix-cache hit, no flash), a
              greedy repeat and one stream: flash launches == 22 x the
              monolithic prefills that missed the cache. In every lane the
              lane's kernel, and no plain version, served its attention;
5. train    — after the server phase has stopped its lanes: full-width
              training of TinyLlama-1.1B geometry (22 layers, f32 weights
              from seed 0, AdamW) on the train command's synthetic batch,
              4 steps at B 4 x S 1024 with an f32 forward (lr 1e-4; the
              loss must fall), 3 at the same shape in make_train_step's
              default bf16 compute (the loss must fall) and 2 at
              B 8 x S 2048 with remat in f32, the launch counts
              set to 0 before the phase and read after every step: 22 flash
              forwards (44 with remat) and 22 launches of each backward
              kernel per step, no plain call; per step wall, host issue and
              device busy time, the idle share, the flash kernels' shares
              (and the device time of their f32 and bf16 variants),
              tokens/s and peak memory;
6. numbers  — each kernel's time at the main path's shapes (with events
              and as device time) beside its bound, the plain version's
              time and the library's (scaled_dot_product_attention; for the
              paged reads over K/V gathered dense, and dequantized for
              int8, beforehand; for the flash forward over q, k, v
              transposed beforehand, its backend forced, in f32 at the
              dense prefill's and the train phase's shapes and in bf16 at
              prefill rows, and for the
              backward the device time of its autograd backward, beside
              which #6 and #7 are also timed as device time, both robust to
              the profiler dropping a session's first events; no copy is
              timed, and the port never calls the library); one full-width
              forward per step the lanes run (the two-path prefill window
              and the dense prefill at 256 and 2048 tokens included), the
              host's time to issue it, the card's busy time in it
              (torch.profiler) and the attention kernel's share (22
              launches at its isolated device time; for the dense prefill
              the f32 flash variant, which that path launches).

The last line of standard output is the JSON result; the line before it
the card's name and power limit; the line before that the kernels' JSON
("ms" and "library_ms" there are device times of one call).

    python3 chip_smoke.py --kernel-times [--package-root DIR]

runs only the kernels' device times (#1 and #5 at the main path's shapes,
#6/#7 at the train shape and a bf16 S 2048 row) through the package under
DIR (default: this checkout), so that two trees (a parent commit unpacked
under build/, and this one) can be timed in turns in one call.
"""

from __future__ import annotations

import http.client
import json
import subprocess
import sys
import threading
import time
import traceback
from pathlib import Path

import numpy as np

PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
PEAK_BF16_FLOPS = 989e12     # H100 SXM dense bf16 tensor-core rate
# H100 SXM float32 outside the tensor cores: the roof of the port's f32
# products, which run without TF32.
PEAK_F32_FLOPS = 67e12
F32_TOL = 1e-5
# The flash backward, as max|got - ref| / max|ref| per gradient: f32 sums
# in another order (1e-4); bf16 p and ds rounded from f32 values that
# differ in their last bits (2e-2).
BWD_F32_TOL = 1e-4
BF16_TOL = 2e-2
QUANT_TOL = 2e-4
OUT_DIR = Path("chiprun_out")
# (key, B, S, dtype) of the flash forward's readings: the dense lane's
# prefill (f32, as every main path launches it: q, k, v come out of
# nn.dense as f32) first, for the kernels line, then the train phase's
# shape and the bf16 variant.
FLASH_SHAPES = (("prefill S=256 f32", 1, 256, "float32"),
                ("train B=4 S=1024 f32", 4, 1024, "float32"),
                ("prefill S=2048 f32", 1, 2048, "float32"),
                ("prefill S=256", 1, 256, "bfloat16"),
                ("prefill S=2048", 1, 2048, "bfloat16"))
MAX_NEW = 32
# The TPU kernel each CUDA kernel replaces, and the lane whose path
# launches it.
KERNELS = {
    "ragged_paged_attention": dict(
        source="tpu_engine_torch/csrc/ragged_paged_attention.cu",
        replaces="tpu_engine/ops/paged_attention.py:226", lane="mixed-bf16"),
    "paged_attention": dict(
        source="tpu_engine_torch/csrc/paged_attention.cu",
        replaces="tpu_engine/ops/paged_attention.py:83",
        lane="two-path-bf16"),
    "quant_paged_attention": dict(
        source="tpu_engine_torch/csrc/paged_attention.cu",
        replaces="tpu_engine/ops/paged_attention.py:427",
        lane="two-path-int8"),
    "quant_ragged_paged_attention": dict(
        source="tpu_engine_torch/csrc/quant_ragged_paged_attention.cu",
        replaces="tpu_engine/ops/paged_attention.py:516",
        lane="mixed-int8"),
    "flash_attention": dict(
        source="tpu_engine_torch/csrc/flash_attention.cu",
        replaces="tpu_engine/ops/flash.py:53", lane="dense-bf16"),
    "flash_attention_bwd_dq": dict(
        source="tpu_engine_torch/csrc/flash_attention_bwd.cu",
        replaces="tpu_engine/ops/flash.py:208", lane="train"),
    "flash_attention_bwd_dkv": dict(
        source="tpu_engine_torch/csrc/flash_attention_bwd.cu",
        replaces="tpu_engine/ops/flash.py:255", lane="train"),
}
PAGED = dict(gen_kv_block_size=16)
LANES = {
    "mixed-bf16": dict(PAGED, gen_mixed_step=True,
                       gen_mixed_token_budget=256),
    "two-path-bf16": dict(PAGED, gen_step_chunk=16),
    "mixed-int8": dict(PAGED, gen_mixed_step=True,
                       gen_mixed_token_budget=256, gen_kv_quantize="int8"),
    "two-path-int8": dict(PAGED, gen_step_chunk=16, gen_kv_quantize="int8"),
    # The worker's defaults: dense cache, 16-step chunks, 64 MB prefix
    # cache.
    "dense-bf16": dict(gen_step_chunk=16),
}


def wrapper(name: str):
    """The counted wrapper that launches kernel ``name``."""
    from tpu_engine_torch.ops import flash, paged_attention

    if name == "flash_attention":
        return flash.flash_attention_fwd
    if name.startswith("flash_attention_bwd"):
        return getattr(flash, name)
    return getattr(paged_attention, name)


def launch_counts() -> dict:
    return {k: (wrapper(k).launches, wrapper(k).plain_calls)
            for k in KERNELS}


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# -- kernel inputs at the main path's shapes ----------------------------------

def main_path_inputs(torch, dev, decode_only: bool, int8: bool = False,
                     seed: int = 1):
    """The batch a TinyLlama step hands the kernels: 8 rows, 32 query / 4
    KV heads, D 64, 16-token blocks, tables 128 wide (max_seq 2048). Mixed
    (W = 256): seven decode rows at contexts up to 2047 and one 256-token
    chunk at pos0 1700; decode only: eight q_len-1 rows. A bf16 pool, or
    the int8 pool and scales the port's quantize_kv makes of the same f32
    values. Returns (q, k, v, [k_scale, v_scale,] tables, pos0, qlen)."""
    from tpu_engine_torch.ops.quant import quantize_kv

    rng = np.random.default_rng(seed)
    b, h, h_kv, d, bs, nb = 8, 32, 4, 64, 16, 128
    w = 1 if decode_only else 256
    n_pool = b * nb + 1
    q = torch.from_numpy(rng.standard_normal((b, w, h, d), np.float32))
    k = torch.from_numpy(rng.standard_normal((n_pool, bs, h_kv, d),
                                             np.float32)).to(dev)
    v = torch.from_numpy(rng.standard_normal((n_pool, bs, h_kv, d),
                                             np.float32)).to(dev)
    tables = (1 + rng.permutation(n_pool - 1)[:b * nb]).reshape(b, nb)
    pos0 = np.array([100, 500, 1000, 2046, 17, 1500, 0, 1700], np.int32)
    qlen = np.ones((b,), np.int32)
    if not decode_only:
        qlen[7] = 256
    if int8:
        (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
        pools = (k, v, ks, vs)
    else:
        pools = (k.bfloat16(), v.bfloat16())
    return (q.to(dev), *pools,
            torch.from_numpy(tables.astype(np.int32)).to(dev),
            torch.from_numpy(pos0).to(dev), torch.from_numpy(qlen).to(dev))


def decode_args(inp):
    """Decode-only ragged inputs as the decode read's (q, pools...,
    tables, pos): the W = 1 rows' pos0 is their pos."""
    return inp[:-1]


def bound_ms(q, k_pool, tables, pos0, qlen, out_item: int,
             scale_bytes: int = 0) -> tuple:
    """Least time the card could take for this call: the larger of the
    bytes the function must move (valid query slots read in f32, the K/V
    blocks each row's queries reach read once, with ``scale_bytes`` of
    scales per (slot, kv-head) for each of K and V, valid output slots
    written) over 3.35 TB/s, and its multiply-adds (QK and PV, 4*D flops
    per (query head, key) pair attended) over the bf16 tensor-core rate."""
    _, _, h, d = q.shape
    bs, h_kv = k_pool.shape[1], k_pool.shape[2]
    p0 = pos0.cpu().numpy().astype(np.int64)
    ql = qlen.cpu().numpy().astype(np.int64)
    live = ql > 0
    blocks = np.where(live, (p0 + ql - 1) // bs + 1, 0).sum()
    kv_bytes = blocks * 2 * bs * h_kv * (d * k_pool.element_size()
                                         + scale_bytes)
    io_bytes = ql.sum() * h * d * (q.element_size() + out_item)
    meta_bytes = tables.numel() * 4 + 2 * pos0.numel() * 4
    pairs = sum(int(ql[r] * (p0[r] + 1) + ql[r] * (ql[r] - 1) // 2)
                for r in range(len(ql)))
    flops = pairs * h * 4 * d
    t_bytes = (kv_bytes + io_bytes + meta_bytes) / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations")


def time_ms(torch, fn, iters: int = 20) -> float:
    """Mean device time of fn() with a cold L2: a 64 MB write between
    launches evicts the 50 MB cache, and CUDA events bracket each call."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        total += e0.elapsed_time(e1)
    return total / iters


def issue_ms(torch, fn, iters: int = 10) -> float:
    """Mean host time to issue fn() (no synchronise inside it): where it
    comes near the device time, the card waits on the host."""
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        total += time.perf_counter() - t0
        torch.cuda.synchronize()
    return total / iters * 1e3


def busy_ms(torch, fn, iters: int = 3) -> float:
    """Mean device-busy time of fn(): the durations of the device-side
    events (kernels, copies, fills) under torch.profiler, summed; host
    ops are left out, since their device time repeats their kernels'.
    Against the wall time of fn() it gives the share of a step the card
    sits idle."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.device_time_total for e in prof.events()
             if e.device_type == DeviceType.CUDA)
    check(us > 0, "the profiler saw no device time")
    return us / iters / 1e3


def device_call_ms(torch, fn, iters: int = 20) -> tuple:
    """Device time of one fn() call under torch.profiler, and the number of
    calls whose device events it saw whole. The profiler can drop the first
    events of a session, so a sum over the session would undercount: each
    device event name (kernel, copy, fill) counts its mean duration times
    its occurrences per call (its count over the fewest count of any name),
    summed. A session that saw fewer than half the calls whole (it once
    kept one of 20) is run again, up to three sessions; the reading of the
    session that saw the most calls is returned."""
    from collections import defaultdict

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    best = None
    for _ in range(3):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        by_name = defaultdict(list)
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                by_name[e.name].append(e.device_time_total)
        check(len(by_name) > 0, "the profiler saw no device time")
        calls = min(len(v) for v in by_name.values())
        us = sum(sum(v) / len(v) * round(len(v) / calls)
                 for v in by_name.values())
        if best is None or calls > best[1]:
            best = (us / 1e3, calls)
        if calls >= iters // 2:
            break
    return best


def sdpa_yardstick(torch, inp, int8: bool):
    """scaled_dot_product_attention over K/V gathered dense (and, for the
    int8 pool, dequantized to f32) BEFOREHAND, with the causal mask of
    the paged read: the library's time for the same function (the gather
    is outside the timed call)."""
    import torch.nn.functional as F

    from tpu_engine_torch.ops.quant import dequantize_kv

    q, tables, pos0 = inp[0], inp[-3], inp[-2]
    b, w, h, d = q.shape
    bs, h_kv = inp[1].shape[1], inp[1].shape[2]
    nb = tables.shape[1]
    idx = tables.long()

    def dense(pool, scale):
        g = pool[idx]
        if int8:
            g = dequantize_kv(g, scale[idx])
        return g.reshape(b, nb * bs, h_kv, d).transpose(1, 2).contiguous()

    kk = dense(inp[1], inp[3] if int8 else None)
    vv = dense(inp[2], inp[4] if int8 else None)
    qq = q.to(kk.dtype).transpose(1, 2).contiguous()
    qpos = pos0.long()[:, None] + torch.arange(w, device=q.device)[None]
    mask = (torch.arange(nb * bs, device=q.device)[None, None, :]
            <= qpos[:, :, None])[:, None]           # (B, 1, W, S)

    def call():
        return F.scaled_dot_product_attention(qq, kk, vv, attn_mask=mask,
                                              enable_gqa=True)
    return call


def flash_inputs(torch, dev, s: int, h: int, d: int, pad: int = 0,
                 seed: int = 2, dtype=None, b: int = 1):
    """A prefill's flash call as the dense lane makes it: one row (B 1) of
    unit-normal q, k, v (b, s, h, d), bf16 unless ``dtype`` says otherwise,
    with a left-padding mask whose first ``pad`` columns are padding (None
    for pad 0); ``b`` rows for the train phase's shape."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, s, h, d),
                                                    np.float32))
               .to(dev, dtype or torch.bfloat16) for _ in range(3))
    mask = None
    if pad:
        m = np.ones((b, s), np.int32)
        m[:, :pad] = 0
        mask = torch.from_numpy(m).to(dev)
    return q, k, v, mask


def flash_bound_ms(q, causal: bool = True) -> tuple:
    """Least time for a causal flash forward over (B, S, H, D) inputs with
    no mask: the larger of the bytes (q, k, v read once, out written once,
    in their dtype, and the f32 lse) over 3.35 TB/s and 4*D flops per
    attended (query, key) pair, S(S+1)/2 per head, over the card's peak in
    the inputs' type (bf16 tensor cores, or f32 CUDA cores: the port's f32
    products run without TF32)."""
    b, s, h, d = q.shape
    nbytes = 4 * q.numel() * q.element_size() + b * h * s * 4
    pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
    peak = PEAK_BF16_FLOPS if q.element_size() == 2 else PEAK_F32_FLOPS
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = 4 * d * pairs / peak * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations")


# -- HTTP client ---------------------------------------------------------------

def post(port: int, path: str, body: dict, timeout: float = 600.0) -> dict:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", path, json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
        check(resp.status == 200, f"{path} answered {resp.status}: "
                                  f"{data[:300]!r}")
        return json.loads(data)
    finally:
        conn.close()


def get(port: int, path: str) -> dict:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        data = resp.read()
        check(resp.status == 200, f"{path} answered {resp.status}")
        return json.loads(data)
    finally:
        conn.close()


def stream(port: int, body: dict) -> tuple:
    """POST /generate/stream; returns (streamed tokens, terminal event,
    seconds to the first token event)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    t0 = time.perf_counter()
    ttft = None
    toks, final = [], None
    try:
        conn.request("POST", "/generate/stream", json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        check(resp.status == 200, f"stream answered {resp.status}")
        buf = b""
        while True:
            chunk = resp.read1(65536)
            if not chunk:
                break
            buf += chunk
            while b"\n\n" in buf:
                frame, buf = buf.split(b"\n\n", 1)
                ev = json.loads(frame[len(b"data: "):])
                if ev.get("done"):
                    final = ev
                else:
                    if ttft is None:
                        ttft = time.perf_counter() - t0
                    toks.extend(ev["tokens"])
    finally:
        conn.close()
    return toks, final, ttft


# -- phases --------------------------------------------------------------------

def _valid_err(torch, out, ref, qlen):
    valid = (torch.arange(out.shape[1], device=out.device)[None]
             < qlen[:, None])[:, :, None, None]
    return float(((out.float() - ref.float()).abs() * valid).max())


def ragged_rows_identical(torch, pa, t, out, shape: str) -> None:
    """#1 gives the same bits over two runs, and each row's output run
    alone (a batch of one, W its own qlen) equals its output in the batch
    bit for bit: a row's split plan and arithmetic depend on its own data
    only."""
    check(torch.equal(out, pa.ragged_paged_attention(*t)),
          f"ragged_paged_attention {shape}: two runs differ")
    q, k, v, tables, pos0, qlen = t
    for r, ql in enumerate(qlen.tolist()):
        alone = pa.ragged_paged_attention(
            q[r:r + 1, :max(ql, 1)].contiguous(), k, v, tables[r:r + 1],
            pos0[r:r + 1], qlen[r:r + 1])
        check(torch.equal(alone[0, :ql], out[r, :ql]),
              f"ragged_paged_attention {shape}: row {r} alone differs from "
              f"the batch")
    log(f"parity ragged_paged_attention bf16 main path {shape}: "
        f"bit-identical over two runs and row by row alone")


def phase_parity(torch, pa) -> dict:
    dev = torch.device("cuda")
    errs = {name: {} for name in KERNELS}

    def record(kernel, case, err, tol, ref_max=None):
        """``ref_max``: the tolerance is ``tol`` times the reference's
        largest magnitude (the backward's gradients), else absolute."""
        bound = tol if ref_max is None else tol * ref_max
        scope = "" if ref_max is None else f" x max|ref| {ref_max:.3e}"
        log(f"parity {kernel} {case}: max_abs_err {err:.3e} (tol "
            f"{tol:g}{scope})")
        check(err <= bound, f"{kernel} parity {case}: {err} > {bound}")
        errs[kernel][case] = err

    def run(kernel, t):
        out = getattr(pa, kernel)(*t)
        ref = getattr(pa, kernel + "_reference")(*t)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out.float()).all()),
              f"{kernel}: non-finite output")
        return out, ref

    on = (lambda arrs: [torch.from_numpy(a).to(dev) for a in arrs])
    # The JAX package's parity-check shapes: f32 pools (int8 for quant).
    for name, q_lens in (("ragged_parity_check", (1, 7, 16, 17)),
                         ("spec_verify_parity_check", (1, 5, 5, 16, 17))):
        t = on(pa.ragged_parity_inputs(q_lens=q_lens))
        out, ref = run("ragged_paged_attention", t)
        record("ragged_paged_attention", f"f32 {name}",
               _valid_err(torch, out, ref, t[-1]), F32_TOL)
    decode_cases = (("parity_check", {}),
                    ("parity_check G4 D16 bs8",
                     dict(n_heads=8, n_kv_heads=2, d_head=16, block_size=8,
                          n_blocks=17, table_len=6)))
    for name, kw in decode_cases:
        out, ref = run("paged_attention", on(pa.parity_inputs(**kw)))
        record("paged_attention", f"f32 {name}",
               float((out - ref).abs().max()), F32_TOL)
    for name, kw in (("quant_parity_check", {}),
                     ("quant_parity_check G4 D64 nb33",
                      dict(n_heads=8, n_kv_heads=2, d_head=64,
                           n_blocks=33, table_len=8))):
        out, ref = run("quant_paged_attention",
                       on(pa.parity_inputs(quant=True, **kw)))
        record("quant_paged_attention", f"int8 {name}",
               float((out - ref).abs().max()), QUANT_TOL)
    for name, kw in (("quant_ragged_parity_check", {}),
                     ("quant_ragged_parity_check G4 D32",
                      dict(q_lens=(1, 3, 16, 17), n_heads=8, n_kv_heads=2,
                           d_head=32, table_len=8))):
        t = on(pa.ragged_parity_inputs(quant=True, **kw))
        out, ref = run("quant_ragged_paged_attention", t)
        record("quant_ragged_paged_attention", f"int8 {name}",
               _valid_err(torch, out, ref, t[-1]), QUANT_TOL)
    # The main path's shapes: bf16 and int8 pools.
    for decode_only in (False, True):
        shape = "decode W=1" if decode_only else "mixed W=256"
        t = main_path_inputs(torch, dev, decode_only)
        out, ref = run("ragged_paged_attention", t)
        record("ragged_paged_attention", f"bf16 main path {shape}",
               _valid_err(torch, out, ref, t[-1]), BF16_TOL)
        ragged_rows_identical(torch, pa, t, out, shape)
        t = main_path_inputs(torch, dev, decode_only, int8=True)
        out, ref = run("quant_ragged_paged_attention", t)
        record("quant_ragged_paged_attention", f"int8 main path {shape}",
               _valid_err(torch, out, ref, t[-1]), QUANT_TOL)
    out, ref = run("paged_attention",
                   decode_args(main_path_inputs(torch, dev, True)))
    record("paged_attention", "bf16 main path decode",
           float((out.float() - ref.float()).abs().max()), BF16_TOL)
    out, ref = run("quant_paged_attention",
                   decode_args(main_path_inputs(torch, dev, True, True)))
    record("quant_paged_attention", "int8 main path decode",
           float((out - ref).abs().max()), QUANT_TOL)
    parity_flash(torch, dev, record)
    parity_flash_bwd(torch, dev, record)
    return errs


# (case, parity_inputs kwargs, causal, valid leading keys or None, window):
# the shapes of tests/test_flash_attention.py and the window cases of
# tests/test_sliding_window.py.
FLASH_F32_CASES = (
    ("causal", {}, True, None, None),
    ("non-causal", {}, False, None, None),
    ("ragged 37/53", dict(sq=37, sk=53), False, None, None),
    ("causal ragged 45", dict(sq=45), True, None, None),
    ("padding mask", {}, False, 40, None),
    ("causal + mask", {}, True, 50, None),
    ("fully masked", {}, False, 0, None),
    ("window 7 S200", dict(sq=200, n_heads=2, d_head=32), True, None, 7),
    ("window 64 S200", dict(sq=200, n_heads=2, d_head=32), True, None, 64),
    ("train shape (4, 1024, 32, 64)",
     dict(batch=4, sq=1024, n_heads=32, d_head=64), True, None, None),
)
# (case, S, H, D, left padding, window): TinyLlama prefills and a
# Mistral-width band.
FLASH_BF16_CASES = (
    ("TinyLlama prefill S256", 256, 32, 64, 37, None),
    ("TinyLlama prefill S2048", 2048, 32, 64, 300, None),
    ("Mistral band S1024 window 256", 1024, 8, 128, 100, 256),
)


def flash_err(torch, out, lse, ref, ref_lse) -> float:
    """Largest difference on out and on lse (rows with a valid key; both
    must be -inf, and out 0, on the others)."""
    dead = torch.isinf(ref_lse)
    check(torch.equal(torch.isinf(lse), dead)
          and not bool(torch.isnan(out.float()).any()),
          "flash_attention: lse -inf rows differ or NaN output")
    lse_err = torch.where(dead, 0.0, lse - ref_lse).abs().max()
    return max(float((out.float() - ref.float()).abs().max()),
               float(lse_err))


def flash_identical(torch, fl, q, k, v, args, out, lse, case) -> None:
    """#5 gives the same bits over two runs."""
    again = fl.flash_attention_fwd(q, k, v, **args)
    check(torch.equal(out, again[0]) and torch.equal(lse, again[1]),
          f"flash_attention {case}: two runs differ")


def parity_flash(torch, dev, record) -> None:
    from tpu_engine_torch.ops import flash as fl

    for case, kw, causal, valid, window in FLASH_F32_CASES:
        q, k, v = (torch.from_numpy(a).to(dev) for a in fl.parity_inputs(
            **kw))
        mask = None
        if valid is not None:
            m = np.zeros((q.shape[0], k.shape[1]), np.int32)
            m[:, :valid] = 1
            mask = torch.from_numpy(m).to(dev)
        args = dict(causal=causal, mask=mask, window=window)
        out, lse = fl.flash_attention_fwd(q, k, v, **args)
        ref, ref_lse = fl.flash_attention_reference(q, k, v, **args)
        torch.cuda.synchronize()
        record("flash_attention", f"f32 {case}",
               flash_err(torch, out, lse, ref, ref_lse), F32_TOL)
        flash_identical(torch, fl, q, k, v, args, out, lse, f"f32 {case}")
    for case, s, h, d, pad, window in FLASH_BF16_CASES:
        q, k, v, mask = flash_inputs(torch, dev, s, h, d, pad)
        args = dict(causal=True, mask=mask, window=window)
        out, lse = fl.flash_attention_fwd(q, k, v, **args)
        ref, ref_lse = fl.flash_attention_reference(q, k, v, **args)
        torch.cuda.synchronize()
        record("flash_attention", f"bf16 {case}",
               flash_err(torch, out, lse, ref, ref_lse), BF16_TOL)
        flash_identical(torch, fl, q, k, v, args, out, lse, f"bf16 {case}")
        del ref, ref_lse


# (case, parity_inputs kwargs, causal, mask, window): the shapes of
# tests/test_flash_backward.py (mask: the valid leading keys of every row,
# or "row 1 dead", a batch row with no valid key), the window case of
# tests/test_sliding_window.py, and the train phase's shape.
FLASH_BWD_F32_CASES = (
    ("causal (2, 64, 2, 32)", dict(sq=64, n_heads=2, d_head=32), True, None,
     None),
    ("causal (1, 200, 4, 64)", dict(batch=1, sq=200, n_heads=4, d_head=64),
     True, None, None),
    ("padding mask (2, 96, 2, 32)", dict(sq=96, n_heads=2, d_head=32), True,
     70, None),
    ("non-causal (2, 48, 2, 32)", dict(sq=48, n_heads=2, d_head=32), False,
     None, None),
    ("fully masked row (2, 32, 2, 16)", dict(sq=32, n_heads=2, d_head=16),
     True, "row 1 dead", None),
    ("window 9 (1, 96, 2, 16)", dict(batch=1, sq=96, n_heads=2, d_head=16),
     True, None, 9),
    ("train shape (4, 1024, 32, 64)",
     dict(batch=4, sq=1024, n_heads=32, d_head=64), True, None, None),
)
# (case, S, H, D, left padding): TinyLlama prefill rows, as the forward's.
FLASH_BWD_BF16_CASES = (
    ("TinyLlama S256", 256, 32, 64, 37),
    ("TinyLlama S2048", 2048, 32, 64, 300),
)


def _bwd_mask(torch, dev, b, s, spec):
    if spec is None:
        return None
    m = np.ones((b, s), np.int32)
    if spec == "row 1 dead":
        m[1] = 0
    else:
        m[:, spec:] = 0
    return torch.from_numpy(m).to(dev)


def parity_flash_bwd(torch, dev, record) -> None:
    """#6 and #7 against their plain versions on the same inputs (the
    forward kernel's out and lse, a unit-normal do), bit-identical over two
    runs; then FlashAttention's autograd as a whole against the plain
    backward (f32 cases)."""
    from tpu_engine_torch.ops import flash as fl

    def held(kernel, case, pairs, tol):
        """Record the (got, want) pair whose error, relative to its
        reference's largest magnitude, is the largest."""
        errs = []
        for got, want in pairs:
            e = float((got.float() - want.float()).abs().max())
            m = max(float(want.float().abs().max()), 1e-30)
            errs.append((e / m, e, m))
        _, e, m = max(errs)
        record(kernel, case, e, tol, m)

    def one(case, q, k, v, mask, causal, window, tol, function):
        args = dict(causal=causal, window=window)
        out, lse = fl.flash_attention_fwd(q, k, v, mask=mask, **args)
        rng = np.random.default_rng(9)
        do = torch.from_numpy(rng.standard_normal(q.shape, np.float32)).to(
            dev, q.dtype)
        a = (q, k, v, mask, lse, fl.bwd_delta(do, out), do)
        runs = [(fl.flash_attention_bwd_dq(*a, **args),
                 *fl.flash_attention_bwd_dkv(*a, **args)) for _ in range(2)]
        torch.cuda.synchronize()
        check(all(torch.equal(x, y) for x, y in zip(*runs)),
              f"flash backward {case}: two runs differ")
        check(all(bool(torch.isfinite(g.float()).all()) for g in runs[0]),
              f"flash backward {case}: non-finite gradient")
        dq, dk, dv = runs[0]
        ref = (fl.flash_attention_bwd_dq_reference(*a, **args),
               *fl.flash_attention_bwd_dkv_reference(*a, **args))
        held("flash_attention_bwd_dq", case, [(dq, ref[0])], tol)
        held("flash_attention_bwd_dkv", case, [(dk, ref[1]), (dv, ref[2])],
             tol)
        if function:
            t = [x.detach().requires_grad_() for x in (q, k, v)]
            o = fl.flash_attention(*t, mask=mask, **args)
            check(o.grad_fn is not None, "FlashAttention: no grad_fn")
            got = torch.autograd.grad(o, t, do)
            ref_o, ref_lse = fl.flash_attention_reference(q, k, v, mask=mask,
                                                          **args)
            want = fl.flash_attention_bwd_reference(q, k, v, mask, ref_o,
                                                    ref_lse, do, **args)
            held("flash_attention_bwd_dq", f"FlashAttention {case}",
                 [(got[0], want[0])], tol)
            held("flash_attention_bwd_dkv", f"FlashAttention {case}",
                 list(zip(got[1:], want[1:])), tol)

    for case, kw, causal, mask, window in FLASH_BWD_F32_CASES:
        q, k, v = (torch.from_numpy(x).to(dev)
                   for x in fl.parity_inputs(seed=5, **kw))
        one(f"f32 {case}", q, k, v,
            _bwd_mask(torch, dev, q.shape[0], q.shape[1], mask), causal,
            window, BWD_F32_TOL, True)
    for case, s, h, d, pad in FLASH_BWD_BF16_CASES:
        q, k, v, mask = flash_inputs(torch, dev, s, h, d, pad)
        one(f"bf16 {case}", q, k, v, mask, True, None, BF16_TOL, False)
        torch.cuda.empty_cache()


def phase_small_model(torch) -> None:
    """A small llama served on the card (kernels) against the same f32
    weights served on the CPU (plain versions), in every lane's mode:
    greedy streams equal."""
    from tpu_engine_torch.models.convert import init_params, params_to
    from tpu_engine_torch.models.registry import create_model
    from tpu_engine_torch.runtime.scheduler import ContinuousGenerator

    base = dict(dtype="float32", n_slots=4, max_seq=128, prefill_chunk=16)
    paged = dict(kv_block_size=16)
    # Dense lanes prefill monolithically (prefill_chunk 0): every prompt's
    # attention goes through the flash kernel on the card.
    dense = dict(step_chunk=4, prefill_chunk=0)
    runs = [("llama-small-test", "mixed",
             dict(paged, mixed_step=True, mixed_token_budget=16)),
            ("llama-small-test", "two-path", dict(paged, step_chunk=4)),
            ("llama-small-test", "mixed int8",
             dict(paged, mixed_step=True, mixed_token_budget=16,
                  kv_quantize="int8")),
            ("llama-small-test", "two-path int8",
             dict(paged, step_chunk=4, kv_quantize="int8")),
            ("llama-small-test", "dense", dense),
            ("mistral-small-test", "dense (window 8)", dense)]
    shared = [(i * 11) % 200 + 1 for i in range(32)]
    prompts = [[5, 9, 3], [(i * 7) % 200 + 1 for i in range(40)],
               shared + [91, 92, 93], shared + [81, 82]]
    flash = wrapper("flash_attention")
    for name, mode, kw in runs:
        spec = create_model(name, max_seq=128)
        params = init_params(spec.config, seed=3, device="cpu",
                             dtype="float32")
        outs = {}
        for dev in ("cpu", "cuda"):
            launches = flash.launches
            gen = ContinuousGenerator(spec, params=params_to(params, dev),
                                      device=dev, **dict(base, **kw))
            try:
                outs[dev] = [gen.generate([p], max_new_tokens=8)[0]
                             for p in prompts]
            finally:
                gen.stop()
            if dev == "cuda" and mode.startswith("dense"):
                check(flash.launches > launches,
                      f"small model {name} {mode}: no flash launch")
        log(f"small model {name} f32 {mode}: card {outs['cuda']} cpu "
            f"{outs['cpu']}")
        check(outs["cuda"] == outs["cpu"],
              f"small-model greedy streams ({name} {mode}) differ between "
              f"card and CPU")


def run_train(argv, params=None) -> str:
    """The port's train command in-process; returns what it printed."""
    import contextlib
    import io

    from tpu_engine_torch.serving import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.train(argv, params=params)
    text = buf.getvalue()
    for line in text.splitlines():
        log(f"  train: {line}")
    check(rc == 0, f"train {argv}: exit code {rc}")
    return text


def phase_train_small(torch) -> dict:
    """llama-small-test, f32 weights: three make_train_step steps on the
    card (the flash forward and backward kernels) against the same steps on
    the CPU (plain versions), in f32 (TF32 off; losses within 1e-4
    relative) and in bf16 compute (within BF16_TOL); then
    the train command with --out and --resume on the card, and the port's
    worker serving <out>/params with a generator's greedy tokens."""
    from tpu_engine_torch.models.convert import init_params
    from tpu_engine_torch.models.registry import create_model
    from tpu_engine_torch.models.transformer import transformer_apply
    from tpu_engine_torch.runtime.scheduler import ContinuousGenerator
    from tpu_engine_torch.serving import cli
    from tpu_engine_torch.serving.app import serve_worker
    from tpu_engine_torch.training.train import (
        adamw,
        cross_entropy_loss,
        make_train_step,
        tree_map,
    )
    from tpu_engine_torch.utils.config import WorkerConfig

    spec = create_model("llama-small-test")
    cfg = spec.config
    params = init_params(cfg, seed=3, device="cpu", dtype="float32")
    rng = np.random.default_rng(5)
    batches = [rng.integers(1, cfg.vocab, (4, 65)).astype(np.int32)
               for _ in range(3)]
    bwd = wrapper("flash_attention_bwd_dq")
    small = {}
    # f32 (TF32 off): f32 sums in another order, 1e-4. bf16 compute
    # (make_train_step's default): a value rounded to bf16 on one device may
    # round one ulp (2^-8) away on the other, BF16_TOL.
    for dtype, tol in (("float32", 1e-4), ("bfloat16", BF16_TOL)):
        losses = {}
        for dev in ("cpu", "cuda"):
            init_state, step = make_train_step(
                lambda p, x, dtype: transformer_apply(p, x, cfg,
                                                      dtype=dtype),
                loss_fn=cross_entropy_loss, optimizer=adamw(1e-3),
                dtype=getattr(torch, dtype))
            state = init_state(tree_map(lambda t: t.clone().to(dev), params))
            launches = bwd.launches
            losses[dev] = []
            for b in batches:
                t = torch.from_numpy(b).to(dev)
                state, loss = step(state, t[:, :-1], t[:, 1:])
                losses[dev].append(float(loss))
            if dev == "cuda":
                check(bwd.launches == launches + 3 * cfg.n_layers,
                      "small train: the dq kernel did not run once per "
                      "layer")
            del state
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                      losses["cpu"]))
        log(f"train small llama {dtype}: card losses {losses['cuda']} cpu "
            f"{losses['cpu']} (max rel diff {rel:.2e}, tol {tol})")
        check(rel <= tol and all(np.isfinite(losses["cuda"])),
              f"small train {dtype}: card and CPU losses differ by {rel}")
        small[dtype] = {"card_losses": losses["cuda"],
                        "cpu_losses": losses["cpu"], "max_rel_loss_diff": rel}

    root = OUT_DIR / "train_small"
    common = ["--model", "llama-small-test", "--batch", "4", "--seq", "64",
              "--log-every", "1"]
    text = run_train([*common, "--steps", "6", "--out", str(root / "ck1")])
    cli_losses = [float(ln.split()[-1]) for ln in text.splitlines()
                  if ln.startswith("step ")]
    check(len(cli_losses) == 6 and cli_losses[-1] < cli_losses[0],
          f"train command: the loss did not fall: {cli_losses}")
    trained = spec.init(0, device="cuda", dtype="float32")
    text = run_train([*common, "--steps", "2", "--resume",
                      str(root / "ck1" / "state"), "--out",
                      str(root / "ck2")], params=trained)
    check("resumed at step 6" in text and "step 8:" in text,
          f"train command: resume did not continue the step count: {text}")
    name, served = cli.resolve_model(str(root / "ck2" / "params"),
                                     device="cuda", dtype="float32")
    check(name == "llama-small-test", f"sidecar names {name}")
    worker, server = serve_worker(WorkerConfig(
        port=0, node_id="chip-smoke-trained", model=name, dtype="float32",
        device="cuda"), params=served)
    gen = ContinuousGenerator(spec, device="cuda", dtype="float32",
                              step_chunk=16,
                              params=tree_map(lambda t: t.detach(), trained))
    try:
        prompt = [5, 9, 3, 7, 11]
        got = post(server.port, "/generate", {
            "request_id": "trained", "prompt_tokens": prompt,
            "max_new_tokens": 8})["tokens"]
        want = gen.generate([prompt], max_new_tokens=8)[0]
    finally:
        server.stop()
        worker.stop()
        gen.stop()
    log(f"train small: worker on <out>/params greedy {got}, in-process "
        f"{want}")
    check(got == want, "the worker on the trained params differs from the "
                       "in-process generator")
    return {**small, "cli_losses": cli_losses, "served_tokens": got}


def measured_step(torch, fn) -> dict:
    """One training step under torch.profiler: wall ms (to the end of the
    card's work), host issue ms (until fn returns), device busy ms (the
    device events summed), and the flash kernels' device ms by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, loss = fn()
        issue = time.perf_counter() - t0
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.device_time_total for e in events) / 1e3

    def kernel_ms(*prefixes):
        return sum(e.device_time_total for e in events
                   if any(p in e.name for p in prefixes)) / 1e3

    # The element type each flash kernel ran in, from its template
    # arguments (flash_attention_bwd_dq_kernel<float, 64>, or
    # <__nv_bfloat16, 64>).
    names = {"fwd": ("flash_attention_kernel",),
             "bwd": ("flash_attention_bwd_dq_kernel",
                     "flash_attention_bwd_dkv_kernel")}
    variants = {f"{k} {t}": kernel_ms(*(f"{n}<{ct}" for n in names[k]))
                for k in names
                for t, ct in (("f32", "float"), ("bf16", "__nv_bfloat16"))}
    return {"loss": float(loss), "wall_ms": wall * 1e3,
            "issue_ms": issue * 1e3, "busy_ms": busy,
            "idle_share": max(0.0, 1 - busy / (wall * 1e3)),
            "flash_fwd_ms": kernel_ms("flash_attention_kernel<"),
            "flash_bwd_ms": kernel_ms("flash_attention_bwd_dq_kernel<",
                                      "flash_attention_bwd_dkv_kernel<"),
            "flash_variant_ms": variants}


# The full-width training runs: (name, steps, batch, seq, lr, remat,
# compute dtype); f32 weights in all. The loss must fall in the runs
# without remat.
TRAIN_RUNS = (("B4 S1024", 4, 4, 1024, 1e-4, False, "float32"),
              ("B4 S1024 bf16", 3, 4, 1024, 1e-4, False, "bfloat16"),
              ("B8 S2048 remat", 2, 8, 2048, 1e-3, True, "float32"))


def phase_train(torch) -> dict:
    """TinyLlama-1.1B geometry (llama, 22 layers), f32 weights from seed 0
    and AdamW, on the train command's fixed synthetic batch: 4 steps at
    B 4 x S 1024 (lr 1e-4) with an f32 forward, 3 at the same shape with
    make_train_step's default bf16 compute dtype, and 2 steps at the
    command's defaults, B 8 x S 2048 with remat, in f32. The launch counts
    are set to 0 before the phase and read after each step: 22 flash
    forwards per step (44 with remat), 22 launches of each backward kernel,
    no plain call; the device time of each flash kernel's f32 and bf16
    variants is read off the profiler."""
    import gc

    from tpu_engine_torch.models.registry import create_model
    from tpu_engine_torch.models.transformer import transformer_apply
    from tpu_engine_torch.ops import kernels
    from tpu_engine_torch.training.train import (
        adamw,
        cross_entropy_loss,
        make_train_step,
    )

    spec = create_model("llama")
    cfg = spec.config
    out = {"runs": {}}
    kernels.reset_counts()  # the train phase: counts from 0, read after
    for name, steps, batch, seq, lr, remat, dtype in TRAIN_RUNS:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

        def apply_fn(p, x, dtype, remat=remat):
            return transformer_apply(p, x, cfg, dtype=dtype, remat=remat)

        init_state, train_step = make_train_step(
            apply_fn, loss_fn=cross_entropy_loss, optimizer=adamw(lr),
            dtype=getattr(torch, dtype))
        state = init_state(spec.init(0, device="cuda", dtype="float32"))
        # The train command's fixed synthetic batch (seed 0, offset 0).
        tokens = np.random.default_rng(0).integers(
            1, cfg.vocab, (batch, seq + 1)).astype(np.int32)
        window = torch.from_numpy(tokens).cuda()
        x, y = window[:, :-1], window[:, 1:]
        recs = []
        for k in range(steps):
            before = launch_counts()
            rec = measured_step(torch, lambda: train_step(state, x, y))
            after = launch_counts()
            n = {kk: after[kk][0] - before[kk][0] for kk in after}
            want_fwd = cfg.n_layers * (2 if remat else 1)
            check(n["flash_attention"] == want_fwd
                  and n["flash_attention_bwd_dq"] == cfg.n_layers
                  and n["flash_attention_bwd_dkv"] == cfg.n_layers
                  and all(v == 0 for kk, v in n.items()
                          if not kk.startswith("flash")),
                  f"train {name} step {k + 1}: launches {n}")
            check(np.isfinite(rec["loss"]),
                  f"train {name} step {k + 1}: loss {rec['loss']}")
            rec.update(launches=n, tokens_per_s=batch * seq
                       / (rec["wall_ms"] / 1e3))
            recs.append(rec)
            log(f"train {name} step {k + 1}: loss {rec['loss']:.4f}, "
                f"{rec['wall_ms']:.1f} ms (host issue "
                f"{rec['issue_ms']:.1f} ms, device busy "
                f"{rec['busy_ms']:.1f} ms, idle "
                f"{100 * rec['idle_share']:.1f}%), flash forward "
                f"{rec['flash_fwd_ms']:.1f} ms "
                f"({100 * rec['flash_fwd_ms'] / rec['wall_ms']:.1f}%), "
                f"backward {rec['flash_bwd_ms']:.1f} ms "
                f"({100 * rec['flash_bwd_ms'] / rec['wall_ms']:.1f}%), "
                f"{rec['tokens_per_s']:.0f} tokens/s; launches flash "
                f"{n['flash_attention']}, dq {n['flash_attention_bwd_dq']}, "
                f"dkv {n['flash_attention_bwd_dkv']}; device ms by variant "
                + ", ".join(f"{k} {v:.1f}"
                            for k, v in rec["flash_variant_ms"].items()))
        peak = torch.cuda.max_memory_allocated()
        log(f"train {name}: max_memory_allocated {peak / 2**30:.2f} GiB")
        if not remat:
            check(recs[-1]["loss"] < recs[0]["loss"],
                  f"train {name}: the loss did not fall")
        out["runs"][name] = {"steps": recs, "max_memory_allocated": peak,
                             "batch": batch, "seq": seq, "lr": lr,
                             "remat": remat, "dtype": dtype}
        del state, x, y, window
    counts = launch_counts()
    check(all(p == 0 for _, p in counts.values()),
          f"train: plain versions ran: {counts}")
    out["launches"] = {k: n for k, (n, _) in counts.items()}
    gc.collect()
    torch.cuda.empty_cache()
    return out


def start_lane(torch, params, lane: str):
    """A worker of the main path's geometry for ``lane``, over HTTP."""
    from tpu_engine_torch.serving.app import serve_worker
    from tpu_engine_torch.utils.config import WorkerConfig

    cfg = WorkerConfig(port=0, node_id=f"chip-smoke-{lane}", model="llama",
                       dtype="bfloat16", gen_max_batch_size=8,
                       gen_prefill_chunk=256, device="cuda", seed=0,
                       **LANES[lane])
    t0 = time.perf_counter()
    worker, server = serve_worker(cfg, params=params)
    torch.cuda.synchronize()
    log(f"server {lane}: llama (TinyLlama-1.1B geometry) ready in "
        f"{time.perf_counter() - t0:.1f} s on port {server.port}")
    return worker, server


def burst(port: int, lane: str, reqs: dict, stream_prompt) -> tuple:
    """The requests of ``reqs`` on /generate and ``stream_prompt`` on
    /generate/stream, all at once. Checks that every one completes with
    MAX_NEW tokens; returns (results by name, stream tokens, stream TTFT,
    the burst's seconds, its tokens)."""
    results, errors = {}, []

    def run(name, prompt):
        try:
            results[name] = post(port, "/generate", {
                "request_id": name, "prompt_tokens": prompt,
                "max_new_tokens": MAX_NEW})
        except Exception as exc:  # reported below, fails the phase
            errors.append(f"{name}: {exc!r}")

    def run_stream():
        try:
            results["stream"] = stream(port, {
                "request_id": "stream", "prompt_tokens": stream_prompt,
                "max_new_tokens": MAX_NEW})
        except Exception as exc:
            errors.append(f"stream: {exc!r}")

    threads = [threading.Thread(target=run, args=kv) for kv in reqs.items()]
    threads.append(threading.Thread(target=run_stream))
    t_burst = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    burst_s = time.perf_counter() - t_burst
    check(not errors and not any(t.is_alive() for t in threads),
          f"{lane} burst failed: {errors}")
    s_toks, s_final, ttft = results.pop("stream")
    check(s_final is not None and "error" not in s_final
          and s_final["tokens"] == s_toks and len(s_toks) == MAX_NEW,
          f"{lane} stream: {s_final}")
    n_tokens = len(s_toks)
    for name, res in results.items():
        check(len(res["tokens"]) == MAX_NEW
              and all(0 <= t < 32000 for t in res["tokens"]),
              f"{lane} {name}: {res}")
        n_tokens += len(res["tokens"])
    return results, s_toks, ttft, burst_s, n_tokens


def wait_idle(port: int, paged: bool) -> tuple:
    """(/stats once the lane is idle, whether it got there in 30 s): no
    active row and, over the paged pool, every block free or radix-held."""
    deadline = time.time() + 30
    while True:
        st = get(port, "/stats")
        idle = st["active"] == 0
        if paged:
            pool = st["kv_pool"]
            idle = idle and (pool["blocks_free"] + pool["radix_nodes"]
                             == pool["blocks_total"])
        if idle or time.time() > deadline:
            return st, idle
        time.sleep(0.05)


def check_counts(lane: str, kernel: str) -> int:
    """The lane's launches of its kernel; no plain call, no other kernel."""
    counts = launch_counts()
    check(all(p == 0 for _, p in counts.values()),
          f"{lane}: plain versions served attention: {counts}")
    check(all(n == 0 for k, (n, _) in counts.items() if k != kernel),
          f"{lane}: other kernels launched: {counts}")
    return counts[kernel][0]


def serve_lane(torch, params, lane: str) -> dict:
    """Drive one paged lane of the main path over HTTP with the launch
    counts set to 0 just before and read just after; check its
    invariants."""
    from tpu_engine_torch.ops import kernels

    overrides = LANES[lane]
    kernel = next(k for k, v in KERNELS.items() if v["lane"] == lane)
    mixed = bool(overrides.get("gen_mixed_step"))
    worker, server = start_lane(torch, params, lane)
    port = server.port
    gcfg = worker.generator.cfg
    vocab, n_layers = gcfg.vocab, gcfg.n_layers
    rng = np.random.default_rng(0)

    def toks(n):
        return [int(t) for t in rng.integers(1, vocab, n)]

    prefix = toks(64)
    reqs = {"long": toks(300), "prefix_a": prefix + toks(20),
            "mid": toks(100), "short": toks(17), "one": toks(1)}
    stream_prompt = toks(200)
    try:
        kernels.reset_counts()  # the lane's run: counts from 0, read after
        warm = post(port, "/generate", {"request_id": "warm",
                                        "prompt_tokens": reqs["short"],
                                        "max_new_tokens": 4})
        check(len(warm["tokens"]) == 4, f"{lane} warm-up: {warm}")
        _, _, ttft, burst_s, n_tokens = burst(port, lane, reqs,
                                              stream_prompt)
        hit0 = get(port, "/stats")["kv_pool"]["prefix_hit_tokens"]
        shared = post(port, "/generate", {
            "request_id": "prefix_b", "prompt_tokens": prefix + toks(40),
            "max_new_tokens": MAX_NEW})
        hit = get(port, "/stats")["kv_pool"]["prefix_hit_tokens"] - hit0
        check(len(shared["tokens"]) == MAX_NEW and hit >= 64,
              f"{lane} shared prefix: {hit} prefix-hit tokens")
        # Greedy repeat under the same batch composition (alone, both
        # resuming from the same radix hit): token-identical. In a mixed
        # lane a co-batched stream may differ from the same prompt alone:
        # a decode row riding a prefill tick goes through a 2048-row GEMM
        # instead of an 8-row one, and bf16 rounds differently.
        first, again = (post(port, "/generate", {
            "request_id": f"long-repeat-{i}", "prompt_tokens": reqs["long"],
            "max_new_tokens": MAX_NEW})["tokens"] for i in range(2))
        check(first == again, f"{lane} greedy repeat differs: {first} "
                              f"{again}")
        st, idle = wait_idle(port, paged=True)
        pool = st["kv_pool"]
        launches = check_counts(lane, kernel)
        check(idle, f"{lane}: not idle or blocks leaked: {pool}")
        check(bool(pool.get("quantized")) == ("int8" in lane),
              f"{lane}: pool {pool}")
        out = {"kernel": kernel, "launches": launches,
               "burst_tokens": n_tokens, "burst_s": burst_s,
               "tokens_per_s": n_tokens / burst_s, "stream_ttft_s": ttft,
               "prefix_hit_tokens": hit, "pool": pool}
        if mixed:
            m = st["mixed"]
            check(m["ticks"] == m["dispatches"] > 0, f"{lane}: {m}")
            check(launches == n_layers * m["dispatches"],
                  f"{lane}: {launches} launches for {m['dispatches']} "
                  f"dispatches of {n_layers} layers")
            out.update(ticks=m["ticks"], dispatches=m["dispatches"])
            steps = f"ticks {m['ticks']} == dispatches {m['dispatches']}"
        else:
            chunks = st["chunks"]
            step_chunk = overrides["gen_step_chunk"]
            check(chunks > 0, f"{lane}: no decode chunk ran")
            check(launches == n_layers * step_chunk * chunks,
                  f"{lane}: {launches} launches for {chunks} chunks of "
                  f"{step_chunk} steps of {n_layers} layers")
            out.update(chunks=chunks,
                       admission_dispatches=st["admission_dispatches"])
            steps = f"chunks {chunks} of {step_chunk} steps"
        health = get(port, "/health")
        check(health["healthy"] and health["generator"]["completed"] >= 8,
              f"{lane} health: {health}")
        log(f"server {lane}: {n_tokens} tokens in {burst_s:.3f} s "
            f"({n_tokens / burst_s:.1f} tokens/s, 6 concurrent requests), "
            f"stream TTFT {ttft * 1e3:.1f} ms; {steps}; {kernel} launches "
            f"{launches}, plain calls 0; prefix hit {hit} tokens; greedy "
            f"repeat identical; blocks free {pool['blocks_free']} + radix "
            f"{pool['radix_nodes']} == total {pool['blocks_total']}")
    finally:
        server.stop()
        worker.stop()
    return out


def serve_dense_lane(torch, params) -> dict:
    """Drive the worker's default lane (dense cache) over HTTP with the
    launch counts set to 0 just before and read just after: six prompts of
    at most 256 tokens and a stream at once (each a monolithic prefill
    through the flash kernel), an exact repeat (a prefix-cache hit), then a
    600-token prompt (prefill windows, no flash) and its greedy repeat (a
    hit). Flash launches == layers x the monolithic prefills that missed
    the prefix cache."""
    from tpu_engine_torch.ops import kernels

    lane, kernel = "dense-bf16", "flash_attention"
    worker, server = start_lane(torch, params, lane)
    port = server.port
    gcfg = worker.generator.cfg
    vocab, n_layers = gcfg.vocab, gcfg.n_layers
    prefill_chunk = worker.generator._prefill_chunk
    rng = np.random.default_rng(1)

    def toks(n):
        return [int(t) for t in rng.integers(1, vocab, n)]

    warm_prompt = toks(16)
    reqs = {f"len{n}": toks(n) for n in (1, 17, 64, 100, 200, 256)}
    stream_prompt = toks(180)
    long_prompt = toks(600)
    try:
        kernels.reset_counts()  # the lane's run: counts from 0, read after
        warm = post(port, "/generate", {"request_id": "warm",
                                        "prompt_tokens": warm_prompt,
                                        "max_new_tokens": 4})
        check(len(warm["tokens"]) == 4, f"{lane} warm-up: {warm}")
        results, _, ttft, burst_s, n_tokens = burst(port, lane, reqs,
                                                    stream_prompt)
        repeat = post(port, "/generate", {
            "request_id": "len100-repeat", "prompt_tokens": reqs["len100"],
            "max_new_tokens": MAX_NEW})["tokens"]
        check(repeat == results["len100"]["tokens"],
              f"{lane} exact repeat differs: {repeat} "
              f"{results['len100']['tokens']}")
        first, again = (post(port, "/generate", {
            "request_id": f"long-{i}", "prompt_tokens": long_prompt,
            "max_new_tokens": MAX_NEW})["tokens"] for i in range(2))
        check(first == again and len(first) == MAX_NEW,
              f"{lane} greedy repeat differs: {first} {again}")
        st, idle = wait_idle(port, paged=False)
        launches = check_counts(lane, kernel)
        check(idle and "kv_pool" not in st, f"{lane}: not idle: {st}")
        prompts = [warm_prompt, *reqs.values(), stream_prompt, long_prompt]
        monolithic = sum(len(p) <= prefill_chunk for p in prompts)
        pc = st["prefix_cache"]
        check(pc["misses"] == len(prompts) and pc["hits"] == 2,
              f"{lane}: prefix cache {pc}")
        check(launches == n_layers * monolithic,
              f"{lane}: {launches} flash launches for {monolithic} "
              f"monolithic prefills of {n_layers} layers")
        check(st["chunks"] > 0, f"{lane}: no decode chunk ran")
        health = get(port, "/health")
        check(health["healthy"] and health["generator"]["completed"] >= 11,
              f"{lane} health: {health}")
        out = {"kernel": kernel, "launches": launches,
               "burst_tokens": n_tokens, "burst_s": burst_s,
               "tokens_per_s": n_tokens / burst_s, "stream_ttft_s": ttft,
               "chunks": st["chunks"],
               "admission_dispatches": st["admission_dispatches"],
               "monolithic_prefills": monolithic, "prefix_cache": pc}
        log(f"server {lane}: {n_tokens} tokens in {burst_s:.3f} s "
            f"({n_tokens / burst_s:.1f} tokens/s, 7 concurrent requests), "
            f"stream TTFT {ttft * 1e3:.1f} ms; chunks {st['chunks']}, "
            f"admission dispatches {st['admission_dispatches']}; {kernel} "
            f"launches {launches} == {n_layers} x {monolithic} monolithic "
            f"prefills, plain calls 0; prefix cache {pc}; exact and greedy "
            f"repeats identical")
    finally:
        server.stop()
        worker.stop()
    return out


def phase_server(torch) -> dict:
    from tpu_engine_torch.models.convert import init_params
    from tpu_engine_torch.models.registry import create_model

    params = init_params(create_model("llama").config, seed=0,
                         device="cuda", dtype="bfloat16")
    out = {lane: serve_lane(torch, params, lane) for lane in LANES
           if lane != "dense-bf16"}
    out["dense-bf16"] = serve_dense_lane(torch, params)
    return out


def kernel_numbers(torch, pa, kernel: str, decode_only: bool) -> dict:
    int8 = kernel.startswith("quant")
    dev = torch.device("cuda")
    inp = main_path_inputs(torch, dev, decode_only, int8)
    args = decode_args(inp) if kernel in ("paged_attention",
                                          "quant_paged_attention") else inp
    fn = getattr(pa, kernel)
    ref = getattr(pa, kernel + "_reference")
    ms = time_ms(torch, lambda: fn(*args))
    device, seen = device_call_ms(torch, lambda: fn(*args))
    plain = time_ms(torch, lambda: ref(*args), iters=5)
    sdpa = sdpa_yardstick(torch, inp, int8)
    library = time_ms(torch, sdpa)
    library_device, library_seen = device_call_ms(torch, sdpa)
    out_item = 4 if int8 else inp[1].element_size()
    bound, by = bound_ms(inp[0], inp[1], inp[-3], inp[-2], inp[-1],
                         out_item, scale_bytes=4 if int8 else 0)
    shape = "decode W=1" if decode_only else "mixed W=256"
    pool = "int8" if int8 else "bf16"
    log(f"numbers {kernel} ({shape}, B 8, H 32/4, D 64, bs 16, {pool} "
        f"pool): kernel {ms:.4f} ms (device time {device:.4f} ms, {seen} "
        f"of 20 calls seen), plain {plain:.4f} ms, sdpa over pre-gathered "
        f"K/V {library:.4f} ms (device time {library_device:.4f} ms, "
        f"{library_seen} seen), bound {bound:.5f} ms ({by})")
    return {"ms": ms, "device_ms": device, "device_calls": seen,
            "plain_ms": plain, "library_ms": library,
            "library_device_ms": library_device, "bound_ms": bound,
            "bound_by": by}


def sdpa_backend(torch, dtype):
    """The scaled_dot_product_attention backend the flash yardstick forces:
    FlashAttention for bf16; for f32, which it does not take, the
    memory-efficient kernel (TF32 is off for the whole run)."""
    from torch.nn.attention import SDPBackend

    return (SDPBackend.FLASH_ATTENTION if dtype == torch.bfloat16
            else SDPBackend.EFFICIENT_ATTENTION)


def flash_numbers(torch, b: int, s: int, dtype) -> dict:
    """The flash forward over unit-normal (B, S, 32, 64) q, k, v, causal: a
    TinyLlama prefill row (B 1), or the train phase's shape (B 4, S 1024),
    in f32 (the variant every main path launches: q, k, v come out of
    nn.dense as f32) or bf16. The kernel, with events and a cold L2 (the
    wrapper's host time included) and as device time (``device_call_ms``);
    the plain version; and scaled_dot_product_attention(is_causal=True)
    with its backend forced (``sdpa_backend``) over the same tensors
    transposed to (B, H, S, D) beforehand (the transpose is not timed),
    timed the same two ways."""
    import torch.nn.functional as F
    from torch.nn.attention import sdpa_kernel

    from tpu_engine_torch.ops import flash as fl

    q, k, v, _ = flash_inputs(torch, torch.device("cuda"), s, 32, 64,
                              dtype=dtype, b=b)
    call = (lambda: fl.flash_attention(q, k, v, causal=True))
    ms = time_ms(torch, call)
    device, seen = device_call_ms(torch, call)
    plain = time_ms(torch, lambda: fl.flash_attention_reference(
        q, k, v, causal=True), iters=3)
    qq, kk, vv = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    backend = sdpa_backend(torch, dtype)

    def library_call():
        with sdpa_kernel(backend):
            return F.scaled_dot_product_attention(qq, kk, vv, is_causal=True)
    library = time_ms(torch, library_call)
    library_device, library_seen = device_call_ms(torch, library_call)
    bound, by = flash_bound_ms(q)
    name = str(dtype).split(".")[-1]
    log(f"numbers flash_attention (B {b}, S {s}, H 32, D 64, causal, "
        f"{name}): kernel {ms:.4f} ms (device time {device:.4f} ms, {seen} "
        f"of 20 calls seen), plain {plain:.4f} ms, sdpa {backend.name} "
        f"{library:.4f} ms (device time {library_device:.4f} ms, "
        f"{library_seen} seen), bound {bound:.5f} ms ({by})")
    return {"ms": ms, "device_ms": device, "device_calls": seen,
            "plain_ms": plain, "library_ms": library,
            "library_device_ms": library_device,
            "library_backend": backend.name, "bound_ms": bound,
            "bound_by": by}


def flash_bwd_bound_ms(torch, q, kernel: str) -> tuple:
    """Least time for #6 or #7 over causal (B, S, H, D) inputs with no
    mask: the larger of the bytes (q, k, v and do read once in their dtype,
    lse and delta in f32, dq (#6) or dk and dv (#7) written once) over
    3.35 TB/s and 6*D (#6: s, dp, dq) or 8*D (#7: s, dp, dv, dk) flops per
    attended (query, key) pair, S(S+1)/2 per head, over the card's peak in
    the inputs' type (bf16 tensor cores, or f32 CUDA cores: the port's f32
    products run without TF32)."""
    b, s, h, d = q.shape
    n_out = 1 if kernel == "flash_attention_bwd_dq" else 2
    nbytes = (4 + n_out) * q.numel() * q.element_size() + 2 * b * h * s * 4
    pairs = b * h * s * (s + 1) // 2
    flops = (6 if n_out == 1 else 8) * d * pairs
    peak = PEAK_BF16_FLOPS if q.dtype == torch.bfloat16 else PEAK_F32_FLOPS
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations")


def flash_bwd_numbers(torch, b: int, s: int, dtype) -> dict:
    """#6 and #7 over one causal call (H 32, D 64, unit-normal inputs, the
    forward kernel's out and lse): the kernels, with events and a cold L2
    (the wrapper's host time before the launch included) and as device
    time (``device_call_ms``, the library's measure); their plain
    versions; and the backward of scaled_dot_product_attention
    (is_causal=True) on the same tensors transposed to (B, H, S, D)
    beforehand, its forward run once beforehand and retained (neither
    timed): the device time of one autograd backward call. (Events
    bracketing that call would also count the autograd engine's host gaps
    between its kernels, which vary from run to run.) The library call
    computes dq, dk and dv at once; it is set beside each kernel and
    compares with #6 + #7 together."""
    import torch.nn.functional as F

    from tpu_engine_torch.ops import flash as fl

    rng = np.random.default_rng(7)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(
        (b, s, 32, 64), np.float32)).to("cuda", dtype) for _ in range(4))
    out, lse = fl.flash_attention_fwd(q, k, v, causal=True)
    a = (q, k, v, None, lse, fl.bwd_delta(do, out), do)
    qq, kk, vv = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    dd = do.transpose(1, 2).contiguous()
    sdpa_out = F.scaled_dot_product_attention(qq, kk, vv, is_causal=True)
    library, library_calls = device_call_ms(
        torch, lambda: torch.autograd.grad(sdpa_out, (qq, kk, vv), dd,
                                           retain_graph=True))
    res = {}
    for kernel in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        fn = getattr(fl, kernel)
        ref = getattr(fl, kernel + "_reference")
        ms = time_ms(torch, lambda: fn(*a, causal=True))
        device, seen = device_call_ms(torch, lambda: fn(*a, causal=True))
        plain = time_ms(torch, lambda: ref(*a, causal=True), iters=3)
        bound, by = flash_bwd_bound_ms(torch, q, kernel)
        log(f"numbers {kernel} (B {b}, S {s}, H 32, D 64, causal, "
            f"{str(dtype).split('.')[-1]}): kernel {ms:.4f} ms (device "
            f"time {device:.4f} ms, {seen} of 20 calls seen), plain "
            f"{plain:.4f} ms, sdpa backward (dq, dk, dv) {library:.4f} ms "
            f"({library_calls} of 20 calls seen), bound {bound:.5f} ms "
            f"({by})")
        res[kernel] = {"ms": ms, "device_ms": device, "device_calls": seen,
                       "plain_ms": plain, "library_ms": library,
                       "library_calls": library_calls, "bound_ms": bound,
                       "bound_by": by}
    del a, out, lse, qq, kk, vv, sdpa_out
    torch.cuda.empty_cache()
    return res


def phase_numbers(torch, pa) -> dict:
    res = {}
    # The flash backward: the train phase's shape first (the row of the
    # kernels line), then the forward's prefill rows.
    shapes = (("train B=4 S=1024 f32", 4, 1024, torch.float32),
              ("prefill S=256 bf16", 1, 256, torch.bfloat16),
              ("prefill S=2048 bf16", 1, 2048, torch.bfloat16))
    for key, b, s, dtype in shapes:
        for kernel, r in flash_bwd_numbers(torch, b, s, dtype).items():
            res.setdefault(kernel, {})[key] = r
    for kernel in KERNELS:
        if kernel.startswith("flash_attention_bwd"):
            continue
        if kernel == "flash_attention":
            res[kernel] = {key: flash_numbers(torch, b, s, getattr(torch, dt))
                           for key, b, s, dt in FLASH_SHAPES}
            continue
        shapes = ((True,) if kernel in ("paged_attention",
                                        "quant_paged_attention")
                  else (False, True))
        res[kernel] = {("decode W=1" if d else "mixed W=256"):
                       kernel_numbers(torch, pa, kernel, d) for d in shapes}
    res["forward"] = forward_times(torch, res)
    return res


def forward_times(torch, kernel_res) -> dict:
    """One full-width forward (22 layers, bf16) per step the lanes run,
    timed on the card, beside the host's time to issue it and the card's
    busy time under the profiler, and the share of it the attention
    kernel takes (22 launches at the isolated kernel's device time): the mixed
    tick at W = 256 and W = 1 and the two-path decode step (8 rows), over
    the bf16 and the int8 pool, the two-path prefill thread's 256-token
    window of one request over its own dense row cache (no pool, no
    paged kernel), and the dense lane's steps: the monolithic prefill of a
    left-padded prompt at buckets 256 and 2048 (the flash kernel) and the
    8-row decode step over the dense cache (grouped dense attention, no
    kernel)."""
    from tpu_engine_torch.models.convert import init_params
    from tpu_engine_torch.models.registry import create_model
    from tpu_engine_torch.models.transformer import (
        KVCache,
        init_caches,
        transformer_decode_rows,
        transformer_decode_rows_paged,
        transformer_decode_window,
        transformer_prefill,
        transformer_step_rows_ragged,
    )

    cfg = create_model("llama").config
    dev = torch.device("cuda")
    params = init_params(cfg, seed=0, device=dev, dtype="bfloat16")
    shape = (cfg.n_layers, 8 * 128 + 1, 16, cfg.kv_heads, cfg.d_head)
    out = {}

    def record(key, fwd, logits_shape, kernel=None, kshape=None):
        logits = fwd()
        check(bool(torch.isfinite(logits).all())
              and tuple(logits.shape) == logits_shape,
              f"full-width forward {key}: non-finite or misshapen logits")
        ms = time_ms(torch, fwd, iters=10)
        host = issue_ms(torch, fwd)
        busy = busy_ms(torch, fwd)
        res = {"forward_ms": ms, "issue_ms": host, "busy_ms": busy,
               "idle_share": max(0.0, 1 - busy / ms)}
        line = (f"forward ({key}, llama {cfg.n_layers} layers): {ms:.3f} "
                f"ms per step (host issue {host:.3f} ms, device busy "
                f"{busy:.3f} ms, idle {100 * res['idle_share']:.1f}%)")
        if kernel is not None:
            attn = cfg.n_layers * kernel_res[kernel][kshape]["device_ms"]
            res.update(kernel=kernel, attention_ms=attn,
                       attention_share=attn / ms)
            line += f", of which {kernel} {attn:.3f} ms " \
                    f"({100 * attn / ms:.1f}%)"
        out[key] = res
        log(line)

    for int8 in (False, True):
        dt = torch.int8 if int8 else torch.bfloat16
        caches = KVCache(torch.zeros(shape, dtype=dt, device=dev),
                         torch.zeros(shape, dtype=dt, device=dev))
        scales = (KVCache(torch.ones(shape[:-1], device=dev),
                          torch.ones(shape[:-1], device=dev))
                  if int8 else None)
        pool = "int8" if int8 else "bf16"
        steps = (("mixed W=256", False, "ragged"),
                 ("decode W=1", True, "ragged"),
                 ("two-path decode step", True, "paged"))
        for name, decode_only, read in steps:
            inp = main_path_inputs(torch, dev, decode_only)
            tables, pos0, qlen = inp[-3:]
            w = 1 if decode_only else 256
            tokens = torch.randint(0, cfg.vocab, (8, w), device=dev,
                                   dtype=torch.int32)
            slot = (qlen - 1).clamp(min=0)
            if read == "ragged":
                kernel = ("quant_ragged_paged_attention" if int8
                          else "ragged_paged_attention")

                def fwd():
                    return transformer_step_rows_ragged(
                        params, tokens, caches, tables, pos0, qlen, cfg,
                        dtype=torch.bfloat16, sample_slot=slot,
                        scales=scales)[0]
            else:
                kernel = ("quant_paged_attention" if int8
                          else "paged_attention")

                def fwd():
                    return transformer_decode_rows_paged(
                        params, tokens[:, 0], caches, tables, pos0, cfg,
                        dtype=torch.bfloat16, scales=scales)[0]
            kshape = "mixed W=256" if name == "mixed W=256" else "decode W=1"
            record(f"{name} {pool}", fwd, (8, cfg.vocab), kernel, kshape)
        del caches, scales

    # The second window of a 300-token prompt (bucket 512): columns
    # 256..511 of the request's row cache, every slot through the head as
    # the scheduler asks for the window that holds the prompt's end.
    row = init_caches(cfg, 1, 512, torch.bfloat16, dev)
    window = torch.randint(0, cfg.vocab, (1, 256), device=dev,
                           dtype=torch.int32)
    w0 = torch.full((1,), 256, dtype=torch.int32, device=dev)
    zero = torch.zeros((1,), dtype=torch.int32, device=dev)
    record("two-path prefill window W=256",
           lambda: transformer_decode_window(
               params, window, row, w0, cfg, dtype=torch.bfloat16,
               start_vec=zero, head="all")[0],
           (1, 256, cfg.vocab))
    del row

    # The dense lane's monolithic prefill of a prompt 7 tokens short of
    # its bucket (left-padded), into the request's own row cache.
    for pb in (256, 2048):
        tokens = torch.randint(0, cfg.vocab, (1, pb), device=dev,
                               dtype=torch.int32)
        attn = torch.ones((1, pb), dtype=torch.int32, device=dev)
        attn[:, :7] = 0
        pos_ids = (torch.cumsum(attn, 1) - 1).clamp(min=0).int()
        row = init_caches(cfg, 1, pb, torch.bfloat16, dev)
        record(f"dense prefill pb={pb}",
               lambda: transformer_prefill(
                   params, tokens, row, cfg, dtype=torch.bfloat16,
                   attn_mask=attn, pos_ids=pos_ids)[0],
               (1, cfg.vocab), "flash_attention", f"prefill S={pb} f32")
        del row
    # The dense decode step: 8 rows at the main path's depths over the
    # (22, 8, 2048, 4, 64) shared cache, each row's prompt from column 5.
    dense = init_caches(cfg, 8, cfg.max_seq, torch.bfloat16, dev)
    pos = main_path_inputs(torch, dev, True)[-2]
    start = torch.clamp(pos, max=5)
    tok = torch.randint(0, cfg.vocab, (8,), device=dev, dtype=torch.int32)
    record("dense decode step", lambda: transformer_decode_rows(
        params, tok, dense, pos, cfg, dtype=torch.bfloat16,
        start_vec=start)[0], (8, cfg.vocab))
    return out


def kernel_times(torch) -> dict:
    """Device time of one call (``device_call_ms``) of #1 at the main
    path's mixed and decode shapes, #5 at FLASH_SHAPES and #6/#7 at the
    train phase's shape (f32) and a bf16 prefill row at S 2048, through
    whichever tree of the package is imported: ``--kernel-times`` runs
    only this, so that two trees can be timed in turns in one call."""
    from tpu_engine_torch.ops import flash as fl
    from tpu_engine_torch.ops import paged_attention as pa

    dev = torch.device("cuda")
    res = {}
    for decode_only in (False, True):
        inp = main_path_inputs(torch, dev, decode_only)
        key = "decode W=1" if decode_only else "mixed W=256"
        res[f"ragged {key}"] = device_call_ms(
            torch, lambda: pa.ragged_paged_attention(*inp))[0]
    for key, b, s, dt in FLASH_SHAPES:
        q, k, v, _ = flash_inputs(torch, dev, s, 32, 64,
                                  dtype=getattr(torch, dt), b=b)
        res[f"flash {key}"] = device_call_ms(
            torch, lambda: fl.flash_attention_fwd(q, k, v, causal=True))[0]
    for key, b, s, dt in (("train B=4 S=1024 f32", 4, 1024, torch.float32),
                          ("prefill S=2048", 1, 2048, torch.bfloat16)):
        q, k, v, _ = flash_inputs(torch, dev, s, 32, 64, dtype=dt, b=b)
        out, lse = fl.flash_attention_fwd(q, k, v, causal=True)
        a = (q, k, v, None, lse, fl.bwd_delta(torch.ones_like(out), out),
             torch.ones_like(out))
        for kernel in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
            fn = getattr(fl, kernel)
            res[f"{kernel} {key}"] = device_call_ms(
                torch, lambda: fn(*a, causal=True))[0]
        del q, k, v, out, lse, a
        torch.cuda.empty_cache()
    return res


def main_kernel_times(torch, root: str) -> int:
    """``--kernel-times [--package-root DIR]``: kernel_times of the package
    under DIR (default: this checkout), one JSON line, appended to
    kernel_times.jsonl in OUT_DIR."""
    card = card_line()
    res = {"root": root, "card": card, "device_ms": kernel_times(torch)}
    OUT_DIR.mkdir(exist_ok=True)
    with open(OUT_DIR / "kernel_times.jsonl", "a") as f:
        f.write(json.dumps(res) + "\n")
    log(json.dumps(res))
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    if "--kernel-times" in sys.argv:
        root = "."
        if "--package-root" in sys.argv:
            root = sys.argv[sys.argv.index("--package-root") + 1]
            sys.path.insert(0, str(Path(root).resolve()))
        return main_kernel_times(torch, root)
    from tpu_engine_torch.ops import kernels as kl
    from tpu_engine_torch.ops import paged_attention as pa

    # Full-f32 products for the plain versions (TF32 keeps ~3 digits).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"device: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    t0 = time.perf_counter()
    kl.kernel_library()
    log(f"build: {time.perf_counter() - t0:.1f} s "
        f"({kl.kernel_library_path().name}, {len(KERNELS)} kernels from "
        f"{len(kl.SOURCES)} sources and {len(kl.HEADERS)} header)")
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "build_log.txt").write_text(kl.build_log)
    errs = phase_parity(torch, pa)
    phase_small_model(torch)
    train_small = phase_train_small(torch)
    server = phase_server(torch)
    train = phase_train(torch)
    numbers = phase_numbers(torch, pa)
    rows = []
    for name, meta in KERNELS.items():
        main_shape = next(iter(numbers[name].values()))
        rows.append({
            "name": name, "route": "cuda", "source": meta["source"],
            "replaces": meta["replaces"],
            "launches": (train["launches"][name] if meta["lane"] == "train"
                         else server[meta["lane"]]["launches"]),
            "max_abs_err": max(errs[name].values()),
            # Device time of one call, the kernel's and the library's (the
            # backward's library reading is device time already).
            "ms": main_shape["device_ms"],
            "plain_ms": main_shape["plain_ms"],
            "bound_ms": main_shape["bound_ms"],
            "bound_by": main_shape["bound_by"],
            "library_ms": main_shape.get("library_device_ms",
                                         main_shape["library_ms"]),
        })
    kernels = {"kernels": rows}
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "parity": errs, "train_small": train_small,
         "server": server, "train": train, "numbers": numbers, **kernels},
        indent=1))
    log(json.dumps(kernels))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:
        traceback.print_exc()
        code = 1
    sys.exit(code)

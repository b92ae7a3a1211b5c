"""On-card smoke test of the PyTorch/CUDA port (``tpu_engine_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. device   — the card's name and power limit (nvidia-smi);
2. build    — nvcc builds the ragged paged-attention kernel from
              tpu_engine_torch/csrc;
3. parity   — the kernel against its plain PyTorch version on the card:
              f32 at the JAX package's ragged_parity_check and
              spec_verify_parity_check shapes (tolerance 1e-5), bf16 at the
              main path's shapes (tolerance 2e-2 on unit normals); then a
              small llama served on the card agrees token for token with the
              same weights served on the CPU through the plain version;
4. server   — the main path: the port's worker over HTTP on localhost
              serving TinyLlama-1.1B geometry (random weights from seed 0,
              bf16, 16-token KV blocks, mixed stepping, 256-token prefill
              chunks): a burst of concurrent /generate requests and one
              /generate/stream, a shared-prefix request, a greedy repeat;
              every request completes, the repeat is token-identical,
              ticks == dispatches, no block leaks once idle, and the kernel
              (not the plain version) served every attention read;
5. numbers  — the kernel's time at the main path's shapes beside its bound,
              the plain version's time and scaled_dot_product_attention's
              (over K/V gathered dense beforehand; the gather is not timed,
              and the port never calls it).

The last line of standard output is the JSON result; the line before it
the card's name and power limit; the line before that the kernels' JSON.
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
F32_TOL = 1e-5
BF16_TOL = 2e-2
OUT_DIR = Path("chiprun_out")


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

def main_path_inputs(torch, dev, decode_only: bool, seed: int = 1):
    """The ragged batch a TinyLlama mixed tick hands the kernel: 8 rows,
    32 query / 4 KV heads, D 64, 16-token blocks, tables 128 wide
    (max_seq 2048). With a prefill chunk: seven decode rows at contexts up
    to 2048 and one 256-token chunk at pos0 1700 (W = 256); decode only:
    eight q_len-1 rows (W = 1)."""
    rng = np.random.default_rng(seed)
    b, h, h_kv, d, bs, nb = 8, 32, 4, 64, 16, 128
    w = 1 if decode_only else 256
    n_pool = b * nb + 1
    q = torch.from_numpy(rng.standard_normal((b, w, h, d), np.float32))
    k = torch.from_numpy(rng.standard_normal((n_pool, bs, h_kv, d),
                                             np.float32))
    v = torch.from_numpy(rng.standard_normal((n_pool, bs, h_kv, d),
                                             np.float32))
    tables = (1 + rng.permutation(n_pool - 1)[:b * nb]).reshape(b, nb)
    pos0 = np.array([100, 500, 1000, 2046, 17, 1500, 0, 1700], np.int32)
    qlen = np.ones((b,), np.int32)
    if not decode_only:
        qlen[7] = 256
    return (q.to(dev), k.to(dev).bfloat16(), v.to(dev).bfloat16(),
            torch.from_numpy(tables.astype(np.int32)).to(dev),
            torch.from_numpy(pos0).to(dev), torch.from_numpy(qlen).to(dev))


def bound_ms(q, k_pool, tables, pos0, qlen) -> tuple:
    """Least time the card could take for this call: the larger of the
    bytes the function must move (valid query slots read, the K/V blocks
    each row's queries reach read once, valid output slots written) over
    3.35 TB/s, and its multiply-adds (QK and PV, 4*D flops per (query,
    key) pair attended) over the bf16 tensor-core rate."""
    _, _, h, d = q.shape
    bs, h_kv = k_pool.shape[1], k_pool.shape[2]
    kv_item = k_pool.element_size()
    p0 = pos0.cpu().numpy().astype(np.int64)
    ql = qlen.cpu().numpy().astype(np.int64)
    live = ql > 0
    blocks = np.where(live, (p0 + ql - 1) // bs + 1, 0).sum()
    kv_bytes = blocks * 2 * bs * h_kv * d * kv_item
    slots = ql.sum()
    io_bytes = slots * h * d * (q.element_size() + kv_item)
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


def sdpa_yardstick(torch, q, k_pool, v_pool, tables, pos0, qlen):
    """scaled_dot_product_attention over K/V gathered dense BEFOREHAND,
    with the ragged causal mask: the library's time for the same
    function (the gather is outside the timed call)."""
    import torch.nn.functional as F

    b, w, h, d = q.shape
    bs, h_kv = k_pool.shape[1], k_pool.shape[2]
    nb = tables.shape[1]
    kk = k_pool[tables.long()].reshape(b, nb * bs, h_kv, d).transpose(1, 2)
    vv = v_pool[tables.long()].reshape(b, nb * bs, h_kv, d).transpose(1, 2)
    kk, vv = kk.contiguous(), vv.contiguous()
    qq = q.to(k_pool.dtype).transpose(1, 2).contiguous()
    qpos = pos0.long()[:, None] + torch.arange(w, device=q.device)[None]
    mask = (torch.arange(nb * bs, device=q.device)[None, None, :]
            <= qpos[:, :, None])[:, None]           # (B, 1, W, S)

    def call():
        return F.scaled_dot_product_attention(qq, kk, vv, attn_mask=mask,
                                              enable_gqa=True)
    return call


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

def phase_parity(torch, pa) -> dict:
    dev = torch.device("cuda")
    errs = {}
    for name, q_lens in (("ragged_parity_check", (1, 7, 16, 17)),
                         ("spec_verify_parity_check", (1, 5, 5, 16, 17))):
        arrs = pa.ragged_parity_inputs(q_lens=q_lens)
        t = [torch.from_numpy(a).to(dev) for a in arrs]
        out = pa.ragged_paged_attention(*t)
        ref = pa.ragged_paged_attention_reference(*t)
        torch.cuda.synchronize()
        valid = (torch.arange(t[0].shape[1], device=dev)[None]
                 < t[5][:, None])[:, :, None, None]
        err = float(((out - ref).abs() * valid).max())
        log(f"parity f32 {name} q_lens={q_lens}: max_abs_err {err:.3e} "
            f"(tol {F32_TOL:g})")
        check(err <= F32_TOL, f"f32 parity {name}: {err} > {F32_TOL}")
        errs[name] = err
    for decode_only in (False, True):
        inp = main_path_inputs(torch, dev, decode_only)
        out = pa.ragged_paged_attention(*inp)
        ref = pa.ragged_paged_attention_reference(*inp)
        torch.cuda.synchronize()
        valid = (torch.arange(inp[0].shape[1], device=dev)[None]
                 < inp[5][:, None])[:, :, None, None]
        check(bool(torch.isfinite(out.float()).all()), "non-finite output")
        err = float(((out.float() - ref.float()).abs() * valid).max())
        shape = "decode W=1" if decode_only else "mixed W=256"
        log(f"parity bf16 main path ({shape}): max_abs_err {err:.3e} "
            f"(tol {BF16_TOL:g})")
        check(err <= BF16_TOL, f"bf16 parity {shape}: {err} > {BF16_TOL}")
        errs[shape] = err
    return errs


def phase_small_model(torch) -> None:
    """A small llama served on the card (kernel) against the same f32
    weights served on the CPU (plain version): greedy streams equal."""
    from tpu_engine_torch.models.convert import init_params, params_to
    from tpu_engine_torch.models.registry import create_model
    from tpu_engine_torch.runtime.scheduler import ContinuousGenerator

    spec = create_model("llama-small-test", max_seq=128)
    params = init_params(spec.config, seed=3, device="cpu", dtype="float32")
    kw = dict(dtype="float32", n_slots=4, max_seq=128, kv_block_size=16,
              prefill_chunk=16, mixed_step=True, mixed_token_budget=16)
    shared = [(i * 11) % 200 + 1 for i in range(32)]
    prompts = [[5, 9, 3], [(i * 7) % 200 + 1 for i in range(40)],
               shared + [91, 92, 93], shared + [81, 82]]
    outs = {}
    for dev in ("cpu", "cuda"):
        gen = ContinuousGenerator(spec, params=params_to(params, dev),
                                  device=dev, **kw)
        try:
            outs[dev] = [gen.generate([p], max_new_tokens=8)[0]
                         for p in prompts]
        finally:
            gen.stop()
    log(f"small model llama-small-test f32: card {outs['cuda']} "
        f"cpu {outs['cpu']}")
    check(outs["cuda"] == outs["cpu"],
          "small-model greedy streams differ between card and CPU")


def phase_server(torch, pa) -> dict:
    from tpu_engine_torch.serving.app import serve_worker
    from tpu_engine_torch.utils.config import WorkerConfig

    cfg = WorkerConfig(port=0, node_id="chip-smoke", model="llama",
                       dtype="bfloat16", gen_max_batch_size=8,
                       gen_prefill_chunk=256, gen_kv_block_size=16,
                       gen_mixed_step=True, gen_mixed_token_budget=256,
                       device="cuda", seed=0)
    t0 = time.perf_counter()
    worker, server = serve_worker(cfg)
    torch.cuda.synchronize()
    log(f"server: llama (TinyLlama-1.1B geometry) ready in "
        f"{time.perf_counter() - t0:.1f} s on port {server.port}")
    port = server.port
    vocab = worker.generator.cfg.vocab
    n_layers = worker.generator.cfg.n_layers
    rng = np.random.default_rng(0)

    def toks(n):
        return [int(t) for t in rng.integers(1, vocab, n)]

    prefix = toks(64)
    reqs = {"long": toks(300), "prefix_a": prefix + toks(20),
            "mid": toks(100), "short": toks(17), "one": toks(1)}
    stream_prompt = toks(200)
    max_new = 32
    out = {}
    try:
        # The main path's run: counts from 0, read right after it.
        pa.ragged_paged_attention.launches = 0
        pa.ragged_paged_attention.plain_calls = 0
        warm = post(port, "/generate", {"request_id": "warm",
                                        "prompt_tokens": reqs["short"],
                                        "max_new_tokens": 4})
        check(len(warm["tokens"]) == 4, f"warm-up: {warm}")

        results, errors = {}, []

        def run(name, prompt):
            try:
                results[name] = post(port, "/generate", {
                    "request_id": name, "prompt_tokens": prompt,
                    "max_new_tokens": max_new})
            except Exception as exc:  # reported below, fails the phase
                errors.append(f"{name}: {exc!r}")

        def run_stream():
            try:
                results["stream"] = stream(port, {
                    "request_id": "stream", "prompt_tokens": stream_prompt,
                    "max_new_tokens": max_new})
            except Exception as exc:
                errors.append(f"stream: {exc!r}")

        threads = [threading.Thread(target=run, args=kv)
                   for kv in reqs.items()]
        threads.append(threading.Thread(target=run_stream))
        t_burst = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        burst_s = time.perf_counter() - t_burst
        check(not errors and not any(t.is_alive() for t in threads),
              f"burst failed: {errors}")
        s_toks, s_final, ttft = results.pop("stream")
        check(s_final is not None and "error" not in s_final
              and s_final["tokens"] == s_toks and len(s_toks) == max_new,
              f"stream: {s_final}")
        n_tokens = len(s_toks)
        for name, res in results.items():
            check(len(res["tokens"]) == max_new
                  and all(0 <= t < vocab for t in res["tokens"]),
                  f"{name}: {res}")
            n_tokens += len(res["tokens"])
        hit0 = get(port, "/stats")["kv_pool"]["prefix_hit_tokens"]
        shared = post(port, "/generate", {
            "request_id": "prefix_b", "prompt_tokens": prefix + toks(40),
            "max_new_tokens": max_new})
        hit = get(port, "/stats")["kv_pool"]["prefix_hit_tokens"] - hit0
        check(len(shared["tokens"]) == max_new and hit >= 64,
              f"shared prefix: {hit} prefix-hit tokens")
        # Greedy repeat under the same batch composition (alone, both
        # resuming from the same radix hit): token-identical. A stream's
        # tokens may differ from a co-batched run of the same prompt: a
        # decode row that rides a prefill tick goes through a 2048-row
        # GEMM instead of an 8-row one, and bf16 rounds differently.
        first, again = (post(port, "/generate", {
            "request_id": f"long-repeat-{i}", "prompt_tokens": reqs["long"],
            "max_new_tokens": max_new})["tokens"] for i in range(2))
        check(first == again, f"greedy repeat differs: {first} {again}")
        deadline = time.time() + 30
        while True:
            st = get(port, "/stats")
            pool = st["kv_pool"]
            idle = (st["active"] == 0 and pool["blocks_free"]
                    + pool["radix_nodes"] == pool["blocks_total"])
            if idle or time.time() > deadline:
                break
            time.sleep(0.05)
        launches = pa.ragged_paged_attention.launches
        plain = pa.ragged_paged_attention.plain_calls
        mixed = st["mixed"]
        check(idle, f"not idle or blocks leaked: {pool}")
        check(mixed["ticks"] == mixed["dispatches"] > 0, f"{mixed}")
        check(plain == 0, f"plain ragged path served {plain} calls")
        check(launches == n_layers * mixed["dispatches"],
              f"{launches} kernel launches for {mixed['dispatches']} "
              f"dispatches of {n_layers} layers")
        health = get(port, "/health")
        check(health["healthy"] and health["generator"]["completed"] >= 8,
              f"health: {health}")
        out = {"launches": launches, "ticks": mixed["ticks"],
               "dispatches": mixed["dispatches"],
               "prefill_tokens": mixed["prefill_tokens"],
               "decode_tokens": mixed["decode_tokens"],
               "burst_tokens": n_tokens, "burst_s": burst_s,
               "tokens_per_s": n_tokens / burst_s, "stream_ttft_s": ttft,
               "prefix_hit_tokens": hit}
        log(f"server: {n_tokens} tokens in {burst_s:.3f} s "
            f"({n_tokens / burst_s:.1f} tokens/s, 6 concurrent requests), "
            f"stream TTFT {ttft * 1e3:.1f} ms; ticks {mixed['ticks']} == "
            f"dispatches {mixed['dispatches']}; kernel launches {launches} "
            f"({n_layers} per tick), plain calls {plain}; prefix hit "
            f"{hit} tokens; greedy repeat identical; blocks free "
            f"{pool['blocks_free']} + radix {pool['radix_nodes']} == total "
            f"{pool['blocks_total']}")
    finally:
        server.stop()
        worker.stop()
    return out


def phase_numbers(torch, pa) -> dict:
    dev = torch.device("cuda")
    res = {}
    for decode_only in (False, True):
        inp = main_path_inputs(torch, dev, decode_only)
        kernel = time_ms(torch, lambda: pa.ragged_paged_attention(*inp))
        plain = time_ms(torch,
                        lambda: pa.ragged_paged_attention_reference(*inp),
                        iters=5)
        library = time_ms(torch, sdpa_yardstick(torch, *inp))
        bound, by = bound_ms(inp[0], inp[1], inp[3], inp[4], inp[5])
        shape = "decode W=1" if decode_only else "mixed W=256"
        res[shape] = {"ms": kernel, "plain_ms": plain, "library_ms": library,
                      "bound_ms": bound, "bound_by": by}
        log(f"numbers ({shape}, B 8, H 32/4, D 64, bs 16, bf16 pool): "
            f"kernel {kernel:.4f} ms, plain {plain:.4f} ms, sdpa over "
            f"pre-gathered K/V {library:.4f} ms, bound {bound:.5f} ms "
            f"({by})")
    res["forward"] = forward_times(torch, pa, res)
    return res


def forward_times(torch, pa, kernel_res) -> dict:
    """One full-width mixed-step forward (22 layers, bf16, 8 rows) at the
    two widths the main path uses, timed on the card, and the share of it
    the attention kernel takes (22 launches at the isolated kernel time)."""
    from tpu_engine_torch.models.convert import init_params
    from tpu_engine_torch.models.registry import create_model
    from tpu_engine_torch.models.transformer import (
        KVCache,
        transformer_step_rows_ragged,
    )

    cfg = create_model("llama").config
    dev = torch.device("cuda")
    params = init_params(cfg, seed=0, device=dev, dtype="bfloat16")
    shape = (cfg.n_layers, 8 * 128 + 1, 16, cfg.kv_heads, cfg.d_head)
    caches = KVCache(torch.zeros(shape, dtype=torch.bfloat16, device=dev),
                     torch.zeros(shape, dtype=torch.bfloat16, device=dev))
    out = {}
    for decode_only in (False, True):
        _, _, _, tables, pos0, qlen = main_path_inputs(torch, dev,
                                                       decode_only)
        w = 1 if decode_only else 256
        tokens = torch.randint(0, cfg.vocab, (8, w), device=dev,
                               dtype=torch.int32)
        slot = (qlen - 1).clamp(min=0)

        def fwd():
            return transformer_step_rows_ragged(
                params, tokens, caches, tables, pos0, qlen, cfg,
                dtype=torch.bfloat16, sample_slot=slot)[0]
        logits = fwd()
        check(bool(torch.isfinite(logits).all())
              and tuple(logits.shape) == (8, cfg.vocab),
              "full-width forward: non-finite or misshapen logits")
        ms = time_ms(torch, fwd, iters=10)
        shape_name = "decode W=1" if decode_only else "mixed W=256"
        attn = cfg.n_layers * kernel_res[shape_name]["ms"]
        out[shape_name] = {"forward_ms": ms, "attention_ms": attn,
                           "attention_share": attn / ms}
        log(f"forward ({shape_name}, llama 22 layers, bf16): {ms:.3f} ms "
            f"per tick, of which the attention kernel {attn:.3f} ms "
            f"({100 * attn / ms:.1f}%)")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    from tpu_engine_torch.ops import paged_attention as pa

    # Full-f32 products for the plain versions (TF32 keeps ~3 digits).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"device: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    t0 = time.perf_counter()
    pa.kernel_library()
    log(f"build: {time.perf_counter() - t0:.1f} s "
        f"({pa.kernel_library_path().name})")
    errs = phase_parity(torch, pa)
    phase_small_model(torch)
    server = phase_server(torch, pa)
    numbers = phase_numbers(torch, pa)
    main_shape = numbers["mixed W=256"]
    kernels = {"kernels": [{
        "name": "ragged_paged_attention",
        "route": "cuda",
        "source": "tpu_engine_torch/csrc/ragged_paged_attention.cu",
        "replaces": "tpu_engine/ops/paged_attention.py:226",
        "launches": server["launches"],
        "max_abs_err": max(errs.values()),
        "ms": main_shape["ms"],
        "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"],
        "library_ms": main_shape["library_ms"],
    }]}
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "parity": errs, "server": server,
         "numbers": numbers, **kernels}, indent=1))
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

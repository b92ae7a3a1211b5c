"""Command line for the port's worker (counterpart of the ``worker``
command of ``tpu_engine/serving/cli.py``):

  python -m tpu_engine_torch.serving.cli worker <port> <node_id> <model>
      [--kv-block-size 16 [--kv-blocks N] [--kv-quantize int8]
       [--mixed-step --mixed-token-budget N]]
      [--step-chunk N] [--prefill-chunk N] [--n-slots N] [--device cpu]
      [--dtype bfloat16] [--seed N]

Without ``--kv-block-size`` the lane runs the dense scheduler, the JAX
worker's default: each prompt's forward on the prefill thread (one
flash-attention prefill up to ``--prefill-chunk`` tokens, windows beyond),
a 64 MB prompt prefix cache, and ``--step-chunk``-step decode chunks over
one dense KV cache on the decode thread. With ``--kv-block-size`` it runs
over the paged KV cache: mixed stepping with ``--mixed-step``, else the
two-path scheduler (prefill windows on one thread, decode chunks on the
other). ``--kv-quantize`` needs ``--kv-block-size``.

The worker serves /generate, /generate/stream, /health and /stats until
SIGTERM or SIGINT. Without ``--device`` it runs on the CUDA card.
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading


def _worker(argv) -> int:
    from tpu_engine_torch.serving.app import serve_worker
    from tpu_engine_torch.utils.config import WorkerConfig

    p = argparse.ArgumentParser(prog="tpu_engine_torch.serving.cli worker")
    p.add_argument("port", type=int)
    p.add_argument("node_id")
    p.add_argument("model")
    p.add_argument("--kv-block-size", type=int, default=0)
    p.add_argument("--kv-blocks", type=int, default=0)
    p.add_argument("--kv-quantize", default="",
                   help="int8: quantized KV pool (needs --kv-block-size)")
    p.add_argument("--mixed-step", action="store_true")
    p.add_argument("--step-chunk", type=int, default=16,
                   help="decode steps per chunk (dense and two-path)")
    p.add_argument("--mixed-token-budget", type=int, default=0)
    p.add_argument("--prefill-chunk", type=int, default=256)
    p.add_argument("--n-slots", type=int, default=8)
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    p.add_argument("--dtype", default="bfloat16",
                   choices=("bfloat16", "float32"))
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random weights")
    a = p.parse_args(argv)
    cfg = WorkerConfig(port=a.port, node_id=a.node_id, model=a.model,
                       dtype=a.dtype, gen_max_batch_size=a.n_slots,
                       gen_step_chunk=a.step_chunk,
                       gen_prefill_chunk=a.prefill_chunk,
                       gen_kv_block_size=a.kv_block_size,
                       gen_kv_blocks=a.kv_blocks,
                       gen_kv_quantize=a.kv_quantize,
                       gen_mixed_step=a.mixed_step,
                       gen_mixed_token_budget=a.mixed_token_budget,
                       device=a.device, seed=a.seed)
    worker, server = serve_worker(cfg)
    print(f"tpu_engine_torch worker {cfg.node_id} ({cfg.model}, "
          f"{worker.generator.device}) listening on port {server.port}",
          flush=True)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    try:
        # A bounded wait: the signal may land on another thread, and the
        # main thread only runs the handler once it wakes.
        while not stop.wait(0.5):
            pass
    finally:
        server.stop()
        worker.stop()
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] != "worker":
        print(__doc__)
        return 2
    return _worker(argv[1:])


if __name__ == "__main__":
    sys.exit(main())

"""Command line of the port (counterpart of the ``worker`` and ``train``
commands of ``tpu_engine/serving/cli.py``):

  python -m tpu_engine_torch.serving.cli worker <port> <node_id> <model>
      [--kv-block-size 16 [--kv-blocks N] [--kv-quantize int8]
       [--mixed-step --mixed-token-budget N]]
      [--step-chunk N] [--prefill-chunk N] [--n-slots N] [--device cpu]
      [--dtype bfloat16] [--seed N]

  python -m tpu_engine_torch.serving.cli train [--model NAME] [--steps N]
      [--batch N] [--seq N] [--lr X] [--remat] [--data tokens.npy]
      [--out DIR] [--resume DIR/state] [--log-every N] [--seed N]
      [--device cpu]

Worker: without ``--kv-block-size`` the lane runs the dense scheduler, the
JAX worker's default: each prompt's forward on the prefill thread (one
flash-attention prefill up to ``--prefill-chunk`` tokens, windows beyond),
a 64 MB prompt prefix cache, and ``--step-chunk``-step decode chunks over
one dense KV cache on the decode thread. With ``--kv-block-size`` it runs
over the paged KV cache: mixed stepping with ``--mixed-step``, else the
two-path scheduler (prefill windows on one thread, decode chunks on the
other). ``--kv-quantize`` needs ``--kv-block-size``. ``<model>`` is a
registry name (seeded random weights) or a checkpoint directory holding
the ``tpu_engine_model.json`` sidecar the ``train`` command writes (its
trained weights, served at ``--dtype``). The worker serves /generate,
/generate/stream, /health and /stats until SIGTERM or SIGINT.

Train: the JAX command's causal-LM loop with AdamW on one card: the same
numpy draws (the fixed synthetic batch from ``--seed``, rows and offsets
from ``--seed + 1``), the same ``step k: loss x`` lines, an f32 forward
through the flash kernels and their backward, ``--remat`` checkpointing
each block. ``--out`` writes ``<out>/state`` (the whole train state) and
``<out>/params`` (servable, with the sidecar); ``--resume`` continues a
saved state's step count. ``--mesh`` (parallel training) is not ported.

Both run on the CUDA card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading

SIDECAR = "tpu_engine_model.json"


def resolve_model(model_arg: str, device=None, dtype="bfloat16"):
    """(registry name, params) for a worker's ``<model>`` argument: a
    registry name gives (the name, None: seeded random weights); a
    checkpoint directory holding the ``tpu_engine_model.json`` sidecar (the
    train command's ``<out>/params``) gives the name the sidecar records and
    its parameters, on ``device`` with matmul kernels in ``dtype``."""
    sidecar = os.path.join(model_arg, SIDECAR)
    if not (os.path.isdir(model_arg) and os.path.exists(sidecar)):
        return model_arg, None
    from tpu_engine_torch.utils.checkpoint import load_params

    with open(sidecar) as f:
        name = json.load(f)["model"]
    return name, load_params(model_arg, device=device, dtype=dtype)


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
    model, params = resolve_model(a.model, device=a.device, dtype=a.dtype)
    cfg = WorkerConfig(port=a.port, node_id=a.node_id, model=model,
                       dtype=a.dtype, gen_max_batch_size=a.n_slots,
                       gen_step_chunk=a.step_chunk,
                       gen_prefill_chunk=a.prefill_chunk,
                       gen_kv_block_size=a.kv_block_size,
                       gen_kv_blocks=a.kv_blocks,
                       gen_kv_quantize=a.kv_quantize,
                       gen_mixed_step=a.mixed_step,
                       gen_mixed_token_budget=a.mixed_token_budget,
                       device=a.device, seed=a.seed)
    worker, server = serve_worker(cfg, params=params)
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


def train(argv, params=None) -> int:
    """The ``train`` command on ``argv`` (its flags, without the command
    name). ``params``: the initial parameter tree (the port's, in f32 on
    the run's device); None draws the model's seeded random weights.
    Returns the exit code."""
    import numpy as np
    import torch

    from tpu_engine_torch.models.registry import create_model
    from tpu_engine_torch.models.transformer import (
        TransformerConfig,
        transformer_apply,
    )
    from tpu_engine_torch.training.train import (
        adamw,
        cross_entropy_loss,
        make_train_step,
    )
    from tpu_engine_torch.utils.checkpoint import (
        load_train_state,
        save_params,
        save_train_state,
    )
    from tpu_engine_torch.utils.device import resolve_device

    p = argparse.ArgumentParser(prog="tpu_engine_torch.serving.cli train")
    p.add_argument("--model", default="gpt2-small-test",
                   help="registry decoder LM")
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=None,
                   help="train sequence length (default: the model's "
                        "max_seq)")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--mesh", default=None,
                   help="parallel training: not ported (refuses)")
    p.add_argument("--remat", action="store_true",
                   help="checkpoint each block (activation memory ~ one "
                        "layer instead of all L)")
    p.add_argument("--data", default=None,
                   help=".npy int32 token array (N, seq+1); default: a "
                        "fixed synthetic batch (memorization smoke)")
    p.add_argument("--out", default=None,
                   help="checkpoint dir (state + params)")
    p.add_argument("--resume", default=None,
                   help="train-state dir to resume from")
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if args.mesh:
        print("--mesh (parallel training) is not yet ported to "
              "tpu_engine_torch")
        return 2
    try:
        spec = create_model(args.model)
    except NotImplementedError as exc:
        print(f"'{args.model}' is not a causal-LM transformer the port "
              f"trains ({exc})")
        return 2
    cfg = spec.config
    if not isinstance(cfg, TransformerConfig) or not cfg.causal:
        print(f"'{args.model}' is not a causal-LM transformer")
        return 2
    dev = resolve_device(args.device)
    seq = min(args.seq or cfg.max_seq, cfg.max_seq)

    def apply_fn(params, x, dtype=torch.bfloat16):
        return transformer_apply(params, x, cfg, dtype=dtype,
                                 remat=args.remat)

    init_state, train_step = make_train_step(
        apply_fn, loss_fn=cross_entropy_loss, optimizer=adamw(args.lr),
        dtype=torch.float32)
    if params is None:
        params = spec.init(args.seed, device=dev, dtype="float32")
    state = init_state(params)
    if args.resume:
        state = load_train_state(args.resume, like=state)
        print(f"resumed at step {state.step}")

    if args.data:
        tokens = np.load(args.data).astype(np.int32)
        assert tokens.ndim == 2 and tokens.shape[1] >= seq + 1, \
            f"need (N, >= {seq + 1}) tokens, got {tokens.shape}"
    else:  # fixed synthetic batch: loss falling = the loop works
        tokens = np.random.default_rng(args.seed).integers(
            1, cfg.vocab, (args.batch, seq + 1)).astype(np.int32)

    rng = np.random.default_rng(args.seed + 1)
    max_off = tokens.shape[1] - (seq + 1)
    for k in range(args.steps):
        rows = (rng.integers(0, tokens.shape[0], args.batch)
                if args.data else np.arange(args.batch))
        off = int(rng.integers(0, max_off + 1)) if max_off > 0 else 0
        window = torch.from_numpy(tokens[rows, off:off + seq + 1]).to(dev)
        state, loss = train_step(state, window[:, :-1], window[:, 1:])
        if k % args.log_every == 0 or k == args.steps - 1:
            print(f"step {state.step}: loss {float(loss):.4f}", flush=True)
    if args.out:
        spath = save_train_state(os.path.join(args.out, "state"), state,
                                 overwrite=True)
        ppath = save_params(os.path.join(args.out, "params"), state.params,
                            overwrite=True)
        # Self-describing checkpoint: the worker resolves the architecture
        # from this sidecar, so `worker <port> <id> <out>/params` needs no
        # model name.
        with open(os.path.join(ppath, SIDECAR), "w") as f:
            json.dump({"model": args.model}, f)
        print(f"saved train state -> {spath}")
        print(f"saved servable params -> {ppath}")
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "worker":
        return _worker(argv[1:])
    if argv and argv[0] == "train":
        return train(argv[1:])
    print(__doc__)
    return 2


if __name__ == "__main__":
    sys.exit(main())

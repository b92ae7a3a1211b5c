"""Command line of the port (counterpart of the ``worker``,
``worker_node``, ``gateway`` and ``train`` commands of
``tpu_engine/serving/cli.py``):

  python -m tpu_engine_torch.serving.cli worker <port> <node_id> <model>
      [--kv-block-size 16 [--kv-blocks N] [--kv-quantize int8]
       [--mixed-step --mixed-token-budget N]
       [--spec-k K [--spec-draft ngram|model] [--gen-draft-model NAME]
       [--gen-draft-path DIR]]]
      [--gen-scheduler batch|continuous|speculative [--gen-decode-fused]
       [--gen-spec-k K] [--gen-draft-model NAME] [--gen-draft-path DIR]]
      [--state-rows N] [--step-chunk N] [--prefill-chunk N] [--n-slots N]
      [--tp N] [--max-batch-size N] [--cache-capacity N]
      [--batch-timeout-ms MS] [--pipeline-depth N] [--warmup]
      [--no-unified-stateless] [--priority-admission] [--adaptive-depth]
      [--brownout [--brownout-clamp-tokens N]]
      [--trace-capacity N] [--trace-stitch] [--profile-dir DIR]
      [--flight-recorder N [--flight-dump-dir DIR]]
      [--role prefill|decode|both] [--prefix-fetch
      [--prefix-fetch-timeout S] [--prefix-fetch-inflight N]]
      [--device cpu] [--dtype bfloat16] [--seed N]

  python -m tpu_engine_torch.serving.cli worker_node <port> [<node_id>
      [<model_path>]] [--no-unified-stateless] [the worker's flags]

  python -m tpu_engine_torch.serving.cli import-weights --model NAME
      --src <HF dir | .safetensors | .bin> --out DIR [--device cpu]

  python -m tpu_engine_torch.serving.cli gateway <worker1_host:port>
      [worker2_host:port ...] [--port 8000] [--breaker-timeout S]
      [--drain-timeout S] [--retry-budget RATIO] [--failover-streams]
      [--health-probe-interval S] [--overload-control
      [--overload-max-inflight N]] [--tenant-rate R] [--trace-stitch
      [--trace-ledger-capacity N]] [--slo-ttft-p99-ms MS]
      [--slo-itl-p99-ms MS] [--slo-completion-p99-ms MS]
      [--slo-target F] [--slo-window-s S]
      [--migrate-streams [--migrate-timeout S]] [--disagg
      [--handoff-timeout S]] [--prefix-affinity [--affinity-block-size N]
      [--affinity-prefix-blocks N] [--affinity-max-imbalance N]]
      [--prefix-directory [--prefix-dir-capacity N]]

  python -m tpu_engine_torch.serving.cli serve [--model NAME[,NAME...]]
      [--lanes N] [--port 8000] [--native-front auto|on|off]
      [--lane-roles prefill,decode] [--model-path PATH] [--warmup]
      [the JAX serve command's worker and gateway flags]
      [--device cpu] [--dtype bfloat16] [--seed N]

  python -m tpu_engine_torch.serving.cli train [--model NAME] [--steps N]
      [--batch N] [--seq N] [--lr X] [--remat] [--data tokens.npy]
      [--out DIR] [--resume DIR/state] [--log-every N] [--seed N]
      [--device cpu]

Worker: every lane serves /infer (the result cache, in-flight coalescing,
and single-tick rows of its scheduler, or the dynamic batcher with
``--no-unified-stateless``), /health and /admin/drain. A config-less model
(``mlp``, ``resnet50``, ``resnet50-v1``) serves /infer only. A decoder
lane also serves /score, /generate and /generate/stream: without
``--kv-block-size`` the lane runs the dense scheduler, the
JAX worker's default: each prompt's forward on the prefill thread (one
flash-attention prefill up to ``--prefill-chunk`` tokens, windows beyond),
a 64 MB prompt prefix cache, and ``--step-chunk``-step decode chunks over
one dense KV cache on the decode thread. With ``--kv-block-size`` it runs
over the paged KV cache: mixed stepping with ``--mixed-step``, else the
two-path scheduler (prefill windows on one thread, decode chunks on the
other). A recurrent decoder (``mamba2``, ``ssd-small-test``: the
state_slab family) serves the same surfaces from a slab of fixed-size
state rows, one per stream (``--state-rows``, default ``--n-slots`` + 1),
in the two-path or (``--mixed-step``) the mixed mode; it refuses the KV
flags and ``--spec-k``. ``--kv-quantize`` needs ``--kv-block-size``.
``--spec-k K`` (paged
lanes, either mode) turns on continuous speculation: up to K proposals per
decode row per tick from the n-gram drafter, or with ``--spec-draft model``
from a draft model (``--gen-draft-model``, default by the target: gpt2 ->
distilgpt2; its weights from ``--gen-draft-path``, an HF checkpoint or a
checkpoint of the port's format, else randomly initialised), verified in
the tick's one ragged forward. ``--gen-scheduler batch`` serves a decoder
through the batch Generator instead: requests batched by the lane's
batcher (up to ``--n-slots``) and each group decoded to completion with
the tokens kept on the card and the done flag read once per
``--step-chunk`` steps (``--gen-decode-fused``, JAX's one-dispatch loop,
takes the same loop here: the streams are one); it also serves
``beam_width`` 2-8 and streams a request's whole result as one event.
``--gen-scheduler speculative`` is the batch lane with draft-model
speculation (``--gen-spec-k`` proposals a round from ``--gen-draft-model``
with ``--gen-draft-path``'s weights; temperature sampling only). The batch
lanes refuse the paged-cache, host-tier, prefix-fetch, ``--spec-k`` and
dedicated ``--role`` flags and the recurrent family. ``<model>`` is a
registry name (seeded random weights) or a checkpoint directory holding
the ``tpu_engine_model.json`` sidecar the ``train`` command writes (its
trained weights, served at ``--dtype``). Overload control (each off by
default): ``--adaptive-depth`` bounds the requests in flight by an AIMD
limit driven by their latency (from 32, at most 64), above which the
lane sheds 503 ``overloaded``; ``--priority-admission`` sheds the lower
``priority`` tiers of requests first (background at 70% of the limit,
batch at 85%); and ``--brownout`` degrades the lane under
pressure before it sheds (the mixed tick's token budget halved,
speculation suspended, host-tier swap-ins deferred, then below-top-tier
requests clamped to ``--brownout-clamp-tokens`` new tokens), restoring
in reverse. Observability: every lane records spans into a ring of
``--trace-capacity`` (default 2048, 0 = off) served at /trace,
/trace/export and /admin/trace/<request_id>, with /metrics in the
Prometheus text format; ``--trace-stitch`` makes a migration snapshot
carry the stream's trace context; ``--flight-recorder N`` keeps the
scheduler's last N ticks for /admin/timeline (anomaly dumps into
``--flight-dump-dir``); ``--profile-dir`` arms /admin/profile's
tick-bounded torch.profiler capture. ``--role`` (a dedicated role needs
``--kv-block-size``) is the lane's disaggregated serving role, shown in
/health and flipped by /admin/role; ``--prefix-fetch`` serves
/admin/export_prefix, publishes the radix tree's deepest chains in
/health and fetches a gateway-hinted peer's chain before prefilling a
miss; ``--scheduler-stall-s S`` makes /health read unhealthy
(``scheduler_stalled``) once the decode loop has not ticked for S
seconds. The worker serves until SIGTERM or SIGINT.

worker_node: the argv of the reference's launch line (``worker_node 8001
worker_1 models/resnet50-v2-7.onnx``): the node id defaults to
``worker_<port>``, the model to ``$MODEL_PATH`` or ``resnet50``. An
existing ``.onnx`` file is served as its graph (architecture and weights
from the file); an HF checkpoint directory serves the registry model its
``config.json`` names (``gpt2``, ``bert``, ``llama``, ``resnet50-v1``) at
its geometry with its weights; a directory holding the
``tpu_engine_model.json`` sidecar (the train and import-weights commands'
output) serves the model it records with its weights; an HF checkpoint
file, or a path to nothing, is named by its file name
(``resnet50-v2-7.onnx`` -> ``resnet50``), the file's weights loaded. Any
other directory (an orbax checkpoint) refuses by name.

import-weights: an HF/torch checkpoint of ``--model``'s family to the
port's checkpoint format (``<out>/params.pt`` and the sidecar, with the
HF directory's geometry), which ``worker_node <port> <id> <out>`` serves.

gateway: the reference's gateway argv (``gateway 127.0.0.1:8001
127.0.0.1:8002 127.0.0.1:8003``): consistent-hash routing of /infer,
/generate, /generate/stream and /score over the workers, a circuit breaker
per lane (``--breaker-timeout`` seconds OPEN before HALF_OPEN, default 30),
ring-order failover, and /stats. ``--drain-timeout`` bounds a graceful
removal's drain call, ``--retry-budget`` caps failover retries at that
share of recent requests. ``--failover-streams`` resumes a stream whose
lane fails mid-generation on another lane (prompt plus the emitted
tokens), ``--health-probe-interval S`` probes every lane's /health each S
seconds and ejects a lane after 3 failed probes until one succeeds,
``--overload-control`` validates the requests' ``priority`` and with
``--overload-max-inflight N`` sheds the lower tiers first as N requests
in flight fill (Retry-After growing with the pressure), ``--tenant-rate
R`` holds each ``tenant`` to R requests/s (a bucket 2R deep),
``--trace-stitch`` carries each stream's root trace context to every lane
it touches and keeps the ledger /admin/trace/<request_id> stitches from,
and the ``--slo-*`` objectives report their burn rates at /admin/slo.
``--migrate-streams`` continues a drained lane's streams on another lane
from their exported KV chains, ``--disagg`` lands generate work on
``--role prefill`` lanes and hands each stream's chain to a decode lane,
``--prefix-affinity`` routes generate requests on the prompt's leading
full blocks, and ``--prefix-directory`` stamps them with the owner lane
of their prefix for ``--prefix-fetch`` workers. Hedged dispatch has no
flag, as in JAX: it is ``GatewayConfig.hedge_enabled``. ``--autoscale``
(and its ``--autoscale-*`` knobs, with ``--autoscale-slo-feed``) runs the
elastic fleet's controller over the ``--standby-worker`` addresses, each
brought in after a passing /health probe; it implies
``--migrate-streams``. /admin/fleet is its operator surface.

serve: one process, one front door, in-process lanes behind the gateway
(``app.serve_combined``): ``--lanes N`` lanes named worker_1..N (default
one per card; with ``--device cpu`` one on the CPU), each its own engine,
cache, batcher and scheduler; ``--model a,b`` assigns models round-robin
and routes requests by their ``model``. The front is the C++ one
(``--native-front auto``, the default, for one model; ``on`` requires it)
that answers /infer cache hits from the lanes' native caches without the
GIL, or the Python one (``off``, and always for several models). Its
library builds with g++ at first use into ``build/tpu_engine_torch/native/``;
a failed build stops the command with the compiler's output. The JAX
command's flags map onto the same WorkerConfig and GatewayConfig fields
(``--default-deadline-ms``, ``--retry-backoff-ms`` among them);
``--autoscale`` mints in-process lanes and retires them with the load,
``--scheduler-stall-s`` arms every lane's stall watchdog; ``--tp N``
makes every lane tensor-parallel over N ranks (the default lane count is
then the cards // N, lane i on cards i*N ..; with ``--device`` every rank
on that device); ``--mesh model=2,data=2`` serves one model on one lane
whose engine spans the mesh (batches split over ``data``, weights over
``model``), its ranks the cards (as many as the mesh's size) or all on
``--device``. SIGTERM stops the front, the gateway and every lane.

``--tp N`` on a worker (paged continuous lanes, ``--kv-block-size``
needed) shards the model by the registry's rule over N ranks, on the
first N cards, or all on ``--device``; its /health carries the
``topology`` label the gateway's ring weights it by.

Train: the JAX command's causal-LM loop with AdamW on one card: the same
numpy draws (the fixed synthetic batch from ``--seed``, rows and offsets
from ``--seed + 1``), the same ``step k: loss x`` lines, an f32 forward
through the flash kernels and their backward, ``--remat`` checkpointing
each block. ``--out`` writes ``<out>/state`` (the whole train state) and
``<out>/params`` (servable, with the sidecar); ``--resume`` continues a
saved state's step count. ``--mesh data=2,model=2`` trains over a mesh
(``training.train.make_mesh_train_step``): parameters split over
``model`` when the mesh has that axis (else whole on every rank), the
batch over ``data``, the whole state (optimizer moments included) placed
on the mesh after a resume, and ``--out`` writing the gathered state, as
an unsharded run's. Its ranks are the cards, or all on ``--device``.

The worker and train commands run on the CUDA card unless ``--device
cpu``; the gateway never touches the card.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading

from tpu_engine_torch.utils.checkpoint import SIDECAR


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


def _add_worker_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--kv-block-size", type=int, default=0)
    p.add_argument("--kv-blocks", type=int, default=0)
    p.add_argument("--kv-quantize", default="",
                   help="int8: quantized KV pool (needs --kv-block-size)")
    p.add_argument("--kv-host-blocks", type=int, default=0,
                   help="host blocks under the paged pool for demoted "
                        "radix prefixes, swapped back in on a hit (needs "
                        "--kv-block-size). 0 = off")
    p.add_argument("--state-rows", type=int, default=0,
                   help="state slab rows of a recurrent (state_slab) "
                        "model, e.g. mamba2: one fixed-size row per live "
                        "stream, constant in sequence length. 0 = auto "
                        "(--n-slots + the null row)")
    p.add_argument("--mixed-step", action="store_true")
    p.add_argument("--step-chunk", type=int, default=16,
                   help="decode steps per chunk (dense and two-path)")
    p.add_argument("--mixed-token-budget", type=int, default=0)
    p.add_argument("--prefill-chunk", type=int, default=256)
    p.add_argument("--spec-k", type=int, default=0,
                   help="continuous speculative decoding (needs "
                        "--kv-block-size): up to this many proposals per "
                        "decode row per tick, verified in the tick's one "
                        "ragged forward. 0 = off")
    p.add_argument("--spec-draft", choices=["ngram", "model"],
                   default="ngram",
                   help="drafter for --spec-k: ngram (prompt lookup, no "
                        "second model) or model (--gen-draft-model)")
    p.add_argument("--gen-scheduler",
                   choices=["batch", "continuous", "speculative"],
                   default="continuous",
                   help="decode scheduling: continuous (iteration-level "
                        "admission), batch-to-completion, or speculative "
                        "(draft-model proposals verified by the target in "
                        "one windowed pass; temperature sampling only)")
    p.add_argument("--gen-draft-model", default=None,
                   help="draft model for --gen-scheduler speculative and "
                        "--spec-draft model (default: auto, e.g. gpt2 -> "
                        "distilgpt2)")
    p.add_argument("--gen-draft-path", default=None,
                   help="draft model weights checkpoint")
    p.add_argument("--gen-spec-k", type=int, default=4,
                   help="speculation depth: draft tokens proposed per "
                        "verify round")
    p.add_argument("--gen-decode-fused", action="store_true",
                   help="batch scheduler: whole decode loop with the "
                        "tokens on the card (no per-chunk token copies; "
                        "identical streams)")
    p.add_argument("--n-slots", type=int, default=8,
                   help="decode rows of a decoder lane's scheduler")
    p.add_argument("--max-batch-size", type=int, default=32,
                   help="largest /infer batch: the batcher's cap and a "
                        "stateless lane's rows per tick (default 32)")
    p.add_argument("--cache-capacity", type=int, default=1000,
                   help="result-cache entries per lane (default 1000)")
    p.add_argument("--batch-timeout-ms", type=float, default=20.0,
                   help="dynamic batcher flush timeout (default 20)")
    p.add_argument("--pipeline-depth", type=int, default=4,
                   help="submitted batches kept in flight on the miss "
                        "path (default 4)")
    p.add_argument("--warmup", action="store_true",
                   help="run every batch bucket once before listening")
    p.add_argument("--no-unified-stateless", action="store_true",
                   help="serve /infer misses and /score through the "
                        "dedicated batch processors instead of "
                        "single-tick rows in the continuous scheduler")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    p.add_argument("--dtype", default="bfloat16",
                   choices=("bfloat16", "float32"))
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random weights")
    p.add_argument("--priority-admission", action="store_true",
                   help="shed the lowest priority tier first under depth "
                        "pressure (requests carry priority: "
                        "interactive|batch|background)")
    p.add_argument("--adaptive-depth", action="store_true",
                   help="AIMD adaptive concurrency limit driven by the "
                        "requests' latency against the window's baseline")
    p.add_argument("--brownout", action="store_true",
                   help="staged brownout: degrade (budget shrink, spec "
                        "off, swap-in deferral, low-tier clamp) before "
                        "shedding")
    p.add_argument("--brownout-clamp-tokens", type=int, default=None,
                   help="the clamp stage's max_new_tokens ceiling for "
                        "below-top-tier requests (default 32)")
    p.add_argument("--trace-capacity", type=int, default=2048,
                   help="spans kept in the lane's ring (0 = no spans and "
                        "no stage histograms)")
    p.add_argument("--trace-stitch", action="store_true",
                   help="migration snapshots carry the stream's trace "
                        "context, so the importing lane's spans join the "
                        "same trace")
    p.add_argument("--profile-dir", default=None,
                   help="torch.profiler capture directory: arms POST "
                        "/admin/profile {\"ticks\": N} (unset = refused)")
    p.add_argument("--flight-recorder", type=int, default=0,
                   help="keep the scheduler's last N per-tick records "
                        "(GET /admin/timeline), dumped on an anomaly "
                        "(0 = off)")
    p.add_argument("--flight-dump-dir", default=None,
                   help="directory of the flight recorder's dumps (unset "
                        "= in memory only)")
    p.add_argument("--role", default=None,
                   choices=("prefill", "decode", "both"),
                   help="disaggregated serving role (a dedicated role "
                        "needs --kv-block-size): a --disagg gateway lands "
                        "fresh generate work on prefill lanes and ships "
                        "their KV chains to decode lanes; flippable via "
                        "/admin/role (default: both)")
    p.add_argument("--prefix-fetch", action="store_true",
                   help="fleet prefix tier (needs --kv-block-size): serve "
                        "/admin/export_prefix to peers, publish radix "
                        "summaries in /health, and fetch a gateway-hinted "
                        "peer's KV chain before prefilling a local miss")
    p.add_argument("--prefix-fetch-timeout", type=float, default=None,
                   help="per-fetch peer budget in seconds (default 5)")
    p.add_argument("--prefix-fetch-inflight", type=int, default=None,
                   help="concurrent peer fetches per lane; excess misses "
                        "prefill locally (default 2)")
    p.add_argument("--scheduler-stall-s", type=float, default=None,
                   help="decode-loop liveness threshold: /health reads "
                        "unhealthy when the loop has not ticked for this "
                        "long (0/unset = report the age only)")
    p.add_argument("--tp", type=int, default=None,
                   help="tensor-parallel serving: shard the model "
                        "(registry-declared partition rule) and the paged "
                        "KV pool's H_kv axis over this many ranks (the "
                        "first cards, or all on --device); needs "
                        "--kv-block-size; unshardable families (mamba2) "
                        "refuse at startup (unset/1 = one device)")


def worker_config(a, node_id: str, model: str, model_path=None):
    """The WorkerConfig of parsed worker flags."""
    from tpu_engine_torch.utils.config import WorkerConfig

    cfg = WorkerConfig(port=a.port, node_id=node_id, model=model,
                       model_path=model_path, dtype=a.dtype,
                       gen_max_batch_size=a.n_slots,
                       gen_step_chunk=a.step_chunk,
                       gen_prefill_chunk=a.prefill_chunk,
                       gen_kv_block_size=a.kv_block_size,
                       gen_kv_blocks=a.kv_blocks,
                       gen_kv_quantize=a.kv_quantize,
                       gen_kv_host_blocks=a.kv_host_blocks,
                       gen_state_rows=a.state_rows,
                       gen_mixed_step=a.mixed_step,
                       gen_mixed_token_budget=a.mixed_token_budget,
                       gen_continuous_spec_k=a.spec_k,
                       gen_spec_draft=a.spec_draft,
                       gen_draft_model=a.gen_draft_model,
                       gen_scheduler=a.gen_scheduler,
                       gen_draft_path=a.gen_draft_path,
                       gen_spec_k=a.gen_spec_k,
                       gen_decode_fused=a.gen_decode_fused,
                       max_batch_size=a.max_batch_size,
                       cache_capacity=a.cache_capacity,
                       batch_timeout_ms=a.batch_timeout_ms,
                       pipeline_depth=a.pipeline_depth,
                       unified_stateless=not a.no_unified_stateless,
                       priority_admission=a.priority_admission,
                       adaptive_depth=a.adaptive_depth,
                       brownout=a.brownout,
                       trace_capacity=a.trace_capacity,
                       trace_stitch=a.trace_stitch,
                       profile_dir=a.profile_dir,
                       flight_recorder=a.flight_recorder,
                       flight_dump_dir=a.flight_dump_dir,
                       device=a.device, seed=a.seed)
    if a.brownout_clamp_tokens is not None:
        cfg.brownout_clamp_tokens = a.brownout_clamp_tokens
    if a.role is not None:
        cfg.role = a.role
    if a.prefix_fetch:
        cfg.gen_prefix_fetch = True
    if a.prefix_fetch_timeout is not None:
        cfg.gen_prefix_fetch_timeout_s = a.prefix_fetch_timeout
    if a.prefix_fetch_inflight is not None:
        cfg.gen_prefix_fetch_inflight = a.prefix_fetch_inflight
    if a.scheduler_stall_s is not None:
        cfg.scheduler_stall_s = a.scheduler_stall_s
    if a.tp is not None:
        cfg.tp = a.tp
    return cfg


def _serve(a, node_id: str, model: str, params=None,
           model_path=None) -> int:
    """Serve one worker from parsed flags until SIGTERM or SIGINT."""
    from tpu_engine_torch.serving.app import serve_worker

    cfg = worker_config(a, node_id, model, model_path)
    worker, server = serve_worker(cfg, params=params, warmup=a.warmup)
    print(f"tpu_engine_torch worker {cfg.node_id} ({cfg.model}, "
          f"{worker.engine.device}) listening on port {server.port}",
          flush=True)
    try:
        _wait_for_signal()
    finally:
        server.stop()
        worker.stop()
    return 0


def _wait_for_signal() -> None:
    """Block until SIGTERM or SIGINT."""
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    # A bounded wait: the signal may land on another thread, and the main
    # thread only runs the handler once it wakes.
    while not stop.wait(0.5):
        pass


def _worker(argv) -> int:
    p = argparse.ArgumentParser(prog="tpu_engine_torch.serving.cli worker")
    p.add_argument("port", type=int)
    p.add_argument("node_id")
    p.add_argument("model")
    _add_worker_flags(p)
    a = p.parse_args(argv)
    model, params = resolve_model(a.model, device=a.device, dtype=a.dtype)
    return _serve(a, a.node_id, model, params)


def worker_node_args(argv):
    """(parsed flags, node id, model, model path) of a ``worker_node``
    command line, as the JAX command resolves them: the node id defaults
    to ``worker_<port>``, the model argument to ``$MODEL_PATH`` or
    ``resnet50``. An existing path is the model path: an ``.onnx`` file
    is the model ``"onnx"`` (its graph), a directory with the sidecar
    the model it records, an HF directory the model its config.json
    names; otherwise (a name, a path to nothing, an HF file)
    ``model_from_path`` names the model."""
    from tpu_engine_torch.models.import_weights import model_name_from_hf
    from tpu_engine_torch.models.registry import model_from_path

    p = argparse.ArgumentParser(prog="worker_node")
    p.add_argument("port", type=int)
    p.add_argument("node_id", nargs="?", default=None)
    p.add_argument("model_arg", nargs="?", default=None)
    _add_worker_flags(p)
    a = p.parse_args(argv)
    node_id = a.node_id or f"worker_{a.port}"
    model_arg = a.model_arg or os.environ.get("MODEL_PATH", "resnet50")
    model_path = model_arg if os.path.exists(model_arg) else None
    model = None
    sidecar = os.path.join(model_arg, SIDECAR)
    if model_path and model_path.endswith(".onnx"):
        model = "onnx"  # the architecture comes from the file
    elif model_path and os.path.isdir(model_path) and os.path.exists(
            sidecar):
        with open(sidecar) as f:
            model = json.load(f)["model"]
    elif model_path:
        model = model_name_from_hf(model_path)
    return a, node_id, model or model_from_path(model_arg), model_path


def _worker_node(argv) -> int:
    if not argv:
        print("Usage: worker_node <port> <node_id> [model_path] "
              "[--no-unified-stateless] [--kv-block-size N] ...")
        return 1
    a, node_id, model, model_path = worker_node_args(argv)
    return _serve(a, node_id, model, model_path=model_path)


def import_weights(argv) -> int:
    """The ``import-weights`` command: ``--src`` (an HF checkpoint
    directory, ``.safetensors`` or torch ``.bin``) imported as ``--model``
    and saved to ``--out`` in the port's checkpoint format (f32, with the
    sidecar naming the model and, for an HF directory, its geometry)."""
    from tpu_engine_torch.models.import_weights import (
        hf_spec_kwargs,
        load_pretrained,
    )
    from tpu_engine_torch.utils.checkpoint import save_params

    p = argparse.ArgumentParser(prog="import-weights")
    p.add_argument("--model", required=True,
                   help="registry model name (gpt2, bert, llama, "
                        "resnet50-v1)")
    p.add_argument("--src", required=True,
                   help="HF checkpoint dir, .safetensors, or torch .bin")
    p.add_argument("--out", required=True)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    params = load_pretrained(args.model, args.src, device=args.device,
                             dtype="float32")
    path = save_params(args.out, params)
    with open(os.path.join(path, SIDECAR), "w") as f:
        json.dump({"model": args.model,
                   "kwargs": hf_spec_kwargs(args.src)}, f)
    print(f"imported {args.src} as {args.model} -> {path}")
    return 0


def _add_autoscale_flags(p: argparse.ArgumentParser) -> None:
    """The elastic fleet's flags of ``gateway`` and ``serve``, the JAX
    commands'; unset, GatewayConfig keeps its defaults."""
    p.add_argument("--autoscale", action="store_true",
                   help="the elastic fleet: a control loop spawns a lane "
                        "(registered after a passing /health probe) or "
                        "retires one (drain and live stream migration) "
                        "with the lanes' pressure (implies "
                        "--migrate-streams)")
    for flag, kind, what in (
            ("--autoscale-interval", float,
             "control-loop tick seconds (default 1)"),
            ("--autoscale-min-lanes", int,
             "never retire below this many lanes (default 1)"),
            ("--autoscale-max-lanes", int,
             "never spawn above this many lanes (default 0: the "
             "provider's capacity)"),
            ("--autoscale-up-pressure", float,
             "mean pressure above which a lane is spawned (default 0.75)"),
            ("--autoscale-down-pressure", float,
             "mean pressure below which a lane is retired (default 0.25)"),
            ("--autoscale-cooldown", float,
             "least seconds between actuated decisions (default 5)"),
            ("--autoscale-spawn-timeout", float,
             "a spawned lane not healthy within this many seconds is "
             "handed back and latches spawn-wedged (default 30)"),
            ("--autoscale-rebalance-band", float,
             "with --disagg, flip a lane's role when the prefill:decode "
             "pressure ratio leaves this band (> 1; default 0: off)")):
        p.add_argument(flag, type=kind, default=None, help=what)
    p.add_argument("--autoscale-slo-feed", action="store_true",
                   help="feed the worst SLO burn into the fleet pressure: "
                        "max(lane pressure, burn / 2) (needs --autoscale "
                        "and an --slo-* objective)")


def _apply_autoscale_flags(a, kw: dict) -> None:
    if a.autoscale:
        kw["autoscale"] = True
        # A retirement rides the live migration, never the replay.
        kw["migrate_streams"] = True
    for name, field in (
            ("autoscale_interval", "autoscale_interval_s"),
            ("autoscale_min_lanes", "autoscale_min_lanes"),
            ("autoscale_max_lanes", "autoscale_max_lanes"),
            ("autoscale_up_pressure", "autoscale_up_pressure"),
            ("autoscale_down_pressure", "autoscale_down_pressure"),
            ("autoscale_cooldown", "autoscale_cooldown_s"),
            ("autoscale_spawn_timeout", "autoscale_spawn_timeout_s"),
            ("autoscale_rebalance_band", "autoscale_rebalance_band")):
        if getattr(a, name) is not None:
            kw[field] = getattr(a, name)
    if a.autoscale_slo_feed:
        kw["autoscale_slo_feed"] = True


def gateway_args(argv):
    """(worker URLs, GatewayConfig, standby worker addresses) of a
    ``gateway`` command line."""
    from tpu_engine_torch.utils.config import GatewayConfig

    p = argparse.ArgumentParser(prog="gateway")
    p.add_argument("workers", nargs="+")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--breaker-timeout", type=float, default=30.0,
                   help="circuit-breaker OPEN -> HALF_OPEN seconds")
    p.add_argument("--drain-timeout", type=float, default=None,
                   help="graceful removal's drain acknowledgment bound in "
                        "seconds (default 10)")
    p.add_argument("--retry-budget", type=float, default=None,
                   help="cap failover retries at this fraction of recent "
                        "requests (default: unlimited)")
    p.add_argument("--failover-streams", action="store_true",
                   help="resume a stream whose lane fails mid-generation "
                        "on another ring lane (prompt + emitted tokens), "
                        "spliced into one stream")
    p.add_argument("--health-probe-interval", type=float, default=0.0,
                   help="probe every lane's /health at this interval and "
                        "eject a lane after 3 failed probes until one "
                        "succeeds (seconds; 0 = off)")
    p.add_argument("--overload-control", action="store_true",
                   help="priority-tiered gateway admission (the lowest "
                        "tier sheds first as --overload-max-inflight "
                        "fills) and a Retry-After growing with pressure")
    p.add_argument("--overload-max-inflight", type=int, default=None,
                   help="the in-flight gauge of tier admission (0 = none)")
    p.add_argument("--tenant-rate", type=float, default=None,
                   help="per-tenant token-bucket rate limit (requests/s; "
                        "0 = off)")
    p.add_argument("--trace-stitch", action="store_true",
                   help="cross-lane trace stitching: each stream's root "
                        "trace context rides every dispatch and the "
                        "stream ledger records its lanes, so GET "
                        "/admin/trace/<request_id> returns one tree")
    p.add_argument("--trace-ledger-capacity", type=int, default=None,
                   help="streams the stitch ledger remembers (default "
                        "512)")
    for flag, what in (("--slo-ttft-p99-ms", "time-to-first-token"),
                       ("--slo-itl-p99-ms", "inter-token latency"),
                       ("--slo-completion-p99-ms",
                        "gateway-scope completion")):
        p.add_argument(flag, type=float, default=None,
                       help=f"{what} objective in ms (0/unset = off)")
    p.add_argument("--slo-target", type=float, default=None,
                   help="good-sample fraction the objectives demand "
                        "(default 0.99)")
    p.add_argument("--slo-window-s", type=float, default=None,
                   help="burn-rate window in seconds (default 300)")
    p.add_argument("--migrate-streams", action="store_true",
                   help="live stream migration: a graceful removal "
                        "exports each in-flight stream's KV chain and "
                        "state and continues it on another lane with zero "
                        "re-prefilled tokens (the replay resume is the "
                        "fallback; implies the stream journal)")
    p.add_argument("--migrate-timeout", type=float, default=None,
                   help="per-stream migration budget in seconds, clamped "
                        "to the stream's deadline (default 30)")
    p.add_argument("--prefix-affinity", action="store_true",
                   help="route /generate(+/stream) on a block-aligned "
                        "prompt-prefix fingerprint instead of request_id "
                        "(ring order under ejection or imbalance)")
    p.add_argument("--affinity-block-size", type=int, default=None,
                   help="fingerprint block size; must match the workers' "
                        "--kv-block-size (default 16)")
    p.add_argument("--affinity-prefix-blocks", type=int, default=None,
                   help="leading blocks the fingerprint covers "
                        "(default 4)")
    p.add_argument("--affinity-max-imbalance", type=int, default=None,
                   help="skip the affinity lane once it has this many "
                        "more recent dispatches than its least-loaded "
                        "peer (0 = always honour affinity)")
    p.add_argument("--prefix-directory", action="store_true",
                   help="fleet prefix tier (gateway side): a bounded "
                        "fingerprint -> owner directory that stamps "
                        "generate requests with a prefix_hint for "
                        "--prefix-fetch lanes")
    p.add_argument("--prefix-dir-capacity", type=int, default=None,
                   help="directory LRU bound in entries (default 512)")
    p.add_argument("--disagg", action="store_true",
                   help="disaggregated prefill/decode serving: with "
                        "--role prefill lanes in the fleet, generate work "
                        "lands on a prefill lane and its finished KV "
                        "chain ships to a decode lane picked by load")
    p.add_argument("--handoff-timeout", type=float, default=None,
                   help="per-stream prefill -> decode handoff budget in "
                        "seconds, clamped to the deadline (default 30)")
    _add_autoscale_flags(p)
    p.add_argument("--standby-worker", action="append", default=None,
                   metavar="HOST:PORT",
                   help="a pre-launched worker the elastic fleet may bring "
                        "in (after a passing /health probe) and retire "
                        "(repeatable)")
    a = p.parse_args(argv)
    kw = {}
    if a.drain_timeout is not None:
        kw["drain_timeout_s"] = a.drain_timeout
    if a.retry_budget is not None:
        kw["retry_budget_ratio"] = a.retry_budget
    if a.failover_streams:
        kw["failover_streams"] = True
    if a.health_probe_interval:
        kw["health_probe_interval_s"] = a.health_probe_interval
    if a.overload_control:
        kw["overload_control"] = True
    if a.overload_max_inflight is not None:
        kw["overload_max_inflight"] = a.overload_max_inflight
    if a.tenant_rate is not None:
        kw["tenant_rate"] = a.tenant_rate
    if a.trace_stitch:
        kw["trace_stitch"] = True
    for flag in ("migrate_streams", "prefix_affinity", "prefix_directory",
                 "disagg"):
        if getattr(a, flag):
            kw[flag] = True
    _apply_autoscale_flags(a, kw)
    if a.migrate_timeout is not None:
        kw["migrate_timeout_s"] = a.migrate_timeout
    if a.prefix_dir_capacity is not None:
        kw["prefix_directory_capacity"] = a.prefix_dir_capacity
    if a.handoff_timeout is not None:
        kw["handoff_timeout_s"] = a.handoff_timeout
    for name in ("affinity_block_size", "affinity_prefix_blocks",
                 "affinity_max_imbalance", "trace_ledger_capacity",
                 "slo_ttft_p99_ms", "slo_itl_p99_ms",
                 "slo_completion_p99_ms", "slo_target", "slo_window_s"):
        if getattr(a, name) is not None:
            kw[name] = getattr(a, name)
    return a.workers, GatewayConfig(port=a.port,
                                    breaker_timeout_s=a.breaker_timeout,
                                    **kw), a.standby_worker


def _gateway(argv) -> int:
    if not argv:
        print("Usage: gateway <worker1_host:port> [worker2_host:port] ...")
        return 1
    from tpu_engine_torch.serving.app import serve_gateway

    workers, cfg, standby = gateway_args(argv)
    gateway, server = serve_gateway(workers, cfg, standby_workers=standby)
    print(f"Gateway listening on port {server.port}")
    print(f"Workers: {len(gateway.worker_names())}")
    print("Circuit breakers enabled")
    print("Ready!", flush=True)
    try:
        _wait_for_signal()
    finally:
        server.stop()
        gateway.stop()
    return 0


def serve_args(argv) -> dict:
    """The keyword arguments of ``app.serve_combined`` for a ``serve``
    command line, mapped as the JAX command maps them."""
    from tpu_engine_torch.utils.config import GatewayConfig, WorkerConfig

    p = argparse.ArgumentParser(prog="serve")
    p.add_argument("--model", default="resnet50",
                   help="registry name, or a,b for several (lanes "
                        "round-robin, requests routed by their model)")
    p.add_argument("--model-path", default=None,
                   help="checkpoint of real weights, loaded once and shared "
                        "(default: random weights from --seed)")
    p.add_argument("--lanes", type=int, default=0,
                   help="in-process lanes (default: one per card, or one "
                        "on --device)")
    p.add_argument("--mesh", default=None,
                   help="mesh-sharded serving: one lane whose engine spans "
                        "a mesh, e.g. data=2 or model=2,data=2 (batches "
                        "split over data, weights over model); its axes "
                        "multiply to the card count, or every rank sits "
                        "on --device")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--warmup", action="store_true",
                   help="run every batch bucket and a short generation on "
                        "each lane before listening")
    p.add_argument("--shape-buckets", default=None,
                   help="mixed-shape serving: comma-separated HxWxC list, "
                        "e.g. 320x320x3,640x640x3")
    p.add_argument("--batch-buckets", default=None,
                   help="comma-separated batch sizes, e.g. 1,8,32,128; the "
                        "batcher flushes at the largest")
    p.add_argument("--pipeline-depth", type=int, default=None)
    p.add_argument("--cache-capacity", type=int, default=None)
    p.add_argument("--batch-timeout-ms", type=float, default=None)
    p.add_argument("--breaker-timeout", type=float, default=None)
    p.add_argument("--default-deadline-ms", type=float, default=None,
                   help="deadline of requests without deadline_ms; an "
                        "expired one sheds 503 + Retry-After")
    p.add_argument("--retry-budget", type=float, default=None)
    p.add_argument("--retry-backoff-ms", type=float, default=None,
                   help="base exponential backoff between failover "
                        "attempts, with +/-50%% jitter (default 0: "
                        "immediate)")
    p.add_argument("--hedge", action="store_true",
                   help="hedged dispatch of /infer and /score")
    p.add_argument("--hedge-quantile", type=float, default=None)
    p.add_argument("--hedge-min-ms", type=float, default=None)
    p.add_argument("--max-queue-depth", type=int, default=None,
                   help="per-lane admission cap (0 = unbounded)")
    p.add_argument("--overload-control", action="store_true")
    p.add_argument("--overload-max-inflight", type=int, default=None)
    p.add_argument("--tenant-rate", type=float, default=None)
    p.add_argument("--tenant-burst", type=float, default=None)
    p.add_argument("--priority-admission", action="store_true")
    p.add_argument("--adaptive-depth", action="store_true")
    p.add_argument("--brownout", action="store_true")
    p.add_argument("--brownout-clamp-tokens", type=int, default=None)
    p.add_argument("--failover-streams", action="store_true")
    p.add_argument("--migrate-streams", action="store_true")
    p.add_argument("--migrate-timeout", type=float, default=None)
    p.add_argument("--drain-timeout", type=float, default=None)
    p.add_argument("--health-probe-interval", type=float, default=None)
    p.add_argument("--native-front", choices=["auto", "on", "off"],
                   default="auto",
                   help="the serving edge: the C++ front (auto: for one "
                        "model; on: required) or the Python front (off, "
                        "and always for several models; streams flush "
                        "incrementally only there, the C++ front sends a "
                        "stream as one body)")
    p.add_argument("--gen-scheduler",
                   choices=["batch", "continuous", "speculative"],
                   default="continuous")
    p.add_argument("--gen-draft-model", default=None)
    p.add_argument("--gen-draft-path", default=None)
    p.add_argument("--gen-spec-k", type=int, default=4)
    p.add_argument("--gen-decode-fused", action="store_true")
    p.add_argument("--no-unified-stateless", action="store_true")
    p.add_argument("--gen-prefill-chunk", type=int, default=256)
    p.add_argument("--gen-prefix-cache-mb", type=int, default=64)
    p.add_argument("--kv-block-size", type=int, default=0)
    p.add_argument("--kv-blocks", type=int, default=0)
    p.add_argument("--kv-host-blocks", type=int, default=0)
    p.add_argument("--kv-quantize", default="", choices=("", "int8"))
    p.add_argument("--state-rows", type=int, default=0)
    p.add_argument("--prefix-affinity", action="store_true")
    p.add_argument("--affinity-block-size", type=int, default=None)
    p.add_argument("--affinity-prefix-blocks", type=int, default=None)
    p.add_argument("--affinity-max-imbalance", type=int, default=None)
    p.add_argument("--prefix-sharing", choices=["on", "off"], default="on")
    p.add_argument("--prefix-fetch", action="store_true",
                   help="the fleet prefix tier, both halves: the gateway's "
                        "directory and the lanes' in-process fetch")
    p.add_argument("--prefix-fetch-timeout", type=float, default=None)
    p.add_argument("--mixed-step", action="store_true")
    p.add_argument("--mixed-token-budget", type=int, default=0)
    p.add_argument("--spec-k", type=int, default=0)
    p.add_argument("--spec-draft", choices=["ngram", "model"],
                   default="ngram")
    p.add_argument("--quantize", choices=["int8"], default=None)
    p.add_argument("--role", default="both",
                   choices=("prefill", "decode", "both"))
    p.add_argument("--lane-roles", default=None,
                   help="per-lane roles round-robin, e.g. "
                        "prefill,decode (pair with --disagg)")
    p.add_argument("--disagg", action="store_true")
    p.add_argument("--handoff-timeout", type=float, default=None)
    p.add_argument("--trace-stitch", action="store_true",
                   help="both halves: the gateway's stream ledger and the "
                        "lanes' snapshot trace headers")
    p.add_argument("--trace-ledger-capacity", type=int, default=None)
    for flag in ("--slo-ttft-p99-ms", "--slo-itl-p99-ms",
                 "--slo-completion-p99-ms", "--slo-target",
                 "--slo-window-s"):
        p.add_argument(flag, type=float, default=None)
    p.add_argument("--profile-dir", default=None)
    p.add_argument("--flight-recorder", type=int, default=None)
    p.add_argument("--flight-dump-dir", default=None)
    p.add_argument("--device", default=None,
                   help="cuda (default: every card) or cpu")
    p.add_argument("--dtype", default="bfloat16",
                   choices=("bfloat16", "float32"))
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random weights")
    p.add_argument("--scheduler-stall-s", type=float, default=None,
                   help="decode-loop liveness threshold of every lane "
                        "(0/unset = report the age only)")
    p.add_argument("--tp", type=int, default=None,
                   help="tensor-parallel serving (needs --kv-block-size): "
                        "every lane serves the model sharded over this "
                        "many ranks, lane i on cards [i*tp, (i+1)*tp) "
                        "(all on --device when given); the default lane "
                        "count becomes cards // tp")
    _add_autoscale_flags(p)
    a = p.parse_args(argv)
    gw = {}
    for name, field in (
            ("breaker_timeout", "breaker_timeout_s"),
            ("default_deadline_ms", "default_deadline_ms"),
            ("retry_budget", "retry_budget_ratio"),
            ("retry_backoff_ms", "retry_backoff_base_ms"),
            ("hedge_quantile", "hedge_quantile"),
            ("hedge_min_ms", "hedge_min_ms"),
            ("migrate_timeout", "migrate_timeout_s"),
            ("drain_timeout", "drain_timeout_s"),
            ("health_probe_interval", "health_probe_interval_s"),
            ("overload_max_inflight", "overload_max_inflight"),
            ("tenant_rate", "tenant_rate"),
            ("tenant_burst", "tenant_burst"),
            ("handoff_timeout", "handoff_timeout_s"),
            ("trace_ledger_capacity", "trace_ledger_capacity"),
            ("slo_ttft_p99_ms", "slo_ttft_p99_ms"),
            ("slo_itl_p99_ms", "slo_itl_p99_ms"),
            ("slo_completion_p99_ms", "slo_completion_p99_ms"),
            ("slo_target", "slo_target"),
            ("slo_window_s", "slo_window_s")):
        if getattr(a, name) is not None:
            gw[field] = getattr(a, name)
    for name, field in (("hedge", "hedge_enabled"),
                        ("failover_streams", "failover_streams"),
                        ("migrate_streams", "migrate_streams"),
                        ("overload_control", "overload_control"),
                        ("disagg", "disagg"),
                        ("trace_stitch", "trace_stitch")):
        if getattr(a, name):
            gw[field] = True
    if a.prefix_affinity:
        gw["prefix_affinity"] = True
        # The fingerprint's block defaults to the lanes' real block size.
        if a.affinity_block_size is not None:
            gw["affinity_block_size"] = a.affinity_block_size
        elif a.kv_block_size > 0:
            gw["affinity_block_size"] = a.kv_block_size
        if a.affinity_prefix_blocks is not None:
            gw["affinity_prefix_blocks"] = a.affinity_prefix_blocks
        if a.affinity_max_imbalance is not None:
            gw["affinity_max_imbalance"] = a.affinity_max_imbalance
    if a.prefix_fetch:
        gw["prefix_directory"] = True
        if "affinity_block_size" not in gw and a.kv_block_size > 0:
            gw["affinity_block_size"] = a.kv_block_size
    _apply_autoscale_flags(a, gw)
    wk = {}
    if a.shape_buckets:
        wk["shape_buckets"] = tuple(
            tuple(int(d) for d in sh.split("x"))
            for sh in a.shape_buckets.split(","))
    if a.batch_buckets:
        wk["batch_buckets"] = tuple(int(b)
                                    for b in a.batch_buckets.split(","))
        wk["max_batch_size"] = max(wk["batch_buckets"])
    for name, field in (("pipeline_depth", "pipeline_depth"),
                        ("cache_capacity", "cache_capacity"),
                        ("batch_timeout_ms", "batch_timeout_ms"),
                        ("max_queue_depth", "max_queue_depth"),
                        ("brownout_clamp_tokens", "brownout_clamp_tokens"),
                        ("prefix_fetch_timeout",
                         "gen_prefix_fetch_timeout_s"),
                        ("profile_dir", "profile_dir"),
                        ("flight_recorder", "flight_recorder"),
                        ("flight_dump_dir", "flight_dump_dir"),
                        ("scheduler_stall_s", "scheduler_stall_s"),
                        ("tp", "tp")):
        if getattr(a, name) is not None:
            wk[field] = getattr(a, name)
    for name, field in (("priority_admission", "priority_admission"),
                        ("adaptive_depth", "adaptive_depth"),
                        ("brownout", "brownout"),
                        ("trace_stitch", "trace_stitch"),
                        ("prefix_fetch", "gen_prefix_fetch")):
        if getattr(a, name):
            wk[field] = True
    if a.no_unified_stateless:
        wk["unified_stateless"] = False
    worker_config = WorkerConfig(
        **wk, gen_scheduler=a.gen_scheduler,
        gen_draft_model=a.gen_draft_model, gen_draft_path=a.gen_draft_path,
        gen_spec_k=a.gen_spec_k, gen_prefix_cache_mb=a.gen_prefix_cache_mb,
        gen_prefill_chunk=a.gen_prefill_chunk,
        gen_kv_block_size=a.kv_block_size, gen_kv_blocks=a.kv_blocks,
        gen_kv_host_blocks=a.kv_host_blocks, gen_kv_quantize=a.kv_quantize,
        gen_prefix_sharing=a.prefix_sharing == "on",
        gen_mixed_step=a.mixed_step,
        gen_mixed_token_budget=a.mixed_token_budget,
        gen_continuous_spec_k=a.spec_k, gen_state_rows=a.state_rows,
        gen_spec_draft=a.spec_draft, gen_decode_fused=a.gen_decode_fused,
        quantize=a.quantize, role=a.role, model_path=a.model_path,
        dtype=a.dtype, device=a.device, seed=a.seed)
    lane_roles = None
    if a.lane_roles:
        lane_roles = [r.strip() for r in a.lane_roles.split(",")
                      if r.strip()]
    return {"model": a.model, "lanes": a.lanes, "port": a.port,
            "warmup": a.warmup, "worker_config": worker_config,
            "gateway_config": (GatewayConfig(port=a.port, **gw)
                               if gw else None),
            "native_front": {"auto": None, "on": True,
                             "off": False}[a.native_front],
            "lane_roles": lane_roles, "mesh": a.mesh}


def _serve_combined(argv) -> int:
    """The ``serve`` command: the combined server until SIGTERM or
    SIGINT, then the front, the gateway and every lane stop."""
    from tpu_engine_torch.serving.app import serve_combined, stop_combined
    from tpu_engine_torch.serving.http import JsonHttpServer

    kw = serve_args(argv)
    gateway, workers, server = serve_combined(**kw)
    kind = ("python front" if isinstance(server, JsonHttpServer)
            else "native C++ front")
    print(f"tpu_engine_torch combined serving: {len(workers)} lanes "
          f"({', '.join(sorted({str(w.engine.device) for w in workers}))})"
          f", port {server.port} ({kind})", flush=True)
    try:
        _wait_for_signal()
    finally:
        stop_combined(gateway, workers, server)
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
        gather_train_state,
        make_mesh_train_step,
        make_train_step,
        replicated_tree,
        shard_params_tp,
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
                   help="e.g. data=2,model=2: params split over model, "
                        "the batch over data; the axis sizes multiply to "
                        "the card count, or every rank sits on --device")
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
    spec = create_model(args.model)
    cfg = spec.config
    if not isinstance(cfg, TransformerConfig) or not cfg.causal:
        print(f"'{args.model}' is not a causal-LM transformer")
        return 2
    mesh = None
    if args.mesh:
        from tpu_engine_torch.serving.app import parse_mesh_spec

        mesh = parse_mesh_spec(args.mesh, device=args.device)
    dev = mesh.home if mesh is not None else resolve_device(args.device)
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
    if mesh is not None:
        # The whole state, optimizer moments included, or a resumed mesh
        # run would train on whole copies.
        place_state, train_step = make_mesh_train_step(
            apply_fn, mesh, loss_fn=cross_entropy_loss, dtype=torch.float32)
        state = place_state(state, (
            shard_params_tp(state.params, mesh, "model")
            if "model" in mesh.shape
            else replicated_tree(state.params, mesh)))
    if args.resume:
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
        if mesh is not None:
            state = gather_train_state(state)
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
    if argv and argv[0] == "worker_node":
        return _worker_node(argv[1:])
    if argv and argv[0] == "gateway":
        return _gateway(argv[1:])
    if argv and argv[0] == "serve":
        return _serve_combined(argv[1:])
    if argv and argv[0] == "train":
        return train(argv[1:])
    if argv and argv[0] == "import-weights":
        return import_weights(argv[1:])
    print(__doc__)
    return 2


if __name__ == "__main__":
    sys.exit(main())

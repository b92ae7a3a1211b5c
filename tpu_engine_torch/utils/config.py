"""Worker and gateway configuration: the fields of ``tpu_engine``'s
``WorkerConfig`` and ``GatewayConfig`` that the port uses, with the same
names and defaults (``model`` defaults to ``"resnet50"``, the one-shot
/infer lane a default launch serves), plus the worker's own ``device`` and
``seed``."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass
class WorkerConfig:
    port: int = 8001
    node_id: str = "worker_1"
    model: str = "resnet50"             # registry name (models.registry)
    # A reference-style model path: an existing .onnx file is served as
    # its graph (models.onnx_graph); an HF checkpoint (file or directory)
    # or a checkpoint of the port's own format loads its weights; a path
    # to nothing only names the model (registry.model_from_path).
    model_path: Optional[str] = None
    # The /infer lane: result cache, dynamic batcher, engine buckets.
    cache_capacity: int = 1000
    max_batch_size: int = 32
    batch_timeout_ms: float = 20.0
    batch_linger_ms: float = 0.0        # accumulation window (0 = off)
    dtype: str = "bfloat16"
    # Weight-only quantization ("int8" | None): dense/conv kernels and MoE
    # expert stacks stored int8 with per-output-channel f32 scales
    # (ops.quant). The engine quantizes; the generation lanes share its
    # params. Set in code (the JAX package's serve --quantize).
    quantize: Optional[str] = None
    batch_buckets: Tuple[int, ...] = (1, 2, 4, 8, 16, 32)
    # Mixed-shape serving: per-sample input shapes of the engine's shape
    # buckets; requests carry "shape": [h, w, c]. Set in code (the JAX
    # package's serve --shape-buckets; the port has no serve command).
    shape_buckets: Optional[Tuple[Tuple[int, ...], ...]] = None
    fake_cached_latency_us: int = 50    # inference_time_us of a cache hit
    # Dispatched /infer batches in flight before the batcher collects the
    # oldest (engine batch_submit / batch_collect); 1 = lockstep.
    pipeline_depth: int = 4
    # Admitted requests in flight before the lane sheds 503 "overloaded"
    # (0 = unbounded).
    max_queue_depth: int = 0
    # Overload control (serving.overload), all off by default.
    # Priority-tiered admission (--priority-admission): requests may carry
    # "priority": interactive | batch | background; each tier admits only
    # up to its fraction of the limit (70%, 85%, 100%).
    priority_admission: bool = False
    # AIMD adaptive concurrency (--adaptive-depth): a latency-driven limit
    # replaces max_queue_depth (starting from it), at most this.
    adaptive_depth: bool = False
    adaptive_depth_max: int = 64
    # Staged brownout (--brownout): every brownout_interval_s a control
    # loop reads the lane's saturation signals and walks the degradation
    # ladder (budget shrink, spec off, swap-in deferral, low-tier clamp)
    # before any shed; brownout_clamp_tokens is the clamp stage's
    # max_new_tokens ceiling below the top tier.
    brownout: bool = False
    brownout_interval_s: float = 0.25
    brownout_clamp_tokens: int = 32
    # Disaggregated serving role (--role): "prefill" | "decode" | "both".
    # Advisory for the gateway's role-aware routing; a lane of any role
    # serves whatever it receives. Flippable at runtime (/admin/role).
    role: str = "both"
    gen_max_batch_size: int = 8         # decode rows (scheduler slots)
    gen_step_chunk: int = 16            # two-path decode steps per chunk
    gen_prefill_chunk: int = 256
    gen_prefix_cache_mb: int = 64       # dense lane's prompt prefix cache
    gen_kv_block_size: int = 0          # 0: dense KV cache; > 0: paged
    gen_kv_blocks: int = 0              # 0 = auto (dense-equivalent)
    gen_kv_quantize: str = ""           # "int8": quantized block pool
    # The fleet prefix tier (--prefix-fetch; needs the paged cache with
    # prefix sharing): a miss whose request carries the gateway's
    # prefix_hint pulls the owner lane's radix chain over
    # /admin/export_prefix instead of prefilling it; every failure
    # prefills locally. gen_prefix_fetch_timeout_s bounds one fetch,
    # gen_prefix_fetch_inflight the fetches in flight (excess misses
    # prefill locally).
    gen_prefix_fetch: bool = False
    gen_prefix_fetch_timeout_s: float = 5.0
    gen_prefix_fetch_inflight: int = 2
    # Host blocks under the paged pool for demoted radix prefixes (needs
    # the paged cache and prefix sharing; --kv-host-blocks), 0 = off.
    gen_kv_host_blocks: int = 0
    gen_prefix_sharing: bool = True
    gen_mixed_step: bool = False        # paged or slab; False: two-path
    gen_mixed_token_budget: int = 0     # 0 = auto (gen_prefill_chunk)
    # State slab rows of a state_slab-family model (mamba2; --state-rows):
    # one fixed-size f32 row per live stream, constant in sequence length.
    # 0 = auto (gen_max_batch_size + the null row). Refused on other
    # families.
    gen_state_rows: int = 0
    # "batch": collect a batch, decode it to completion
    # (runtime.generator). "continuous": iteration-level scheduling,
    # requests join and leave the running decode batch between ticks
    # (runtime.scheduler); the default. "speculative": batch-mode lane
    # where a DRAFT model proposes gen_spec_k tokens per round and the
    # target verifies them in one windowed pass (runtime.speculative);
    # temperature sampling only.
    gen_scheduler: str = "continuous"
    # Continuous speculation (paged only, either mode): proposals per
    # decode row per tick, 0 = off (--spec-k); the drafter, "ngram" or
    # "model" (--spec-draft).
    gen_continuous_spec_k: int = 0
    gen_spec_draft: str = "ngram"
    # Draft model for the speculative scheduler and the continuous model
    # drafter. None = auto by target (gpt2 -> distilgpt2); set explicitly
    # for other families.
    gen_draft_model: Optional[str] = None
    gen_draft_path: Optional[str] = None  # draft weights checkpoint
    gen_spec_k: int = 4                 # speculation depth (draft tokens/round)
    # Batch scheduler only: keep each group's tokens on the card until its
    # decode ends (the host reads the all-done flag once per
    # gen_step_chunk steps; identical streams). The port's Generator runs
    # that one loop for both values.
    gen_decode_fused: bool = False
    # One-shot /infer and /score requests ride the continuous scheduler as
    # single-tick rows; False serves them through the dedicated batch lane
    # (runtime.batch_processor) instead (--no-unified-stateless).
    unified_stateless: bool = True
    # Observability (utils.tracing), as in the JAX worker. Spans kept in
    # the lane's ring (--trace-capacity); 0 records no span and renders
    # no stage histogram.
    trace_capacity: int = 2048
    # Cross-lane trace stitching (--trace-stitch): an export snapshot
    # carries the stream's traceparent and its KV chain a "trace" header,
    # so the importing lane's spans join the same trace. Off: snapshot
    # and chain bytes unchanged.
    trace_stitch: bool = False
    # Directory of /admin/profile's torch.profiler captures
    # (--profile-dir); None: the endpoint answers unconfigured.
    profile_dir: Optional[str] = None
    # The scheduler's per-tick flight recorder (--flight-recorder): ring
    # length in ticks, 0 = off; anomaly dumps go to flight_dump_dir
    # (--flight-dump-dir; None keeps them in memory).
    flight_recorder: int = 0
    flight_dump_dir: Optional[str] = None
    # The decode loop's stall watchdog (--scheduler-stall-s): with a
    # threshold > 0, a continuous lane whose loop has not ticked for this
    # many seconds answers /health unhealthy (scheduler_stalled), so the
    # gateway's prober ejects it. 0 reports the tick age only. Set it
    # above the longest first-use kernel build.
    scheduler_stall_s: float = 0.0
    # Tensor-parallel serving (--tp): the continuous scheduler serves one
    # model sharded over this many ranks (the registry's rule; the paged
    # pool shards its H_kv axis). Needs the paged cache; unshardable
    # families refuse at startup. 1 = one device.
    tp: int = 1
    # First CUDA device of this lane's tp ranks (serve gives lane i offset
    # i * tp, so in-process tp lanes own disjoint cards); with ``device``
    # named, every rank sits on that device instead.
    tp_device_offset: int = 0
    # The port's own: where the lane runs (None = the CUDA card) and the
    # seed of its random weights.
    device: Optional[str] = None
    seed: int = 0


@dataclass
class GatewayConfig:
    port: int = 8000
    virtual_nodes: int = 150
    failure_threshold: int = 5
    success_threshold: int = 2
    breaker_timeout_s: float = 30.0
    worker_timeout_s: float = 5.0
    gen_timeout_s: float = 120.0        # /generate, /score, streams
    default_worker_port: int = 8080
    # A deadline for requests that carry no "deadline_ms" (None: none);
    # an expired request sheds 503 with Retry-After at admission, and
    # expiry mid-route ends the failover march.
    default_deadline_ms: Optional[float] = None
    # The Retry-After (seconds) of a gateway shed; with overload control
    # the base that the measured pressure scales.
    shed_retry_after_s: float = 1.0
    # Backoff before each failover attempt (serving.resilience
    # backoff_delay): min(base * 2^attempt, max), spread by +/- jitter.
    # base 0: immediate ring-order failover.
    retry_backoff_base_ms: float = 0.0
    retry_backoff_max_ms: float = 1000.0
    retry_jitter: float = 0.5
    # The retry budget: retries allowed while retries <= ratio * requests
    # + min over the window; None = unlimited (the breaker-only routing
    # and /stats schema).
    retry_budget_ratio: Optional[float] = None
    retry_budget_min: int = 10
    retry_budget_window_s: float = 10.0
    # How long remove_worker(drain=True) waits for a lane to acknowledge
    # its drain before counting the failure and removing it anyway.
    drain_timeout_s: float = 10.0
    # Hedged dispatch of /infer and /score: once the primary lane exceeds
    # the best other lane's hedge_quantile latency (at least hedge_min_ms;
    # hedge_min_ms alone before hedge_min_samples samples), the next ring
    # lane is dispatched too and the first answer wins.
    hedge_enabled: bool = False
    hedge_quantile: float = 0.95
    hedge_min_ms: float = 50.0
    hedge_min_samples: int = 20
    # Crash-tolerant streaming (--failover-streams): a retryable
    # mid-stream failure resumes the stream on another ring lane (prompt
    # + emitted tokens, the budget offset), at most failover_max_resumes
    # times.
    failover_streams: bool = False
    failover_max_resumes: int = 3
    # The health prober (--health-probe-interval, 0 = off): every lane's
    # /health each interval; health_probe_failures consecutive failures
    # eject a lane from dispatch, the next success restores it.
    health_probe_interval_s: float = 0.0
    health_probe_failures: int = 3
    # Gateway overload control (--overload-control): priority-tiered
    # admission against an in-flight gauge of overload_max_inflight (0 =
    # no gauge: the priority is validated only) and a load-derived
    # Retry-After. The per-tenant token bucket (--tenant-rate, 0 = off):
    # tenant_rate requests/s, tenant_burst deep (0 = 2x the rate).
    overload_control: bool = False
    overload_max_inflight: int = 0
    tenant_rate: float = 0.0
    tenant_burst: float = 0.0
    # The gateway's own span ring (route, attempt and decision spans);
    # 0 records nothing.
    trace_capacity: int = 2048
    # Cross-lane trace stitching (--trace-stitch): a stream's dispatches
    # carry its root traceparent and the stream ledger records which lanes
    # served it (admit and resume hops, trace_ledger_capacity streams), so
    # /admin/trace/<rid> merges every lane's fragments into one tree.
    trace_stitch: bool = False
    trace_ledger_capacity: int = 512
    # SLO objectives in ms, 0 = not set (--slo-ttft-p99-ms,
    # --slo-itl-p99-ms, --slo-completion-p99-ms): burn rates over the
    # latency histograms at /admin/slo, in /stats and /metrics, with
    # slo_target the good-sample fraction and slo_window_s the window.
    slo_ttft_p99_ms: float = 0.0
    slo_itl_p99_ms: float = 0.0
    slo_completion_p99_ms: float = 0.0
    slo_target: float = 0.99
    slo_window_s: float = 300.0
    # Live stream migration (--migrate-streams): remove_worker(drain=True)
    # exports each journaled stream off the draining lane and continues it
    # on another with zero re-prefilled tokens (the replay resume is the
    # fallback; implies the stream journal). migrate_timeout_s bounds one
    # stream's transfer, clamped to its deadline.
    migrate_streams: bool = False
    migrate_timeout_s: float = 30.0
    # Disaggregated prefill/decode serving (--disagg): while the fleet
    # has a "prefill" lane and a decode-capable one beside it, a
    # /generate(/stream) lands on a prefill lane, parks after prefill, and
    # its KV chain ships to the decode lane with the fewest journaled
    # streams. handoff_timeout_s bounds one handoff and the source row's
    # park window.
    disagg: bool = False
    handoff_timeout_s: float = 30.0
    # Prefix-affinity routing (--prefix-affinity): generate requests route
    # on a fingerprint of the prompt's leading full blocks
    # (affinity_block_size tokens, at most affinity_prefix_blocks
    # blocks), so shared prefixes converge on one lane; ring order when
    # there is no full block, the lane is ejected or broken, or it is
    # affinity_max_imbalance dispatches hotter than its least-loaded peer
    # within affinity_window_s (0 = never).
    prefix_affinity: bool = False
    affinity_block_size: int = 16
    affinity_prefix_blocks: int = 4
    affinity_max_imbalance: int = 0
    # The fleet prefix directory (--prefix-directory): a bounded
    # (prefix_directory_capacity fingerprints, LRU) fingerprint -> owner
    # lane map, seeded from the lanes' /health summaries and completions;
    # a generate request whose owner is another lane carries a
    # prefix_hint.
    prefix_directory: bool = False
    prefix_directory_capacity: int = 512
    affinity_window_s: float = 10.0

    # The elastic fleet (--autoscale; serving.autoscaler): a control loop
    # every autoscale_interval_s reads each lane's pressure and spawns a
    # lane above autoscale_up_pressure or retires one below
    # autoscale_down_pressure (through the drain and live migration),
    # within [autoscale_min_lanes, autoscale_max_lanes] (0 = no upper
    # clamp) and at most once per autoscale_cooldown_s. A spawned lane
    # joins only after a passing /health probe within
    # autoscale_spawn_timeout_s. autoscale_rebalance_band (> 1, with
    # disagg) flips a lane's role when the prefill:decode pressure ratio
    # leaves the band. Off: no controller thread and no /stats "fleet"
    # block; /admin/fleet works either way.
    autoscale: bool = False
    autoscale_interval_s: float = 1.0
    autoscale_min_lanes: int = 1
    autoscale_max_lanes: int = 0
    autoscale_up_pressure: float = 0.75
    autoscale_down_pressure: float = 0.25
    autoscale_cooldown_s: float = 5.0
    autoscale_spawn_timeout_s: float = 30.0
    autoscale_rebalance_band: float = 0.0
    # Feed the worst SLO burn into the fleet pressure
    # (--autoscale-slo-feed): max(lane pressure, min(1, burn / 2)).
    autoscale_slo_feed: bool = False

"""The port's worker lane (counterpart of ``tpu_engine/serving/worker.py``):
one engine and one generation lane behind ``/infer``, ``/score``,
``/generate``, ``/generate/stream`` and ``/health``, with the JAX worker's
wire fields, and the admission plane in front of them.

Lanes. A decoder model (the gpt2 and llama families) gets the continuous
scheduler (``gen_scheduler="continuous"``, the default): dense, the
default lane, or paged (mixed stepping or two-path, bf16/f32 or int8
pool, with continuous speculation under ``gen_continuous_spec_k`` and a
host KV tier under ``gen_kv_host_blocks``; its model drafter loads
``gen_draft_path``). ``gen_scheduler="batch"`` serves it through the batch
``Generator`` behind a batcher of its own (``gen_max_batch_size`` rows a
group, decoded to completion; ``gen_decode_fused`` takes the same loop),
which also serves ``beam_width`` 2-8 (``MAX_BEAM_WIDTH``; each beam
request alone) and ``/score``; ``"speculative"`` through the batch
``SpeculativeGenerator`` (``gen_spec_k``, the draft ``gen_draft_model``
with ``gen_draft_path``'s weights, or a random draft with the JAX
warning; temperature sampling only: top_p, top_k, min_p and a penalty are
400s before they join a batch). On both batch lanes a stream is one
``tokens`` event and the ``done`` event, unified stateless serving is
off (``/infer`` and ``/score`` keep their batchers), the continuous
scheduler's knobs and a dedicated role refuse with the JAX worker's
messages, and the ``/admin`` routes of the continuous scheduler answer
JAX's "no continuous scheduler" bodies. A recurrent decoder (``mamba2``,
``ssd-small-test``: the state_slab family) gets the continuous scheduler
over a slab of fixed-size state rows (``gen_state_rows``), two-path or
mixed, with migration and the handoff; it refuses the KV knobs and
speculation, and every other family refuses ``gen_state_rows``, with the
JAX worker's messages. A stateless model (``mlp``, ``resnet50``,
``resnet50-v1``, the ``bert`` encoder, ``yolov8n``, an ONNX graph; the
default ``resnet50``) serves only /infer: with ``unified_stateless`` on
(the default) its scheduler's rows are all one-shot (``n_slots =
max_batch_size``, no prefix cache).

The model comes from ``model`` (a registry name, seeded random weights)
or ``model_path``: an existing ``.onnx`` file serves its graph
(``models.onnx_graph``; ``quantize`` refuses any ``.onnx`` path with the
JAX worker's message, whose worker opens every such path as a graph);
an HF checkpoint (a ``config.json``/``model.safetensors``/
``pytorch_model.bin`` directory, sharded or not, or a ``.safetensors``,
``.bin``, ``.pt`` or ``.pth`` file) loads its weights into ``model``
through ``models.import_weights.load_pretrained`` (an HF directory's
``config.json`` sets the geometry); a directory of the port's own format
(``utils.checkpoint``, the train command's ``<out>/params``) loads as
saved; any other directory (an orbax checkpoint of the JAX package)
refuses by name. ``shape_buckets`` turns on the engine's mixed-shape
serving. ``reload_weights`` (``/admin/reload``) swaps in a checkpoint's
weights of the served architecture: the engine and then the scheduler
serve them from their next dispatch, the result cache is cleared, and a
result computed under the old weights never enters it. With
``unified_stateless`` on, /infer misses and /score requests ride the
scheduler as single-tick rows; with it off, /infer goes through the
dynamic batcher (``runtime.batch_processor``) and /score through a batcher
of its own.

/infer: ``{request_id, input_data, shape?, model?, deadline_ms?}`` ->
``{request_id, output_data, node_id, cached, inference_time_us}``. The
result cache (an LRU of ``cache_capacity`` entries) is keyed by the input's
float32 bytes (and its shape when given); a hit answers ``cached: true``
with ``inference_time_us = fake_cached_latency_us``. Concurrent identical
misses coalesce: one leader dispatches, followers wait for its result (a
leader's ``DeadlineExceeded`` retires the entry and each follower retries
on its own budget; any other error reaches the followers unchanged). The
cached value is the response's pre-encoded ``output_data`` fragment
(``_encode_output``: the JAX worker's native encoder's bytes).

/score: ``{request_id, prompt_tokens, completion_tokens}`` ->
``{request_id, logprobs, total_logprob, node_id, score_time_us}`` on
decoder lanes; an empty completion and a row longer than the largest
sequence bucket are 400s.

/generate: ``{request_id, prompt_tokens, max_new_tokens?, eos_id?,
temperature?, seed?, top_p?, top_k?, repetition_penalty?, stop_tokens?,
min_p?, deadline_ms?, model?}`` -> ``{request_id, tokens, node_id,
generate_time_us}``; ``/generate/stream`` sends ``{"tokens": [...]}``
events, then a terminal ``{"done": true, ...}`` event with the blocking
endpoint's fields, or with ``error``, ``retryable`` and ``tokens_emitted``.
A stateless lane refuses /generate with the JAX worker's 400.

Live-row migration: ``/admin/migrate {request_id, timeout_s?}`` exports a
stream's row (its stream ends with a retryable ``migrated`` terminal
event) and answers the snapshot, or ``{ok: false, reason}``; a
``/generate/stream`` body carrying that snapshot as ``migrate_import``
continues the row on this lane with no prefill (``import_refused`` marks a
terminal event of an import the lane refused).

Disaggregated serving: ``role`` ("prefill", "decode" or "both"; a
dedicated role needs the paged cache or the slab) is advisory routing
metadata, shown in ``/health`` when not "both" and flipped at runtime by
``set_role`` (``/admin/role``); a lane of any role serves whatever it
receives. A
gateway-stamped ``/generate/stream`` with ``handoff: true`` parks its row
after prefill for up to ``handoff_park_ms`` (clamped to [0.1, 120] s)
awaiting ``/admin/migrate {request_id, wait_prefill: true}``, which
exports it at the first tick past its prefill; ``cancel: true`` releases
the hold instead.

The fleet prefix tier (``gen_prefix_fetch``): ``/admin/export_prefix
{tokens, max_blocks?}`` serves a peer the longest radix chain of a token
prefix (a draining lane refuses by name), ``/health`` carries the radix
tree's deepest chains as ``prefix_fingerprints``, and a generate request
carrying the gateway's ``prefix_hint`` fetches the hinted peer's chain
before prefilling a local miss (``_fetch_prefix_peer``: at most
``gen_prefix_fetch_inflight`` fetches in flight, each bounded by
``gen_prefix_fetch_timeout_s``; every failure prefills locally). With
the flag off the hint is ignored and ``/health`` is unchanged.

As in the JAX worker, a ``model`` other than the lane's is a 400; a
negative or NaN ``deadline_ms`` is a 400; a row whose deadline passes
mid-generation is cancelled between ticks. Misconfigured lanes refuse at
startup with the JAX worker's messages.

Admission (``serving.resilience.AdmissionController``): every request is
admitted before it counts in ``total_requests`` and released when it ends
(a stream when its event iterator ends or is closed). A draining lane, one
at ``max_queue_depth`` and an /infer miss whose budget is below the lane's
service-time estimate (an EWMA of the misses' ``inference_time_us``) are
503 ``overloaded``; a deadline already passed is 503
``deadline_exceeded``; both carry ``Retry-After``. ``drain()`` and
``undrain()`` answer named statuses.

Faults (the combined server's ``/admin/fault``): ``inject_fault`` fails
every request with a lane fault until ``heal`` (``/health`` reads
``healthy: false``), ``inject_latency`` sleeps each admitted request
without failing it. ``on_fault_change`` listeners hear a fault, a heal,
a drain and an undrain (``healthy`` False while the lane is faulted or
draining): the native front stops and resumes the lane's C++ hits by
them. ``external_counters`` (requests, hits) served outside this Python
path (the C++ hits) are summed into ``/health``. The result cache is the
``cache`` the constructor is given (the front's lanes: a raw-mode native
one) or an ``LRUCache``; both hold the same bytes under the same keys.

Overload control (``serving.overload``, each off by default):
``priority_admission`` reads a request's ``priority`` (interactive,
batch, background; an unknown value is a 400) and admits each tier only
up to its fraction of the limit; ``adaptive_depth`` replaces
``max_queue_depth`` by an AIMD limit fed the admit-to-finish time of
every completed request (streams included); ``brownout`` runs a control
loop every ``brownout_interval_s`` over the lane's saturation signals
(admitted depth against the limit, the decode loop's tick age, parked
admissions and pool starvation, deadline misses) that walks the
degradation ladder: the scheduler's budget shrink, spec suspension and
swap-in deferral (``ContinuousGenerator.set_brownout``), then the
``brownout_clamp_tokens`` cap on a below-top-tier request's
``max_new_tokens``. With a feature on, ``/health``'s ``admission`` block
splits ``shed_overloaded`` by cause (``shed_depth``, ``shed_tier``,
``shed_adaptive``, and the limiter's ``adaptive`` block), and with
brownout on ``/health`` carries the ``brownout`` block.

Observability, as in the JAX worker: every request records a root span
(``infer``, ``score``, ``generate``, ``generate_stream``; parented under a
``traceparent`` field when the request carries one, else under the trace
id derived from its request_id) with stage children: ``admission``,
``cache_lookup``, ``coalesced_wait``, ``serialize``, ``queue_wait``,
``batch_form`` and ``device_compute`` on /infer, and the scheduler's
stages on /score and the generation paths. A brownout stage change
records an ``overload`` marker. The ring holds ``trace_capacity`` spans
(0 records none); ``latency_histograms`` exposes the scheduler's TTFT and
ITL histograms, ``handle_timeline`` its flight recorder
(``flight_recorder`` ticks) and ``handle_profile`` a torch.profiler
capture bounded in scheduler ticks (needs ``profile_dir``). Span times are
host walls: ``device_compute`` runs from the dispatch's submit to its
collect; device time comes from the profile.

``/health`` has the JAX lane's keys: ``cache_hits``, ``cache_size`` and
``cache_hit_rate`` of the result cache, the batcher's four-key
``batch_processor`` block (on a stateless lane the scheduler's one-shot
dispatch counters fold into it, and no ``generator`` key appears), on
decoder lanes the scheduler's stats under ``generator`` (with the pool's
``host`` block on a lane with ``gen_kv_host_blocks``, and ``migration``
once the lane exported or imported a row), and once
admission has anything to report (a bound, a drain, a shed, a row
dropped at its deadline or an overload feature) the ``admission`` block.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import queue
import socket
import threading
import time
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from tpu_engine_torch.core.lru_cache import LRUCache
from tpu_engine_torch.models.registry import ModelSpec, create_model
from tpu_engine_torch.runtime.batch_processor import BatchProcessor
from tpu_engine_torch.runtime.engine import InferenceEngine
from tpu_engine_torch.runtime.generator import Generator
from tpu_engine_torch.runtime.scheduler import ContinuousGenerator
from tpu_engine_torch.runtime.speculative import SpeculativeGenerator
from tpu_engine_torch.serving.clients import HttpWorkerClient
from tpu_engine_torch.serving.http import sse_event
from tpu_engine_torch.serving.overload import (
    AIMDLimit,
    BROWNOUT_BUDGET_FRAC,
    BROWNOUT_STAGES,
    TIER_ADMIT_FRAC,
    TOP_TIER,
    BrownoutController,
    parse_priority,
)
from tpu_engine_torch.serving.resilience import AdmissionController
from tpu_engine_torch.utils import tracing
from tpu_engine_torch.utils.config import WorkerConfig
from tpu_engine_torch.utils.deadline import (
    Deadline,
    DeadlineExceeded,
    ShedError,
    clamp_timeout,
)
from tpu_engine_torch.utils.sampling import (
    clamp_top_k,
    expand_stopping_params,
    validate_min_p,
)
from tpu_engine_torch.utils.tracing import SpanRecorder, TraceContext, TraceSink


@dataclass
class _BatchItem:
    request_id: str
    input_data: Sequence[float]
    shape: Optional[tuple] = None
    # The request's worker-root span context: the batch lane's stage
    # spans parent here.
    trace: Optional[TraceContext] = None


@dataclass
class _BatchResult:
    output_data: np.ndarray
    inference_time_us: int


@dataclass
class _ScoreItem:
    request_id: str
    prompt: List[int]
    completion: List[int]


@dataclass
class _GenItem:
    """One /generate request, validated (a batch lane's batcher takes it
    as it is; the continuous scheduler takes its fields)."""
    request_id: str
    prompt: List[int]
    max_new_tokens: int
    eos_id: int
    temperature: float
    seed: int
    top_p: float = 1.0
    top_k: int = 0
    repetition_penalty: float = 1.0
    stop_tokens: tuple = ()
    beam_width: int = 1
    length_penalty: float = 1.0
    min_p: float = 0.0
    # The request's worker-root span context (its stage spans).
    trace: Optional[TraceContext] = None


@dataclass
class _GenResult:
    tokens: List[int]
    generate_time_us: int


class _RootSpan:
    """A worker-root span while its request runs: its context (stage
    children parent here) and the cached flag and attrs the request path
    fills in before the span records."""

    __slots__ = ("ctx", "request_id", "attrs", "cached")

    def __init__(self, ctx: TraceContext, request_id: str):
        self.ctx = ctx
        self.request_id = request_id
        self.attrs = {"outcome": "error"}
        self.cached = False


class _AdmittedStream:
    """The SSE events of an admitted stream. Its admission slot is held
    until the events end or fail, or the iterator is closed (the client
    went away), whether or not iteration had started; it is released
    once. ``release(completed)`` is told whether the stream ran to its
    ``done`` event."""

    def __init__(self, events, release):
        self._events = events
        self._release = release
        self._lock = threading.Lock()
        self.completed = False

    def __iter__(self):
        return self

    def __next__(self) -> bytes:
        try:
            return next(self._events)
        except BaseException:
            self.close()
            raise

    def close(self) -> None:
        with self._lock:
            release, self._release = self._release, None
        self._events.close()
        if release is not None:
            release(self.completed)


class _Inflight:
    """One in-flight computation shared by concurrent identical misses."""

    __slots__ = ("event", "frag", "time_us", "error")

    def __init__(self):
        self.event = threading.Event()
        self.frag: Optional[bytes] = None
        self.time_us = 0
        self.error: Optional[BaseException] = None


def _format_f32(v: float) -> str:
    if v != v:
        return "NaN"
    if v in (float("inf"), float("-inf")):
        return "Infinity" if v > 0 else "-Infinity"
    return "%.6g" % v


def _encode_output(arr) -> bytes:
    """The ``output_data`` JSON fragment of a float array: ``[a,b,...]``
    with six significant digits (``%.6g``, locale-free), ``NaN``,
    ``Infinity`` and ``-Infinity``: the bytes of the JAX worker's native
    encoder (``tpu_json_encode_f32``)."""
    a = np.ascontiguousarray(arr, dtype=np.float32).ravel()
    vals = a.astype(np.float64).tolist()
    fmt = "%.6g".__mod__ if bool(np.isfinite(a).all()) else _format_f32
    return ("[" + ",".join(map(fmt, vals)) + "]").encode()


_HF_FILES = ("config.json", "model.safetensors", "pytorch_model.bin",
             "model.safetensors.index.json", "pytorch_model.bin.index.json")


def _model_spec(model: str, model_path: str) -> ModelSpec:
    """The registry spec of ``model``; for an HF checkpoint directory with
    the checkpoint's own geometry (its config.json), for a directory with
    the sidecar with the geometry it records."""
    kwargs = {}
    if model_path and os.path.isdir(model_path):
        from tpu_engine_torch.models.import_weights import hf_spec_kwargs
        from tpu_engine_torch.utils.checkpoint import SIDECAR

        kwargs = hf_spec_kwargs(model_path)
        sidecar = os.path.join(model_path, SIDECAR)
        if os.path.exists(sidecar):
            with open(sidecar) as f:
                kwargs = json.load(f).get("kwargs", {})
    return create_model(model, **kwargs)


def _load_model_path(spec: ModelSpec, model_path: Optional[str], device,
                     dtype):
    """The parameter tree a ``model_path`` holds for ``spec`` on
    ``device`` (kernels in ``dtype``), or None for no path, a path to
    nothing or a file that only names the model: HF checkpoints through
    ``load_pretrained``, the port's own checkpoint directories through
    ``utils.checkpoint.load_params``; any other directory refuses."""
    from tpu_engine_torch.models.import_weights import load_pretrained
    from tpu_engine_torch.utils.checkpoint import PARAMS_FILE, load_params

    path = model_path or ""
    if os.path.isfile(path):
        if not path.endswith((".safetensors", ".bin", ".pt", ".pth")):
            return None
    elif not os.path.isdir(path):
        return None
    elif not any(os.path.exists(os.path.join(path, f)) for f in _HF_FILES):
        if os.path.exists(os.path.join(path, PARAMS_FILE)):
            return load_params(path, device=device, dtype=dtype)
        raise NotImplementedError(
            f"'{path}' is neither an HF checkpoint nor a checkpoint of the "
            f"port's format ({PARAMS_FILE}); loading orbax checkpoints is "
            f"not yet ported to tpu_engine_torch")
    return load_pretrained(spec.name, path, spec=spec, device=device,
                           dtype=dtype)


class WorkerNode:
    def __init__(self, config: WorkerConfig, params=None, cache=None):
        """``params``: the model's parameter tree (``models.convert``) on
        the lane's device; None draws seeded random weights
        (``config.seed``). ``cache``: the /infer result cache (an
        ``LRUCache`` of ``cache_capacity`` by default; the combined
        server's native front gives its lanes a raw-mode
        ``core.native.NativeLRUCache``, whose entries it serves in C++)."""
        self.config = config
        self.node_id = config.node_id
        self._node_id_json = json.dumps(self.node_id).encode()
        # The generation lane: the continuous scheduler, or one of the
        # batch lanes, each behind a batcher of its own ("batch": the
        # Generator; "speculative": the SpeculativeGenerator).
        self._continuous = config.gen_scheduler == "continuous"
        self._speculative = config.gen_scheduler == "speculative"
        if config.gen_continuous_spec_k > 0 and not self._continuous:
            # --spec-k is the continuous scheduler's knob: another lane
            # would serve without speculation, silently.
            raise RuntimeError(
                f"--spec-k requires gen_scheduler=continuous, got "
                f"{config.gen_scheduler!r} (batch-lane speculation "
                f"is gen_scheduler=speculative)")
        if config.gen_kv_host_blocks > 0 and (
                not self._continuous
                or config.gen_kv_block_size <= 0
                or not config.gen_prefix_sharing):
            # The JAX worker's guard, with its message: a lane asked for
            # the host tier never quietly recomputes every evicted prefix.
            raise RuntimeError(
                "--kv-host-blocks requires the continuous scheduler with "
                "the paged KV cache and prefix sharing on "
                "(--kv-block-size > 0, --prefix-sharing on)")
        if config.gen_kv_quantize and (not self._continuous
                                       or config.gen_kv_block_size <= 0):
            # The JAX worker's guard, with its message: a lane asked for
            # the int8 pool never quietly serves the full-precision one.
            raise RuntimeError(
                "--kv-quantize requires the continuous scheduler with "
                "the paged KV cache (--kv-block-size > 0)")
        if config.gen_kv_quantize not in ("", "int8"):
            raise RuntimeError(f"--kv-quantize must be 'int8', got "
                               f"{config.gen_kv_quantize!r}")
        if config.gen_prefix_fetch and (not self._continuous
                                        or config.gen_kv_block_size <= 0
                                        or not config.gen_prefix_sharing):
            # The JAX worker's guard: a lane asked for the fleet prefix
            # tier never quietly ignores every hint.
            raise RuntimeError(
                "--prefix-fetch requires the continuous scheduler with "
                "the paged KV cache and prefix sharing on "
                "(--kv-block-size > 0, --prefix-sharing on)")
        if config.role not in ("prefill", "decode", "both"):
            raise RuntimeError(
                f"--role must be prefill|decode|both, got "
                f"{config.role!r}")
        path = config.model_path or ""
        if path.endswith(".onnx") and config.quantize is not None:
            # ONNX initializers are flat named arrays, not the kernel
            # dicts ops.quant rewrites: quantizing would quantize nothing.
            raise RuntimeError(
                "quantize is not supported for raw .onnx graphs "
                "(import the checkpoint into a registry "
                "architecture to serve quantized)")
        # Quantized lanes load f32 weights and quantize those, as JAX
        # quantizes its f32 tree.
        load_dtype = "float32" if config.quantize else config.dtype
        if path.endswith(".onnx") and os.path.exists(path):
            # The graph itself is the model: architecture and weights.
            from tpu_engine_torch.models.onnx_graph import build_onnx_model

            spec, graph_params = build_onnx_model(path, device=config.device)
            if params is None:
                params = graph_params
        else:
            spec = _model_spec(config.model, path)
            if params is None:
                params = _load_model_path(spec, path, config.device,
                                          load_dtype)
        self._fence_family(spec)
        self.engine = InferenceEngine(
            spec, params=params, rng_seed=config.seed, dtype=config.dtype,
            batch_buckets=config.batch_buckets,
            shape_buckets=config.shape_buckets, device=config.device,
            quantize=config.quantize)
        # The lane's span ring, made before the batcher whose observer
        # records into it.
        self.tracer = SpanRecorder(config.trace_capacity)
        self.engine.tracer = self.tracer
        self.engine.trace_node = self.node_id
        self.cache = (cache if cache is not None
                      else LRUCache(config.cache_capacity))
        self.batch_processor: BatchProcessor[_BatchItem, _BatchResult] = \
            BatchProcessor(config.max_batch_size, config.batch_timeout_ms,
                           lambda items: self._collect_batch(
                               self._submit_batch(items)),
                           linger_ms=config.batch_linger_ms,
                           name=f"{self.node_id}-batcher",
                           submit_callback=self._submit_batch,
                           collect_callback=self._collect_batch,
                           ready_callback=(lambda s: self.engine.handle_ready(
                               s[0])),
                           pipeline_depth=config.pipeline_depth,
                           observer=self._batch_observer)
        self.batch_processor.start()
        # Unified stateless serving is the continuous scheduler's: a batch
        # lane keeps the dedicated /infer and /score batchers.
        self._unified = bool(config.unified_stateless) and self._continuous
        self._score_proc: Optional[BatchProcessor] = None
        self._gen_processor: Optional[BatchProcessor] = None
        self._scorer = None
        self._counter_lock = threading.Lock()
        self.generator: Optional[Union[ContinuousGenerator, Generator,
                                       SpeculativeGenerator]] = None
        try:
            self.generator = self._build_generator(spec)
        except BaseException:
            self.batch_processor.stop()
            raise
        gen = self._sched
        if gen is not None:
            gen.tracer = self.tracer
            gen.trace_node = self.node_id
            if not gen._stateless:
                gen.trace_stitch = bool(config.trace_stitch)
            if config.flight_recorder > 0:
                gen.configure_flight_recorder(config.flight_recorder,
                                              config.flight_dump_dir)
            if config.gen_prefix_fetch and not gen._stateless:
                # The scheduler calls it on its prefill thread for hinted
                # misses; the worker owns the transport, the in-flight cap
                # and the timeout.
                gen.prefix_fetch = self._fetch_prefix_peer
        # The prefix fetch's in-flight cap, its cached peer clients, and
        # an optional in-process transport (set_prefix_fetch_transport).
        self._prefix_fetch_sem = threading.BoundedSemaphore(
            max(1, int(config.gen_prefix_fetch_inflight or 1)))
        self._prefix_fetch_transport = None
        self._prefix_peers: dict = {}
        self._prefix_peers_lock = threading.Lock()
        self._total_requests = 0
        self._cache_hits = 0
        # The AIMD limit replaces the static cap, starting from it.
        self._aimd = (AIMDLimit(max_limit=config.adaptive_depth_max,
                                start=config.max_queue_depth or None)
                      if config.adaptive_depth else None)
        self._tiered = bool(config.priority_admission)
        self._admission = AdmissionController(
            config.max_queue_depth, self.node_id,
            tier_fracs=TIER_ADMIT_FRAC if self._tiered else None,
            limiter=self._aimd)
        # EWMA (0.8 / 0.2) of the misses' inference_time_us: the /infer
        # miss path's early rejection estimate.
        self._service_ewma_us: Optional[float] = None
        # Bumped by apply_weights: a result computed under older weights
        # never enters the cleared cache (check and put under one lock).
        self._weights_gen = 0
        self._reload_lock = threading.Lock()
        # In-flight coalescing: concurrent identical misses share one
        # dispatch.
        self._inflight: dict = {}
        self._inflight_lock = threading.Lock()
        # Fault injection (the combined server's /admin/fault): a faulted
        # lane fails every request, a slowed one sleeps before serving;
        # listener(healthy) hears faults, heals, drains and undrains.
        self._injected_fault: Optional[str] = None
        self._injected_latency_s = 0.0
        self._fault_listeners: list = []
        # () -> (requests, hits) served on this lane's behalf outside
        # this Python path (the native front's C++ hits), summed into
        # /health.
        self.external_counters = None
        # Staged brownout: the control loop's thread walks the ladder
        # every brownout_interval_s.
        self._brownout: Optional[BrownoutController] = None
        self._brownout_clamps = 0
        self._brownout_prev = {"starved": 0, "missed": 0}
        self._brownout_stop = threading.Event()
        self._brownout_thread: Optional[threading.Thread] = None
        if config.brownout:
            self._brownout = BrownoutController()
            self._brownout_thread = threading.Thread(
                target=self._brownout_loop,
                name=f"{self.node_id}-brownout", daemon=True)
            self._brownout_thread.start()

    def _fence_family(self, spec: ModelSpec) -> None:
        """The serving-state family's fences, with the JAX worker's
        messages: a slab model refuses the KV knobs and --spec-k, another
        family --state-rows, a stateless one every generative knob; and a
        dedicated --role needs a family whose rows export (the paged
        cache, or the slab)."""
        cfg = self.config
        fam = spec.state_family
        if fam == "state_slab":
            if not self._continuous:
                raise RuntimeError(
                    f"model '{spec.name}' serves the state_slab family, "
                    f"which requires gen_scheduler=continuous (got "
                    f"{cfg.gen_scheduler!r}: the batch and speculative "
                    f"lanes serve only kv_paged models)")
            if (cfg.gen_kv_block_size > 0 or cfg.gen_kv_blocks > 0
                    or cfg.gen_kv_host_blocks > 0 or cfg.gen_kv_quantize):
                raise RuntimeError(
                    "state_slab-family models have no paged KV cache: "
                    "--kv-block-size/--kv-blocks/--kv-host-blocks/"
                    "--kv-quantize apply to the kv_paged family "
                    "(state capacity is --state-rows)")
            if cfg.gen_continuous_spec_k > 0:
                raise RuntimeError(
                    "--spec-k requires a kv_paged-family model: the "
                    "state_slab recurrence has no KV verify window")
        elif cfg.gen_state_rows > 0:
            raise RuntimeError(
                f"--state-rows applies to state_slab-family models; model "
                f"'{spec.name}' serves the {fam} family")
        if fam == "stateless":
            self._fence_stateless(spec)
        if cfg.role != "both" and (
                not self._continuous
                or (cfg.gen_kv_block_size <= 0 and fam != "state_slab")):
            # A dedicated role whose rows cannot export would serve
            # colocated, silently. (Slab rows export as one-pseudo-block
            # chains, so slab lanes qualify.)
            raise RuntimeError(
                "--role prefill|decode requires the continuous "
                "scheduler with the paged KV cache "
                "(--kv-block-size > 0)")

    def _fence_stateless(self, spec: ModelSpec) -> None:
        """A stateless model refuses every generative knob (the JAX
        worker's messages; --spec-k first, so a speculation request gets
        the speculative diagnosis even with KV knobs set)."""
        cfg = self.config
        if cfg.gen_continuous_spec_k > 0:
            raise RuntimeError(
                f"speculative lane misconfigured: --spec-k requires a "
                f"generation-capable family; model '{spec.name}' serves "
                f"the stateless family (one-shot rows have no decode loop "
                f"to speculate)")
        if (cfg.gen_kv_block_size > 0 or cfg.gen_kv_blocks > 0
                or cfg.gen_kv_host_blocks > 0 or cfg.gen_kv_quantize):
            raise RuntimeError(
                "stateless-family models have no KV cache: "
                "--kv-block-size/--kv-blocks/--kv-host-blocks/"
                "--kv-quantize apply to the kv_paged family")
        if cfg.gen_mixed_step:
            raise RuntimeError(
                "--mixed-step merges prefill and decode dispatches; "
                "stateless-family models have neither (one-shot rows "
                "already ride one grouped dispatch per tick)")

    @property
    def _sched(self) -> Optional[ContinuousGenerator]:
        """The lane's continuous scheduler (a decoder's, or a stateless
        lane's one-shot rows), None on a batch lane or without one."""
        gen = self.generator
        return gen if isinstance(gen, ContinuousGenerator) else None

    def _gen_lane(self) -> Optional[ContinuousGenerator]:
        """The continuous scheduler of a generation lane (None on a
        stateless lane, whose rows are all one-shot, and on a batch
        lane)."""
        gen = self._sched
        return None if gen is None or gen._stateless else gen

    def _build_generator(self, spec: ModelSpec):
        cfg = self.config
        if spec.state_family == "stateless":
            if not self._unified:
                return None
            # All rows one-shot: the dispatch width is the batcher's.
            return ContinuousGenerator(
                spec, params=self.engine.params, dtype=cfg.dtype,
                n_slots=cfg.max_batch_size, prefix_cache_mb=0,
                infer_engine=self.engine, device=cfg.device)
        if not self._continuous:
            try:
                gen = (self._build_speculative(spec) if self._speculative
                       else Generator(spec, params=self.engine.params,
                                      dtype=cfg.dtype,
                                      step_chunk=cfg.gen_step_chunk,
                                      device=self.engine.device))
            except ValueError:
                return None  # this model cannot generate
            # The lane's batcher: one group decode at a time.
            self._gen_processor = BatchProcessor(
                cfg.gen_max_batch_size, cfg.batch_timeout_ms,
                self._process_gen_batch, name=f"{self.node_id}-gen-batcher",
                observer=self._batch_observer)
            self._gen_processor.start()
            return gen
        spec_kw = self._continuous_spec_kwargs(spec)
        try:
            return ContinuousGenerator(
                spec, params=self.engine.params, dtype=cfg.dtype,
                n_slots=cfg.gen_max_batch_size,
                step_chunk=cfg.gen_step_chunk,
                prefill_chunk=cfg.gen_prefill_chunk,
                prefix_cache_mb=cfg.gen_prefix_cache_mb,
                kv_block_size=cfg.gen_kv_block_size,
                kv_blocks=cfg.gen_kv_blocks,
                kv_host_blocks=cfg.gen_kv_host_blocks,
                kv_quantize=cfg.gen_kv_quantize,
                prefix_sharing=cfg.gen_prefix_sharing,
                mixed_step=cfg.gen_mixed_step,
                mixed_token_budget=cfg.gen_mixed_token_budget,
                state_rows=cfg.gen_state_rows,
                infer_engine=self.engine if self._unified else None,
                score_provider=self._get_scorer if self._unified else None,
                device=cfg.device, **spec_kw)
        except ValueError as exc:
            if spec_kw:
                # The operator asked for speculation: a construction
                # failure (a draft that is no decoder, a draft max_seq too
                # small for k) is a misconfiguration, named as such.
                raise RuntimeError(
                    f"speculative lane misconfigured: {exc}") from exc
            raise

    _AUTO_DRAFT = {"gpt2": "distilgpt2", "gpt2-small-test": "gpt2-small-test"}

    def _resolve_draft_spec(self, target: ModelSpec) -> tuple:
        """(the draft model's spec, its weights or None): the model is
        ``gen_draft_model`` or the auto map's draft for the target, at the
        geometry of the checkpoint at ``gen_draft_path`` (an HF
        directory's config.json, a port checkpoint's sidecar); the weights
        are that checkpoint's (``_load_model_path``), None without a path
        or for a path to nothing (a random draft). Shared by the batch
        speculative lane and the continuous scheduler's model drafter.
        Misconfiguration raises RuntimeError."""
        draft_name = (self.config.gen_draft_model
                      or self._AUTO_DRAFT.get(target.name))
        if draft_name is None:
            raise RuntimeError(
                f"a draft model is required for '{target.name}': set "
                f"gen_draft_model (--gen-draft-model)")
        path = self.config.gen_draft_path or ""
        try:
            draft_spec = _model_spec(draft_name, path)
        except KeyError as exc:
            raise RuntimeError(f"speculative lane misconfigured: unknown "
                               f"draft model {exc}")
        draft_params = None
        if path:
            draft_params = _load_model_path(draft_spec, path,
                                            self.engine.device,
                                            self.config.dtype)
        return draft_spec, draft_params

    def _continuous_spec_kwargs(self, target: ModelSpec) -> dict:
        """Speculation kwargs for ContinuousGenerator (--spec-k,
        --spec-draft), empty when off. Misconfiguration raises
        RuntimeError with the JAX worker's messages."""
        k = int(self.config.gen_continuous_spec_k)
        if k <= 0:
            return {}
        if self.config.gen_kv_block_size <= 0:
            raise RuntimeError(
                "--spec-k requires the paged KV cache (--kv-block-size)")
        max_seq = target.config.max_seq
        if k > max_seq - 2:
            raise RuntimeError(
                f"--spec-k {k} cannot fit a verify window in the "
                f"model's max_seq {max_seq}")
        if self.config.gen_spec_draft not in ("ngram", "model"):
            raise RuntimeError(
                f"--spec-draft must be 'ngram' or 'model', got "
                f"{self.config.gen_spec_draft!r}")
        kw = {"spec_k": k, "spec_draft": self.config.gen_spec_draft}
        if self.config.gen_spec_draft == "model":
            draft_spec, draft_params = self._resolve_draft_spec(target)
            if draft_spec.config.vocab != target.config.vocab:
                raise RuntimeError(
                    f"speculative lane misconfigured: draft vocab "
                    f"{draft_spec.config.vocab} != target "
                    f"{target.config.vocab}")
            if draft_params is None:
                print(f"[{self.node_id}] WARNING: --spec-draft model "
                      f"'{draft_spec.name}' is randomly initialized (no "
                      f"gen_draft_path); expect ~zero acceptance — the "
                      f"ngram drafter is the better default", flush=True)
            kw["spec_draft_model"] = draft_spec
            kw["spec_draft_params"] = draft_params
        return kw

    def _build_speculative(self, spec: ModelSpec) -> SpeculativeGenerator:
        """The speculative lane's generator, sharing the engine's params.
        A target that is no decoder raises ValueError (the lane then has
        no generator, as for the other lanes); every misconfiguration of
        the draft or of k raises RuntimeError, so startup fails loudly."""
        if spec.state_family != "kv_paged":
            raise ValueError(f"model '{spec.name}' is not a decoder "
                             "transformer; generation unsupported")
        draft_spec, draft_params = self._resolve_draft_spec(spec)
        if draft_params is None:
            # A random draft accepts about nothing; a test fixture, not an
            # error.
            print(f"[{self.node_id}] WARNING: speculative draft "
                  f"'{draft_spec.name}' is randomly initialized (no "
                  f"gen_draft_path); expect ~zero acceptance and worse "
                  f"throughput than gen_scheduler=batch", flush=True)
        try:
            return SpeculativeGenerator(
                spec, draft_spec, params=self.engine.params,
                draft_params=draft_params, k=self.config.gen_spec_k,
                dtype=self.config.dtype, device=self.engine.device)
        except ValueError as exc:
            raise RuntimeError(f"speculative lane misconfigured: {exc}")

    # -- common request checks ------------------------------------------------

    def _check_model(self, request: dict) -> None:
        """A request addressed to a specific model is never answered by a
        lane serving another one (the JAX worker's check)."""
        want = request.get("model")
        have = self.engine.spec.name
        if want is not None and str(want) != have:
            raise ValueError(
                f"this lane serves model '{have}', not '{want}'")

    @contextlib.contextmanager
    def _traced_request(self, request: dict, op: str):
        """The worker-root span of a blocking request: parse the caller's
        traceparent (else derive the trace from the request_id), yield a
        ``_RootSpan`` whose context parents every stage span, and record
        the root (wall time, outcome: ok, the shed kind or error, and the
        attrs the body added) however the body exits."""
        parent = TraceContext.from_request(request)
        request_id = str(request.get("request_id", ""))
        ctx = (parent.child() if parent is not None
               else TraceContext.root(request_id))
        span = _RootSpan(ctx, request_id)
        t0 = time.perf_counter()
        start = time.time()
        try:
            yield span
            span.attrs["outcome"] = "ok"
        except ShedError as exc:
            span.attrs["outcome"] = exc.kind
            raise
        finally:
            self.tracer.record(
                request_id, op, self.node_id,
                (time.perf_counter() - t0) * 1e6,
                cached=span.cached, trace_id=ctx.trace_id,
                span_id=ctx.span_id,
                parent_id=parent.span_id if parent is not None else None,
                start_ts=start, attrs=span.attrs)

    @contextlib.contextmanager
    def _admitted(self, deadline: Optional[Deadline],
                  tier: Optional[int] = None,
                  trace: Optional[_RootSpan] = None):
        """The admission scope of a blocking request: admit (at ``tier``
        under tiered admission), then always release. A request that
        completes feeds its admit-to-finish time, queueing included, to
        the AIMD limiter. With ``trace`` an ``admission`` span (its
        outcome: admitted, or the shed kind) joins the root."""
        t0 = time.perf_counter()
        start = time.time()

        def span(outcome):
            if trace is None:
                return
            child = trace.ctx.child()
            self.tracer.record(
                trace.request_id, "admission", self.node_id,
                (time.perf_counter() - t0) * 1e6,
                trace_id=child.trace_id, span_id=child.span_id,
                parent_id=trace.ctx.span_id, start_ts=start,
                attrs={"outcome": outcome})

        try:
            self._admission.admit(deadline, tier=tier)
        except ShedError as exc:
            span(exc.kind)
            raise
        ok = False
        try:
            self._maybe_slow()
            span("admitted")
            yield
            ok = True
        finally:
            self._admission.release()
            if ok and self._aimd is not None:
                self._aimd.observe(time.perf_counter() - t0)

    # -- overload control (priority tiers, staged brownout) -------------------

    def _request_tier(self, request: dict) -> Optional[int]:
        """The request's priority tier when an overload feature reads it
        (tiered admission or the brownout clamp), else None: the field is
        then ignored. An unknown value with a feature on is a 400."""
        if not self._tiered and self._brownout is None:
            return None
        return parse_priority(request)

    def _brownout_clamp(self, max_new: int, tier: Optional[int]) -> int:
        """The clamp stage: a below-top-tier request's token budget is
        capped at ``brownout_clamp_tokens``; the top tier never is."""
        bo = self._brownout
        if (bo is None or tier is None or tier >= TOP_TIER
                or bo.stage < BROWNOUT_STAGES.index("clamp")):
            return max_new
        clamp = max(1, int(self.config.brownout_clamp_tokens))
        if max_new > clamp:
            with self._counter_lock:
                self._brownout_clamps += 1
            return clamp
        return max_new

    def n_gen_slots(self) -> int:
        return max(1, int(self.config.gen_max_batch_size))

    def _brownout_signals(self) -> dict:
        """The saturation components of one control-loop evaluation, each
        normalized so 1.0 is the red line: admitted depth against the
        limit (or twice the decode slots when unbounded), the decode
        loop's tick age against 2 s (the JAX worker's red line without a
        stall threshold; the port has no stall watchdog), parked
        admissions per slot, new pool starvation, new deadline misses."""
        comps = {}
        adm = self._admission
        limit = adm.effective_limit()
        nominal = limit or 2 * self.n_gen_slots()
        comps["queue_depth"] = adm.depth / nominal
        missed = adm.shed_deadline
        gen = self.generator
        st = gen.stats() if gen is not None else None
        if st:
            age = st.get("last_tick_age_s")
            if age is not None:
                comps["tick_age"] = age / 2.0
            kv = st.get("kv_pool") or {}
            if kv:
                comps["pool_pending"] = (kv.get("pending_admissions", 0)
                                         / self.n_gen_slots())
                starved = st.get("pool_starved", 0)
                if starved > self._brownout_prev["starved"]:
                    comps["pool_starved"] = 1.0
                self._brownout_prev["starved"] = starved
            missed += st.get("deadline_cancelled", 0)
        if missed > self._brownout_prev["missed"]:
            comps["deadline_miss"] = 1.0
        self._brownout_prev["missed"] = missed
        return comps

    def _apply_brownout(self, action: str, comps: dict) -> None:
        """Apply the controller's stage to the scheduler: the budget
        shrink from stage 1, spec suspension from 2, swap-in deferral
        from 3 (the clamp, stage 4, applies at request parsing), and
        record one ``overload`` marker per transition, so escalations
        plus restores equal those spans."""
        stage = self._brownout.stage
        if self._sched is not None:
            self._sched.set_brownout(
                budget_frac=BROWNOUT_BUDGET_FRAC if stage >= 1 else 1.0,
                suspend_spec=stage >= 2,
                defer_swap_in=stage >= 3)
        ctx = TraceContext.root(f"brownout:{self.node_id}").child()
        binding = max(comps, key=comps.get) if comps else ""
        self.tracer.record(
            "brownout", "overload", self.node_id, 0,
            trace_id=ctx.trace_id, span_id=ctx.span_id,
            start_ts=time.time(),
            attrs={"action": action, "stage": stage,
                   "stage_name": BROWNOUT_STAGES[stage],
                   "binding_signal": binding})

    def _brownout_loop(self) -> None:
        """Read the signals, walk the ladder, apply; a failed evaluation
        (a torn stats read) skips the sample, never the loop."""
        interval = max(0.05, float(self.config.brownout_interval_s))
        while not self._brownout_stop.wait(interval):
            try:
                comps = self._brownout_signals()
                action = self._brownout.evaluate(comps)
                if action is not None:
                    self._apply_brownout(action, comps)
            except Exception:
                continue

    def _count_request(self) -> None:
        with self._counter_lock:
            self._total_requests += 1

    # -- drain (lame-duck) ----------------------------------------------------

    def drain(self) -> str:
        """Refuse new admissions (503 ``overloaded``) while in-flight work
        completes; ``"draining"``, or ``"already-draining"`` on a repeat.
        The fault listeners hear it (the native front stops answering the
        lane's hits, which never reach the admission check)."""
        status = self._admission.drain()
        if status == "already-draining":
            return status
        if self._sched is not None:
            self._sched.set_draining(True)
        for listener in self._fault_listeners:
            listener(False)
        return status

    def undrain(self) -> str:
        """``"undrained"``, or ``"not-draining"`` when the lane was not
        draining. A faulted lane stays disabled for its listeners."""
        status = self._admission.undrain()
        if status == "not-draining":
            return status
        if self._sched is not None:
            self._sched.set_draining(False)
        if self._injected_fault is None:
            for listener in self._fault_listeners:
                listener(True)
        return status

    # -- fault injection --------------------------------------------------------

    def inject_fault(self, reason: str = "injected") -> None:
        """Fail every request (a lane fault: RuntimeError) until
        ``heal``; /health reads ``healthy: false``."""
        self._injected_fault = reason
        for listener in self._fault_listeners:
            listener(False)

    def inject_latency(self, seconds: float) -> None:
        """The slow-lane fault: each admitted request sleeps ``seconds``
        first; the lane stays healthy (no breaker sees it)."""
        self._injected_latency_s = max(0.0, float(seconds))

    def heal(self) -> None:
        """Clear both faults; a draining lane stays disabled for its
        listeners (the drain outranks health)."""
        self._injected_fault = None
        self._injected_latency_s = 0.0
        for listener in self._fault_listeners:
            listener(not self._admission.draining)

    def on_fault_change(self, listener) -> None:
        """Register ``listener(healthy: bool)``."""
        self._fault_listeners.append(listener)

    def _check_fault(self) -> None:
        if self._injected_fault is not None:
            raise RuntimeError(f"fault injected: {self._injected_fault}")

    def _maybe_slow(self) -> None:
        if self._injected_latency_s > 0:
            time.sleep(self._injected_latency_s)

    @property
    def draining(self) -> bool:
        return self._admission.draining

    # -- live-row migration ---------------------------------------------------

    def handle_migrate_export(self, request: dict) -> dict:
        """/admin/migrate ``{request_id, timeout_s?, wait_prefill?,
        cancel?}``: export one live stream's row
        (``ContinuousGenerator.export_row``) so another lane can continue
        it with ``migrate_import``; the local stream ends with a retryable
        ``migrated`` terminal event. ``wait_prefill`` exports at the first
        tick past the row's prefill (the handoff); ``cancel`` releases its
        handoff hold. Refusals (an unknown stream, a row mid-prefill, a
        dense lane) answer ``{"ok": false, "reason"}``, never an
        error."""
        rid = request.get("request_id")
        if not rid:
            raise ValueError("request_id is required")
        gen = self._gen_lane()
        if gen is None:
            return {"ok": False, "node_id": self.node_id,
                    "reason": "this lane has no continuous decode "
                              "scheduler to export from"}
        out = gen.export_row(
            str(rid), timeout_s=float(request.get("timeout_s", 10.0)),
            wait_prefill=bool(request.get("wait_prefill", False)),
            cancel=bool(request.get("cancel", False)))
        out["node_id"] = self.node_id
        return out

    # -- the fleet prefix tier --------------------------------------------------

    def handle_export_prefix(self, request: dict) -> dict:
        """/admin/export_prefix ``{tokens, max_blocks?}``: a peer's prefix
        fetch, the longest radix chain matching ``tokens``
        (``ContinuousGenerator.export_prefix``; no stream state).
        Refusals (no scheduler, a draining lane, no prefix, no matching
        chain) answer ``{"ok": false, "node_id", "reason"}`` and never
        raise; the drain refusal names this lane."""
        gen = self._gen_lane()
        if gen is None:
            return {"ok": False, "node_id": self.node_id,
                    "reason": "this lane has no continuous decode "
                              "scheduler to export from"}
        if self.draining:
            return {"ok": False, "node_id": self.node_id,
                    "reason": f"lane {self.node_id} is draining"}
        tokens = request.get("tokens")
        if not isinstance(tokens, list) or not tokens:
            return {"ok": False, "node_id": self.node_id,
                    "reason": "request carries no token prefix"}
        max_blocks = request.get("max_blocks")
        out = gen.export_prefix(
            tokens, max_blocks=(int(max_blocks)
                                if max_blocks is not None else None))
        out["node_id"] = self.node_id
        return out

    def set_prefix_fetch_transport(self, fn) -> None:
        """Install an in-process peer transport ``(hint, payload) ->
        dict`` in place of the HTTP POST to the hint's address."""
        self._prefix_fetch_transport = fn

    def _fetch_prefix_peer(self, hint: dict, tokens,
                           max_blocks: int) -> Optional[dict]:
        """The scheduler's fetch callable (prefill thread): pull the
        hinted peer's chain, each transport outcome classified as the
        rung the scheduler counts (``peer_unreachable``,
        ``peer_refused``, ``timeout``, ``inflight_capped``). The in-flight
        cap is taken without blocking, so a herd on one hot prefix
        prefills locally instead of queueing. None for a hint naming this
        lane (nothing to fetch)."""
        if hint.get("lane") == self.node_id:
            return None
        if not self._prefix_fetch_sem.acquire(blocking=False):
            return {"ok": False, "rung": "inflight_capped"}
        try:
            payload = {"tokens": [int(t) for t in tokens],
                       "max_blocks": int(max_blocks)}
            timeout_s = max(0.1, float(
                self.config.gen_prefix_fetch_timeout_s))
            if self._prefix_fetch_transport is not None:
                try:
                    out = self._prefix_fetch_transport(hint, payload)
                except Exception:
                    return {"ok": False, "rung": "peer_unreachable"}
            else:
                addr = hint.get("addr")
                if not addr:
                    return {"ok": False, "rung": "peer_unreachable",
                            "reason": "hint carries no peer address"}
                try:
                    out = self._prefix_peer_client(addr).export_prefix(
                        payload, timeout_s=timeout_s)
                except (socket.timeout, TimeoutError):
                    return {"ok": False, "rung": "timeout"}
                except Exception as exc:
                    if "timed out" in str(exc).lower():
                        return {"ok": False, "rung": "timeout"}
                    return {"ok": False, "rung": "peer_unreachable"}
            if not isinstance(out, dict) or not out.get("ok"):
                return {"ok": False, "rung": "peer_refused",
                        "reason": (out.get("reason")
                                   if isinstance(out, dict)
                                   else "malformed reply")}
            return {"ok": True, "chain": out.get("chain"),
                    "blocks": out.get("blocks")}
        finally:
            self._prefix_fetch_sem.release()

    def _prefix_peer_client(self, addr: str) -> HttpWorkerClient:
        """One cached HTTP client per peer address (at most 64)."""
        with self._prefix_peers_lock:
            client = self._prefix_peers.get(addr)
            if client is None:
                if len(self._prefix_peers) >= 64:
                    self._prefix_peers.clear()
                client = HttpWorkerClient(
                    addr, timeout_s=max(0.1, float(
                        self.config.gen_prefix_fetch_timeout_s)),
                    pool_size=max(1, int(
                        self.config.gen_prefix_fetch_inflight or 1)))
                self._prefix_peers[addr] = client
            return client

    # -- disaggregated roles ----------------------------------------------------

    def set_role(self, role: str) -> dict:
        """/admin/role: flip this lane's serving role (the gateway drains
        and migrates around the flip). The role is advisory routing
        metadata, so the flip is safe mid-traffic; a dedicated role needs
        the paged cache or the slab (a ValueError, the 400)."""
        role = str(role)
        if role not in ("prefill", "decode", "both"):
            raise ValueError(f"role must be prefill|decode|both, "
                             f"got {role!r}")
        if role != "both" and (
                not self._continuous
                or (self.config.gen_kv_block_size <= 0
                    and self.engine.spec.state_family != "state_slab")):
            raise ValueError(
                "a dedicated role requires the continuous scheduler "
                "with the paged KV cache (--kv-block-size > 0)")
        self.config.role = role
        return {"ok": True, "node_id": self.node_id, "role": role}

    @property
    def role(self) -> str:
        return self.config.role

    @property
    def service_estimate_us(self) -> Optional[float]:
        """The /infer miss path's service-time estimate (None before the
        first miss): a miss whose budget is below it sheds 503
        ``overloaded``."""
        return self._service_ewma_us

    def reload_weights(self, model_path: str) -> dict:
        """Hot weight reload (``/admin/reload``): load ``model_path``'s
        weights for the served architecture (``_load_model_path``) and
        swap them in (``apply_weights``). A checkpoint of another
        architecture or dtype is refused while the old weights keep
        serving."""
        params = _load_model_path(
            self.engine.spec, model_path, self.engine.device,
            "float32" if self.config.quantize else self.config.dtype)
        if params is None:
            raise ValueError(f"no loadable weights at '{model_path}'")
        return self.apply_weights(params, source=model_path)

    def apply_weights(self, params, source: str = "<params>") -> dict:
        """Swap in new weights of the served model (the engine's
        ``set_params`` checks), on the engine and then on the scheduler
        (which drops its prefix caches) or the batch lane's generator:
        every lane serves them from its next dispatch, and the result
        cache is cleared; an in-flight result computed under the old
        weights never enters it."""
        self.engine.set_params(params)
        if self._sched is not None:
            self._sched.set_params(self.engine.params)
        elif self.generator is not None:
            # A batch lane's generator reads its params at each group.
            self.generator.params = self.engine.params
        with self._reload_lock:
            self._weights_gen += 1
            self.cache.clear()
        return {"ok": True, "node_id": self.node_id, "model_path": source}

    # -- /infer ---------------------------------------------------------------

    @staticmethod
    def _cache_key(input_data, shape=None) -> bytes:
        blob = np.asarray(input_data, dtype=np.float32).tobytes()
        if shape is not None:
            blob = np.asarray(shape, np.int64).tobytes() + b"|" + blob
        return blob

    def _infer_core(self, request: dict) -> Tuple[str, bytes, bool, int]:
        """The /infer flow -> (request_id, output_data fragment, cached?,
        inference_time_us)."""
        self._check_fault()
        self._check_model(request)
        deadline = Deadline.from_request(request)
        tier = self._request_tier(request)
        with self._traced_request(request, "infer") as span:
            with self._admitted(deadline, tier, trace=span):
                self._count_request()
                out = self._infer_admitted(request, deadline, span.ctx)
                span.cached = out[2]
                span.attrs["inference_time_us"] = out[3]
                return out

    def _child_span(self, request_id: str, tctx: TraceContext, op: str,
                    t0: float, start: float,
                    attrs: Optional[dict] = None) -> None:
        """A stage span under the worker root ``tctx`` from ``t0``
        (perf_counter; wall ``start``) to now."""
        child = tctx.child()
        self.tracer.record(request_id, op, self.node_id,
                           (time.perf_counter() - t0) * 1e6,
                           trace_id=child.trace_id, span_id=child.span_id,
                           parent_id=tctx.span_id, start_ts=start,
                           attrs=attrs)

    def _infer_admitted(self, request: dict, deadline: Optional[Deadline],
                        tctx: TraceContext
                        ) -> Tuple[str, bytes, bool, int]:
        request_id = request["request_id"]
        input_data = request["input_data"]
        shape = request.get("shape")
        if shape is not None:
            shape = tuple(int(d) for d in shape)
        key = self._cache_key(input_data, shape)
        cl0, cl_start = time.perf_counter(), time.time()
        frag = self.cache.get(key)
        self._child_span(request_id, tctx, "cache_lookup", cl0, cl_start,
                         {"hit": frag is not None})
        if frag is not None:
            with self._counter_lock:
                self._cache_hits += 1
            return (request_id, frag, True,
                    self.config.fake_cached_latency_us)
        while True:
            # The miss path's early rejection, on this request's own
            # budget each round.
            est = self._service_ewma_us
            self._admission.check_deadline(
                deadline, None if est is None else est / 1e6)
            with self._inflight_lock:
                entry = self._inflight.get(key)
                leader = entry is None
                if leader:
                    entry = _Inflight()
                    self._inflight[key] = entry
            if leader:
                break
            w0, w_start = time.perf_counter(), time.time()
            if not entry.event.wait(timeout=clamp_timeout(deadline, 120.0)):
                if deadline is not None and deadline.expired():
                    raise DeadlineExceeded(
                        "deadline expired waiting on coalesced result")
                raise RuntimeError("coalesced request timed out")
            if entry.error is not None:
                if isinstance(entry.error, DeadlineExceeded):
                    # The leader's budget ran out, not this request's:
                    # retire the dead entry and go round again (join a
                    # live leader or lead).
                    with self._inflight_lock:
                        if self._inflight.get(key) is entry:
                            self._inflight.pop(key)
                    continue
                raise entry.error  # a bad input is a 400 for all of them
            self._child_span(request_id, tctx, "coalesced_wait", w0,
                             w_start, {"leader_time_us": entry.time_us})
            return request_id, entry.frag, False, entry.time_us
        try:
            gen0 = self._weights_gen  # stamped before the compute
            result = self._dispatch_infer(
                _BatchItem(request_id, input_data, shape, trace=tctx),
                deadline)
            s0, s_start = time.perf_counter(), time.time()
            frag = _encode_output(result.output_data)
            self._child_span(request_id, tctx, "serialize", s0, s_start)
            with self._reload_lock:
                if gen0 == self._weights_gen:
                    self.cache.put(key, frag)
            entry.frag = frag
            entry.time_us = result.inference_time_us
            t = float(result.inference_time_us)
            self._service_ewma_us = (t if self._service_ewma_us is None
                                     else 0.8 * self._service_ewma_us
                                     + 0.2 * t)
        except BaseException as exc:
            entry.error = exc
            raise
        finally:
            entry.event.set()
            with self._inflight_lock:
                self._inflight.pop(key, None)
        return request_id, frag, False, result.inference_time_us

    def handle_infer(self, request: dict) -> dict:
        """One /infer request; the JAX worker's wire schema."""
        request_id, frag, cached, time_us = self._infer_core(request)
        return {"request_id": request_id, "output_data": json.loads(frag),
                "node_id": self.node_id, "cached": cached,
                "inference_time_us": time_us}

    def handle_infer_raw(self, request: dict) -> bytes:
        """``handle_infer``, serialized: the response JSON spliced around
        the cached output fragment, no float re-encoding."""
        request_id, frag, cached, time_us = self._infer_core(request)
        return (b'{"request_id": ' + json.dumps(request_id).encode()
                + b', "output_data": ' + frag
                + b', "node_id": ' + self._node_id_json
                + b', "cached": ' + (b"true" if cached else b"false")
                + b', "inference_time_us": ' + str(time_us).encode() + b"}")

    def _infer_unified(self) -> bool:
        gen = self._sched
        return self._unified and gen is not None and gen.accepts_oneshot

    def _score_unified(self) -> bool:
        gen = self._sched
        return self._unified and gen is not None and gen.accepts_score

    @staticmethod
    def _oneshot_timeout(deadline: Optional[Deadline]) -> float:
        return (600.0 if deadline is None
                else max(5.0, deadline.remaining_s() + 5.0))

    def _dispatch_infer(self, item: _BatchItem,
                        deadline: Optional[Deadline]) -> _BatchResult:
        """A miss: one single-tick scheduler row on a unified lane, else
        the dynamic batcher. Results and errors are the same either
        way."""
        if not self._infer_unified():
            return self.batch_processor.process(item, deadline=deadline)
        sink = (TraceSink(self.tracer, self.node_id, item.request_id,
                          item.trace) if item.trace is not None else None)
        fut = self.generator.submit_infer(item.input_data, shape=item.shape,
                                          deadline=deadline, sink=sink)
        out, time_us = fut.result(timeout=self._oneshot_timeout(deadline))
        return _BatchResult(out, time_us)

    def _submit_batch(self, items: List[_BatchItem]):
        """The batcher's dispatch half: the device work enqueued, no
        wait."""
        start = time.perf_counter()
        shapes = ([it.shape for it in items]
                  if any(it.shape is not None for it in items) else None)
        handle = self.engine.batch_submit([it.input_data for it in items],
                                          shapes=shapes)
        return handle, start, items

    def _collect_batch(self, submitted) -> List[_BatchResult]:
        """The blocking half: inference_time_us is the batch's submit ->
        collect residence divided by its size."""
        handle, start, items = submitted
        outputs = self.engine.batch_collect(handle)
        elapsed_us = (time.perf_counter() - start) * 1e6
        per_us = int(elapsed_us / max(1, len(items)))
        self._record_device_spans(items, elapsed_us)
        return [_BatchResult(out, per_us) for out in outputs]

    def _batch_observer(self, items, timing) -> None:
        """The batcher's tracing hook (its dispatch thread): a
        ``queue_wait`` span per traced member and a ``batch_form`` span
        each for the batch they shared, placed back from the observer's
        call time."""
        end_wall = time.time()
        formed_at = end_wall - timing.compute_us / 1e6
        for it, wait_us in zip(items, timing.queue_wait_us):
            ctx = getattr(it, "trace", None)
            if ctx is None:
                continue
            qw = ctx.child()
            self.tracer.record(
                it.request_id, "queue_wait", self.node_id, wait_us,
                trace_id=qw.trace_id, span_id=qw.span_id,
                parent_id=ctx.span_id, start_ts=formed_at - wait_us / 1e6)
            bf = ctx.child()
            self.tracer.record(
                it.request_id, "batch_form", self.node_id,
                timing.batch_form_us, batch_size=len(items),
                trace_id=bf.trace_id, span_id=bf.span_id,
                parent_id=ctx.span_id,
                start_ts=formed_at - timing.batch_form_us / 1e6,
                attrs={"timed_out": timing.timed_out})

    def _record_device_spans(self, items, elapsed_us: float) -> None:
        """A ``device_compute`` span per traced batch member: the whole
        batch's submit -> collect (what inference_time_us divides), the
        batch's size beside it."""
        start_wall = time.time() - elapsed_us / 1e6
        n = len(items)
        for it in items:
            ctx = getattr(it, "trace", None)
            if ctx is None:
                continue
            child = ctx.child()
            self.tracer.record(
                it.request_id, "device_compute", self.node_id, elapsed_us,
                batch_size=n, trace_id=child.trace_id,
                span_id=child.span_id, parent_id=ctx.span_id,
                start_ts=start_wall)

    # -- /score ---------------------------------------------------------------

    def handle_score(self, request: dict) -> dict:
        """Teacher-forced scoring: per-token log P(completion | prompt) in
        one forward."""
        self._check_fault()
        self._check_model(request)
        if self.engine.spec.state_family != "kv_paged":
            # Teacher-forced next-token logprobs are a decoder-LM notion:
            # encoders and the config-less models refuse with this message.
            raise ValueError(
                f"model '{self.config.model}' does not support scoring")
        deadline = Deadline.from_request(request)
        tier = self._request_tier(request)
        with self._traced_request(request, "score") as span:
            with self._admitted(deadline, tier, trace=span):
                return self._score_admitted(request, deadline, span.ctx)

    def _score_admitted(self, request: dict, deadline: Optional[Deadline],
                        tctx: TraceContext) -> dict:
        self._count_request()
        completion = [int(t) for t in request["completion_tokens"]]
        if not completion:
            raise ValueError("completion_tokens must be non-empty")
        item = _ScoreItem(request["request_id"],
                          [int(t) for t in request["prompt_tokens"]],
                          completion)
        total = max(len(item.prompt), 1) + len(completion)
        largest = self._get_scorer().prompt_buckets[-1]
        if total > largest:
            # Refused before it joins a group: one over-long request must
            # not fail its co-batched neighbours.
            raise ValueError(
                f"prompt+completion length {total} exceeds the largest "
                f"sequence bucket {largest}")
        t0 = time.perf_counter()
        if self._score_unified():
            fut = self.generator.submit_score(
                item.prompt, item.completion, deadline=deadline,
                sink=TraceSink(self.tracer, self.node_id, item.request_id,
                               tctx))
            lps, _us = fut.result(timeout=self._oneshot_timeout(deadline))
        else:
            lps = self._score_processor().process(item, deadline=deadline)
        return {"request_id": item.request_id, "logprobs": lps,
                "total_logprob": float(sum(lps)), "node_id": self.node_id,
                "score_time_us": int((time.perf_counter() - t0) * 1e6)}

    def _get_scorer(self) -> Generator:
        """The lane's scorer: the batch lane's own Generator, else one made
        at first use; on the engine's current parameters."""
        if isinstance(self.generator, Generator):
            return self.generator
        with self._counter_lock:
            if self._scorer is None:
                self._scorer = Generator(self.engine.spec,
                                         params=self.engine.params,
                                         dtype=self.config.dtype,
                                         device=self.engine.device)
            scorer = self._scorer
        scorer.params = self.engine.params
        return scorer

    def _score_processor(self) -> BatchProcessor:
        with self._counter_lock:
            if self._score_proc is None:
                self._score_proc = BatchProcessor(
                    self.config.max_batch_size, self.config.batch_timeout_ms,
                    self._process_score_batch,
                    name=f"{self.node_id}-score-batcher")
                self._score_proc.start()
            return self._score_proc

    def _process_score_batch(self, items: List[_ScoreItem]):
        return self._get_scorer().score([it.prompt for it in items],
                                        [it.completion for it in items])

    def _process_gen_batch(self, items: List[_GenItem]) -> List[_GenResult]:
        """A batch lane's batch: each beam request alone (its beams ride
        the batch axis), the others grouped by ``eos_id``, each group run
        to its largest ``max_new_tokens`` (``gen_decode_fused`` is passed
        on, as in JAX, though the Generator runs one loop for both; the
        speculative generator takes no such flag) and each row cut to its
        own. A request's time is its
        group's divided by the group's size."""
        results: List[Optional[_GenResult]] = [None] * len(items)
        groups: dict = {}
        for idx, it in enumerate(items):
            if it.beam_width > 1:
                t0 = time.perf_counter()
                row = self.generator.beam_search(
                    it.prompt, beam_width=it.beam_width,
                    max_new_tokens=it.max_new_tokens, eos_id=it.eos_id,
                    length_penalty=it.length_penalty)
                results[idx] = _GenResult(
                    row[:it.max_new_tokens],
                    int((time.perf_counter() - t0) * 1e6))
                continue
            groups.setdefault(it.eos_id, []).append(idx)
        for eos_id, idxs in groups.items():
            t0 = time.perf_counter()
            group = [items[i] for i in idxs]
            toks = self.generator.generate(
                [it.prompt for it in group],
                max_new_tokens=max(it.max_new_tokens for it in group),
                eos_id=eos_id,
                temperature=[it.temperature for it in group],
                seed=[it.seed for it in group],
                top_p=[it.top_p for it in group],
                top_k=[it.top_k for it in group],
                repetition_penalty=[it.repetition_penalty for it in group],
                stop_tokens=[list(it.stop_tokens) for it in group],
                min_p=[it.min_p for it in group],
                **({} if self._speculative
                   else {"fused": self.config.gen_decode_fused}))
            group_us = (time.perf_counter() - t0) * 1e6
            self._record_device_spans(group, group_us)
            per_us = int(group_us / max(1, len(idxs)))
            for i, row in zip(idxs, toks):
                results[i] = _GenResult(row[:items[i].max_new_tokens],
                                        per_us)
        return results

    # -- /generate ------------------------------------------------------------

    def _generation_deadline(self, request: dict) -> Optional[Deadline]:
        """The checks before a /generate request's admission: a lane that
        generates, the lane's model; returns its deadline."""
        if self.generator is None or getattr(self.generator, "_stateless",
                                             False):
            raise ValueError(
                f"model '{self.config.model}' does not support generation")
        self._check_fault()
        self._check_model(request)
        return Deadline.from_request(request)

    # Wire-facing beam cap: the beams multiply the cache by the width.
    MAX_BEAM_WIDTH = 8

    def _validate_beam(self, beam_width: int, temperature: float,
                       top_p: float, top_k: int, rep_penalty: float,
                       stop_tokens, length_penalty: float = 1.0,
                       min_p: float = 0.0) -> None:
        """A beam request (``beam_width`` > 1) checked as the JAX worker
        checks it: a finite ``length_penalty`` in [-10, 10], a width in
        [1, MAX_BEAM_WIDTH], a batch lane, and no sampling control (beam
        search is deterministic). A ValueError is the 400."""
        if beam_width == 1:
            return
        if not math.isfinite(length_penalty) or abs(length_penalty) > 10:
            raise ValueError(
                f"length_penalty must be finite in [-10, 10], got "
                f"{length_penalty}")
        if not 1 <= beam_width <= self.MAX_BEAM_WIDTH:
            raise ValueError(
                f"beam_width must be in [1, {self.MAX_BEAM_WIDTH}], got "
                f"{beam_width}")
        if self._continuous or self._speculative:
            raise ValueError("beam_width > 1 needs gen_scheduler=batch")
        if (temperature > 0 or top_p < 1.0 or top_k > 0
                or rep_penalty != 1.0 or stop_tokens or min_p > 0):
            raise ValueError(
                "beam_width is deterministic: temperature/top_p/top_k/"
                "min_p/repetition_penalty/stop_tokens do not apply")

    def _parse(self, request: dict, tier: Optional[int] = None) -> _GenItem:
        """A /generate payload, validated before it joins a batch or a
        stream commits to 200 (a malformed request is a 400): the beam
        checks, the stop list, and on the speculative lane the sampling
        controls it cannot serve. The brownout clamp applies to
        ``max_new_tokens`` at ``tier``."""
        item = _GenItem(
            request_id=request["request_id"],
            prompt=[int(t) for t in request["prompt_tokens"]],
            max_new_tokens=self._brownout_clamp(
                int(request.get("max_new_tokens", 32)), tier),
            eos_id=int(request.get("eos_id", -1)),
            temperature=float(request.get("temperature", 0.0)),
            seed=int(request.get("seed", 0)),
            top_p=float(request.get("top_p", 1.0)),
            top_k=clamp_top_k(request.get("top_k", 0)),
            repetition_penalty=float(request.get("repetition_penalty",
                                                 1.0)),
            stop_tokens=tuple(int(t)
                              for t in request.get("stop_tokens", ())),
            beam_width=int(request.get("beam_width", 1)),
            length_penalty=float(request.get("length_penalty", 1.0)),
            min_p=validate_min_p(request.get("min_p", 0.0)))
        self._validate_beam(item.beam_width, item.temperature, item.top_p,
                            item.top_k, item.repetition_penalty,
                            item.stop_tokens, item.length_penalty,
                            item.min_p)
        expand_stopping_params(1, item.repetition_penalty,
                               [list(item.stop_tokens)]
                               if item.stop_tokens else None)
        if self._speculative and (item.top_p < 1.0 or item.top_k > 0
                                  or item.repetition_penalty != 1.0
                                  or item.min_p > 0):
            # Rejection sampling is exact for the temperature distribution
            # only; one filtered request must not fail its batch.
            raise ValueError(
                "speculative scheduler supports temperature sampling only "
                "(top_p/top_k/repetition_penalty unavailable; use "
                "gen_scheduler=continuous)")
        return item

    @staticmethod
    def _submit_kwargs(item: _GenItem, deadline: Optional[Deadline]) -> dict:
        """The continuous scheduler's ``submit`` arguments of an item."""
        return {"max_new_tokens": item.max_new_tokens,
                "eos_id": item.eos_id, "temperature": item.temperature,
                "seed": item.seed, "top_p": item.top_p, "top_k": item.top_k,
                "repetition_penalty": item.repetition_penalty,
                "stop_tokens": list(item.stop_tokens), "min_p": item.min_p,
                "deadline": deadline}

    def handle_generate(self, request: dict) -> dict:
        deadline = self._generation_deadline(request)
        tier = self._request_tier(request)
        with self._traced_request(request, "generate") as span, \
                self._admitted(deadline, tier, trace=span):
            self._count_request()
            request_id = request["request_id"]
            item = self._parse(request, tier)
            if not self._continuous:
                item.trace = span.ctx
                result = self._gen_processor.process(item, deadline=deadline)
                return {"request_id": request_id, "tokens": result.tokens,
                        "node_id": self.node_id,
                        "generate_time_us": result.generate_time_us}
            t0 = time.perf_counter()
            tokens = self.generator.submit(
                item.prompt, tag=request_id,
                sink=TraceSink(self.tracer, self.node_id, request_id,
                               span.ctx),
                prefix_hint=self._prefix_hint(request),
                **self._submit_kwargs(item, deadline)).result(timeout=600)
            return {"request_id": request_id, "tokens": tokens,
                    "node_id": self.node_id,
                    "generate_time_us": int((time.perf_counter() - t0)
                                            * 1e6)}

    def handle_generate_stream(self, request: dict):
        """Returns an iterator of SSE event byte chunks. Validation and
        admission run before it is returned (a 400 or 503, not a 200
        stream); the admission slot is held until the events end. A body
        with ``migrate_import`` continues an exported row
        (``submit_import``); a gateway-stamped ``handoff`` parks the row
        after prefill for ``handoff_park_ms`` (clamped to [0.1, 120] s)
        awaiting its export. On a batch lane the whole result arrives as
        one ``tokens`` event and the ``done`` event."""
        deadline = self._generation_deadline(request)
        request_id = request["request_id"]
        tier = self._request_tier(request)
        parent = TraceContext.from_request(request)
        snap = request.get("migrate_import")
        if snap is not None:
            if self._gen_lane() is None:
                raise ValueError(
                    "migrate_import requires a continuous-scheduler lane "
                    "with the paged KV cache")
            if parent is None and isinstance(snap, dict):
                # A snapshot from a stitching lane carries the exported
                # row's trace: the continuation's spans join it.
                parent = TraceContext.from_request(snap)
            # The continuation of a migrated row: no prefill, no re-sent
            # prefix; a malformed snapshot raises here (a 400).
            return self._open_stream(
                request, deadline,
                lambda q, sink: self.generator.submit_import(
                    snap, stream=q, deadline=deadline, tag=request_id,
                    sink=sink), tier, parent)
        item = self._parse(request, tier)
        if not self._continuous:
            return self._one_shot_stream(request, item, deadline, tier,
                                         parent)
        kw = self._submit_kwargs(item, deadline)
        if request.get("handoff"):
            # A client-supplied park window never pins a slot and its
            # chain for long (the scheduler clamps again).
            kw["handoff"] = True
            kw["handoff_park_s"] = min(120.0, max(0.1, float(
                request.get("handoff_park_ms", 5000.0)) / 1000.0))
        return self._open_stream(
            request, deadline,
            lambda q, sink: self.generator.submit(
                item.prompt, stream=q, tag=request_id, sink=sink,
                prefix_hint=self._prefix_hint(request), **kw), tier, parent)

    def _one_shot_stream(self, request: dict, item: _GenItem,
                         deadline: Optional[Deadline], tier: Optional[int],
                         parent: Optional[TraceContext]):
        """A batch lane's stream, as the JAX worker's: an admission now
        and released at once (a shed or an expired deadline is a 503
        before the 200), then ``handle_generate`` of the normalized
        payload on the first iteration (admitted there for real), giving
        one ``tokens`` event and the ``done`` event, or the terminal
        error event."""
        self._admission.admit(deadline, tier=tier)
        self._admission.release()
        request_id = item.request_id
        normalized = {
            "request_id": request_id, "prompt_tokens": item.prompt,
            "max_new_tokens": item.max_new_tokens, "eos_id": item.eos_id,
            "temperature": item.temperature, "seed": item.seed,
            "top_p": item.top_p, "top_k": item.top_k,
            "repetition_penalty": item.repetition_penalty,
            "stop_tokens": list(item.stop_tokens),
            "beam_width": item.beam_width,
            "length_penalty": item.length_penalty, "min_p": item.min_p}
        if "priority" in request:
            normalized["priority"] = request["priority"]
        if deadline is not None:
            # The remaining budget travels on.
            normalized["deadline_ms"] = max(0.0, deadline.remaining_ms())
        trace_id = (parent.child() if parent is not None
                    else TraceContext.root(request_id)).trace_id

        def one_shot():
            try:
                result = self.handle_generate(normalized)
            except Exception as exc:
                yield sse_event(self._stream_error(exc, request_id,
                                                   trace_id, 0))
                return
            yield sse_event({"tokens": result["tokens"]})
            yield sse_event({"done": True, **result})
        return one_shot()

    def _prefix_hint(self, request: dict) -> Optional[dict]:
        """The gateway's ``prefix_hint``, inert without prefix fetch."""
        return (request.get("prefix_hint")
                if self.config.gen_prefix_fetch else None)

    def _open_stream(self, request: dict, deadline: Optional[Deadline],
                     submit, tier: Optional[int],
                     parent: Optional[TraceContext]) -> _AdmittedStream:
        """Admit (at ``tier``) and count one scheduler stream of
        ``request``, submitted by ``submit(q, sink)`` (its Future; ``q``
        takes the token lists, ``sink`` the stage spans): the SSE events
        hold the admission slot until they end, and a stream that
        reaches its ``done`` event feeds its admit-to-finish time to the
        AIMD limiter. Its ``generate_stream`` root span (under
        ``parent``) records when the stream ends; a segment that ends
        another way (exported, failed, stalled) records it with a
        ``segment`` attr, so its stage spans never dangle."""
        request_id = request["request_id"]
        tctx = (parent.child() if parent is not None
                else TraceContext.root(request_id))
        trace_id = tctx.trace_id
        t_start_wall = time.time()
        t_admit = time.perf_counter()
        self._admission.admit(deadline, tier=tier)
        try:
            self._maybe_slow()
            self._count_request()
            q: "queue.Queue" = queue.Queue()
            t0 = time.perf_counter()
            fut = submit(q, TraceSink(self.tracer, self.node_id, request_id,
                                      tctx))
        except BaseException:
            self._admission.release()
            raise

        def root_span(attrs=None):
            self.tracer.record(
                request_id, "generate_stream", self.node_id,
                (time.perf_counter() - t0) * 1e6, trace_id=tctx.trace_id,
                span_id=tctx.span_id,
                parent_id=parent.span_id if parent is not None else None,
                start_ts=t_start_wall, attrs=attrs)

        def release(completed: bool) -> None:
            self._admission.release()
            if completed and self._aimd is not None:
                self._aimd.observe(time.perf_counter() - t_admit)

        def events():
            sent = 0
            while True:
                try:
                    item = q.get(timeout=600)
                except queue.Empty:
                    fut.cancel()
                    root_span({"segment": "stalled"})
                    yield sse_event(self._stream_error(
                        RuntimeError("generation stalled (no tokens for "
                                     "600s)"), request_id, trace_id, sent))
                    return
                if item is None:
                    break
                sent += len(item)
                yield sse_event({"tokens": item})
            elapsed_us = int((time.perf_counter() - t0) * 1e6)
            try:
                tokens = fut.result(timeout=10)
            except Exception as exc:
                root_span({"segment": "exported"
                           if getattr(exc, "migrated", False) else "error"})
                yield sse_event(self._stream_error(exc, request_id,
                                                   trace_id, sent))
                return
            root_span()
            stream.completed = True
            yield sse_event({
                "done": True, "request_id": request_id, "tokens": tokens,
                "node_id": self.node_id, "generate_time_us": elapsed_us})
        stream = _AdmittedStream(events(), release)
        return stream

    @staticmethod
    def _stream_error(exc: BaseException, request_id: str, trace_id: str,
                      tokens_emitted: int) -> dict:
        """Terminal error event (the JAX worker's): ``retryable`` tells a
        lane fault or a shed (the stream can resume elsewhere from
        ``tokens_emitted`` tokens) from a spent deadline or a request at
        fault; ``trace_id`` joins it to the request's trace; ``migrated``
        marks a row exported to another lane, ``import_refused`` a
        migration import this lane refused, ``shed`` a refusal by policy
        of a healthy lane (a gateway resumes it with no breaker
        penalty)."""
        retryable = getattr(exc, "retryable", None)
        if retryable is None:
            # A spent deadline, like a request at fault, no lane can help.
            retryable = not isinstance(exc, (DeadlineExceeded, KeyError,
                                             ValueError, TypeError))
        out = {"done": True, "error": str(exc)[:300],
               "retryable": bool(retryable), "request_id": request_id,
               "trace_id": trace_id, "tokens_emitted": int(tokens_emitted)}
        if getattr(exc, "migrated", False):
            out["migrated"] = True
        if getattr(exc, "import_refused", False):
            out["import_refused"] = True
        if isinstance(exc, ShedError):
            out["shed"] = True
        return out

    # -- observability --------------------------------------------------------

    def latency_histograms(self) -> dict:
        """The scheduler's TTFT and ITL histograms as /metrics families
        (node -> histogram); none on a lane without a continuous
        scheduler's generation."""
        gen = self._gen_lane()
        if gen is None:
            return {}
        return {"tpu_engine_ttft_seconds": {self.node_id: gen.ttft_hist},
                "tpu_engine_itl_seconds": {self.node_id: gen.itl_hist}}

    def handle_timeline(self, request: Optional[dict] = None) -> dict:
        """/admin/timeline: the flight recorder's ring (GET) or, with
        ``{"dump": reason}``, a dump now (POST); ``{"n": k}`` the last k
        records."""
        gen = self._sched
        if gen is None:
            return {"node_id": self.node_id, "enabled": False,
                    "reason": "this lane has no continuous scheduler"}
        if request and request.get("dump"):
            dump = gen.flight_dump(str(request["dump"]))
            return {"node_id": self.node_id,
                    "enabled": dump is not None, "dumped": dump}
        n = int(request.get("n", 0)) if request else 0
        out = gen.flight_timeline(n or None)
        out["node_id"] = self.node_id
        return out

    def flight_dump(self, reason: str) -> Optional[dict]:
        """Dump the scheduler's flight recorder now (None when the lane
        runs none)."""
        gen = self._sched
        return gen.flight_dump(reason) if gen is not None else None

    def handle_profile(self, request: Optional[dict] = None) -> dict:
        """/admin/profile: a torch.profiler capture bounded in scheduler
        ticks, written under ``profile_dir``. ``{"ticks": N}`` starts one
        the decode loop stops after N ticks, ``{"action": "stop"}`` stops
        it early, ``{"action": "status"}`` (GET) reports the count down
        and the last capture (its trace file and device events). Without
        ``ticks`` the capture runs until stopped; on a lane without a
        scheduler it lives on a thread of its own (the card's kernels,
        not the request threads' CPU ops)."""
        profile_dir = self.config.profile_dir
        request = request or {}
        action = request.get("action")
        gen = self._sched
        if action == "status":
            out = {"node_id": self.node_id, "profile_dir": profile_dir}
            if gen is not None:
                out.update(gen.profile_status())
            return out
        if action == "stop":
            res = (gen.stop_profile() if gen is not None
                   else tracing.profiler_stop())
            return {"node_id": self.node_id, **res}
        if not profile_dir:
            return {"node_id": self.node_id,
                    "error": "profiling not configured "
                             "(start the worker with --profile-dir)"}
        log_dir = request.get("log_dir") or profile_dir
        ticks = int(request.get("ticks", 0) or 0)
        if gen is not None:
            res = gen.start_profile(log_dir, ticks)
        else:
            res = tracing.profiler_start(log_dir)
        return {"node_id": self.node_id, **res}

    def get_health(self) -> dict:
        with self._counter_lock:
            total, hits = self._total_requests, self._cache_hits
        if self.external_counters is not None:
            ext_total, ext_hits = self.external_counters()
            total += ext_total
            hits += ext_hits
        out = {"healthy": self._injected_fault is None,
               "node_id": self.node_id,
               "model": self.engine.spec.name, "total_requests": total,
               "cache_hits": hits, "cache_size": self.cache.size(),
               "cache_hit_rate": self.cache.hit_rate(),
               "batch_processor": self.batch_processor.get_metrics()
               .as_dict()}
        if self.config.role != "both":
            # Only on dedicated-role lanes (absent reads "both"): a
            # default lane's /health keeps its keys.
            out["role"] = self.config.role
        gstats = (self.generator.stats() if self.generator is not None
                  else {})
        if self.generator is not None and not getattr(
                self.generator, "_stateless", False):
            out["generator"] = gstats
        elif self.generator is not None:
            # A stateless lane's scheduler is its batch lane: its one-shot
            # dispatches fold into the four-key batch_processor block.
            st = gstats["stateless"]
            bp = out["batch_processor"]
            rows = st["infer_rows"] + st["score_rows"]
            prev_rows = bp["avg_batch_size"] * bp["total_batches"]
            bp["total_batches"] += st["dispatches"]
            bp["full_batches"] += st["full_dispatches"]
            if bp["total_batches"] > 0:
                bp["avg_batch_size"] = ((prev_rows + rows)
                                        / bp["total_batches"])
        if self.config.gen_prefix_fetch and self._gen_lane() is not None:
            # The fleet prefix tier's seed: the radix tree's deepest
            # chains, bounded, for the gateway prober's directory.
            out["prefix_fingerprints"] = \
                self._gen_lane().prefix_fingerprints()
        # Rows dropped at their deadline by the batchers and the
        # scheduler's one-shot rows count with the admission sheds.
        dropped = self.batch_processor.deadline_dropped
        for proc in (self._score_proc, self._gen_processor):
            if proc is not None:
                dropped += proc.deadline_dropped
        if "stateless" in gstats:
            dropped += gstats["stateless"]["deadline_dropped"]
        if self._admission.active or dropped:
            adm = self._admission.as_dict()
            adm["deadline_dropped"] = dropped
            out["admission"] = adm
        if self._brownout is not None:
            bo = self._brownout.as_dict()
            bo["clamped_requests"] = self._brownout_clamps
            out["brownout"] = bo
        return out

    def stop(self) -> None:
        self._brownout_stop.set()
        if self._brownout_thread is not None:
            self._brownout_thread.join(timeout=5)
            self._brownout_thread = None
        self.batch_processor.stop()
        if self._score_proc is not None:
            self._score_proc.stop()
        if self._gen_processor is not None:
            self._gen_processor.stop()
        if self._sched is not None:
            self._sched.stop()

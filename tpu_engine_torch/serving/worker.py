"""The port's generation worker (counterpart of the /generate half of
``tpu_engine/serving/worker.py``): one continuous scheduler (dense, the
default lane, or paged: mixed stepping or two-path, bf16/f32 or int8
pool, with continuous speculation under ``gen_continuous_spec_k``) behind
``/generate``,
``/generate/stream`` (SSE), ``/health`` and ``/stats``, with the JAX
worker's wire fields.

Wire: ``/generate`` takes ``{request_id, prompt_tokens, max_new_tokens?,
eos_id?, temperature?, seed?, top_p?, top_k?, repetition_penalty?,
stop_tokens?, min_p?, deadline_ms?, model?}`` and answers ``{request_id,
tokens, node_id, generate_time_us}``. ``/generate/stream`` sends
``{"tokens": [...]}`` events as tokens decode, then a terminal
``{"done": true, ...}`` event with the blocking endpoint's fields, or
with ``error``, ``retryable`` and ``tokens_emitted`` when the stream
failed. As in the JAX worker, a ``model`` other than the lane's is a 400;
a negative or NaN ``deadline_ms`` is a 400; a request whose deadline has
passed at admission is a 503 with ``Retry-After`` (before a stream
commits to 200); and a row whose deadline passes mid-generation is
cancelled between ticks (blocking: 503; stream: the terminal error
event, not retryable).

A speculative lane's ``/stats`` and ``/health`` carry the scheduler's
``spec`` block. A misconfigured one refuses at startup with the JAX
worker's messages (``--spec-k`` without ``--kv-block-size``, a k the
model's max_seq cannot hold, an unknown ``--spec-draft``, no draft model
for the target, a draft vocab other than the target's); a draft model
without weights is randomly initialised, with the JAX worker's warning.

``/health`` carries the JAX lane's keys at defaults: the ``/infer``
result cache's (``cache_hits``, ``cache_size``, ``cache_hit_rate``) and
``batch_processor``, and the generator's ``stateless`` block, all idle
with zero counts, since the port serves no one-shot rows yet.
"""

from __future__ import annotations

import queue
import threading
import time

from tpu_engine_torch.models.registry import ModelSpec, create_model
from tpu_engine_torch.runtime.scheduler import ContinuousGenerator
from tpu_engine_torch.serving.http import sse_event
from tpu_engine_torch.utils.config import WorkerConfig
from tpu_engine_torch.utils.deadline import Deadline, DeadlineExceeded
from tpu_engine_torch.utils.sampling import (
    clamp_top_k,
    expand_stopping_params,
    validate_min_p,
)


class WorkerNode:
    def __init__(self, config: WorkerConfig, params=None):
        """``params``: the model's parameter tree (``models.convert``);
        None draws seeded random weights (``config.seed``) on the lane's
        device."""
        self.config = config
        self.node_id = config.node_id
        if config.gen_kv_quantize and config.gen_kv_block_size <= 0:
            # The JAX worker's guard, with its message: a lane asked for
            # the int8 pool never quietly serves the full-precision one.
            raise RuntimeError(
                "--kv-quantize requires the continuous scheduler with "
                "the paged KV cache (--kv-block-size > 0)")
        if config.gen_kv_quantize not in ("", "int8"):
            raise RuntimeError(f"--kv-quantize must be 'int8', got "
                               f"{config.gen_kv_quantize!r}")
        if config.gen_draft_path:
            raise RuntimeError(
                "gen_draft_path (--gen-draft-path): loading draft weights "
                "is not yet ported to tpu_engine_torch")
        spec = create_model(config.model)
        spec_kw = self._continuous_spec_kwargs(spec)
        try:
            self.generator = ContinuousGenerator(
                spec, params=params, rng_seed=config.seed,
                dtype=config.dtype, n_slots=config.gen_max_batch_size,
                step_chunk=config.gen_step_chunk,
                prefill_chunk=config.gen_prefill_chunk,
                prefix_cache_mb=config.gen_prefix_cache_mb,
                kv_block_size=config.gen_kv_block_size,
                kv_blocks=config.gen_kv_blocks,
                kv_quantize=config.gen_kv_quantize,
                prefix_sharing=config.gen_prefix_sharing,
                mixed_step=config.gen_mixed_step,
                mixed_token_budget=config.gen_mixed_token_budget,
                device=config.device, **spec_kw)
        except ValueError as exc:
            if spec_kw:
                # The operator asked for speculation: a construction
                # failure (a draft that is no decoder, a draft max_seq too
                # small for k) is a misconfiguration, named as such.
                raise RuntimeError(
                    f"speculative lane misconfigured: {exc}") from exc
            raise
        self._total_requests = 0
        self._counter_lock = threading.Lock()

    _AUTO_DRAFT = {"gpt2": "distilgpt2", "gpt2-small-test": "gpt2-small-test"}

    def _resolve_draft_spec(self, target: ModelSpec) -> ModelSpec:
        """The draft model's spec: ``gen_draft_model``, or the auto map's
        draft for the target. Misconfiguration raises RuntimeError."""
        draft_name = (self.config.gen_draft_model
                      or self._AUTO_DRAFT.get(target.name))
        if draft_name is None:
            raise RuntimeError(
                f"a draft model is required for '{target.name}': set "
                f"gen_draft_model (--gen-draft-model)")
        try:
            return create_model(draft_name)
        except KeyError as exc:
            raise RuntimeError(f"speculative lane misconfigured: unknown "
                               f"draft model {exc}")

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
            draft_spec = self._resolve_draft_spec(target)
            if draft_spec.config.vocab != target.config.vocab:
                raise RuntimeError(
                    f"speculative lane misconfigured: draft vocab "
                    f"{draft_spec.config.vocab} != target "
                    f"{target.config.vocab}")
            # The port loads no draft checkpoint yet: always random.
            print(f"[{self.node_id}] WARNING: --spec-draft model "
                  f"'{draft_spec.name}' is randomly initialized (no "
                  f"gen_draft_path); expect ~zero acceptance — the "
                  f"ngram drafter is the better default", flush=True)
            kw["spec_draft_model"] = draft_spec
            kw["spec_draft_params"] = None
        return kw

    def _check_model(self, request: dict) -> None:
        """A request addressed to a specific model is never answered by a
        lane serving another one (the JAX worker's check)."""
        want = request.get("model")
        have = getattr(self.generator.spec, "name", None)
        if want is not None and have is not None and str(want) != have:
            raise ValueError(
                f"this lane serves model '{have}', not '{want}'")

    def _parse(self, request: dict) -> dict:
        """Validate a /generate payload eagerly: a malformed request must
        400, and an expired one 503, before a stream commits to 200."""
        self._check_model(request)
        deadline = Deadline.from_request(request)
        if int(request.get("beam_width", 1)) != 1:
            raise ValueError("beam search is not yet ported to "
                             "tpu_engine_torch")
        kw = {
            "prompt": [int(t) for t in request["prompt_tokens"]],
            "max_new_tokens": int(request.get("max_new_tokens", 32)),
            "eos_id": int(request.get("eos_id", -1)),
            "temperature": float(request.get("temperature", 0.0)),
            "seed": int(request.get("seed", 0)),
            "top_p": float(request.get("top_p", 1.0)),
            "top_k": clamp_top_k(request.get("top_k", 0)),
            "repetition_penalty": float(
                request.get("repetition_penalty", 1.0)),
            "stop_tokens": [int(t) for t in request.get("stop_tokens", ())],
            "min_p": validate_min_p(request.get("min_p", 0.0)),
        }
        expand_stopping_params(1, kw["repetition_penalty"],
                               [kw["stop_tokens"]] if kw["stop_tokens"]
                               else None)
        if deadline is not None and deadline.expired():
            raise DeadlineExceeded("deadline exceeded at admission")
        kw["deadline"] = deadline
        return kw

    def _count_request(self) -> None:
        with self._counter_lock:
            self._total_requests += 1

    def handle_generate(self, request: dict) -> dict:
        request_id = request["request_id"]
        kw = self._parse(request)
        self._count_request()
        t0 = time.perf_counter()
        tokens = self.generator.submit(kw.pop("prompt"), **kw).result(
            timeout=600)
        return {"request_id": request_id, "tokens": tokens,
                "node_id": self.node_id,
                "generate_time_us": int((time.perf_counter() - t0) * 1e6)}

    def handle_generate_stream(self, request: dict):
        """Returns an iterator of SSE event byte chunks."""
        request_id = request["request_id"]
        kw = self._parse(request)
        self._count_request()
        q: "queue.Queue" = queue.Queue()
        t0 = time.perf_counter()
        fut = self.generator.submit(kw.pop("prompt"), stream=q, **kw)

        def events():
            sent = 0
            while True:
                try:
                    item = q.get(timeout=600)
                except queue.Empty:
                    fut.cancel()
                    yield sse_event(self._stream_error(
                        RuntimeError("generation stalled (no tokens for "
                                     "600s)"), request_id, sent))
                    return
                if item is None:
                    break
                sent += len(item)
                yield sse_event({"tokens": item})
            try:
                tokens = fut.result(timeout=10)
            except Exception as exc:
                yield sse_event(self._stream_error(exc, request_id, sent))
                return
            yield sse_event({
                "done": True, "request_id": request_id, "tokens": tokens,
                "node_id": self.node_id,
                "generate_time_us": int((time.perf_counter() - t0) * 1e6)})
        return events()

    @staticmethod
    def _stream_error(exc: BaseException, request_id: str,
                      tokens_emitted: int) -> dict:
        """Terminal error event: ``retryable`` tells a lane fault (the
        stream can resume elsewhere from ``tokens_emitted`` tokens) from a
        request at fault."""
        retryable = getattr(exc, "retryable", None)
        if retryable is None:
            # A spent deadline, like a request at fault, no lane can help.
            retryable = not isinstance(exc, (DeadlineExceeded, KeyError,
                                             ValueError, TypeError))
        return {"done": True, "error": str(exc)[:300],
                "retryable": bool(retryable), "request_id": request_id,
                "tokens_emitted": int(tokens_emitted)}

    def _generator_stats(self) -> dict:
        """The scheduler's stats with the JAX lane's ``stateless`` block
        (one-shot rows), idle: the port serves none yet."""
        return {**self.generator.stats(), "stateless": {
            "admitted": 0, "completed": 0, "failed": 0, "ticks": 0,
            "dispatches": 0, "infer_rows": 0, "score_rows": 0,
            "full_dispatches": 0, "deadline_dropped": 0}}

    def get_health(self) -> dict:
        with self._counter_lock:
            total = self._total_requests
        return {"healthy": True, "node_id": self.node_id,
                "model": self.generator.spec.name,
                "total_requests": total,
                # The /infer result cache and batcher, idle.
                "cache_hits": 0, "cache_size": 0, "cache_hit_rate": 0.0,
                "batch_processor": {"total_batches": 0,
                                    "avg_batch_size": 0.0,
                                    "timeout_batches": 0,
                                    "full_batches": 0},
                "generator": self._generator_stats()}

    def get_stats(self) -> dict:
        return {"node_id": self.node_id, **self._generator_stats()}

    def stop(self) -> None:
        self.generator.stop()

"""The port's generation worker (counterpart of the /generate half of
``tpu_engine/serving/worker.py``): one continuous scheduler (dense, the
default lane, or paged: mixed stepping or two-path, bf16/f32 or int8
pool) behind ``/generate``,
``/generate/stream`` (SSE), ``/health`` and ``/stats``, with the JAX
worker's wire fields.

Wire: ``/generate`` takes ``{request_id, prompt_tokens, max_new_tokens?,
eos_id?, temperature?, seed?, top_p?, top_k?, repetition_penalty?,
stop_tokens?, min_p?}`` and answers ``{request_id, tokens, node_id,
generate_time_us}``. ``/generate/stream`` sends ``{"tokens": [...]}``
events as tokens decode, then a terminal ``{"done": true, ...}`` event
with the blocking endpoint's fields, or with ``error``, ``retryable`` and
``tokens_emitted`` when the stream failed.
"""

from __future__ import annotations

import queue
import threading
import time

from tpu_engine_torch.models.registry import create_model
from tpu_engine_torch.runtime.scheduler import ContinuousGenerator
from tpu_engine_torch.serving.http import sse_event
from tpu_engine_torch.utils.config import WorkerConfig
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
        spec = create_model(config.model)
        self.generator = ContinuousGenerator(
            spec, params=params, rng_seed=config.seed, dtype=config.dtype,
            n_slots=config.gen_max_batch_size,
            step_chunk=config.gen_step_chunk,
            prefill_chunk=config.gen_prefill_chunk,
            prefix_cache_mb=config.gen_prefix_cache_mb,
            kv_block_size=config.gen_kv_block_size,
            kv_blocks=config.gen_kv_blocks,
            kv_quantize=config.gen_kv_quantize,
            prefix_sharing=config.gen_prefix_sharing,
            mixed_step=config.gen_mixed_step,
            mixed_token_budget=config.gen_mixed_token_budget,
            device=config.device)
        self._total_requests = 0
        self._counter_lock = threading.Lock()

    def _parse(self, request: dict) -> dict:
        """Validate a /generate payload eagerly: a malformed request must
        400 before a stream commits to 200."""
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
            retryable = not isinstance(exc, (KeyError, ValueError,
                                             TypeError))
        return {"done": True, "error": str(exc)[:300],
                "retryable": bool(retryable), "request_id": request_id,
                "tokens_emitted": int(tokens_emitted)}

    def get_health(self) -> dict:
        with self._counter_lock:
            total = self._total_requests
        return {"healthy": True, "node_id": self.node_id,
                "model": self.generator.spec.name,
                "total_requests": total,
                "generator": self.generator.stats()}

    def get_stats(self) -> dict:
        return {"node_id": self.node_id, **self.generator.stats()}

    def stop(self) -> None:
        self.generator.stop()

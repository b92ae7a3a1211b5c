"""One-shot inference engine (counterpart of ``InferenceEngine`` in
``tpu_engine/runtime/engine.py``): batched forwards of a registry model
over flat float vectors, with the JAX engine's bucketing and wire rules.

- **Batch buckets.** A batch of B runs on the smallest bucket >= B, the
  rows past B zero; larger batches chunk at the largest bucket.
- **Inputs.** Each sample is flattened and truncated to the model's input
  size (``_coerce_sample``); the zero-pad half happens on the device.
- **Wire buckets** of 128 * 8^k up to the input size: the host stages a
  (bucket, wire) buffer only as wide as the widest sample, and the device
  zero-pads it to the input size and reshapes it to the model's input
  shape. The wire is staged in the compute dtype when that dtype is
  narrower than f32 and the model takes no token ids (a bf16 resnet's
  inputs round to bf16 on the host, as in JAX); token-id models always
  stage f32, exact for any id below 2^24.
- **Split phases.** ``batch_submit`` stages the wire in pinned host memory,
  enqueues the copy to the card, the forward and a non-blocking copy of
  the result back to pinned memory, then records a CUDA event; nothing in
  it waits for the card. ``handle_ready`` is the events' ``query()``, and
  ``batch_collect`` waits on them and splits the rows. ``batch_predict``
  is the two in a row.

Mixed-shape serving (``shape_buckets``) and weight quantization
(``quantize``) are not yet ported and refuse by name.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from tpu_engine_torch.models.registry import ModelSpec, create_model
from tpu_engine_torch.training.train import tree_leaves
from tpu_engine_torch.utils.device import resolve_device, resolve_dtype


def _structure(tree):
    """The nesting of a parameter tree (dict keys sorted, list lengths),
    without its leaves."""
    if isinstance(tree, dict):
        return tuple((k, _structure(tree[k])) for k in sorted(tree))
    if isinstance(tree, (list, tuple)):
        return tuple(_structure(v) for v in tree)
    return None


def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).replace("torch.", "")


class InferenceEngine:
    def __init__(
        self,
        model: Union[str, ModelSpec],
        params=None,
        rng_seed: int = 0,
        dtype: str = "bfloat16",
        batch_buckets: Sequence[int] = (1, 2, 4, 8, 16, 32),
        shape_buckets: Optional[Sequence[Tuple[int, ...]]] = None,
        device=None,
        quantize: Optional[str] = None,
    ):
        """``params``: the model's parameter tree on ``device``; None draws
        seeded random weights (``rng_seed``). ``device`` defaults to the
        CUDA card; pass ``device="cpu"`` to run on the CPU."""
        if shape_buckets is not None:
            raise NotImplementedError(
                "mixed-shape serving (shape_buckets) is not yet ported to "
                "tpu_engine_torch")
        if quantize is not None:
            raise NotImplementedError(
                "weight quantization (quantize) is not yet ported to "
                "tpu_engine_torch")
        if isinstance(model, str):
            model = create_model(model)
        if model.apply is None:
            raise ValueError(f"model '{model.name}' has no one-shot apply")
        self.spec = model
        self.device = resolve_device(device)
        self._dtype = resolve_dtype(dtype)
        self._buckets = tuple(sorted({max(1, int(b)) for b in batch_buckets}))
        self.params = params if params is not None else model.init(
            rng_seed, device=self.device, dtype=self._dtype)
        self._cuda = self.device.type == "cuda"
        self._stats_lock = threading.Lock()
        self._execute_count = 0
        # Host time spent blocked in batch_collect waiting for the card:
        # near zero when the submit/collect pipeline hides the device leg.
        self._collect_block_s = 0.0
        n_in = model.input_size
        wb, wire = 128, []
        while wb < n_in:
            wire.append(wb)
            wb *= 8
        wire.append(n_in)
        self._wire_buckets = tuple(wire)
        int_input = model.config is not None  # transformers take token ids
        self._wire_dtype = (torch.float32
                            if self._dtype == torch.float32 or int_input
                            else self._dtype)

    def set_params(self, params) -> None:
        """Swap in a new parameter tree of the served one's structure,
        leaf shapes and dtypes (refused otherwise, with the JAX engine's
        messages), placed on the engine's device."""
        if _structure(params) != _structure(self.params):
            raise ValueError(
                "reload rejected: parameter tree structure differs from "
                "the served model's")
        for i, (o, n) in enumerate(zip(tree_leaves(self.params),
                                       tree_leaves(params))):
            if tuple(o.shape) != tuple(n.shape):
                raise ValueError(
                    f"reload rejected: leaf {i} shape {tuple(n.shape)} != "
                    f"served {tuple(o.shape)}")
            if o.dtype != n.dtype:
                raise ValueError(
                    f"reload rejected: leaf {i} dtype "
                    f"{_dtype_name(n.dtype)} != served "
                    f"{_dtype_name(o.dtype)}")
        from tpu_engine_torch.models.convert import params_to

        self.params = params_to(params, self.device)

    # -- buckets and staging --------------------------------------------------

    def _bucket_for(self, batch_size: int) -> int:
        for b in self._buckets:
            if b >= batch_size:
                return b
        return self._buckets[-1]

    def _wire_bucket_for(self, n: int) -> int:
        for b in self._wire_buckets:
            if b >= n:
                return b
        return self._wire_buckets[-1]

    def _coerce_sample(self, vec) -> np.ndarray:
        """Flatten and truncate to the model's input size."""
        arr = np.asarray(vec, dtype=np.float32).ravel()
        n = self.spec.input_size
        return arr[:n] if arr.size > n else arr

    def _stage_wire(self, samples: List[np.ndarray], bucket: int,
                    wire: int) -> torch.Tensor:
        """The (bucket, wire) host buffer in the wire dtype (pinned when the
        engine runs on the card), rows past the samples zero."""
        buf = np.zeros((bucket, wire), np.float32)
        for i, s in enumerate(samples):
            buf[i, :s.size] = s
        host = torch.from_numpy(buf).to(self._wire_dtype)
        return host.pin_memory() if self._cuda else host

    def _forward(self, xw: torch.Tensor, bucket: int) -> torch.Tensor:
        """Zero-pad the wire to the input size on the device, reshape to
        the model's input shape and run the forward: (bucket, out) f32."""
        n_in = self.spec.input_size
        if xw.shape[1] < n_in:
            xw = F.pad(xw, (0, n_in - xw.shape[1]))
        x = xw.reshape((bucket,) + tuple(self.spec.input_shape))
        return self.spec.apply(self.params, x, dtype=self._dtype)

    def warmup(self, buckets: Optional[Sequence[int]] = None) -> None:
        """Run every batch bucket at the narrowest and widest wire bucket,
        and the largest batch bucket at every wire bucket, once, so the
        first requests meet built kernels and a warm allocator."""
        ends = sorted({self._wire_buckets[0], self._wire_buckets[-1]})
        shapes = [(self._bucket_for(b), w) for b in buckets or self._buckets
                  for w in ends]
        shapes += [(self._buckets[-1], w) for w in self._wire_buckets]
        for bucket, wire in dict.fromkeys(shapes):
            self.batch_collect([self._submit_chunk(
                [np.zeros((wire,), np.float32)] * bucket, bucket, wire)])

    # -- inference ------------------------------------------------------------

    def predict(self, input_vector) -> np.ndarray:
        """Single-sample inference; the flat float32 output vector."""
        return self.batch_predict([input_vector])[0]

    def batch_predict(self, inputs: Sequence,
                      shapes: Optional[Sequence] = None) -> List[np.ndarray]:
        """Batched inference over a list of flat vectors: one flat float32
        output per input, in order."""
        return self.batch_collect(self.batch_submit(inputs, shapes=shapes))

    def batch_submit(self, inputs: Sequence,
                     shapes: Optional[Sequence] = None):
        """Enqueue the device work of ``inputs`` and return a handle for
        ``batch_collect`` without waiting for the card. ``shapes`` (the
        requests' ``shape`` fields) are ignored, as the JAX engine ignores
        them without shape buckets."""
        samples = [self._coerce_sample(v) for v in inputs]
        max_bucket = self._buckets[-1]
        pending = []
        for c0 in range(0, len(samples), max_bucket):
            chunk = samples[c0:c0 + max_bucket]
            wire = self._wire_bucket_for(max(s.size for s in chunk))
            pending.append(self._submit_chunk(
                chunk, self._bucket_for(len(chunk)), wire))
        return pending

    def _submit_chunk(self, chunk: List[np.ndarray], bucket: int,
                      wire: int):
        """(rows, host output, event): one bucket's forward enqueued, its
        output copied back to pinned host memory without blocking."""
        host_in = self._stage_wire(chunk, bucket, wire)
        with torch.inference_mode():
            xw = host_in.to(self.device, non_blocking=True)
            y = self._forward(xw, bucket).reshape(bucket, -1)
            event = None
            if self._cuda:
                out = torch.empty(y.shape, dtype=y.dtype, pin_memory=True)
                out.copy_(y, non_blocking=True)
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(self.device))
            else:
                out = y
        with self._stats_lock:
            self._execute_count += 1
        return len(chunk), out, event

    def handle_ready(self, handle) -> bool:
        """True when every chunk behind a ``batch_submit`` handle has
        finished on the card (non-blocking)."""
        return all(ev is None or ev.query() for _n, _out, ev in handle)

    def batch_collect(self, handle) -> List[np.ndarray]:
        """Wait for a ``batch_submit`` handle's results and split them per
        input."""
        t0 = time.perf_counter()
        try:
            out: List[np.ndarray] = []
            for n_real, host, ev in handle:
                if ev is not None:
                    ev.synchronize()
                rows = host.numpy()
                out.extend(rows[i] for i in range(n_real))
            return out
        finally:
            with self._stats_lock:
                self._collect_block_s += time.perf_counter() - t0

    # -- observability --------------------------------------------------------

    def stats(self) -> dict:
        with self._stats_lock:
            count, block = self._execute_count, self._collect_block_s
        return {"model": self.spec.name,
                "dtype": _dtype_name(self._dtype),
                "buckets": list(self._buckets),
                "wire_buckets": list(self._wire_buckets),
                "device": str(self.device),
                "execute_count": count,
                "collect_block_s": round(block, 4)}

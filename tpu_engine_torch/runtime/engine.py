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
  narrower than f32 and the model takes no token ids (a bf16 resnet's or
  yolo's inputs round to bf16 on the host, as in JAX); token-id models
  (the transformers, bert among them) always stage f32, exact for any id
  below 2^24.
- **Shape buckets** (``shape_buckets``, mixed-shape serving): a few
  per-sample input shapes, the model's own among them. A request that
  carries its ``shape`` runs on the smallest bucket that fits every dim
  (else the largest): its values fill a zero canvas of the bucket, dims
  too large cropped (``_coerce_shaped``). Requests group by bucket and
  chunk by the largest batch bucket; answers come back in request order.
  A canvas is staged as one full-width row of the same pinned wire (the
  model's first op rounds its input to the compute dtype either way, as
  the JAX engine's f32 canvas is rounded there).
- **Split phases.** ``batch_submit`` stages the wire in pinned host memory,
  enqueues the copy to the card, the forward and a non-blocking copy of
  the result back to pinned memory, then records a CUDA event; nothing in
  it waits for the card. ``handle_ready`` is the events' ``query()``, and
  ``batch_collect`` waits on them and splits the rows. ``batch_predict``
  is the two in a row.

- **Weight-only int8** (``quantize="int8"``): the engine's tree goes
  through ``ops.quant.quantize_params`` (dense and conv kernels and MoE
  expert stacks int8 with per-output-channel f32 scales; the MoE router
  stays full precision), at construction and at every ``set_params``.
  The generation lanes share the engine's params, so one flag quantizes
  every serving path of a worker. Random weights are drawn in f32 and
  quantized from f32, as JAX quantizes its f32 tree; a given tree is
  quantized as it is.
- **Mesh** (``mesh``, a ``parallel.mesh.Mesh``): every bucket's rows
  scatter over the ``data`` axis in equal slices (buckets round up to
  multiples of its size), each data rank runs the family's own apply on
  its slice on its device, and the outputs gather back to the home device
  (rank 0's) in row order. Parameters place by ``param_shardings``
  (``training.train.shard_params_tp``: split over ``model``) or whole on
  every rank; a data rank gathers each split leaf from its model ranks'
  shards on its device at every forward, so every family's apply runs
  unchanged and each rank's rows are the single-device engine's for the
  same rows, bit for bit (a product's bits may depend on its row count,
  so one whole-bucket forward can differ in the last bit). ``params``
  stays the
  whole tree on the home device, which the worker's generation and
  scoring paths share as on any lane.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from tpu_engine_torch.models.registry import ModelSpec, create_model
from tpu_engine_torch.ops.quant import quantize_params
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
        mesh=None,
        data_axis: str = "data",
        param_shardings=None,
    ):
        """``params``: the model's parameter tree on ``device``; None draws
        seeded random weights (``rng_seed``). ``device`` defaults to the
        CUDA card; pass ``device="cpu"`` to run on the CPU.
        ``shape_buckets``: per-sample input shapes for mixed-shape serving
        (the model's apply must take each, as a fully convolutional model
        does); the model's own shape is always one. ``quantize``: None or
        "int8" (weight-only, ``ops.quant``). ``mesh``: a
        ``parallel.mesh.Mesh`` the engine spans instead of one ``device``,
        batches split over ``data_axis``, parameters placed by
        ``param_shardings`` (default whole on every rank)."""
        if quantize is not None and quantize != "int8":
            raise ValueError(f"unsupported quantize mode '{quantize}' "
                             "(supported: int8)")
        if isinstance(model, str):
            model = create_model(model)
        if model.apply is None:
            raise ValueError(f"model '{model.name}' has no one-shot apply")
        self.spec = model
        if mesh is not None and device is not None:
            raise ValueError("pass either mesh or device, not both")
        if quantize is not None and mesh is not None \
                and param_shardings is not None:
            raise ValueError(
                "quantize=int8 with tensor-parallel param_shardings is "
                "unsupported (shard rules address 'kernel' paths); "
                "serve quantized on replicated/data meshes")
        self._mesh = mesh
        self._data_axis = data_axis
        self._data_size = 1 if mesh is None else mesh.shape[data_axis]
        self.device = mesh.home if mesh is not None else resolve_device(
            device)
        self._dtype = resolve_dtype(dtype)
        d = self._data_size
        # Every bucket splits evenly over the data axis.
        self._buckets = tuple(sorted({-(-max(1, int(b)) // d) * d
                                      for b in batch_buckets}))
        self._shape_buckets: Optional[Tuple[Tuple[int, ...], ...]] = None
        if shape_buckets is not None:
            shapes = {tuple(int(d) for d in sh) for sh in shape_buckets}
            shapes.add(tuple(model.input_shape))
            self._shape_buckets = tuple(sorted(
                shapes, key=lambda sh: (int(np.prod(sh)), sh)))
        self.quantize = quantize
        self.params = params if params is not None else model.init(
            rng_seed, device=self.device,
            dtype=torch.float32 if quantize else self._dtype)
        if quantize is not None:
            self.params = quantize_params(self.params)
        self._param_shardings = None
        self._placed = None
        if mesh is not None:
            from tpu_engine_torch.parallel.mesh import replicated

            self._param_shardings = (param_shardings
                                     if param_shardings is not None
                                     else replicated(mesh))
            self._place()
        self._cuda = self.device.type == "cuda"
        # Set by the owning worker, as on the JAX engine. The JAX engine
        # records an ``xla_compile`` span per bucket it compiles; the
        # eager port compiles nothing per bucket, so it records none.
        self.tracer = None
        self.trace_node = "engine"
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
        self._wire_dtype = (torch.float32
                            if self._dtype == torch.float32
                            or model.token_input else self._dtype)

    def set_params(self, params) -> None:
        """Swap in a new parameter tree of the served one's structure,
        leaf shapes and dtypes (refused otherwise, with the JAX engine's
        messages), placed on the engine's device. A quantizing engine
        quantizes the new tree first, so a reload serves int8 weights."""
        if self.quantize is not None:
            params = quantize_params(params)
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
        if self._mesh is not None:
            self._place()

    def _place(self) -> None:
        """The mesh ranks' trees of ``params`` (``parallel.mesh.place``)."""
        from tpu_engine_torch.parallel.mesh import place

        self._placed = place(self.params, self._param_shardings)

    # -- buckets and staging --------------------------------------------------

    @property
    def buckets(self) -> Tuple[int, ...]:
        return self._buckets

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

    def _shape_bucket_for(self, shape: Tuple[int, ...]) -> Tuple[int, ...]:
        """The smallest bucket that fits every dim; else the largest (the
        sample is cropped)."""
        for b in self._shape_buckets:
            if len(b) == len(shape) and all(bd >= sd
                                            for bd, sd in zip(b, shape)):
                return b
        return self._shape_buckets[-1]

    @staticmethod
    def _coerce_shaped(vec, shape: Tuple[int, ...],
                       bucket: Tuple[int, ...]) -> np.ndarray:
        """A sample of ``shape`` (zero-padded or truncated to its size) in
        a zero canvas of ``bucket``, dims that exceed the bucket's
        cropped; flat."""
        arr = np.asarray(vec, dtype=np.float32).ravel()
        n = int(np.prod(shape))
        if arr.size < n:
            arr = np.pad(arr, (0, n - arr.size))
        arr = arr[:n].reshape(shape)
        canvas = np.zeros(bucket, np.float32)
        region = tuple(slice(0, min(bd, sd)) for bd, sd in zip(bucket, shape))
        canvas[region] = arr[region]
        return canvas.ravel()

    def _stage_wire(self, samples: List[np.ndarray], bucket: int,
                    wire: int) -> torch.Tensor:
        """The (bucket, wire) host buffer in the wire dtype (pinned when the
        engine runs on the card), rows past the samples zero."""
        buf = np.zeros((bucket, wire), np.float32)
        for i, s in enumerate(samples):
            buf[i, :s.size] = s
        host = torch.from_numpy(buf).to(self._wire_dtype)
        return host.pin_memory() if self._cuda else host

    def _forward(self, params, xw: torch.Tensor,
                 shape: Tuple[int, ...]) -> torch.Tensor:
        """Zero-pad the wire's rows to the size of ``shape`` on their
        device, reshape to (rows, *shape) and run the forward on
        ``params``: (rows, -1) f32."""
        n_in = int(np.prod(shape))
        if xw.shape[1] < n_in:
            xw = F.pad(xw, (0, n_in - xw.shape[1]))
        x = xw.reshape((xw.shape[0],) + tuple(shape))
        return self.spec.apply(params, x, dtype=self._dtype).reshape(
            xw.shape[0], -1)

    def _run(self, host_in: torch.Tensor,
             shape: Tuple[int, ...]) -> torch.Tensor:
        """The forward of a staged (bucket, wire) host buffer: on the
        engine's device, or with a mesh each data rank's slice on its
        device over its gathered tree, the rows gathered back to the home
        device in order."""
        if self._mesh is None:
            return self._forward(self.params, host_in.to(
                self.device, non_blocking=True), shape)
        mesh = self._mesh
        return mesh.gather_batch([
            self._forward(self._placed.gathered(r), xw, shape)
            for r, xw in zip(mesh.data_ranks(self._data_axis),
                             mesh.scatter_batch(host_in, self._data_axis))])

    def warmup(self, buckets: Optional[Sequence[int]] = None) -> None:
        """Run every batch bucket at the narrowest and widest wire bucket,
        and the largest batch bucket at every wire bucket and at every
        shape bucket other than the model's own, once, so the first
        requests meet built kernels and a warm allocator."""
        ends = sorted({self._wire_buckets[0], self._wire_buckets[-1]})
        default = tuple(self.spec.input_shape)
        runs = [(self._bucket_for(b), w, default)
                for b in buckets or self._buckets for w in ends]
        runs += [(self._buckets[-1], w, default) for w in self._wire_buckets]
        runs += [(self._buckets[-1], int(np.prod(sh)), sh)
                 for sh in self._shape_buckets or () if sh != default]
        for bucket, wire, shape in dict.fromkeys(runs):
            self.batch_collect((bucket, [self._submit_chunk(
                [np.zeros((wire,), np.float32)] * bucket, bucket, wire,
                shape, range(bucket))]))

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
        ``batch_collect`` without waiting for the card: (the number of
        inputs, the chunks), each chunk (its rows' positions among the
        inputs, the host output, the event). ``shapes`` (the
        requests' ``shape`` fields, None entries for the model's own) take
        the shape buckets when the engine has them; without, they are
        ignored, as the JAX engine ignores them."""
        if (self._shape_buckets is not None and shapes is not None
                and any(sh is not None for sh in shapes)):
            return self._batch_submit_shaped(inputs, shapes)
        samples = [self._coerce_sample(v) for v in inputs]
        max_bucket = self._buckets[-1]
        default = tuple(self.spec.input_shape)
        pending = []
        for c0 in range(0, len(samples), max_bucket):
            chunk = samples[c0:c0 + max_bucket]
            wire = self._wire_bucket_for(max(s.size for s in chunk))
            pending.append(self._submit_chunk(
                chunk, self._bucket_for(len(chunk)), wire, default,
                range(c0, c0 + len(chunk))))
        return len(samples), pending

    def _batch_submit_shaped(self, inputs: Sequence, shapes: Sequence):
        """Mixed-shape dispatch: each sample on its shape bucket's canvas,
        the samples grouped by bucket, each group's chunks enqueued;
        ``batch_collect`` restores request order."""
        default = tuple(self.spec.input_shape)
        groups: Dict[Tuple[int, ...], List[int]] = {}
        canvases: List[np.ndarray] = []
        for i, (vec, shape) in enumerate(zip(inputs, shapes)):
            shape = default if shape is None else tuple(int(d) for d in shape)
            bucket = self._shape_bucket_for(shape)
            canvases.append(self._coerce_shaped(vec, shape, bucket))
            groups.setdefault(bucket, []).append(i)
        max_bucket = self._buckets[-1]
        pending = []
        for shape_bucket, idxs in groups.items():
            width = int(np.prod(shape_bucket))
            for c0 in range(0, len(idxs), max_bucket):
                chunk = idxs[c0:c0 + max_bucket]
                pending.append(self._submit_chunk(
                    [canvases[i] for i in chunk], self._bucket_for(len(chunk)),
                    width, shape_bucket, chunk))
        return len(inputs), pending

    def _submit_chunk(self, chunk: List[np.ndarray], bucket: int,
                      wire: int, shape: Tuple[int, ...], rows):
        """(rows, host output, event): one bucket's forward on (bucket,
        *shape) inputs enqueued, its output copied back to pinned host
        memory without blocking; ``rows`` are the requests' positions."""
        host_in = self._stage_wire(chunk, bucket, wire)
        with torch.inference_mode():
            y = self._run(host_in, shape)
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
        return list(rows), out, event

    def handle_ready(self, handle) -> bool:
        """True when every chunk behind a ``batch_submit`` handle has
        finished on the card (non-blocking)."""
        return all(ev is None or ev.query() for _rows, _out, ev in handle[1])

    def batch_collect(self, handle) -> List[np.ndarray]:
        """Wait for a ``batch_submit`` handle's results and split them per
        input, in request order."""
        t0 = time.perf_counter()
        try:
            n, pending = handle
            out: List[Optional[np.ndarray]] = [None] * n
            for rows, host, ev in pending:
                if ev is not None:
                    ev.synchronize()
                y = host.numpy()
                for j, i in enumerate(rows):
                    out[i] = y[j]
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
                "shape_buckets": (None if self._shape_buckets is None
                                  else [list(sh) for sh in
                                        self._shape_buckets]),
                "wire_buckets": list(self._wire_buckets),
                "device": str(self.device),
                "execute_count": count,
                "collect_block_s": round(block, 4),
                "mesh": None if self._mesh is None else {
                    "axes": dict(self._mesh.shape),
                    "n_devices": self._mesh.size}}

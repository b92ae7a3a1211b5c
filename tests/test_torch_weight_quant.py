"""The port's weight-only int8 quantization (tpu_engine_torch.ops.quant
``quantize_params`` and its kin, the ``kernel_q`` branches of ops.nn, and
``quantize`` on the engine and the worker) against the JAX package's, on
the CPU, with the same f32 weights filled from numpy:

- ``quantize_params`` and ``dequantize_params`` trees bit-equal to JAX's,
  carried across with the converters, on seven models (decoders, the MoE
  decoder, the encoder, the mlp, the recurrent decoder and yolov8n with
  its unquantized C2f lists); the rank and ``kind`` rules, the scale of 1
  for a zero channel, ``tree_is_quantized`` and ``param_bytes``;
- ``dense`` and ``conv2d`` over int8 kernels, with and without a compute
  dtype, within 1e-5 of JAX's (both sum exact products in f32), and in
  f32 within 1e-5 of the dequantized kernel's product (the rearrangement
  is exact up to the sum's rounding);
- the engine's quantized rows and ``set_params`` re-quantizing, a
  quantized worker's /generate and /infer, and a quantized recurrent lane,
  each against JAX's on the same weights; the refusals with JAX's
  messages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_engine.models.registry import (
    _ensure_builtin_models_imported,
    create_model as jcreate,
)
from tpu_engine.ops import nn as jnn
from tpu_engine.ops import quant as jq
from tpu_engine_torch.models import convert
from tpu_engine_torch.models.registry import create_model as tcreate
from tpu_engine_torch.ops import nn as tnn
from tpu_engine_torch.ops import quant as tq
from tpu_engine_torch.training.train import tree_leaves

_ensure_builtin_models_imported()

TOL = 1e-5
MODEL_TOL = 1e-4
MODELS = ["gpt2-small-test", "llama-small-test", "gpt2-moe-test",
          "bert-small-test", "mlp", "ssd-small-test", "yolov8n-small-test"]


def numpy_params(name, seed=0):
    """A JAX parameter tree of ``name`` (the shapes of its init, traced but
    not run) filled from numpy, f32: He-normal kernels (one output
    channel of the first kernel all zero), batch norm statistics near 1,
    the rest small normals."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(jcreate(name).init, jax.random.PRNGKey(0))
    zeroed = []

    def leaf(path, sd):
        key, shape = path[-1].key, sd.shape
        if key == "kernel":
            std = (2.0 / np.prod(shape[:-1])) ** 0.5
            out = (rng.standard_normal(shape) * std).astype(np.float32)
            if not zeroed:
                out[..., 0] = 0.0
                zeroed.append(path)
            return out
        if key in ("scale", "var"):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        return (rng.standard_normal(shape) * 0.1).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def to_port(name, tree):
    """The converter that carries ``name``'s JAX tree across, in f32."""
    cfg = tcreate(name).config
    if name == "ssd-small-test":
        return convert.ssd_params_from_jax(tree, cfg, device="cpu")
    if name in ("mlp", "yolov8n-small-test"):
        cfg = None
    return convert.params_from_jax(tree, cfg, device="cpu",
                                   dtype="float32")


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _paths(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, list):
        return [p for i, v in enumerate(tree)
                for p in _paths(v, f"{prefix}/{i}")]
    return [prefix]


def assert_trees_equal(got, want):
    assert _paths(got) == _paths(want)
    for path, a, b in zip(_paths(got), tree_leaves(got), tree_leaves(want)):
        assert a.dtype == b.dtype, path
        assert torch.equal(a, b), path


_TREES = {}


def trees(name):
    """(JAX f32 tree as numpy, its quantized tree as numpy), made once."""
    if name not in _TREES:
        tree = numpy_params(name)
        qtree = jax.tree.map(np.asarray, jq.quantize_params(
            jax.tree.map(jnp.asarray, tree)))
        _TREES[name] = (tree, qtree)
    return _TREES[name]


@pytest.mark.parametrize("name", MODELS)
def test_quantize_params_bit_equal_to_jax(name):
    tree, qtree = trees(name)
    got = tq.quantize_params(to_port(name, tree))
    assert_trees_equal(got, to_port(name, qtree))
    assert tq.tree_is_quantized(got)
    assert not tq.tree_is_quantized(to_port(name, tree))
    # Idempotent.
    assert_trees_equal(tq.quantize_params(got), got)
    # Bytes: the same leaves as JAX's, split per layer.
    assert tq.param_bytes(got) == jq.param_bytes(qtree)
    assert tq.param_bytes(to_port(name, tree)) == jq.param_bytes(tree)


@pytest.mark.parametrize("name", MODELS)
def test_dequantize_params_bit_equal_to_jax(name):
    _, qtree = trees(name)
    got = tq.dequantize_params(to_port(name, qtree))
    want = to_port(name, jax.tree.map(np.asarray, jq.dequantize_params(
        jax.tree.map(jnp.asarray, qtree))))
    assert_trees_equal(got, want)


def test_tree_rules():
    tree, qtree = trees("gpt2-moe-test")
    q = to_port("gpt2-moe-test", qtree)
    mlp = q["blocks"][0]["mlp"]
    # The router stays full precision; the expert stacks quantize with a
    # scale per (expert, output channel).
    assert "kernel" in mlp["gate"] and "kernel_q" not in mlp["gate"]
    assert mlp["wi_q"].dtype == torch.int8 and "wi" not in mlp
    assert tuple(mlp["wi_scale"].shape) == (4, 128)
    assert tq.is_quantized(q["head"]) and not tq.is_quantized(q["ln_f"])
    assert "table" in q["tok_embed"]
    # yolo's C2f bottleneck lists pass through unquantized, as JAX's
    # dict-only recursion leaves them.
    ytree, yq = trees("yolov8n-small-test")
    y = tq.quantize_params(to_port("yolov8n-small-test", ytree))
    assert "kernel" in y["c2f1"]["m"][0]["cv1"]["conv"]
    assert "kernel" in yq["c2f1"]["m"][0]["cv1"]["conv"]
    assert "kernel_q" in y["c2f1"]["cv1"]["conv"]
    k = y["stem"]["conv"]["kernel_q"]
    assert k.is_contiguous(memory_format=torch.channels_last)


def test_quantize_kernel_rank_and_kind_rules():
    rng = np.random.default_rng(1)
    cases = [((16, 8), None, (8,)), ((3, 16, 8), None, (3, 8)),
             ((2, 4, 16, 8), "dense", (2, 4, 8))]
    for shape, kind, scale_shape in cases:
        k = (rng.standard_normal(shape) * 3).astype(np.float32)
        k[..., 1] = 0.0
        jqk, js = jq.quantize_kernel(jnp.asarray(k), kind)
        q, s = tq.quantize_kernel(torch.from_numpy(k), kind)
        assert q.dtype == torch.int8 and tuple(s.shape) == scale_shape
        np.testing.assert_array_equal(q.numpy(), np.asarray(jqk))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        assert bool((s[..., 1] == 1.0).all()) and not bool(q[..., 1].any())
        back = tq.dequantize_kernel(q, s, kind)
        np.testing.assert_array_equal(
            back.numpy(), np.asarray(jq.dequantize_kernel(jqk, js))
            if kind is None else
            np.asarray(jqk).astype(np.float32) * np.asarray(js)[..., None, :])
    # Conv: HWIO in JAX, OIHW in the port; the same bytes and scales.
    for shape in ((3, 3, 8, 16), (2, 3, 3, 8, 16)):
        k = rng.standard_normal(shape).astype(np.float32)
        jqk, js = jq.quantize_kernel(jnp.asarray(k))
        perm = (3, 2, 0, 1) if len(shape) == 4 else (0, 4, 3, 1, 2)
        q, s = tq.quantize_kernel(torch.from_numpy(k).permute(*perm))
        np.testing.assert_array_equal(
            q.numpy(), np.asarray(jqk).transpose(*perm))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    for bad in ((8,), (1, 2, 3, 4, 5, 6)):
        with pytest.raises(ValueError) as want:
            jq.quantize_kernel(jnp.zeros(bad))
        with pytest.raises(ValueError) as got:
            tq.quantize_kernel(torch.zeros(bad))
        assert str(got.value) == str(want.value)


# -- dense and conv2d over int8 kernels -------------------------------------

@pytest.mark.parametrize("dtype", [None, "bfloat16", "float32"])
def test_dense_int8_matches_jax(dtype):
    rng = np.random.default_rng(2)
    p = {"kernel": rng.standard_normal((32, 16)).astype(np.float32),
         "bias": rng.standard_normal(16).astype(np.float32)}
    x = rng.standard_normal((4, 5, 32)).astype(np.float32)
    jp = jq.quantize_params(jax.tree.map(jnp.asarray, p))
    tp = tq.quantize_params({k: torch.from_numpy(v) for k, v in p.items()})
    jdt = None if dtype is None else getattr(jnp, dtype)
    tdt = None if dtype is None else getattr(torch, dtype)
    want = np.asarray(jnn.dense(jp, jnp.asarray(x), dtype=jdt))
    got = tnn.dense(tp, torch.from_numpy(x), dtype=tdt)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    if dtype != "bfloat16":
        # In f32 the scale on the output is the dequantized kernel's
        # product (a bf16 compute dtype would round that kernel).
        deq = tnn.dense(tq.dequantize_params(tp), torch.from_numpy(x),
                        dtype=tdt)
        np.testing.assert_allclose(got.numpy(), deq.numpy(), atol=TOL,
                                   rtol=TOL)
    if dtype is None:
        # No dtype: the int8 kernel goes to x's dtype (bf16 here).
        xb = torch.from_numpy(x).bfloat16()
        got = tnn.dense(tp, xb)
        want = np.asarray(jnn.dense(jp, jnp.asarray(x).astype(jnp.bfloat16)))
        np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
@pytest.mark.parametrize("stride", [1, 2])
def test_conv2d_int8_matches_jax(dtype, stride):
    rng = np.random.default_rng(3)
    k = rng.standard_normal((3, 3, 8, 16)).astype(np.float32)
    x = rng.standard_normal((2, 10, 10, 8)).astype(np.float32)
    jp = jq.quantize_params({"kernel": jnp.asarray(k)})
    tp = tq.quantize_params({"kernel": torch.from_numpy(k).permute(
        3, 2, 0, 1).contiguous(memory_format=torch.channels_last)})
    jdt = None if dtype is None else getattr(jnp, dtype)
    tdt = None if dtype is None else getattr(torch, dtype)
    want = np.asarray(jnn.conv2d(jp, jnp.asarray(x), stride=stride,
                                 dtype=jdt))
    tx = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = tnn.conv2d(tp, tx, stride=stride, dtype=tdt)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=TOL, rtol=TOL)
    if dtype is None:
        deq = tnn.conv2d(tq.dequantize_params(tp), tx, stride=stride)
        np.testing.assert_allclose(got.numpy(), deq.numpy(), atol=TOL,
                                   rtol=TOL)


# -- the engine and the worker ----------------------------------------------

@pytest.mark.parametrize("name", ["mlp", "gpt2-small-test"])
def test_engine_quantized_rows_and_reload_match_jax(name):
    from tpu_engine.runtime.engine import InferenceEngine as JaxEngine
    from tpu_engine_torch.runtime.engine import InferenceEngine

    tree, qtree = trees(name)
    je = JaxEngine(jcreate(name), params=jax.tree.map(jnp.asarray, tree),
                   dtype="float32", quantize="int8", batch_buckets=(4,))
    te = InferenceEngine(tcreate(name), params=to_port(name, tree),
                         dtype="float32", quantize="int8", device="cpu",
                         batch_buckets=(4,))
    assert_trees_equal(te.params, to_port(name, qtree))
    rng = np.random.default_rng(4)
    n = tcreate(name).input_size
    rows = [rng.integers(1, 200, n).astype(np.float32) for _ in range(3)]
    for got, want in zip(te.batch_predict(rows), je.batch_predict(rows)):
        np.testing.assert_allclose(got, want, atol=MODEL_TOL, rtol=MODEL_TOL)
    # A reload of f32 weights serves them quantized.
    tree2 = numpy_params(name, seed=1)
    je.set_params(jax.tree.map(jnp.asarray, tree2))
    te.set_params(to_port(name, tree2))
    assert_trees_equal(te.params, to_port(name, jax.tree.map(
        np.asarray, je.params)))
    for got, want in zip(te.batch_predict(rows), je.batch_predict(rows)):
        np.testing.assert_allclose(got, want, atol=MODEL_TOL, rtol=MODEL_TOL)


def test_engine_quantizes_its_own_f32_draw():
    from tpu_engine_torch.runtime.engine import InferenceEngine

    te = InferenceEngine("gpt2-moe-test", device="cpu", quantize="int8")
    f32 = tcreate("gpt2-moe-test").init(0, device="cpu", dtype="float32")
    assert_trees_equal(te.params, tq.quantize_params(f32))
    assert te.params["blocks"][0]["mlp"]["gate"]["kernel"].dtype == \
        torch.float32
    out = te.predict(np.array([5.0, 9.0, 3.0], np.float32))
    assert out.shape == (256,) and np.isfinite(out).all()


def test_refusals_carry_jax_messages():
    from tpu_engine.runtime.engine import InferenceEngine as JaxEngine
    from tpu_engine.serving.worker import WorkerNode as JaxWorker
    from tpu_engine.utils.config import WorkerConfig as JaxConfig
    from tpu_engine_torch.runtime.engine import InferenceEngine
    from tpu_engine_torch.serving.worker import WorkerNode
    from tpu_engine_torch.utils.config import WorkerConfig

    with pytest.raises(ValueError) as want:
        JaxEngine("mlp", quantize="int4")
    with pytest.raises(ValueError) as got:
        InferenceEngine("mlp", device="cpu", quantize="int4")
    assert str(got.value) == str(want.value)
    with pytest.raises(RuntimeError) as want:
        JaxWorker(JaxConfig(node_id="q", model_path="m.onnx",
                            quantize="int8"))
    with pytest.raises(RuntimeError) as got:
        WorkerNode(WorkerConfig(node_id="q", model_path="m.onnx",
                                quantize="int8", device="cpu"))
    assert str(got.value) == str(want.value)


def test_quantized_worker_matches_jax():
    from tpu_engine.runtime.engine import InferenceEngine as JaxEngine
    from tpu_engine.serving.worker import WorkerNode as JaxWorker
    from tpu_engine.utils.config import WorkerConfig as JaxConfig
    from tpu_engine_torch.serving.worker import WorkerNode
    from tpu_engine_torch.utils.config import WorkerConfig

    name = "gpt2-small-test"
    tree, _ = trees(name)
    lane = dict(gen_kv_block_size=16, gen_prefill_chunk=16,
                gen_mixed_step=True, gen_mixed_token_budget=16)
    w = WorkerNode(WorkerConfig(node_id="q8", model=name, dtype="float32",
                                device="cpu", quantize="int8", **lane),
                   params=to_port(name, tree))
    jw = JaxWorker(JaxConfig(node_id="q8", model=name, dtype="float32",
                             quantize="int8", **lane),
                   engine=JaxEngine(jcreate(name),
                                    params=jax.tree.map(jnp.asarray, tree),
                                    dtype="float32", quantize="int8"))
    try:
        assert tq.tree_is_quantized(w.engine.params)
        assert w.generator is not None
        for prompt in ([5, 9], [7, 2, 11, 40, 3]):
            req = {"request_id": "g", "prompt_tokens": prompt,
                   "max_new_tokens": 6}
            assert w.handle_generate(dict(req))["tokens"] == \
                jw.handle_generate(dict(req))["tokens"]
        x = [5.0, 9.0, 3.0]
        np.testing.assert_allclose(
            w.handle_infer({"request_id": "i", "input_data": x})[
                "output_data"],
            jw.handle_infer({"request_id": "i", "input_data": x})[
                "output_data"], atol=MODEL_TOL, rtol=MODEL_TOL)
    finally:
        w.stop()
        jw.stop()


def test_quantized_recurrent_lane_matches_jax():
    from tpu_engine.runtime.scheduler import ContinuousGenerator as JaxGen
    from tpu_engine_torch.runtime.scheduler import ContinuousGenerator

    name = "ssd-small-test"
    tree, qtree = trees(name)
    kw = dict(n_slots=4, step_chunk=2, prefill_chunk=8, mixed_step=True,
              mixed_token_budget=6, dtype="float32")
    jg = JaxGen(jcreate(name), params=jax.tree.map(jnp.asarray, qtree), **kw)
    tg = ContinuousGenerator(tcreate(name), device="cpu",
                             params=tq.quantize_params(to_port(name, tree)),
                             **kw)
    try:
        for prompt in ([5, 9, 3, 17, 44, 2, 8, 11, 23], [7, 2]):
            assert tg.generate([prompt], max_new_tokens=8) == \
                jg.generate([prompt], max_new_tokens=8)
    finally:
        jg.stop()
        tg.stop()

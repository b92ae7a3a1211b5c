"""``yolov8n-small-test`` in the port (``tpu_engine_torch.models.yolo``)
against the JAX package's on the same weights (``params_from_jax``), and the
port engine's shape buckets (mixed-shape serving, BASELINE config 4)
against JAX's ``InferenceEngine(shape_buckets=...)``, then the worker's
/infer with a ``shape`` field on both lanes. All on the CPU.

Tolerances: f32 1e-4 absolute on head maps of magnitude <= 1 (the same
convolutions summed in another order); bf16 1e-4 as well: both round the
input and every conv's operands to bf16 and sum in f32. One more number
differs: XLA's CPU rsqrt of the batch norm's var + eps is one ulp from
the correctly rounded value the port computes, and at the model's own
shape that ulp flips a bf16 rounding, so the bf16 engine row there misses
1e-4 (test_batchnorm_scale_is_the_one_difference_from_xla_cpu; with
XLA's value substituted every row agrees,
test_engine_rows_match_jax_with_xla_batchnorm_scale).
"""

from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpu_engine.models.registry import (
    _ensure_builtin_models_imported,
    create_model as jcreate,
)
from tpu_engine.runtime.engine import InferenceEngine as JaxEngine
from tpu_engine_torch.models.convert import params_from_jax
from tpu_engine_torch.models.registry import create_model as tcreate
from tpu_engine_torch.models.yolo import YoloConfig, n_anchors
from tpu_engine_torch.runtime.engine import InferenceEngine
from tpu_engine_torch.serving.worker import WorkerNode
from tpu_engine_torch.utils.config import WorkerConfig

_ensure_builtin_models_imported()

TOL = 1e-4
NAME = "yolov8n-small-test"
BUCKETS = ((32, 32, 3), (64, 64, 3), (96, 96, 3))


@pytest.fixture(scope="module")
def models():
    jspec = jcreate(NAME)
    jparams = jspec.init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    return jspec, jparams, tree


def _tparams(tree, dtype="float32"):
    return params_from_jax(tree, device="cpu", dtype=dtype)


def test_spec_and_config_match_jax(models):
    jspec, _, _ = models
    tspec = tcreate(NAME)
    assert isinstance(tspec.config, YoloConfig)
    assert tspec.config.__dict__ == jspec.config.__dict__
    assert (tspec.input_shape, tspec.output_shape) == (jspec.input_shape,
                                                       jspec.output_shape)
    assert tspec.state_family == "stateless" and not tspec.token_input
    full = tcreate("yolov8n")
    assert full.output_shape == (8400, 144)
    assert n_anchors(320, 320) == 2100 and n_anchors(480, 480) == 4725


def test_random_init_has_the_jax_tree(models):
    _, _, tree = models
    tp = tcreate(NAME).init(0, device="cpu", dtype="float32")
    want = jax.tree_util.tree_structure(tree)
    got = jax.tree_util.tree_structure(
        jax.tree.map(lambda t: 0, tp, is_leaf=torch.is_tensor))
    assert got == jax.tree_util.tree_structure(
        jax.tree.map(lambda t: 0, tree))
    assert want.num_leaves == got.num_leaves


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hw", [(64, 64), (32, 96)])
def test_forward_matches_jax(models, dtype, hw):
    jspec, jparams, tree = models
    tspec = tcreate(NAME)
    x = np.random.default_rng(hw[0] + hw[1]).standard_normal(
        (2, hw[0], hw[1], 3)).astype(np.float32)
    want = np.asarray(jspec.apply(jparams, jnp.asarray(x),
                                  dtype=getattr(jnp, dtype)))
    got = tspec.apply(_tparams(tree, dtype), torch.from_numpy(x),
                      dtype=getattr(torch, dtype)).numpy()
    assert got.shape == (2, n_anchors(*hw), tspec.config.head_ch)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("shape,bucket", [
    ((32, 32, 3), (32, 32, 3)),      # exact
    ((20, 30, 3), (32, 32, 3)),      # smallest that fits
    ((33, 10, 3), (64, 64, 3)),
    ((100, 20, 3), (96, 96, 3)),     # fits none: the largest, cropped
    ((64, 64), (96, 96, 3)),         # another rank fits none
])
def test_shape_bucket_for_matches_jax(models, shape, bucket):
    jspec, jparams, tree = models
    je = JaxEngine(jspec, params=jparams, dtype="float32",
                   shape_buckets=BUCKETS)
    te = InferenceEngine(NAME, params=_tparams(tree), dtype="float32",
                         shape_buckets=BUCKETS, device="cpu")
    assert te._shape_bucket_for(shape) == je._shape_bucket_for(shape) == \
        bucket


@pytest.mark.parametrize("n,shape", [
    (20 * 30 * 3, (20, 30, 3)),      # a full sample padded onto its canvas
    (50, (20, 30, 3)),               # a short sample zero-padded first
    (100 * 20 * 3 + 7, (100, 20, 3)),  # too long, and cropped
])
def test_coerce_shaped_matches_jax(n, shape):
    vec = np.arange(n, dtype=np.float32)
    bucket = (96, 96, 3) if shape[0] > 64 else (32, 32, 3)
    want = JaxEngine._coerce_shaped(None, vec, shape, bucket)
    got = InferenceEngine._coerce_shaped(vec, shape, bucket)
    np.testing.assert_array_equal(got, want.ravel())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_engine_shape_buckets_match_jax(models, dtype):
    """One mixed batch of five shapes, the 3-float reference payload with
    the model's default shape, and more rows than the largest batch
    bucket: each row equals JAX's engine's, in request order."""
    jspec, jparams, tree = models
    je = JaxEngine(jspec, params=jparams, dtype=dtype, batch_buckets=(1, 2),
                   shape_buckets=BUCKETS)
    te = InferenceEngine(NAME, params=_tparams(tree, dtype), dtype=dtype,
                         batch_buckets=(1, 2), shape_buckets=BUCKETS,
                         device="cpu")
    rng = np.random.default_rng(4)
    shapes = [(64, 64, 3), (32, 32, 3), (20, 30, 3), (96, 96, 3),
              None, (100, 20, 3), (32, 32, 3)]
    inputs = [rng.standard_normal(
        int(np.prod(s)) if s else 3).astype(np.float32) for s in shapes]
    want = je.batch_predict(inputs, shapes=shapes)
    got = te.batch_predict(inputs, shapes=shapes)
    for s, w, g in zip(shapes, want, got):
        b = te._shape_bucket_for(s or (64, 64, 3))
        assert g.shape == w.shape == (n_anchors(b[0], b[1]) * 20,)
        np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL)
    assert te.stats()["shape_buckets"] == [list(b) for b in BUCKETS]
    # Without shapes the flat path serves the model's own shape.
    flat = te.batch_predict([inputs[0]])[0]
    np.testing.assert_allclose(flat, got[0], atol=TOL, rtol=TOL)


def test_engine_warmup_covers_shape_buckets(models):
    _, _, tree = models
    te = InferenceEngine(NAME, params=_tparams(tree), dtype="float32",
                         batch_buckets=(1, 2), shape_buckets=BUCKETS,
                         device="cpu")
    te.warmup()
    # 2 batch buckets x 2 wire ends, 3 wire buckets at B 2 (one repeat),
    # and the two shape buckets other than the model's own.
    assert te.stats()["execute_count"] == 4 + 2 + 2
    te2 = InferenceEngine(NAME, params=_tparams(tree), dtype="float32",
                          batch_buckets=(1, 2), device="cpu")
    te2.warmup()
    assert te2.stats()["execute_count"] == 6


def test_wire_dtype_follows_token_input(models):
    """bf16 wire for the image model (as JAX's non-token models), f32 for
    the token-id encoder."""
    _, _, tree = models
    te = InferenceEngine(NAME, params=_tparams(tree, "bfloat16"),
                         device="cpu")
    assert te._wire_dtype == torch.bfloat16
    be = InferenceEngine("bert-small-test", device="cpu")
    assert be._wire_dtype == torch.float32


@pytest.mark.parametrize("unified", [True, False])
def test_worker_infer_with_shape(models, unified):
    """/infer with ``shape`` on both lanes: each answer is JAX's engine's
    row; the cache key holds the shape (same data, another shape: a miss
    with another answer; a repeat: a hit); concurrent identical requests
    coalesce only with the same shape."""
    jspec, jparams, tree = models
    je = JaxEngine(jspec, params=jparams, dtype="float32",
                   shape_buckets=BUCKETS)
    w = WorkerNode(WorkerConfig(model=NAME, dtype="float32", device="cpu",
                                batch_buckets=(1, 2, 4),
                                shape_buckets=BUCKETS,
                                unified_stateless=unified),
                   params=_tparams(tree))
    try:
        data = np.random.default_rng(9).standard_normal(32 * 32 * 3)
        data = data.astype(np.float32).tolist()
        outs = {}
        for s in ((32, 32, 3), (64, 64, 3)):
            r = w.handle_infer({"request_id": f"s{s[0]}", "input_data": data,
                                "shape": list(s)})
            assert not r["cached"]
            want = je.batch_predict([data], shapes=[s])[0]
            np.testing.assert_allclose(r["output_data"], want, atol=TOL,
                                       rtol=TOL)
            outs[s] = r["output_data"]
        assert len(outs[(32, 32, 3)]) != len(outs[(64, 64, 3)])
        again = w.handle_infer({"request_id": "a", "input_data": data,
                                "shape": [32, 32, 3]})
        assert again["cached"] and again["output_data"] == outs[(32, 32, 3)]
        assert w._cache_key(data, (32, 32, 3)) != w._cache_key(
            data, (64, 64, 3)) != w._cache_key(data)
        # Concurrent identical data under two new shapes: two answers.
        data2 = [0.5] * 12
        res, barrier = {}, threading.Barrier(4)

        def go(i, shape):
            barrier.wait()
            res[i] = w.handle_infer({"request_id": f"c{i}",
                                     "input_data": data2, "shape": shape})

        ts = [threading.Thread(target=go, args=(i, s)) for i, s in
              enumerate([[20, 20, 3], [20, 20, 3], [40, 40, 3],
                         [40, 40, 3]])]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert len(res) == 4
        assert res[0]["output_data"] == res[1]["output_data"]
        assert res[2]["output_data"] == res[3]["output_data"]
        assert len(res[0]["output_data"]) == n_anchors(32, 32) * 20
        assert len(res[2]["output_data"]) == n_anchors(64, 64) * 20
    finally:
        w.stop()


def test_batchnorm_scale_is_the_one_difference_from_xla_cpu():
    """What keeps the bf16 (64, 64, 3) row of
    test_engine_shape_buckets_match_jax apart from JAX's (by ~4e-4 on
    100 of its outputs): the inverse standard deviation of the identity
    batch norm. XLA's CPU rsqrt is an approximation that misses the
    correctly rounded 1/sqrt(1 + 1e-5) by one ulp, which torch.rsqrt (and
    so the port's nn.batchnorm) returns. That ulp moves the batch norms'
    outputs in their last bits, and one of them rounds the next conv's
    bf16 operand the other way; the convolutions' own f32 summation order
    flips no rounding at this input (the next test). Reproducing
    XLA's approximation would take the CPU's rsqrt table, which no
    specification fixes bit for bit."""
    from tpu_engine_torch.ops import nn as tnn

    v = np.float32(1.0 + 1e-5)
    xla = np.asarray(jax.lax.rsqrt(jnp.asarray([v])))[0]
    exact = np.float32(1 / np.sqrt(np.float64(v)))
    port = tnn.batchnorm({"var": torch.tensor([1.0]),
                          "scale": torch.tensor([1.0]),
                          "bias": torch.tensor([0.0]),
                          "mean": torch.tensor([0.0])},
                         torch.ones(1, 1, 1, 1)).item()
    assert np.float32(port) == exact
    # One ulp apart on the AVX-512 hosts the tests run on; within one
    # wherever XLA's approximation lands.
    ulps = int(xla.view(np.int32)) - int(exact.view(np.int32))
    assert abs(ulps) <= 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_engine_rows_match_jax_with_xla_batchnorm_scale(models, dtype,
                                                        monkeypatch):
    """test_engine_shape_buckets_match_jax's batch with the port's batch
    norm given XLA's rsqrt of var + eps (the one number the test above
    shows apart): every row, the model's own shape included, agrees with
    JAX's engine within TOL in both dtypes."""
    from tpu_engine_torch.ops import nn as tnn

    def batchnorm(params, x, eps=1e-5):
        var = (params["var"] + eps).numpy()
        inv = torch.from_numpy(np.asarray(jax.lax.rsqrt(
            jnp.asarray(var)))) * params["scale"]
        shift = params["bias"] - params["mean"] * inv
        return x * inv[:, None, None] + shift[:, None, None]

    monkeypatch.setattr(tnn, "batchnorm", batchnorm)
    jspec, jparams, tree = models
    je = JaxEngine(jspec, params=jparams, dtype=dtype, batch_buckets=(1, 2),
                   shape_buckets=BUCKETS)
    te = InferenceEngine(NAME, params=_tparams(tree, dtype), dtype=dtype,
                         batch_buckets=(1, 2), shape_buckets=BUCKETS,
                         device="cpu")
    rng = np.random.default_rng(4)
    shapes = [(64, 64, 3), (32, 32, 3), (20, 30, 3), (96, 96, 3),
              None, (100, 20, 3), (32, 32, 3)]
    inputs = [rng.standard_normal(
        int(np.prod(s)) if s else 3).astype(np.float32) for s in shapes]
    for w, g in zip(je.batch_predict(inputs, shapes=shapes),
                    te.batch_predict(inputs, shapes=shapes)):
        np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL)

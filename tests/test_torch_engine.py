"""The port's InferenceEngine (tpu_engine_torch.runtime.engine) against the
JAX package's on the same weights and inputs, on the CPU: batch_predict
over 1, 3 and 33 samples (bucket padding, and chunking at the largest
bucket), truncation of oversize inputs, the wire buckets (a 3-float
payload on the 128 bucket), bf16 wire rounding, the f32 wire of token-id
models, the split phases, and the set_params refusals.

Tolerances, as max|port - jax| / max|jax| per output: f32 1e-4, bf16
2e-2."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_engine.models.registry import (
    _ensure_builtin_models_imported,
    create_model as jcreate,
)
from tpu_engine.runtime.engine import InferenceEngine as JaxEngine
from tpu_engine_torch.models.convert import params_from_jax
from tpu_engine_torch.models.registry import create_model as tcreate
from tpu_engine_torch.runtime.engine import InferenceEngine

_ensure_builtin_models_imported()

TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def engines(name, dtype, buckets=(1, 2, 4, 8, 16, 32), **kw):
    """The JAX engine and the port's on the same weights (for the resnets
    the shapes of the JAX init filled from numpy: He-normal kernels,
    batch norm with its own statistics)."""
    jspec = jcreate(name, **kw)
    if name.startswith("resnet"):
        from test_torch_infer_models import numpy_params

        jparams = numpy_params(name)
    else:
        jparams = jax.jit(jspec.init)(jax.random.PRNGKey(0))
    je = JaxEngine(jspec, params=jparams, dtype=dtype, batch_buckets=buckets)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              getattr(jspec, "config", None),
                              device="cpu", dtype=dtype)
    te = InferenceEngine(tcreate(name, **kw), params=tparams, dtype=dtype,
                         batch_buckets=buckets, device="cpu")
    return je, te


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def mlp_pair(request):
    return request.param, engines("mlp", request.param)


@pytest.mark.parametrize("n", [1, 3, 33])
def test_batch_predict_matches_jax(mlp_pair, n):
    dtype, (je, te) = mlp_pair
    rng = np.random.default_rng(n)
    # Ragged inputs: short ones zero-pad, a long one truncates.
    inputs = [rng.standard_normal(int(rng.integers(1, 20))).astype(
        np.float32).tolist() for _ in range(n)]
    got = te.batch_predict(inputs)
    want = je.batch_predict(inputs)
    assert len(got) == len(want) == n
    for g, w in zip(got, want):
        assert g.shape == w.shape == (16,) and g.dtype == np.float32
        assert rel_err(g, w) <= TOL[dtype]
    # 33 samples: a chunk of 32 and one of 1; n = 3 pads to bucket 4.
    assert te.stats()["execute_count"] >= (2 if n == 33 else 1)


def test_oversize_inputs_truncate(mlp_pair):
    _, (je, te) = mlp_pair
    x = np.random.default_rng(5).standard_normal(24).astype(np.float32)
    assert np.array_equal(te.predict(x), te.predict(x[:16]))
    assert np.array_equal(je.predict(x), je.predict(x[:16]))
    assert te._coerce_sample(x).size == 16


def test_split_phases_equal_batch_predict(mlp_pair):
    _, (_je, te) = mlp_pair
    rng = np.random.default_rng(6)
    inputs = [rng.standard_normal(16).astype(np.float32) for _ in range(5)]
    handle = te.batch_submit(inputs)
    assert te.handle_ready(handle)  # the CPU computes inside submit
    split = te.batch_collect(handle)
    whole = te.batch_predict(inputs)
    assert all(np.array_equal(a, b) for a, b in zip(split, whole))
    assert te.batch_collect(te.batch_submit([])) == []


@pytest.fixture(scope="module")
def resnet_pair():
    """resnet50 at 32 x 32 (input size 3072, so wire buckets 128, 1024,
    3072) in bf16."""
    return engines("resnet50", "bfloat16", buckets=(1, 2, 4), image_size=32)


def test_wire_buckets_and_the_3_float_payload(resnet_pair):
    je, te = resnet_pair
    assert te._wire_buckets == je._wire_buckets == (128, 1024, 3072)
    assert te._wire_bucket_for(3) == 128
    assert te._wire_bucket_for(129) == 1024
    assert te._wire_bucket_for(10 ** 6) == 3072
    got, want = te.predict([1.0, 2.0, 3.0]), je.predict([1.0, 2.0, 3.0])
    assert got.shape == (1000,) and rel_err(got, want) <= TOL["bfloat16"]


def test_bf16_wire_rounds_on_the_host(resnet_pair):
    """A bf16 image model's wire is bf16: the inputs round to bf16 on the
    host, so an input and its bf16 rounding give the same bits; the JAX
    engine stages the same bf16 values."""
    je, te = resnet_pair
    assert te._wire_dtype == torch.bfloat16
    assert np.dtype(je._wire_np_dtype) == np.dtype(jnp.bfloat16)
    x = (1.0 + np.random.default_rng(7).random(300) / 64).astype(np.float32)
    rounded = torch.from_numpy(x).bfloat16().float().numpy()
    assert not np.array_equal(x, rounded)
    staged = te._stage_wire([x], 1, 1024)
    assert staged.dtype == torch.bfloat16
    assert np.array_equal(staged[0, :300].float().numpy(), rounded)
    assert np.array_equal(te.predict(x), te.predict(rounded))
    assert rel_err(te.predict(x), je.predict(x)) <= TOL["bfloat16"]


def test_token_id_models_stage_f32():
    """Token ids above 256 are not bf16 numbers: a decoder's wire is f32
    even in bf16, and its /infer output is the last non-pad position's
    logits, as the JAX engine's."""
    je, te = engines("gpt2-chaos-test", "bfloat16", buckets=(1, 2))
    assert te._wire_dtype == torch.float32
    ids = [301.0, 777.0, 5.0, 1023.0]
    staged = te._stage_wire([np.asarray(ids, np.float32)], 1, 16)
    assert staged[0, :4].tolist() == ids
    got, want = te.predict(ids), je.predict(ids)
    assert got.shape == (1024,) and rel_err(got, want) <= TOL["bfloat16"]
    shifted = te.predict([302.0, 777.0, 5.0, 1023.0])
    assert not np.array_equal(got, shifted)


def test_set_params_refusals_match_jax():
    je, te = engines("mlp", "float32")
    jp = je.params
    tp = te.params
    # Another tree structure.
    with pytest.raises(ValueError) as want:
        je.set_params({"layer_0": jp["layer_0"]})
    with pytest.raises(ValueError) as got:
        te.set_params({"layer_0": tp["layer_0"]})
    assert str(got.value) == str(want.value)
    # A leaf of another shape (leaf 3: layer_1's kernel).
    with pytest.raises(ValueError) as want:
        je.set_params({**jp, "layer_1": {**jp["layer_1"],
                                         "kernel": jnp.zeros((128, 8))}})
    with pytest.raises(ValueError) as got:
        te.set_params({**tp, "layer_1": {**tp["layer_1"],
                                         "kernel": torch.zeros(128, 8)}})
    assert str(got.value) == str(want.value)
    # A leaf of another dtype (leaf 0: layer_0's bias).
    with pytest.raises(ValueError) as want:
        je.set_params({**jp, "layer_0": {
            **jp["layer_0"], "bias": jp["layer_0"]["bias"].astype(
                jnp.bfloat16)}})
    with pytest.raises(ValueError) as got:
        te.set_params({**tp, "layer_0": {
            **tp["layer_0"], "bias": tp["layer_0"]["bias"].bfloat16()}})
    assert str(got.value) == str(want.value)
    # A valid swap serves the new weights.
    doubled = {k: {"kernel": v["kernel"] * 2, "bias": v["bias"]}
               for k, v in tp.items()}
    before = te.predict(np.ones(16, np.float32))
    te.set_params(doubled)
    assert not np.array_equal(te.predict(np.ones(16, np.float32)), before)


def test_unported_options_refuse_by_name():
    # Weight quantization is ported (tests/test_torch_weight_quant.py):
    # int8 serves, an unknown mode raises JAX's ValueError.
    te = InferenceEngine("mlp", device="cpu", quantize="int8")
    assert te.params["layer_0"]["kernel_q"].dtype == torch.int8
    assert np.isfinite(te.predict(np.ones(16, np.float32))).all()
    with pytest.raises(ValueError, match="unsupported quantize mode"):
        InferenceEngine("mlp", device="cpu", quantize="int4")
    # Shape buckets are ported (tests/test_torch_yolo.py); the model's own
    # shape is always one of them.
    te = InferenceEngine("mlp", device="cpu", shape_buckets=[(8,)])
    assert te.stats()["shape_buckets"] == [[8], [16]]
    # Without shape buckets a request's shape is ignored, as in JAX.
    te = InferenceEngine("mlp", device="cpu", dtype="float32")
    assert np.array_equal(te.batch_predict([[1.0]], shapes=[(1, 16)])[0],
                          te.predict([1.0]))


def test_warmup_and_stats():
    te = InferenceEngine("mlp", device="cpu", dtype="float32",
                         batch_buckets=(1, 4))
    te.warmup()
    st = te.stats()
    assert st["execute_count"] == 2 and st["collect_block_s"] >= 0
    assert st["model"] == "mlp" and st["buckets"] == [1, 4]

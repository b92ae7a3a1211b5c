"""The port's one-shot models (tpu_engine_torch.models.mlp and .resnet, on
ops.nn's conv2d, batchnorm, max_pool and global_avg_pool) against the JAX
package's on the same weights (models.convert.params_from_jax) and the
same numpy-seeded inputs, on the CPU.

Tolerances, as max|port - jax| / max|jax| over the logits: f32 1e-4
(the same products summed in another order); bf16 2e-2 (each conv's bf16
operands multiply exactly and sum in f32 on both sides, but a sum that
differs in its last f32 bit can round the next conv's bf16 input the
other way, and that spreads through 16 blocks). ResNet-50 and ResNet-50
v1.5 run at full width and depth, at 224 (the served size) and 63 (odd:
SAME's padding differs between the stride-2 stem at 63 and at 224). The
SAME padding of XLA is asymmetric at stride 2; the stem alone shows that
torch's symmetric padding would not be the JAX function."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tpu_engine.models.registry import (
    _ensure_builtin_models_imported,
    create_model as jcreate,
)
from tpu_engine.ops import nn as jnn
from tpu_engine_torch.models.convert import params_from_jax
from tpu_engine_torch.models.registry import create_model as tcreate
from tpu_engine_torch.ops import nn

_ensure_builtin_models_imported()

TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def numpy_params(name, seed=0):
    """A JAX parameter tree of ``name`` (the shapes of its init, traced but
    not run) filled from numpy: He-normal kernels, batch norm with its
    own statistics (scale and var in [0.5, 1.5], bias and mean N(0,
    0.1^2)), small dense biases."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(jcreate(name).init, jax.random.PRNGKey(0))

    def leaf(path, sd):
        key, shape = path[-1].key, sd.shape
        if key == "kernel":
            std = (2.0 / np.prod(shape[:-1])) ** 0.5
            return (rng.standard_normal(shape) * std).astype(np.float32)
        if key in ("scale", "var"):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        return (rng.standard_normal(shape) * 0.1).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def jax_params():
    """Each model's weights, drawn once (they do not depend on the image
    size)."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = numpy_params(name)
        return cache[name]
    return get


def run_both(name, tree, x, dtype, **kw):
    """The JAX forward (jit, as the engine runs it) and the port's."""
    jspec, tspec = jcreate(name, **kw), tcreate(name, **kw)
    want = np.asarray(jax.jit(lambda p, x: jspec.apply(
        p, x, dtype=getattr(jnp, dtype)))(tree, x))
    params = params_from_jax(tree, None, device="cpu", dtype=dtype)
    with torch.inference_mode():
        got = tspec.apply(params, torch.from_numpy(x),
                          dtype=getattr(torch, dtype)).numpy()
    return got, want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_matches_jax(jax_params, dtype):
    x = np.random.default_rng(0).standard_normal((5, 16)).astype(np.float32)
    got, want = run_both("mlp", jax_params("mlp"), x, dtype)
    assert got.shape == want.shape == (5, 16) and got.dtype == np.float32
    assert rel_err(got, want) <= TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("size", [224, 63])
@pytest.mark.parametrize("name", ["resnet50", "resnet50-v1"])
def test_resnet_matches_jax(jax_params, name, size, dtype):
    batch = 1 if size == 224 else 2  # one served image; two small ones
    x = np.random.default_rng(size).standard_normal(
        (batch, size, size, 3)).astype(np.float32)
    got, want = run_both(name, jax_params(name), x, dtype, image_size=size)
    assert got.shape == want.shape == (batch, 1000)
    assert np.isfinite(got).all()
    assert rel_err(got, want) <= TOL[dtype]


@pytest.mark.parametrize("size,k,want", [(224, 7, (2, 3)), (112, 3, (0, 1)),
                                         (63, 7, (3, 3)), (32, 3, (0, 1)),
                                         (63, 3, (1, 1))])
def test_same_pads_is_xla_same(size, k, want):
    assert nn.same_pads(size, k, 2) == want
    assert nn.same_pads(size, 1, 2) == (0, 0)


@pytest.mark.parametrize("size", [224, 63])
def test_stem_conv_and_pool_pad_as_xla_same(size):
    """The 7x7/2 stem and the 3x3/2 max pool against lax's SAME ops; the
    same conv with torch's symmetric padding (k // 2 per side) is off by a
    pixel at 224, so this test fails under symmetric stride-2 padding."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1, size, size, 3)).astype(np.float32)
    w = rng.standard_normal((7, 7, 3, 64)).astype(np.float32)
    want = np.asarray(jnn.conv2d({"kernel": jnp.asarray(w)},
                                 jnp.asarray(x), stride=2))
    tx = torch.from_numpy(x).permute(0, 3, 1, 2)
    tk = torch.from_numpy(w).permute(3, 2, 0, 1).contiguous()
    got = nn.conv2d({"kernel": tk}, tx, stride=2).permute(0, 2, 3, 1)
    assert rel_err(got.numpy(), want) <= 1e-5
    symmetric = F.conv2d(tx, tk, stride=2, padding=3).permute(0, 2, 3, 1)
    if size == 224:  # SAME pads (2, 3) here, so symmetric (3, 3) differs
        assert rel_err(symmetric.numpy(), want) > 0.1
    pool_want = np.asarray(jnn.max_pool(jnp.asarray(want), 3, 2))
    pool_got = nn.max_pool(got.permute(0, 3, 1, 2), 3, 2).permute(0, 2, 3, 1)
    assert np.array_equal(pool_got.numpy(), pool_want)


def test_bf16_conv_is_f32_sum_of_bf16_products():
    """conv2d in bf16 gives JAX's preferred_element_type=f32 result: the
    rounded operands' products summed in f32."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 17, 17, 8)).astype(np.float32)
    w = rng.standard_normal((3, 3, 8, 16)).astype(np.float32)
    want = np.asarray(jnn.conv2d({"kernel": jnp.asarray(w)}, jnp.asarray(x),
                                 stride=2, dtype=jnp.bfloat16))
    got = nn.conv2d({"kernel": torch.from_numpy(w).permute(3, 2, 0, 1)},
                    torch.from_numpy(x).permute(0, 3, 1, 2), stride=2,
                    dtype=torch.bfloat16)
    assert got.dtype == torch.float32
    assert rel_err(got.permute(0, 2, 3, 1).numpy(), want) <= 1e-6


def test_batchnorm_and_global_pool_match_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 5, 6)).astype(np.float32)
    bn = {k: rng.random(6).astype(np.float32) + 0.5
          for k in ("scale", "bias", "mean", "var")}
    want = np.asarray(jnn.global_avg_pool(jnn.batchnorm(
        {k: jnp.asarray(v) for k, v in bn.items()}, jnp.asarray(x))))
    got = nn.global_avg_pool(nn.batchnorm(
        {k: torch.from_numpy(v) for k, v in bn.items()},
        torch.from_numpy(x).permute(0, 3, 1, 2)))
    assert rel_err(got.numpy(), want) <= 1e-6


def test_converted_conv_kernels_are_oihw_channels_last():
    tree = {"stem": {"kernel": np.zeros((7, 7, 3, 64), np.float32)},
            "bn": {"scale": np.ones(64, np.float32)}}
    out = params_from_jax(tree, None, device="cpu", dtype="bfloat16")
    k = out["stem"]["kernel"]
    assert k.shape == (64, 3, 7, 7) and k.dtype == torch.bfloat16
    assert k.is_contiguous(memory_format=torch.channels_last)
    assert out["bn"]["scale"].dtype == torch.float32


@pytest.mark.parametrize("name", ["mlp", "resnet50", "resnet50-v1"])
def test_random_init_is_seeded_and_finite(name):
    spec = tcreate(name, **({} if name == "mlp" else {"image_size": 32}))
    a = spec.init(0, device="cpu", dtype="float32")
    b = spec.init(0, device="cpu", dtype="float32")
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2,) + spec.input_shape).astype(np.float32))
    with torch.inference_mode():
        ya = spec.apply(a, x, dtype=torch.float32)
        yb = spec.apply(b, x, dtype=torch.float32)
    assert torch.equal(ya, yb) and bool(torch.isfinite(ya).all())
    assert tuple(ya.shape) == (2,) + spec.output_shape
    assert spec.state_family == "stateless" and spec.config is None
